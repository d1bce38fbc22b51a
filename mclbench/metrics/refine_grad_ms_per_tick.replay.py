"""refine_grad_ms_per_tick.replay: device time a tick (ms) of the stage
that each refinement round's `refine_grad` mark opens
(mclbench/program_telemetry.py): the differentiable caster's dense DDA
forward over every ray, its backward, and the step.  None where no such
mark ran."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "refine_grad")
