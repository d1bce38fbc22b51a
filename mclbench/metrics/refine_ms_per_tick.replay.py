"""refine_ms_per_tick.replay: device time a tick (ms) of the gradient
refinement, the stages that the marks `refine`, `refine_grad` and
`refine_score` open (mclbench/program_telemetry.py): the start's scoring,
each round's dense DDA forward and backward and its step, and each
proposal's scoring and acceptance.  None where no refine mark ran."""
from mclbench import program_telemetry

STAGES = ("refine", "refine_grad", "refine_score")


def read(r):
    split = program_telemetry.stage_split(r) or {}
    ms = [split[s] for s in STAGES if s in split]
    return sum(ms) if ms else None
