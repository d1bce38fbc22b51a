"""motion_ms_per_tick.replay: device time a tick (ms) of the motion stage,
the operations after each `motion` mark up to the next mark
(mclbench/program_telemetry.py): odometry and propagation (refinement,
where it is on, opens stages of its own: `refine`, `refine_grad`,
`refine_score`)."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "motion")
