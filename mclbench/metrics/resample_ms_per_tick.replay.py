"""resample_ms_per_tick.replay: device time a tick (ms) of the resampling
stage, the operations after each `resample` mark up to the next mark
(mclbench/program_telemetry.py): the draw of the survivors and the
injection."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "resample")
