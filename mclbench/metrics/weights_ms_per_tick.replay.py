"""weights_ms_per_tick.replay: device time a tick (ms) of the weights
stage, the operations after each `weights` mark up to the next mark
(mclbench/program_telemetry.py): K1 and the sensor module's operations."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "weights")
