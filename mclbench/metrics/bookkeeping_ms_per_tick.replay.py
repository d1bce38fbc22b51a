"""bookkeeping_ms_per_tick.replay: device time a tick (ms) of the
operations after each `begin` or `emit` mark up to the next mark
(mclbench/program_telemetry.py): the draws, the hysteresis, publishing,
the state's assembly and the output slab's copies."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "bookkeeping")
