"""outside_graph_ms_per_tick.replay: device time a tick (ms) of the
operations outside every replay's extent, from its `begin` mark to its
`end` mark (mclbench/program_telemetry.py): the calls' copy-ins, the mask
fill and the output stacking."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "outside")
