"""idle_in_graph_share.replay: the share of the traced window (%) in
which the device sat idle inside a replay's extent, from its `begin` mark
to its `end` mark (mclbench/program_telemetry.py): the graph's own gaps
between its nodes.  Its base is idle_share.replay's, so it never exceeds
it; the rest of idle_share.replay is the host's."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "idle_in_graph_share")
