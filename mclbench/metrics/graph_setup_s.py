"""graph_setup_s: the seconds the process spent capturing and
instantiating CUDA graphs, the recorder's counters graph.capture_s and
graph.instantiate_s (models/compiled), over the whole run: the part of
setup_s that the compiled tick costs (mclbench/program_telemetry.py)."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.counter_sum(("graph.capture_s",
                                          "graph.instantiate_s"))
