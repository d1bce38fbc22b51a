"""cluster_ms_per_tick.replay: device time a tick (ms) of the cluster
stage, the operations after each `cluster` mark up to the next mark
(mclbench/program_telemetry.py): K3 and the confidence."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "cluster")
