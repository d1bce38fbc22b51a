"""launch_ms.fleet: the median over the fleet's frames (ms) of the span
`fleet.launch`: the graph's lookup, copy-in and replay, and the reply's
copy to the host behind its event (mclbench/program_telemetry.py)."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.fleet_median(r, ("fleet.launch",))
