"""wait_ms.fleet: the median over the fleet's frames (ms) of the span
`fleet.wait`, the host waiting on the reply's event: the device's tick
and copy that the host did not hide (mclbench/program_telemetry.py)."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.fleet_median(r, ("fleet.wait",))
