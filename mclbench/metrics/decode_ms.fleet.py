"""decode_ms.fleet: the median over the fleet's frames (ms) of the spans
`fleet.decode` (json.loads of the line) and `fleet.stage` (the frame into
the pinned buffer) (mclbench/program_telemetry.py)."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.fleet_median(r, ("fleet.decode",
                                              "fleet.stage"))
