"""encode_ms.fleet: the median over the fleet's frames (ms) of the spans
`fleet.reply` (the reply's rounding into a dict) and `fleet.write`
(json.dumps, print and flush) (mclbench/program_telemetry.py)."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.fleet_median(r, ("fleet.reply",
                                              "fleet.write"))
