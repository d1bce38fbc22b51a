"""ism_roofline: the SLAM map update's share of its roofline (%): the
yardstick's least time a tick for the pixels the mapped filters' scans
reach (mclbench/bounds.ism_bound, the reading's ism_ms_per_tick) over
the device time a tick of the `slam_map` stage.  None where the stage
or the bound is missing (no mark ran, or no traced tick mapped)."""
from mclbench import program_telemetry


def read(r):
    ms = program_telemetry.stage_ms(r, "slam_map")
    bound = r.bounds.get("ism_ms_per_tick")
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
