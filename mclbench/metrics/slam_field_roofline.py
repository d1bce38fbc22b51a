"""slam_field_roofline: the SLAM likelihood field's share of its roofline
(%): the yardstick's least time a tick for every particle's map read
once, its wallness, the blur's taps and the scan's bilinear samples
(mclbench/bounds.slam_field_bound, the reading's slam_field_ms_per_tick)
over the device time a tick of the `slam_field` stage.  None where the
stage or the bound is missing."""
from mclbench import program_telemetry


def read(r):
    ms = program_telemetry.stage_ms(r, "slam_field")
    bound = r.bounds.get("slam_field_ms_per_tick")
    if not ms or bound is None:
        return None
    return 100.0 * bound / ms
