"""resample_ms_per_tick.slam: device time a tick (ms) of RBPF SLAM's
resampling, the stage that the mark `slam_resample` opens (models/slam):
the ESS gate, the gathers of poses, maps and scores, the weighted mean
pose and the keyframe criterion.  None where no slam_resample mark
ran."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "slam_resample")
