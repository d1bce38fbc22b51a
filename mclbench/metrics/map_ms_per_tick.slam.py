"""map_ms_per_tick.slam: device time a tick (ms) of RBPF SLAM's map
update, the stage that the mark `slam_map` opens (models/slam): the
inverse sensor model over every particle's map, the keyframe select,
kf_pose and the best pose.  None where no slam_map mark ran."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "slam_map")
