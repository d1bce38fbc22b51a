"""field_ms_per_tick.slam: device time a tick (ms) of RBPF SLAM's
likelihood field, the stage that the mark `slam_field` opens
(models/slam): the field of each particle's map and its blur, the scan's
bilinear samples, the evidence and the weights' normalisation.  None
where no slam_field mark ran."""
from mclbench import program_telemetry


def read(r):
    return program_telemetry.stage_ms(r, "slam_field")
