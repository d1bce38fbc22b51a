"""slam_ns_per_ray.slam: device time (ns) of RBPF SLAM's tick a ray: the
four SLAM stages (`slam_motion`, `slam_field`, `slam_resample`,
`slam_map`) a tick over the rays a tick, the port's counters slam.rays
over slam.calls (models/slam: E x K x P x B a call, a graph's captured
tick counted once).  None where the trace holds no SLAM mark or the port
records no such counters."""
from mclbench import program_telemetry

STAGES = ("slam_motion", "slam_field", "slam_resample", "slam_map")


def read(r):
    split = program_telemetry.stage_split(r) or {}
    ms = [split[s] for s in STAGES if s in split]
    rays = program_telemetry.counter_sum(("slam.rays",))
    calls = program_telemetry.counter_sum(("slam.calls",))
    if not ms or not rays or not calls:
        return None
    return sum(ms) * 1e6 / (rays / calls)
