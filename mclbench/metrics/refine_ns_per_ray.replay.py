"""refine_ns_per_ray.replay: device time (ns) of the refinement a ray its
castings score: refine_ms_per_tick.replay's stages over the rays a tick,
the port's counters refine.rays over refine.calls (models/refine; a call
is a tick, a graph's captured tick counted once).  None where the trace
holds no refine mark or the port records no such counters."""
from mclbench import program_telemetry

STAGES = ("refine", "refine_grad", "refine_score")


def read(r):
    split = program_telemetry.stage_split(r) or {}
    ms = [split[s] for s in STAGES if s in split]
    rays = program_telemetry.counter_sum(("refine.rays",))
    calls = program_telemetry.counter_sum(("refine.calls",))
    if not ms or not rays or not calls:
        return None
    return sum(ms) * 1e6 / (rays / calls)
