"""frame_p95_ms: the fleet's tail, the 95th percentile (nearest rank) of
the traced run's frames outside its profile, from each frame's due time to
its reply written.  A per-layer number: on a shared host its runs spread
too widely to hold a bound (PERF.md, section 2)."""
import math


def read(r):
    v = sorted(r.latency_ms)
    if not v:
        return None
    return v[max(0, math.ceil(0.95 * len(v)) - 1)]
