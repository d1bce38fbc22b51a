"""What the per-layer metrics read from inside the program: the stage
marks among a traced run's device operations, and the spans and counters
of the port's recorder (montecarlolocalisation_tpu_torch/utils/profiling).

This is the only benchmark module besides program.py that imports the
port, and it imports only the recorder's reader, `recorded`.  Where the
port has no recorder, or a trace holds no marks, each reader here returns
None, and so does the metric that calls it.

Marks are the device operations whose names contain "mcl_mark_": empty
kernels that a CUDA graph replays in stream order with the tick's
operations.  A replay's extent runs from its `begin` mark to its `end`
mark.  Inside an extent an operation belongs to the stage that the last
mark before it opened: a mark `mcl_mark_<name>` opens the stage <name>,
but `begin` and `emit` open the bookkeeping (the draws, the hysteresis,
publishing, the state's assembly and the output slab's copies) and `end`
closes the extent.  The marks' own time belongs to no stage, and the
operations outside every extent are outside the graph (the calls'
copy-ins, the mask fill, the output stacking).

The fleet's spans: each frame is a span `fleet.frame` whose children
`fleet.decode`, `fleet.stage`, `fleet.launch`, `fleet.wait`,
`fleet.reply` and `fleet.write` carry its tick.  The readers take the
frames host_ms.fleet takes: those of the `fleet.serve` session that
holds the traced window, less every frame that overlaps the window
widened by one period at its end (the profiler slows the host) and every
frame that built a graph.
"""
from __future__ import annotations

import re

from .drivers import nearest_rank
from .trace import covered_ns, union

MARK = re.compile(r"mcl_mark_([a-z][a-z0-9_]*)")
# The stages every split reports; a trace's other marks add their own.
STAGES = ("motion", "weights", "resample", "cluster", "bookkeeping")
# The marks that open another stage than their name (None: it closes the
# extent).
OPENS = dict(begin="bookkeeping", emit="bookkeeping", end=None)


def recorded():
    """(spans, counters) of the port's recorder; None where the port has
    none."""
    try:
        from montecarlolocalisation_tpu_torch.utils.profiling import \
            recorded as read
    except ImportError:
        return None
    return read()


def stage_split(r):
    """The traced device time by stage, as ms a tick, for r.ops: each of
    STAGES and every other stage a mark opened, `outside` (outside every
    extent), `marks` (the marks' own time), and `idle_in_graph_share` (%
    of r.window_s idle inside the extents).  None where the trace holds
    no mark."""
    intervals = {k: [] for k in STAGES + ("outside", "marks")}
    extents = []
    stage = None
    opened = None
    for name, s, e in sorted(r.ops, key=lambda o: o[1]):
        m = MARK.search(name)
        if m is None:
            intervals[stage or "outside"].append((s, e))
            continue
        intervals["marks"].append((s, e))
        which = m.group(1)
        if which == "begin":
            opened = s
        elif which == "end" and opened is not None:
            extents.append((opened, e))
            opened = None
        stage = OPENS.get(which, which)
        if stage is not None:
            intervals.setdefault(stage, [])
    if not intervals["marks"] or not r.ticks:
        return None
    out = {k: covered_ns(v) * 1e-6 / r.ticks for k, v in intervals.items()}
    # The busy time inside the extents: both lists sorted and disjoint.
    inside = i = 0
    for s, e in union([(s, e) for _, s, e in r.ops]):
        while i < len(extents) and extents[i][1] <= s:
            i += 1
        j = i
        while j < len(extents) and extents[j][0] < e:
            inside += min(e, extents[j][1]) - max(s, extents[j][0])
            j += 1
    idle = sum(b - a for a, b in extents) - inside
    window_ns = r.window[1] - r.window[0]
    out["idle_in_graph_share"] = (100.0 * idle / window_ns if window_ns > 0
                                  else None)
    return out


def stage_ms(r, key: str):
    """stage_split's `key`; None where the trace holds no mark, or no mark
    opened that stage."""
    split = stage_split(r)
    return None if split is None else split.get(key)


def fleet_frames(r):
    """The fleet frames the metrics read (module docstring), each a dict
    of its span's and its children's ms by name; None where the recorder
    holds no such frame."""
    got = recorded()
    if got is None or not r.ticks:
        return None
    spans = got[0]
    period = (r.window[1] - r.window[0]) / r.ticks
    w0, w1 = r.window[0], r.window[1] + period
    sessions = [s for s in spans
                if s.name == "fleet.serve" and s.start <= w0 <= s.end]
    if not sessions:
        return None
    a, b = sessions[-1].start, sessions[-1].end
    builds = [s.start for s in spans if s.name == "graph.build"]
    children = {}
    for s in spans:
        if s.parent == "fleet.frame":
            children.setdefault(s.id, []).append(s)
    frames = []
    for f in spans:
        if (f.name != "fleet.frame" or not a <= f.start <= f.end <= b
                or (f.start < w1 and f.end > w0)
                or any(f.start <= t <= f.end for t in builds)):
            continue
        ms = {f.name: (f.end - f.start) * 1e-6}
        for c in children.get(f.id, ()):
            if f.start <= c.start and c.end <= f.end:
                ms[c.name] = ms.get(c.name, 0.0) + (c.end - c.start) * 1e-6
        frames.append(ms)
    return frames or None


def fleet_median(r, names) -> float:
    """The median over the frames of the sum of the spans `names` (ms);
    None without frames."""
    frames = fleet_frames(r)
    if frames is None:
        return None
    return nearest_rank([sum(f.get(n, 0.0) for n in names) for f in frames],
                        0.5)


def counter_sum(names):
    """The sum of the recorder's counters `names` over the process; None
    where the port has no recorder or none of them."""
    got = recorded()
    if got is None:
        return None
    counters = got[1]
    if not any(n in counters for n in names):
        return None
    return float(sum(counters.get(n, 0) for n in names))
