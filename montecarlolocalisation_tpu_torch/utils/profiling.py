"""Profiling: the recorder of spans, stage marks and counters, the trace,
and stage timing.

Torch counterpart of montecarlolocalisation_tpu/utils/profiling.py.  The
reference times its hot loops with chrono spans logged to ROS_INFO
(computeWeight, resample, k-means, the tick: monte_carlo.cpp:625, 678,
556, 943, 1093) and records none of them.  Here:

  * the recorder (`Recorder`, one a process: `recorder`, with `span`,
    `record`, `count` and the reader `recorded`): spans and counters that
    the program keeps whenever it runs, with no switch.  A span is (name,
    id, parent, start ns, end ns): `id` is the request it serves (a fleet
    frame's tick, an episode call's index) and `parent` the name of the
    span open around it, whose id a span without its own inherits.
    Spans are stamped with time.time_ns(), the clock of torch.profiler's
    events, so they lie on one timeline with the device's operations;
    they never go through record_function or NVTX, whose ranges a CUDA
    trace would also show as device annotations.  The last SPANS_KEPT
    spans stay in a ring; counters are process totals.
  * mark: a stage mark on the device's timeline.  On CUDA it launches an
    empty kernel named after the mark (csrc/marks.cu, ops/marks) on the
    current stream, so a CUDA graph captures it with the stage's
    operations and every replay runs it in stream order: in a trace, the
    operations after a mark, up to the next, are that stage's.  On the
    CPU it does nothing.
  * time_fn: mean wall seconds a call after a warm-up, the card
    synchronized around the timed calls; device_ms: the card's busy time
    a call, from the profiler;
  * trace: a context manager over torch.profiler that writes a Chrome
    trace of the host, the card and the recorder's spans into a
    directory;
  * stage_knockout_times: the stage marginals of the filter tick, by
    replacing one stage at a time with a trivial dependent stand-in,
    every variant its own CUDA graph (the JAX package's jax.jit per skip
    set).
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import os
import time
from typing import Callable, Dict, NamedTuple, Optional

import torch

from ..ops import marks as _marks

STAGES = ("motion", "weights", "resample", "cluster")
# Spans the recorder keeps, the newest: a 30 s fleet run records about
# 3,000, a 30 s replay of 1024 logs about 15,000.
SPANS_KEPT = 65_536


class Span(NamedTuple):
    """One recorded span; start and end in time.time_ns() nanoseconds."""

    name: str
    id: int
    parent: Optional[str]
    start: int
    end: int


class _Open:
    """A span while it is open (Recorder.span)."""

    __slots__ = ("rec", "name", "id", "parent", "start")

    def __init__(self, rec, name, id, start):
        self.rec = rec
        self.name = name
        self.id = id
        self.start = start

    def __enter__(self):
        stack = self.rec._open
        if stack:
            top = stack[-1]
            self.parent = top.name
            if self.id is None:
                self.id = top.id
        else:
            self.parent = None
            if self.id is None:
                self.id = next(self.rec._ids)
        stack.append(self)
        if self.start is None:
            self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        rec = self.rec
        rec._open.pop()
        rec.spans.append((self.name, self.id, self.parent, self.start, end))
        return False


class Recorder:
    """Spans in a ring of the last `limit` and counters (module
    docstring).  One thread records: the one that serves or runs the
    episodes (the port records on no other)."""

    def __init__(self, limit: int = SPANS_KEPT):
        self.spans = collections.deque(maxlen=limit)
        self.counters: Dict[str, float] = {}
        self._ids = itertools.count()
        self._open = []     # the open spans, the innermost last

    def span(self, name: str, id: Optional[int] = None,
             start: Optional[int] = None) -> _Open:
        """A context manager that records the span `name` over its block.
        `id` None takes the open span's id, or a new one where none is
        open; `start` (time.time_ns()) dates a span that began before the
        block."""
        return _Open(self, name, id, start)

    def record(self, name: str, start: int, end: int) -> None:
        """A span that has ended, as a child of the open span (with its
        id), or with a new id where none is open."""
        if self._open:
            top = self._open[-1]
            self.spans.append((name, top.id, top.name, start, end))
        else:
            self.spans.append((name, next(self._ids), None, start, end))

    def count(self, name: str, n=1) -> None:
        """Add n to the process total `name`."""
        self.counters[name] = self.counters.get(name, 0) + n

    def read(self):
        """(the spans in the ring, oldest ended first, as Span; a copy of
        the counters)."""
        return [Span(*s) for s in self.spans], dict(self.counters)


recorder = Recorder()
span = recorder.span
record = recorder.record
count = recorder.count


def recorded():
    """The reader: (spans, counters).  The counters are the recorder's
    totals and the kernel wrappers' launch counters, read where they
    live (`launches.<wrapper>`, models/compiled)."""
    from ..models import compiled

    spans, counters = recorder.read()
    for f in compiled.KERNEL_WRAPPERS:
        counters["launches." + f.__name__] = f.launches
    return spans, counters


def mark(name: str, device: torch.device) -> None:
    """The stage mark `name` (ops/marks.MARKS) on `device`'s current
    stream; nothing off CUDA (module docstring)."""
    if device.type == "cuda":
        _marks.launch(name, device)


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, iters: int = 20, warmup: int = 1) -> float:
    """Mean wall seconds a call of fn(*args) over `iters` calls, after
    `warmup` calls; on CUDA the card is synchronized before and after the
    timed calls."""
    for _ in range(warmup):
        fn(*args)
    _sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    _sync()
    return (time.perf_counter() - t0) / iters


def device_ms(fn: Callable, reps: int = 20, tries: int = 3) -> float:
    """Device ms of one call of fn() on the card: every kernel and copy
    the profiler sees over `reps` calls after a warm-up, over reps.  A
    window with no device activity is taken again, up to `tries` times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                total += getattr(ev, "self_device_time_total",
                                 None) or ev.self_cuda_time_total
        if total > 0.0:
            return total / 1e3 / reps
    raise RuntimeError("the profiler recorded no device time")


# The Chrome trace's track of the recorder's spans.
_SPAN_TID = 0


def _add_spans(path: str, t0: int, t1: int) -> None:
    """Append the spans recorded within [t0, t1] to the Chrome trace at
    `path`, as complete events on its microsecond timeline."""
    with open(path) as f:
        doc = json.load(f)
    base = doc.get("baseTimeNanoseconds", 0)
    pid = os.getpid()
    events = doc.setdefault("traceEvents", [])
    events.append(dict(ph="M", name="thread_name", pid=pid, tid=_SPAN_TID,
                       args=dict(name="program spans")))
    for s in recorder.read()[0]:
        if t0 <= s.start and s.end <= t1:
            events.append(dict(
                ph="X", cat="program_span", name=s.name, pid=pid,
                tid=_SPAN_TID, ts=(s.start - base) / 1e3,
                dur=(s.end - s.start) / 1e3,
                args=dict(id=s.id, parent=s.parent)))
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around the block, the host's activity and, on a
    card, its kernels; writes `logdir`/trace.json (Chrome trace format,
    viewable in Perfetto or chrome://tracing) when the block ends, with
    the recorder's spans of the block on a track of their own.  Yields
    the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, "trace.json")
    with profile(activities=acts) as prof:
        t0 = time.time_ns()
        yield prof
        _sync()
        t1 = time.time_ns()
    prof.export_chrome_trace(path)
    _add_spans(path, t0, t1)


def _knockout_step(m, cfg, scan, st, enc, skip, draws=None):
    """One mcl_step (models/filter.py) with the `skip` stages replaced by
    trivial dependent stand-ins.  With skip=() it reproduces mcl_step bit
    for bit at a configuration without the ESS gate, refinement or a known
    map (the same draws, stage order and state wiring); `draws` default to
    the state's generator's, as mcl_step draws them."""
    from ..models import cluster, filter as mcl, motion, resample, sensor

    n = st.particles.shape[-2]
    if draws is None:
        draws = mcl.draw_tick(st.gen, m, n, cfg, st.batch)
    was_lost, cluster_thr, conf_thr, _, _ = mcl._hysteresis(st, m, cfg)
    if "motion" in skip:
        odom, parts = st.odom, st.particles
    else:
        odom, parts = motion.motion_update(
            st.particles, st.odom, enc, enc, cfg.motion,
            draws.motion_normals)
    if "weights" in skip:
        w = parts[..., 0] * 1e-6
    else:
        w = sensor.beam_weights(m, parts, scan, cfg.sensor,
                                cfg.valid_pos_offset)
    if "resample" in skip:
        parts2 = parts + w[..., None] * 0.0
        w2 = torch.full_like(w, 1.0 / n)
        inj = st.inj
    else:
        parts2, w2, inj, _ = resample.resample(
            parts, w, st.inj, was_lost, m, cfg, draws.resample)
    if "cluster" in skip:
        conf, best = 0.5 + parts2[..., 0, 0] * 0.0, st.best_pose
    else:
        conf, best = cluster.cluster_confidence(
            parts2, w2, conf_thr, cfg.cluster, draws.kmeans_init,
            draws.kmeans_reseed)
    return dataclasses.replace(
        st, particles=parts2, weights=w2, odom=odom, inj=inj,
        confidence=conf, was_lost=was_lost, cluster_threshold=cluster_thr,
        confident_threshold=conf_thr, best_pose=best)


def _knockout_tick(carry, x, consts, m, cfg, skip):
    scan = consts["scan"]
    st = _knockout_step(m, cfg, scan, carry, x["enc"], skip)
    return st, st.confidence


def _graph(step, state, m, cfg, scan, **static):
    """A one-tick TickGraph of step(carry, x, consts) from `state`, with
    the encoders at 0.1 rad (the JAX harness's) as its input."""
    from ..models import compiled

    dev = state.particles.device
    xs = dict(enc=torch.full(state.batch + (1,), 0.1, device=dev))
    consts = dict(scan=scan)
    graph = compiled.TickGraph(step, state, xs, consts, len(state.batch),
                               dict(static, m=m, cfg=cfg))
    return graph, xs, consts


def stage_knockout_times(m, cfg, scan, state,
                         iters: int = 20) -> Dict[str, float]:
    """Stage marginals by knockout: the wall seconds of the full tick a
    call, and `marginal_<stage>` = full - the tick with that stage
    replaced by its stand-in.  Each variant is its own one-tick graph
    (CUDA graph replays on the card), timed over `iters` replays chained
    from the state, after one replay; every measurement stays one
    composed program, so small stages are not overstated by dispatch."""
    def run(skip):
        graph, xs, consts = _graph(_knockout_tick, state, m, cfg, scan,
                                   skip=skip)
        carry = [graph(state, xs, consts)[0]]

        def call():
            carry[0] = graph(carry[0], xs, consts)[0]

        return time_fn(call, iters=iters, warmup=0)

    full = run(())
    out = dict(full=full)
    for stage in STAGES:
        out[f"marginal_{stage}"] = full - run((stage,))
    return out
