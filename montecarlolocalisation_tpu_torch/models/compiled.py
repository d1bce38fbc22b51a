"""The compiled tick: K consecutive ticks captured in one CUDA graph.

The port's counterpart of the JAX package's `jax.jit` plus `lax.scan`.
The JAX package never runs its tick op by op: each entry point compiles
the whole tick into one program and dispatches it once a tick
(io/server.py:121, :377; io/fleet.py:95, :330) or once every K ticks
(models/filter.py:274-298, parallel/episodes.py:76-148, presets.py:85,
:361, the root bench.py:73-88).  Here the same eager calls of a tick
function are captured in one torch.cuda.CUDAGraph and replayed: one
replay runs K ticks, every kernel and torch op inside it.

A `TickGraph` is K calls of one tick function `step(carry, x, consts) ->
(carry, y)` for one fixed set of shapes.  It owns static buffers: the
carried state, an input slab whose tensors hold K ticks along the tick
axis (axis `lead`, after the leading episode dims), the constants every
tick reads, and an output slab of the K ticks' outputs, stacked along the
same axis.  The captured region runs the K ticks on the buffers, writes
each tick's outputs into the output slab and, last, copies the final
state back into the state buffers, so the state stays on the card between
replays.  A call copies the caller's state (each tensor that is not
already the buffer), its generators' states and the K ticks' inputs into
the buffers, replays once, copies the generators' states back, and
returns the state buffers (with the caller's generators) and the output
slab.  Both are the graph's own and change at its next call: a caller
that keeps them past that copies them.

Random numbers: every torch.Generator in the state is replaced by one
the graph owns and registers with the CUDA graph
(CUDAGraph.register_generator_state).  A replay reads the registered
generator's seed and offset at launch and advances it by the captured
ticks' draws, so it draws exactly what the eager ticks would draw from
the same generator state; the call moves that state in from the caller's
generator and back out to it.

On the CPU the same class runs the same choreography, buffers and copies
included, with eager calls of the ticks in place of capture and replay.
On CUDA the ticks are captured and replayed, or the call raises: nothing
catches a failed capture and runs eagerly instead.  Before capture, one
tick runs eagerly on a side stream (the warm-up of the torch
documentation): it loads the kernels' library and their modules, sets
their launch attributes and gives the output slab its shapes.

Telemetry (utils/profiling): the captured region opens with the stage
mark `begin` and closes with `end`, so a trace of the card shows each
replay's extent; `cached` records the span `graph.lookup` (with
`graph.build` inside it when the key is new), a call `graph.copy_in` and
`graph.replay`, and `run_chunked` `episode.copy_out`.  The recorder's
counters `graph.builds`, `graph.hits`, `graph.capture_s` and
`graph.instantiate_s` count every graph of every cache, those dropped
since too.

Launch counts: a kernel wrapper's `launches` counter and the C entries'
device launch counters count what reaches the card.  The calls that a
capture records do not launch, so a capture takes its own counts back
out, and every replay adds them again: the counters count the warm-up's
launches and each replay's.

`GraphCache` holds TickGraphs keyed as jit's trace cache is keyed: the
tick function, its static arguments and the shapes, dtypes and devices of
everything the tick reads (`signature`).  A static argument that holds a
tensor (a map, a beam table) is keyed by its identity and held weakly:
the entry is dropped when that object dies, so a graph never outlives the
tensors it reads and an identity in a key is never reused while its entry
lives.  Any other static argument (a config, a count) is keyed by value.
A changed key builds a new graph; an unchanged key replays.  `graphs` is
the cache of the functional entry points (models/filter, sim/robot, the
bench), which keeps the GRAPHS_KEPT graphs used last; each server owns a
cache of its own, which lives as long as the server and holds one graph
for each particle count and resize of its budget.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import weakref
from typing import Callable, Hashable, Optional

import torch

from ..ops import build, expand, ism, kmeans, refine, weights
from ..utils import profiling

# Ticks a graph for an episode: the JAX bench's default --scan-chunk
# (bench.py:156-161).  An episode of T ticks replays T // TICKS_PER_GRAPH
# times one graph of this many ticks, then one graph of the remainder.
TICKS_PER_GRAPH = 8
# Graphs the functional entry points' cache keeps, the ones used last: a
# sweep on a map stack uses four (the wander's and the filter's, each of
# TICKS_PER_GRAPH ticks and of the remainder), so two such sweeps fit.
GRAPHS_KEPT = 8

# The kernel wrappers' launch counters, and the C entries' device launch
# counters, that a capture takes back out and a replay adds.
KERNEL_WRAPPERS = (
    weights.beam_weights_cuda, weights.beam_weights_batched_cuda,
    weights.beam_weights_stack_cuda, weights.beamsub_cuda,
    expand.systematic_expand_cuda, expand.systematic_expand_batched_cuda,
    kmeans.kmeans_cuda, kmeans.kmeans_batched_cuda,
    refine.refine_grad_cuda, refine.refine_score_cuda,
    ism.ism_update_cuda)
DEVICE_COUNTERS = (expand.device_launches, kmeans.device_launches)
# The launches replays added, by wrapper: the part of each `launches`
# counter that ran inside CUDA graphs (a caller resets both together).
replayed = dict.fromkeys((f.__name__ for f in KERNEL_WRAPPERS), 0)


def _counts() -> list:
    # The C counters live in the kernel library: read only once it is
    # loaded (a tick that launches no kernel never builds it).
    loaded = build.loaded()
    return ([f.launches for f in KERNEL_WRAPPERS]
            + [f() if loaded else 0 for f in DEVICE_COUNTERS])


def _add_counts(delta, replay: bool) -> None:
    n = len(KERNEL_WRAPPERS)
    for f, d in zip(KERNEL_WRAPPERS, delta[:n]):
        f.launches += d
        if replay:
            replayed[f.__name__] += d
    for f, d in zip(DEVICE_COUNTERS, delta[n:]):
        f.graph_launches += d


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, torch.Generator))


def tree_map(fn, tree, *rest):
    """`tree` rebuilt with fn(leaf, *matching leaves of `rest`) at every
    tensor and generator; dataclasses, tuples, lists and dicts are walked,
    anything else (None, numbers) is kept."""
    if _is_leaf(tree):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name),
                             *(getattr(r, f.name) for r in rest))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *vs)
                          for v, *vs in zip(tree, *rest))
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return tree


def leaves(tree) -> list:
    out = []
    tree_map(lambda v: out.append(v), tree)
    return out


def signature(tree) -> Hashable:
    """The structure of `tree` with each tensor's shape, dtype and device
    and each generator's device: what a graph's buffers are built from."""
    if isinstance(tree, torch.Tensor):
        return ("T", tuple(tree.shape), tree.dtype, tree.device)
    if isinstance(tree, torch.Generator):
        return ("G", tree.device)
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return (type(tree).__name__,) + tuple(
            signature(getattr(tree, f.name))
            for f in dataclasses.fields(tree))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,) + tuple(signature(v) for v in tree)
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, signature(v))
                                 for k, v in sorted(tree.items()))
    return ("V", tree)


def _buffer(v, device):
    """A static buffer holding v: a contiguous copy on `device` (an input
    may come from host memory), or a generator of v's device in v's
    state."""
    if isinstance(v, torch.Generator):
        gen = torch.Generator(device=v.device)
        gen.set_state(v.get_state())
        return gen
    return torch.empty(v.shape, dtype=v.dtype, device=device).copy_(v)


def _copy_in(dst, src):
    if isinstance(dst, torch.Generator):
        dst.set_state(src.get_state())
    elif dst is not src:
        # From pinned host memory (a HostFrames buffer) the copy is queued
        # and the host goes on; from pageable memory CUDA waits for the
        # stream first.
        dst.copy_(src, non_blocking=True)
    return dst


def _copy_out(own, caller):
    """The state a call returns: the graph's tensors, and the caller's
    generator, advanced as the graph's was."""
    if isinstance(own, torch.Generator):
        caller.set_state(own.get_state())
        return caller
    return own


def _keep(buf, new):
    """The captured region's last ops: the new state into the buffers."""
    if isinstance(buf, torch.Tensor) and buf is not new:
        buf.copy_(new)
    return buf


def _tick_length(xs, lead: int) -> int:
    lengths = {v.shape[lead] for v in leaves(xs)}
    if len(lengths) != 1:
        raise ValueError(f"the input slab's tick axis {lead} has lengths "
                         f"{sorted(lengths)}: one K for every input")
    return lengths.pop()


def _by_identity(v) -> bool:
    """Whether a static argument is keyed by identity: it holds a tensor."""
    if isinstance(v, torch.Tensor):
        return True
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return any(_by_identity(getattr(v, f.name))
                   for f in dataclasses.fields(v))
    if isinstance(v, (tuple, list)):
        return any(map(_by_identity, v))
    if isinstance(v, dict):
        return any(map(_by_identity, v.values()))
    return False


class TickGraph:
    """K ticks of `step(carry, x, consts, **static) -> (carry, y)` in one
    CUDA graph (module docstring); eager calls of the same ticks on the
    CPU.

    `carry` is the state (tensors and generators), `xs` the input slab
    (every tensor [lead dims..., K, ...]), `consts` what every tick reads
    as it is; their values are only the buffers' first contents.  `static`
    holds the tick's other arguments as they are, those that hold tensors
    weakly (module docstring).  `y`'s tensors have the lead dims first,
    and the output slab inserts the tick axis after them."""

    def __init__(self, step: Callable, carry, xs, consts=None,
                 lead: int = 0, static: Optional[dict] = None):
        self.step = step
        self._static = {k: weakref.ref(v) if _by_identity(v) else v
                        for k, v in (static or {}).items()}
        self.lead = lead
        self.k = _tick_length(xs, lead)
        # The state's device: inputs from host memory get buffers there.
        self.device = leaves(carry)[0].device
        self.cuda = self.device.type == "cuda"

        def buffer(v):
            return _buffer(v, self.device)

        self._carry = tree_map(buffer, carry)
        self._xs = tree_map(buffer, xs)
        self._consts = tree_map(buffer, consts)
        self._graph = None
        self._delta = None
        self.capture_s = self.instantiate_s = 0.0
        self.pool_bytes = 0
        self.replays = 0
        y = self._warm_up()
        k = self.k
        self._ys = tree_map(lambda t: torch.empty(
            t.shape[:lead] + (k,) + t.shape[lead:], dtype=t.dtype,
            device=t.device), y)
        if self.cuda:
            self._capture()
        profiling.count("graph.builds")

    def _tick_inputs(self, k: int):
        return tree_map(lambda t: t.select(self.lead, k), self._xs)

    def _tick(self, carry, x):
        static = {k: v() if isinstance(v, weakref.ref) else v
                  for k, v in self._static.items()}
        return self.step(carry, x, self._consts, **static)

    def _warm_up(self):
        """One eager tick on the buffers, its result thrown away (the
        generators' advance too: every call sets them anew).  On CUDA on
        a side stream, as torch's graph documentation asks."""
        if not self.cuda:
            return self._tick(self._carry, self._tick_inputs(0))[1]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            y = self._tick(self._carry, self._tick_inputs(0))[1]
        torch.cuda.current_stream(self.device).wait_stream(side)
        return y

    def _body(self) -> None:
        """The K ticks on the buffers, between the marks `begin` and `end`
        (utils/profiling.mark): what a replay runs."""
        profiling.mark("begin", self.device)
        c = self._carry
        for k in range(self.k):
            c, y = self._tick(c, self._tick_inputs(k))
            tree_map(lambda d, s, k=k: d.select(self.lead, k).copy_(s),
                     self._ys, y)
        tree_map(_keep, self._carry, c)
        profiling.mark("end", self.device)

    def _capture(self) -> None:
        dev = self.device
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        for gen in leaves(self._carry):
            if isinstance(gen, torch.Generator):
                graph.register_generator_state(gen)
        torch.cuda.synchronize(dev)
        before = _counts()
        with torch.cuda.graph(graph):
            # Inside: the context has emptied the allocator's cache, and
            # what the capture reserves is the graph's private pool.
            reserved = torch.cuda.memory_reserved(dev)
            t0 = time.perf_counter()
            self._body()
            self.capture_s = time.perf_counter() - t0
            self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        t0 = time.perf_counter()
        graph.instantiate()
        self.instantiate_s = time.perf_counter() - t0
        profiling.count("graph.capture_s", self.capture_s)
        profiling.count("graph.instantiate_s", self.instantiate_s)
        self._delta = [a - b for a, b in zip(_counts(), before)]
        _add_counts([-d for d in self._delta], replay=False)
        self._graph = graph

    def __call__(self, carry, xs, consts=None):
        """K ticks from `carry` on the inputs `xs` -> (state, output
        slab), both the graph's buffers (module docstring)."""
        with profiling.span("graph.copy_in"):
            tree_map(_copy_in, self._carry, carry)
            tree_map(_copy_in, self._xs, xs)
            tree_map(_copy_in, self._consts, consts)
        with profiling.span("graph.replay"):
            if self._graph is None:
                self._body()
            else:
                self._graph.replay()
                _add_counts(self._delta, replay=True)
        self.replays += 1
        return tree_map(_copy_out, self._carry, carry), self._ys


class GraphCache:
    """TickGraphs by key (module docstring): `get` builds on a new key and
    returns the entry of a known one.  With a `limit`, the entries used
    least recently go beyond it; every entry goes when an object it holds
    weakly dies.  `stats` counts every graph the cache built, those gone
    too."""

    def __init__(self, limit: Optional[int] = None):
        self.limit = limit
        self._graphs: "collections.OrderedDict[Hashable, tuple]" = \
            collections.OrderedDict()
        self.builds = 0
        self.hits = 0
        # The capture, instantiation and replays of the entries gone.
        self._gone = dict(capture_s=0.0, instantiate_s=0.0, replays=0)

    def get(self, key: Hashable, build_graph: Callable[[], TickGraph],
            held=()) -> TickGraph:
        """The entry of `key`, built by build_graph() if there is none
        (span `graph.build`); it is dropped when an object of `held`
        dies."""
        entry = self._graphs.get(key)
        if entry is not None:
            self._graphs.move_to_end(key)
            self.hits += 1
            profiling.count("graph.hits")
            return entry[0]
        with profiling.span("graph.build"):
            graph = build_graph()
        # The finalizers hold the cache weakly: a server's cache dies with
        # the server, whatever outlives it.  None runs at exit.
        ref = weakref.ref(self)
        finalizers = [weakref.finalize(v, _drop, ref, key) for v in held]
        for f in finalizers:
            f.atexit = False
        self._graphs[key] = (graph, finalizers)
        self.builds += 1
        while self.limit is not None and len(self._graphs) > self.limit:
            self._pop(next(iter(self._graphs)))
        return graph

    def _pop(self, key: Hashable) -> None:
        graph, finalizers = self._graphs.pop(key)
        for f in finalizers:
            f.detach()
        for k in self._gone:
            self._gone[k] += getattr(graph, k)

    def __len__(self) -> int:
        return len(self._graphs)

    def entries(self):
        """The graphs, the one used last at the end."""
        return [g for g, _ in self._graphs.values()]

    def clear(self) -> None:
        """Drop every graph, and with it its buffers and memory pool."""
        for key in list(self._graphs):
            self._pop(key)

    def stats(self) -> dict:
        """The live entries and their pools' bytes; the builds, hits,
        capture and instantiation seconds and replays of every graph the
        cache built."""
        gs = self.entries()
        return dict(entries=len(gs), builds=self.builds, hits=self.hits,
                    **{k: v + sum(getattr(g, k) for g in gs)
                       for k, v in self._gone.items()},
                    pool_bytes=sum(g.pool_bytes for g in gs))


def _drop(ref, key) -> None:
    """A weakly held object of the entry `key` died: drop the entry."""
    cache = ref()
    if cache is not None and key in cache._graphs:
        cache._pop(key)


# The functional entry points' cache (models/filter, sim/robot, bench).
graphs = GraphCache(limit=GRAPHS_KEPT)


class HostFrames:
    """Host buffers for the frames a server copies into its graph's input
    slab: pinned on a CUDA device, so that the copy is queued without the
    host waiting for the tick in flight.  Two buffers take turns (the
    pipelined fleet fills one while the other's tick runs); a buffer is
    refilled only once the copy that last read it has run."""

    def __init__(self, shape, device: torch.device):
        self._pinned = torch.device(device).type == "cuda"
        self._bufs = [torch.zeros(shape, dtype=torch.float32,
                                  pin_memory=self._pinned)
                      for _ in range(2)]
        self._read = [None, None]
        self._next = 0

    def take(self) -> torch.Tensor:
        """The next buffer, free to fill."""
        if self._read[self._next] is not None:
            self._read[self._next].synchronize()
        return self._bufs[self._next]

    def sent(self) -> None:
        """The buffer from take() is queued to the device (on the current
        stream): mark it and turn to the next."""
        if self._pinned:
            self._read[self._next] = torch.cuda.Event()
            self._read[self._next].record()
        self._next = (self._next + 1) % len(self._bufs)


def run_chunked(run: Callable, total: int, lead: int):
    """Drive `run(t0, n) -> (ys slab)` over an episode's graphs
    (TICKS_PER_GRAPH ticks each, the remainder last) and stack the outputs
    along axis `lead` into fresh [..., total, ...] tensors.  Each graph's
    slab is copied out before the next call may reuse it."""
    out = None
    for t0 in range(0, total, TICKS_PER_GRAPH):
        n = min(TICKS_PER_GRAPH, total - t0)
        ys = run(t0, n)
        with profiling.span("episode.copy_out"):
            if out is None:
                out = tree_map(lambda t: torch.empty(
                    t.shape[:lead] + (total,) + t.shape[lead + 1:],
                    dtype=t.dtype, device=t.device), ys)
            tree_map(lambda d, s: d.narrow(lead, t0, n).copy_(s), out, ys)
    return out


def detach_state(state):
    """A state whose tensors are copies of the graph's buffers (the
    generators stay the caller's), safe to keep past the next call."""
    return tree_map(lambda v: v if isinstance(v, torch.Generator)
                    else v.clone(), state)


def stack_ticks(ticks, lead: int):
    """A list of per-tick trees (TickDraws, ...) -> one tree with the tick
    axis at `lead`."""
    return tree_map(lambda t, *rest: torch.stack((t,) + tuple(rest),
                                                 dim=lead),
                    ticks[0], *ticks[1:])


def cached(cache: Optional[GraphCache], step: Callable, carry, xs, consts,
           lead: int, **static) -> TickGraph:
    """The graph of `cache` (None: `graphs`) that runs step(carry, x,
    consts, **static), built on a new key: the tick function, `static`
    (module docstring) and the signature of what the tick reads."""
    cache = graphs if cache is None else cache
    with profiling.span("graph.lookup"):
        key = (step, lead, tuple(
            (k, ("id", id(v)) if _by_identity(v) else v)
            for k, v in sorted(static.items())),
            signature((carry, xs, consts)))
        return cache.get(
            key, lambda: TickGraph(step, carry, xs, consts, lead, static),
            held=[v for v in static.values() if _by_identity(v)])
