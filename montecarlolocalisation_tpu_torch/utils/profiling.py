"""Profiling and stage timing.

Torch counterpart of montecarlolocalisation_tpu/utils/profiling.py.  The
reference times its hot loops with chrono spans logged to ROS_INFO
(computeWeight, resample, k-means, the tick: monte_carlo.cpp:625, 678,
556, 943, 1093) and records none of them.  Here:

  * time_fn: mean wall seconds a call after a warm-up, the card
    synchronized around the timed calls;
  * trace: a context manager over torch.profiler that writes a Chrome
    trace of the host and the card into a directory;
  * stage_knockout_times: the stage marginals of the filter tick, by
    replacing one stage at a time with a trivial dependent stand-in,
    every variant its own CUDA graph (the JAX package's jax.jit per skip
    set);
  * stage_times: subtractive prefixes, kept with the JAX package's caveat.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Callable, Dict

import torch

STAGES = ("motion", "weights", "resample", "cluster")


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


@contextlib.contextmanager
def trace(logdir: str):
    """torch.profiler around the block, the host's activity and, on a
    card, its kernels; writes `logdir`/trace.json (Chrome trace format,
    viewable in Perfetto or chrome://tracing) when the block ends.
    Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        _sync()
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


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


def _prefix_tick(carry, x, consts, m, cfg, stop):
    """The tick's stages up to `stop` on the state, the state kept:
    returns (state, the last stage's output)."""
    from ..models import cluster, filter as mcl, motion, resample, sensor

    st, enc, scan = carry, x["enc"], consts["scan"]
    n = st.particles.shape[-2]
    draws = mcl.draw_tick(st.gen, m, n, cfg, st.batch)
    _, parts = motion.motion_update(st.particles, st.odom, enc, enc,
                                    cfg.motion, draws.motion_normals)
    if stop == "motion":
        return st, parts
    w = sensor.beam_weights(m, parts, scan, cfg.sensor, cfg.valid_pos_offset)
    if stop == "weights":
        return st, w
    p2, w2, _, _ = resample.resample(parts, w, st.inj, st.was_lost, m, cfg,
                                     draws.resample)
    if stop == "resample":
        return st, p2
    conf, _ = cluster.cluster_confidence(
        p2, w2, st.confident_threshold, cfg.cluster, draws.kmeans_init,
        draws.kmeans_reseed)
    return st, conf


def _full_tick(carry, x, consts, m, cfg):
    from ..models import filter as mcl

    enc = x["enc"]
    st, _ = mcl.mcl_step(carry, enc, enc, consts["scan"], m, cfg)
    return st, st.particles


def stage_times(m, cfg, scan, state, iters: int = 10) -> Dict[str, float]:
    """Per-stage breakdown of one tick in seconds (motion, weights,
    resample, cluster, full) by subtraction of cumulative prefixes, each
    its own one-tick graph replayed from the same state.  CAVEAT, as in
    the JAX package: each prefix pays its own dispatch and loses the
    stages after it, so small stages come out overstated; prefer
    stage_knockout_times for attribution."""
    t = {}
    for stop in STAGES:
        graph, xs, consts = _graph(_prefix_tick, state, m, cfg, scan,
                                   stop=stop)
        t[stop] = time_fn(graph, state, xs, consts, iters=iters)
    graph, xs, consts = _graph(_full_tick, state, m, cfg, scan)
    t_full = time_fn(graph, state, xs, consts, iters=iters)
    return dict(motion=t["motion"],
                weights=t["weights"] - t["motion"],
                resample=t["resample"] - t["weights"],
                cluster=t["cluster"] - t["resample"],
                full=t_full)
