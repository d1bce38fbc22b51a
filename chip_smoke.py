#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the port's hand-written kernels from montecarlolocalisation_tpu_torch/
csrc, holds each against its plain PyTorch version on the card, then drives
the filter through the entry points a user calls: the JSONL server
(MCLServer) at 1,048,576 particles x 34 beams with the closed-form caster
and systematic resampling, and run_episode at 65,536 x 12 with the fixed
march and multinomial resampling.  Every phase prints one line; any failure
raises, so the exit code is non-zero and no result line appears.  It needs
one CUDA card and fails without one.

Output, in order: the card (nvidia-smi name and power limit), the build,
the kernel checks, the serve phase, the entry config, the kernel-vs-plain
tick, the kernel times, a {"kernels": [...]} line, and last
{"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import dataclasses
import json
import math
import sys
import time

import numpy as np
import torch

from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.bench import card
from montecarlolocalisation_tpu_torch.config import (
    WALL_LEFT, WALL_TOP, SensorModelConfig,
)
from montecarlolocalisation_tpu_torch.io.server import MCLServer
from montecarlolocalisation_tpu_torch.maps import from_walls
from montecarlolocalisation_tpu_torch.models import filter as mcl
from montecarlolocalisation_tpu_torch.models import motion, sensor
from montecarlolocalisation_tpu_torch.ops import build, expand, kmeans
from montecarlolocalisation_tpu_torch.ops import weights

SERVE_N, SERVE_B, SERVE_TICKS = 1_048_576, 34, 20
ENTRY_N, ENTRY_B, ENTRY_TICKS = 65_536, 12, 50
START = (1.25, 1.25, 0.0)     # the bench's pose, a free spot of the maze
WHEELS = (0.5, 0.45)          # encoder step per tick (rad): a gentle arc
PKG = "montecarlolocalisation_tpu_torch"
KERNELS = {
    "beam_weights": dict(
        fn=weights.beam_weights_cuda, source=f"{PKG}/csrc/weights.cu",
        replaces="montecarlolocalisation_tpu/ops/weights_pallas.py:277"),
    "systematic_expand": dict(
        fn=expand.systematic_expand_cuda, source=f"{PKG}/csrc/expand.cu",
        replaces="montecarlolocalisation_tpu/ops/expand_pallas.py:220"),
    "kmeans": dict(
        fn=kmeans.kmeans_cuda, source=f"{PKG}/csrc/kmeans.cu",
        replaces="montecarlolocalisation_tpu/ops/kmeans_pallas.py:133"),
}


def say(phase: str, **fields) -> None:
    print(json.dumps(dict(phase=phase, **fields)), flush=True)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0


def counts() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


def drive(n_ticks: int):
    """Encoder readings [T, 2] and true poses [T, 3] of a short drive from
    START; the truth follows the encoders through diff_drive_update."""
    cfg = presets.make_world().cfg.motion
    f32 = torch.float32
    odom = motion.OdometryState(
        x=torch.tensor(START[0], dtype=f32), y=torch.tensor(START[1], dtype=f32),
        theta=torch.tensor(START[2], dtype=f32),
        encoder_left=torch.tensor(0.0), encoder_right=torch.tensor(0.0))
    enc, truth = [], []
    for t in range(1, n_ticks + 1):
        e = (WHEELS[0] * t, WHEELS[1] * t)
        odom = motion.diff_drive_update(odom, e[0], e[1], cfg)[0]
        enc.append(e)
        truth.append([float(odom.x), float(odom.y), float(odom.theta)])
    return np.float32(enc), np.float32(truth)


def scans(m, truth, angles, cfg: SensorModelConfig, seed: int):
    """Noisy scans [T, B] from the true poses (port's simulate_scan)."""
    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    return torch.stack([sensor.simulate_scan(m, p, angles, cfg, gen=gen,
                                             noise_sigma=0.02).ranges
                        for p in truth])


def cuda_ms(fn, reps: int = 10) -> float:
    """Median over `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# -- phase 3: each kernel against its plain version ------------------------

def k1_inputs(m, n, nb, cfg, gen):
    from montecarlolocalisation_tpu_torch.models import resample

    parts = resample.sample_uniform_particles(gen, m, n)
    angles = np.deg2rad(np.linspace(-118.0, 118.0, nb)).astype(np.float32)
    scan = sensor.simulate_scan(m, START, angles, cfg)
    # Two dead lanes: the mask must scale the terms away.
    mask = torch.ones(nb, dtype=torch.bool, device=m.device)
    mask[[1, nb // 2]] = False
    return parts, sensor.Scan(angles=scan.angles, ranges=scan.ranges,
                              mask=mask)


def big_maze(dev):
    """A random 30 x 30-cell maze.  Its 241 x 241 px raster is past the
    32 KB that the beam weight kernel keeps in shared memory, so the kernel
    reads it from device memory."""
    rng = np.random.default_rng(7)
    walls = [[[w for w in (WALL_TOP, WALL_LEFT) if rng.random() < 0.4]
              for _ in range(30)] for _ in range(30)]
    return from_walls(walls, device=dev)


def check_k1(m, gen) -> dict:
    """Sum rtol 1e-5; log (raw log-sums) rtol 1e-4; analytic > 99.9 %
    close, since a pixel-boundary tie moves a beam's whole Gaussian (the
    tolerances the JAX suite holds its kernel to)."""
    cases = [(m, n, nb, mode, comb)
             for n in (1000, 65_536, 1_048_576) for nb in (12, 34)
             for mode in ("fixed", "analytic") for comb in ("sum", "log")]
    big = big_maze(m.device)
    cases += [(big, 65_536, 34, mode, "sum") for mode in ("fixed", "analytic")]
    worst = 0.0
    for maze, n, nb, mode, comb in cases:
        cfg = SensorModelConfig(ray_mode=mode, beam_combine=comb)
        parts, scan = k1_inputs(maze, n, nb, cfg, gen)
        got = weights.beam_weights_cuda(maze, parts, scan, cfg)
        want = weights.beam_weights_plain(maze, parts, scan, cfg)
        torch.cuda.synchronize()
        rtol = 1e-4 if comb == "log" else 1e-5
        close = torch.isclose(got, want, rtol=rtol, atol=1e-6)
        share = close.float().mean().item()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        say("check", kernel="beam_weights", raster=list(maze.occ.shape),
            n=n, beams=nb, ray_mode=mode, combine=comb, max_abs_err=err,
            share_close=share)
        need = 0.999 if mode == "analytic" else 1.0
        if not (share >= need and torch.isfinite(got).all()):
            raise AssertionError(f"K1 {mode}/{comb} n={n} b={nb} raster "
                                 f"{tuple(maze.occ.shape)}: {share} close")
    return dict(max_abs_err=worst)


def skewed_cdf(n, gen, dev):
    w = torch.rand(n, generator=gen, device=dev) ** 8     # heavy skew
    w[torch.rand(n, generator=gen, device=dev) < 0.5] = 0.0
    total = w.sum()
    w = torch.where(total > 0, w / total, 1.0 / n)
    return torch.cumsum(w, 0)


def check_k2(dev, gen) -> dict:
    """Bit-exact: the expansion only copies rows."""
    for n in (1, 1000, 65_536, 1_048_576, 4_194_304):
        parts = torch.randn((n, 3), generator=gen, device=dev)
        counts_ = expand.offspring_counts(
            skewed_cdf(n, gen, dev), torch.rand((), generator=gen,
                                                device=dev))
        got = expand.systematic_expand_cuda(parts, counts_)
        want = expand.systematic_expand_plain(parts, counts_)
        torch.cuda.synchronize()
        equal = torch.equal(got, want)
        say("check", kernel="systematic_expand", n=n, bit_exact=equal,
            max_abs_err=(got - want).abs().max().item(),
            share_close=(got == want).all(1).float().mean().item())
        if not equal:
            raise AssertionError(f"K2 n={n}: not bit-exact")
    return dict(max_abs_err=0.0)


def blobs(n, gen, dev):
    """Three Gaussian blobs in the maze (a multimodal particle cloud)."""
    centers = torch.tensor([[1.2, 1.2], [3.6, 2.0], [2.0, 4.0]], device=dev)
    pick = torch.randint(0, 3, (n,), generator=gen, device=dev)
    return centers[pick] + 0.3 * torch.randn((n, 2), generator=gen,
                                             device=dev)


def check_k3(dev, gen) -> dict:
    """Centers within 1e-4; > 99.9 % of assignments equal (float sums in
    another order can move a point that sits on a boundary)."""
    worst = 0.0
    for n in (1000, 65_536, 1_048_576):
        xy = blobs(n, gen, dev)
        c0 = xy[torch.randint(0, n, (3,), generator=gen, device=dev)]
        rs = xy[torch.randint(0, n, (20, 3), generator=gen, device=dev)]
        c1, a1 = kmeans.kmeans_cuda(xy, c0, rs)
        c2, a2 = kmeans.kmeans_plain(xy, c0, rs)
        torch.cuda.synchronize()
        err = (c1 - c2).abs().max().item()
        share = (a1 == a2).float().mean().item()
        worst = max(worst, err)
        say("check", kernel="kmeans", n=n, max_abs_err=err,
            share_close=share)
        if not (err <= 1e-4 and share > 0.999):
            raise AssertionError(f"K3 n={n}: centers {err}, assign {share}")
    # An empty cluster takes its reseed candidate: a center far from every
    # point owns nothing in the first iteration.
    xy = blobs(4096, gen, dev)
    c0 = torch.tensor([[1.2, 1.2], [3.6, 2.0], [90.0, 90.0]], device=dev)
    rs = xy[torch.randint(0, 4096, (20, 3), generator=gen, device=dev)]
    c1, _ = kmeans.kmeans_cuda(xy, c0, rs)
    c2, _ = kmeans.kmeans_plain(xy, c0, rs)
    reseeded = c1[2, 0].item() < 50.0
    if (c1 - c2).abs().max().item() > 1e-4 or not reseeded:
        raise AssertionError("K3 empty-cluster reseed differs")
    return dict(max_abs_err=worst)


# -- phase 4: the server at full size --------------------------------------

class Replies:
    """A text stream that keeps each reply line and the time it arrived."""

    def __init__(self):
        self.lines, self.times, self._buf = [], [], ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append(line)
            self.times.append(time.perf_counter())
        return len(s)

    def flush(self) -> None:
        pass


def serve_phase(dev):
    world = presets.make_world(num_particles=SERVE_N, num_beams=SERVE_B,
                               ray_mode="analytic",
                               resample_method="systematic", device=dev)
    enc, truth = drive(SERVE_TICKS)
    ranges = scans(world.maze, truth, world.angles, world.cfg.sensor,
                   seed=1).cpu().numpy()
    lines = [json.dumps(dict(encoder_left=float(e[0]),
                             encoder_right=float(e[1]),
                             ranges=[float(r) for r in z]))
             for e, z in zip(enc, ranges)]
    lines += [json.dumps(dict(cmd="stats")), json.dumps(dict(cmd="shutdown"))]
    out = Replies()
    torch.cuda.synchronize()
    reset_counts()
    server = MCLServer(world.maze, world.cfg, world.angles, seed=0)
    t0 = time.perf_counter()
    ticks = server.serve(lines, out_stream=out)
    torch.cuda.synchronize()
    launched = counts()
    replies = [json.loads(s) for s in out.lines]
    errors = [r for r in replies if "error" in r]
    tick_replies = [r for r in replies if "exact_pose" in r]
    if errors or ticks != SERVE_TICKS or len(tick_replies) != SERVE_TICKS:
        raise AssertionError(f"serve: ticks={ticks}, errors={errors[:3]}")
    for r in tick_replies:
        if not all(math.isfinite(v) for v in r["exact_pose"]
                   + [r["confidence"]]):
            raise AssertionError(f"serve: non-finite reply {r}")
    if replies[-2].get("tick") != SERVE_TICKS or replies[-1] != {"ok": True}:
        raise AssertionError(f"serve: stats/shutdown replies {replies[-2:]}")
    short = {k: v for k, v in launched.items() if v < SERVE_TICKS}
    if short:
        raise AssertionError(f"serve: kernels launched < {SERVE_TICKS} "
                             f"times: {short}")
    lat = np.diff(np.array([t0] + out.times[:SERVE_TICKS])) * 1e3
    best = np.array(tick_replies[-1]["exact_pose"][:2])
    err_m = (float(np.hypot(*(best - truth[-2, :2])))
             if best[0] >= 0 else None)
    say("serve", particles=SERVE_N, beams=SERVE_B, ray_mode="analytic",
        resample="systematic", ticks=ticks, error_replies=0,
        launches=launched, tick_ms_median=float(np.median(lat)),
        tick_ms_p90=float(np.percentile(lat, 90)),
        tick_ms_first=float(lat[0]),
        updates_per_sec=SERVE_N * SERVE_B / (float(np.median(lat)) / 1e3),
        final_confidence=tick_replies[-1]["confidence"],
        position_error_m=err_m)
    return world, server, launched


# -- phase 5: the entry config ---------------------------------------------

def entry_phase(dev):
    world = presets.make_world(num_particles=ENTRY_N, num_beams=ENTRY_B,
                               ray_mode="fixed",
                               resample_method="multinomial", device=dev)
    m = world.maze
    enc, truth = drive(ENTRY_TICKS)
    ranges = scans(m, truth, world.angles, world.cfg.sensor, seed=2)
    state = mcl.init_state(m, world.cfg, seed=3)
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, outs = mcl.run_episode(state, enc, ranges, world.angles, m,
                                  world.cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rose = {k: v - before[k] for k, v in counts().items()}
    if rose["beam_weights"] < ENTRY_TICKS or rose["kmeans"] < ENTRY_TICKS:
        raise AssertionError(f"entry: kernel launches {rose}")
    if not (torch.isfinite(final.particles).all()
            and outs.confidence.shape == (ENTRY_TICKS,)):
        raise AssertionError("entry: non-finite state or bad output shape")
    say("entry", particles=ENTRY_N, beams=ENTRY_B, ray_mode="fixed",
        resample="multinomial", ticks=ENTRY_TICKS, launches=rose,
        ticks_per_sec=ENTRY_TICKS / dt,
        updates_per_sec=ENTRY_TICKS * ENTRY_N * ENTRY_B / dt,
        final_confidence=float(outs.confidence[-1]))


# -- phase 6: one tick through the kernels and through the plain versions --

def plain_config(cfg):
    """The same filter with every kernel's plain version: the config values
    under which the JAX package, too, runs XLA instead of its kernels."""
    return dataclasses.replace(
        cfg, sensor=dataclasses.replace(cfg.sensor, lookup_mode="gather"),
        resample=dataclasses.replace(cfg.resample, expand="xla"),
        cluster=dataclasses.replace(cfg.cluster, impl="dense"))


def tick_phase(world, state):
    """Tolerances of the CPU slice test: >= 99.9 % of particle rows within
    atol 1e-5 (a summation ulp can move a rare draw across a CDF
    boundary); confidence and best pose within 1e-3; song, wanderer and
    n_injected equal."""
    m, cfg = world.maze, world.cfg
    gen = torch.Generator(device=m.device)
    gen.manual_seed(4)
    enc, truth = drive(SERVE_TICKS + 1)
    scan = sensor.Scan(
        angles=torch.as_tensor(world.angles, device=m.device),
        ranges=scans(m, truth[-1:], world.angles, cfg.sensor, seed=5)[0],
        mask=torch.ones(SERVE_B, dtype=torch.bool, device=m.device))
    draws = mcl.draw_tick(gen, m, SERVE_N, cfg)
    el, er = float(enc[-1, 0]), float(enc[-1, 1])
    before = counts()
    k_state, k_out = mcl.mcl_step(state, el, er, scan, m, cfg, draws=draws)
    mid = counts()
    p_state, p_out = mcl.mcl_step(state, el, er, scan, m, plain_config(cfg),
                                  draws=draws)
    torch.cuda.synchronize()
    after = counts()
    again, _ = mcl.mcl_step(state, el, er, scan, m, cfg, draws=draws)
    repeat = (again.particles == k_state.particles).all(1).float().mean()
    if after != mid or any(mid[k] <= before[k] for k in mid):
        raise AssertionError(f"tick: launches {before} -> {mid} -> {after}")
    rows = ((k_state.particles - p_state.particles).abs() <= 1e-5).all(1)
    share = rows.float().mean().item()
    conf_err = abs(float(k_out.confidence) - float(p_out.confidence))
    pose_err = (k_state.best_pose - p_state.best_pose).abs().max().item()
    same = all(int(getattr(k_out, f)) == int(getattr(p_out, f))
               for f in ("song", "wanderer_cmd", "n_injected"))
    say("tick_vs_plain", particles=SERVE_N, beams=SERVE_B,
        rows_close_share=share, repeat_rows_equal_share=repeat.item(),
        confidence_err=conf_err,
        best_pose_err=pose_err, discrete_outputs_equal=same)
    if not (share >= 0.999 and conf_err <= 1e-3 and pose_err <= 1e-3
            and same):
        raise AssertionError("tick: kernel and plain ticks disagree")


# -- phase 7: times at the main path's shapes ------------------------------

def time_phase(world, state, gen) -> dict:
    m, cfg = world.maze, world.cfg
    dev = m.device
    parts = state.particles
    scan = sensor.Scan(
        angles=torch.as_tensor(world.angles, device=dev),
        ranges=sensor.simulate_scan(m, START, world.angles,
                                    cfg.sensor).ranges,
        mask=torch.ones(SERVE_B, dtype=torch.bool, device=dev))
    counts_ = expand.offspring_counts(
        skewed_cdf(SERVE_N, gen, dev), torch.rand((), generator=gen,
                                                  device=dev))
    xy = parts[:, :2].contiguous()
    c0 = xy[torch.randint(0, SERVE_N, (3,), generator=gen, device=dev)]
    rs = xy[torch.randint(0, SERVE_N, (20, 3), generator=gen, device=dev)]
    pairs = {
        "beam_weights": (
            lambda: weights.beam_weights_cuda(m, parts, scan, cfg.sensor),
            lambda: weights.beam_weights_plain(m, parts, scan, cfg.sensor)),
        "systematic_expand": (
            lambda: expand.systematic_expand_cuda(parts, counts_),
            lambda: expand.systematic_expand_plain(parts, counts_)),
        "kmeans": (lambda: kmeans.kmeans_cuda(xy, c0, rs),
                   lambda: kmeans.kmeans_plain(xy, c0, rs)),
    }
    times = {}
    for name, (kernel, plain) in pairs.items():
        # plain, kernel, kernel, plain: the two sides share the card's state
        p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel),
                          cuda_ms(plain))
        times[name] = dict(ms=float(np.median([k1, k2])),
                           plain_ms=float(np.median([p1, p2])))
        say("time", kernel=name, particles=SERVE_N, beams=SERVE_B,
            ms=[k1, k2], plain_ms=[p1, p2])
    tick_cfg = (cfg, plain_config(cfg))
    tick_ms = [cuda_ms(lambda c=c: mcl.mcl_step(state, 0.1, 0.1, scan, m, c))
               for c in tick_cfg]
    say("time", what="mcl_step", particles=SERVE_N, beams=SERVE_B,
        kernels_ms=tick_ms[0], plain_ms=tick_ms[1])
    return times


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    print(card(), flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    build.library()
    say("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=build.build_seconds)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m = presets.make_world(device=dev).maze
    errs = dict(beam_weights=check_k1(m, gen), systematic_expand=check_k2(
        dev, gen), kmeans=check_k3(dev, gen))

    world, server, launched = serve_phase(dev)
    entry_phase(dev)
    tick_phase(world, server.state)
    times = time_phase(world, server.state, gen)

    if "jax" in sys.modules:
        raise AssertionError("the port imported jax")
    print(json.dumps(dict(kernels=[
        dict(name=name, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=launched[name],
             max_abs_err=errs[name]["max_abs_err"], ms=times[name]["ms"],
             plain_ms=times[name]["plain_ms"])
        for name, k in KERNELS.items()])), flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=kind, count=torch.cuda.device_count()))),
        flush=True)


if __name__ == "__main__":
    main()
