"""The reference filter tick in plain torch: the semantics the benchmark
holds the program to.

One 10 Hz tick of the reference node (monte_carlo.cpp
executeParticleFilter) on a batch of independent filters (particles
[E, N, 3], every per-filter scalar [E]):

  1. hysteresis on the previous confidence: songs, wanderer commands
     (start on a fall into lost; stop on a recovery, or on a confident
     tick after a confident one whose best pose lies in free space; else
     none) and the thresholds;
  2. the previous best pose is published, with its cell;
  3. odometry from the encoders, one noisy (rot1, trans, rot2) a filter,
     every particle moved by it, then, where refine.iters > 0, the
     gradient refinement (reference/refine.py);
  4. beam weights: a ray per beam from 0.1 m ahead of the particle along
     the negated beam angle, a truncated Gaussian on |observed -
     expected| plus the max-range term, summed beam after beam, zero off
     free space;
  5. resampling, multinomial (one uniform a slot indexes the weight CDF
     and decides injection) or systematic ((k + u0) / N against the CDF,
     separate injection uniforms), with the dual-rate averages' injection
     of fresh uniform particles, capped first come, and the regime's
     jitter; where resample.ess_threshold is set, the ESS gate
     (`ess_gate`) decides by filter whether the pass's result or the
     carried importance weights are kept;
  6. k-means (K = 3, at most 20 Lloyd iterations, early exit, empty
     clusters reseeded) on the resampled cloud: the heaviest cluster's
     mean and circular mean heading, and the share of particles within
     0.4 m of it (under the ESS gate, importance-weighted).

Random numbers: a tick draws, from one torch.Generator and in this order,
the motion normals, the resampling uniforms, the jitter, the fresh
particles and the k-means indices (`draw_tick`), whether or not the ESS
gate fires; refinement draws nothing; the initial cloud is
drawn from the same generator seeded with the filter's seed (`init`).
That is the seeded stream the program's filter states carry, so the
reference replays a program's filter from its seed, or from a copy of
its state and its generator's state.

Floating point: float32 throughout, with the constant divisions taken as
products with float32 reciprocals and the beams summed one after another,
so that sound float32 arithmetic rounds as the reference does; the weight
CDF is accumulated in float64.  `dtype` runs the particles' move and the
beam weights in another precision (the control: bfloat16).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from . import caster
from .caster import recip
from .maze import Maze

# The hysteresis's wanderer commands (monte_carlo.cpp:243-246).
WANDERER_NOOP, WANDERER_STOP, WANDERER_START = -1, 0, 1


@dataclasses.dataclass
class State:
    """A batch of reference filters: particles [E, N, 3], weights [E, N],
    and the per-filter scalars [E]."""

    particles: torch.Tensor
    weights: torch.Tensor
    odom: torch.Tensor          # [E, 5] x, y, theta, encoder_l, encoder_r
    w_slow: torch.Tensor
    w_fast: torch.Tensor
    confidence: torch.Tensor
    was_lost: torch.Tensor
    cluster_threshold: torch.Tensor
    confident_threshold: torch.Tensor
    best_pose: torch.Tensor     # [E, 3]


@dataclasses.dataclass
class Output:
    """One tick's numbers, [E, ...]: what it publishes (the previous
    best pose and its cell, the confidence, the song), this tick's best
    pose, every k-means center, the confidences and thresholds that
    decide the sentinel (this tick's) and the song (the previous
    tick's), and the wanderer command (WANDERER_*)."""

    exact_pose: torch.Tensor
    cell_pose: torch.Tensor     # int32 row, col, orientation
    confidence: torch.Tensor
    song: torch.Tensor          # int32
    n_injected: torch.Tensor
    pose: torch.Tensor          # [E, 3] this tick's best pose
    centers: torch.Tensor       # [E, K, 2]
    threshold: torch.Tensor
    prev_confidence: torch.Tensor
    prev_threshold: torch.Tensor
    wanderer_cmd: torch.Tensor  # int32


def wrap(angle):
    return torch.atan2(torch.sin(angle), torch.cos(angle))


def uniform_cloud(gen, mz: Maze, shape, init: dict):
    """Uniform particles: a random cell, an offset of +-cell_offset in it,
    a heading in [-pi, pi), plus global_offset on x and y."""
    dev = mz.device
    rows = torch.randint(0, mz.n_rows, shape, generator=gen, device=dev)
    cols = torch.randint(0, mz.n_cols, shape, generator=gen, device=dev)
    cm = mz.cell_meters
    cx = cols.to(torch.float32) * cm + 0.5 * cm
    cy = rows.to(torch.float32) * cm + 0.5 * cm

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    off = init["cell_offset"]
    x = cx + uniform(-off, off)
    y = cy + uniform(-off, off)
    yaw = uniform(-math.pi, math.pi)
    g = init["global_offset"]
    return torch.stack([x + g, y + g, yaw], dim=-1).to(torch.float32)


def init(mz: Maze, cfg: dict, seed: int, episodes: int) -> tuple:
    """(State, generator) of `episodes` filters started from the uniform
    cloud, the generator seeded with `seed`."""
    dev = mz.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    n = cfg["num_particles"]
    e = (episodes,)
    parts = uniform_cloud(gen, mz, e + (n,), cfg["init"])
    h = cfg["hysteresis"]

    def full(v, dtype=torch.float32, shape=e):
        return torch.full(shape, v, dtype=dtype, device=dev)

    st = State(particles=parts, weights=full(cfg["init"]["init_weight"],
                                             shape=e + (n,)),
               odom=full(0.0, shape=e + (5,)), w_slow=full(0.0),
               w_fast=full(0.0), confidence=full(0.0),
               was_lost=full(False, torch.bool),
               cluster_threshold=full(h["init_cluster_threshold"]),
               confident_threshold=full(h["init_confident_threshold"]),
               best_pose=full(-1.0, shape=e + (3,)))
    return st, gen


def draw_tick(gen, mz: Maze, cfg: dict, episodes: int) -> dict:
    """One tick's random numbers, in the stream's order."""
    dev = mz.device
    n = cfg["num_particles"]
    e = (episodes,)

    def rand(*shape):
        return torch.rand(e + shape, generator=gen, device=dev)

    d = dict(normals=torch.randn(e + (3,), generator=gen, device=dev))
    if cfg["resample"]["method"] == "systematic":
        d["u0"] = rand()
        d["inject_r"] = rand(n)
    else:
        d["u"] = rand(n)
    d["jitter"] = 2.0 * rand(3, n) - 1.0
    d["fresh"] = uniform_cloud(gen, mz, e + (n,), cfg["init"])
    k, iters = cfg["cluster"]["k"], cfg["cluster"]["max_iters"]
    d["kmeans_init"] = torch.randint(0, n, e + (k,), generator=gen,
                                     device=dev)
    d["kmeans_reseed"] = torch.randint(0, n, e + (iters, k), generator=gen,
                                       device=dev)
    return d


def valid(mz: Maze, x, y):
    """Inside the map, and no wall within one pixel (the 9-point stencil
    at the reference's 0.1 m offset)."""
    mx, my, _ = caster.to_pixel(mz, x, y)
    free = ~caster.pixel(mz.occ_dilated, mx, my)
    inside = (x >= 0.0) & (x < mz.width * mz.resolution) & (y >= 0.0) & (
        y < mz.height * mz.resolution)
    return inside & free


def motion(st: State, enc_l, enc_r, normals, mc: dict, dtype):
    """Odometry (diff drive, float32) and the noisy move of every particle
    (in `dtype`).  Returns (odometry [E, 5], particles [E, N, 3])."""
    x0, y0, th0, el0, er0 = st.odom.unbind(-1)
    d_left = (enc_l - el0) * mc["wheel_size"] * 0.5
    d_right = (enc_r - er0) * mc["wheel_size"] * 0.5
    d_center = 0.5 * (d_left + d_right)
    d_theta = (d_left - d_right) * recip(mc["wheel_space"])
    x = x0 + d_center * torch.cos(th0 + 0.5 * d_theta)
    y = y0 + d_center * torch.sin(th0 + 0.5 * d_theta)
    th = wrap(th0 + d_theta)
    rot1 = torch.atan2(y - y0, x - x0) - th0
    trans = torch.sqrt((y - y0) ** 2 + (x - x0) ** 2)
    rot2 = th - th0 - rot1
    rot1, trans, rot2 = (v.to(dtype) for v in (rot1, trans, rot2))
    a1, a2, a3, a4 = (mc[f"alpha_{i}"] for i in (1, 2, 3, 4))
    var_r1 = a1 * torch.abs(rot1) + a2 * trans
    var_tr = a3 * trans + a4 * (torch.abs(rot1) + torch.abs(rot2))
    var_r2 = a1 * torch.abs(rot2) + a2 * trans
    n1, n2, n3 = normals.to(dtype).unbind(-1)
    r1 = (rot1 + torch.sqrt(var_r1) * n1)[:, None]
    tr = (trans + torch.sqrt(var_tr) * n2)[:, None]
    r2 = (rot2 + torch.sqrt(var_r2) * n3)[:, None]
    p = st.particles.to(dtype)
    theta = p[..., 2]
    moved = theta + r1
    parts = torch.stack([p[..., 0] + tr * torch.cos(moved),
                         p[..., 1] + tr * torch.sin(moved),
                         theta + r1 + r2], dim=-1)
    return torch.stack([x, y, th, enc_l, enc_r], dim=-1), parts


def gauss(diff, sensor: dict):
    s = sensor["sigma"]
    pdf = (torch.exp(-(diff * diff) * recip(2.0 * s * s))
           * recip(s * math.sqrt(2.0 * math.pi)))
    return torch.where((diff >= 0.0) & (diff <= sensor["gauss_max_diff"]),
                       pdf, 0.0)


def weights(mz: Maze, parts, ranges, mask, angles, sensor: dict,
            block: int = 1 << 22, cast=caster.cast):
    """Beam weights [E, N] of particles [E, N, 3] against ranges and mask
    [E, B] on the beam table angles [B], in blocks of about `block`
    rays; `cast` is the caster (the configured one, or the refinement's
    differentiable one)."""
    e, n = parts.shape[:2]
    nb = angles.shape[0]
    out = torch.empty((e, n), dtype=parts.dtype, device=parts.device)
    rows = max(1, block // (n * nb))
    sign = -1.0 if sensor["negate_beam_angle"] else 1.0
    off = sensor["laser_offset"]
    for e0 in range(0, e, rows):
        p = parts[e0:e0 + rows]
        cols = max(1, block // (p.shape[0] * nb))
        for n0 in range(0, n, cols):
            q = p[:, n0:n0 + cols]
            x, y, th = q[..., 0], q[..., 1], q[..., 2]
            ox = (x + off * torch.cos(th))[..., None]
            oy = (y + off * torch.sin(th))[..., None]
            ray = th[..., None] + sign * angles.to(q.dtype)
            expected = cast(mz, ox, oy, ray, sensor)
            obs = ranges[e0:e0 + rows, None, :].to(q.dtype)
            p_hit = sensor["w_hit"] * gauss(torch.abs(obs - expected),
                                            sensor)
            p_rand = sensor["w_rand"] * (
                torch.abs(obs - sensor["max_range"])
                < sensor["rand_window"]).to(q.dtype)
            terms = (p_hit + p_rand) * mask[e0:e0 + rows, None, :].to(
                q.dtype)
            acc = torch.zeros(terms.shape[:-1], dtype=terms.dtype,
                              device=terms.device)
            for b in range(nb):
                acc = acc + terms[..., b]
            out[e0:e0 + rows, n0:n0 + cols] = torch.where(
                valid(mz, x, y), acc, 0.0)
    return out


def _regime(was_lost, rc: dict) -> dict:
    """The regime's parameters; under the ESS gate the averages' rates
    are clamped to at most 1."""
    def sel(a, b):
        return torch.where(was_lost, float(a), float(b))

    def rate(a):
        return a if rc["ess_threshold"] is None else min(float(a), 1.0)

    return dict(max_injection=sel(rc["lost_max_injection"],
                                  rc["conf_max_injection"]),
                alpha_slow=sel(rate(rc["lost_alpha_slow"]),
                               rate(rc["conf_alpha_slow"])),
                alpha_fast=sel(rate(rc["lost_alpha_fast"]),
                               rate(rc["conf_alpha_fast"])),
                jitter_xy=sel(rc["lost_jitter_xy"], rc["conf_jitter_xy"]),
                jitter_theta=sel(rc["lost_jitter_theta"],
                                 rc["conf_jitter_theta"]))


def resample(st: State, parts, w, was_lost, draws: dict, cfg: dict,
             draw_w=None):
    """The full pass: this tick's likelihood `w` feeds the averages,
    `draw_w` (default `w`) the draw.  Returns (particles, uniform
    weights, w_slow, w_fast, n_injected, p_inject)."""
    rc = cfg["resample"]
    n = parts.shape[-2]
    p = _regime(was_lost, rc)
    total = torch.sum(w, dim=-1)
    w_avg = total * recip(n)
    w_slow = st.w_slow + p["alpha_slow"] * (w_avg - st.w_slow)
    w_fast = st.w_fast + p["alpha_fast"] * (w_avg - st.w_fast)
    p_inject = torch.where(w_slow > 0.0,
                           torch.clamp(1.0 - w_fast / w_slow, min=0.0), 0.0)
    dw = w if draw_w is None else draw_w
    tot = torch.sum(dw, dim=-1, keepdim=True)
    cdf = torch.cumsum(torch.where(tot > 0.0, dw / tot, 1.0 / n).double(),
                       dim=-1).float()
    if rc["method"] == "multinomial":
        inject_r = draws["u"]
        idx = torch.searchsorted(cdf, draws["u"].contiguous(),
                                 side="left").clamp(max=n - 1)
    else:
        inject_r = draws["inject_r"]
        counts = torch.clamp(torch.floor(
            n * cdf - draws["u0"][:, None]).to(torch.int32) + 1, 0, n)
        counts = torch.cummax(counts, dim=-1).values
        k = torch.arange(n, dtype=torch.int32, device=cdf.device)
        key = torch.minimum(k, counts[:, -1:] - 1).contiguous()
        idx = torch.searchsorted(counts, key, right=True).clamp(max=n - 1)
    drawn = torch.take_along_dim(parts, idx[..., None].long(), dim=-2)
    bern = inject_r < p_inject[:, None]
    inject = bern & (torch.cumsum(bern, dim=-1)
                     <= p["max_injection"][:, None])
    jit = draws["jitter"]
    jx = jit[:, 0, :] * p["jitter_xy"][:, None]
    jy = jit[:, 1, :] * p["jitter_xy"][:, None]
    jt = jit[:, 2, :] * p["jitter_theta"][:, None]
    drawn = torch.stack([drawn[..., 0] + jx, drawn[..., 1] + jy,
                         wrap(drawn[..., 2] + jt)], dim=-1)
    new = torch.where(inject[..., None], draws["fresh"], drawn)
    uni = torch.full(parts.shape[:-1], 1.0 / n, dtype=torch.float32,
                     device=parts.device)
    return new, uni, w_slow, w_fast, torch.sum(inject, dim=-1), p_inject


def ess_gate(st: State, parts, w, was_lost, draws: dict, cfg: dict):
    """The ESS-gated pass: the carried weights times this tick's
    likelihood, normalized (uniform where they sum to 0), decide the
    draw; the full pass runs on every filter, and a filter keeps its
    result where its ESS = 1 / sum(w^2) is below ess_threshold * N or the
    averages ask for injection, else its particles and the normalized
    carried weights, with nothing injected.  Returns resample's tuple."""
    n = parts.shape[-2]
    combined = st.weights * w
    total = torch.sum(combined, dim=-1, keepdim=True)
    norm = torch.where(total > 0.0, combined / total, 1.0 / n)
    ess = 1.0 / torch.sum(norm * norm, dim=-1)
    new, uni, w_slow, w_fast, n_inj, p_inject = resample(
        st, parts, w, was_lost, draws, cfg, draw_w=norm)
    fire = (ess < cfg["resample"]["ess_threshold"] * n) | (p_inject > 0.0)
    return (torch.where(fire[:, None, None], new, parts),
            torch.where(fire[:, None], uni, norm), w_slow, w_fast,
            torch.where(fire, n_inj, 0), p_inject)


def kmeans(xy, init_idx, reseed_idx):
    """Lloyd's k-means from the particles at init_idx [E, K], an empty
    cluster taking the particle at reseed_idx [E, I, K] of its iteration;
    the first iteration that changes no assignment ends a filter's run.
    Returns (centers [E, K, 2], assignments [E, N] int32)."""
    e, n = xy.shape[:2]
    k = init_idx.shape[-1]
    centers = torch.take_along_dim(xy, init_idx[..., None], dim=-2)
    reseed = torch.take_along_dim(
        xy, reseed_idx.reshape(e, -1)[..., None], dim=-2).reshape(
            reseed_idx.shape + (2,))
    x, y = xy[..., 0], xy[..., 1]
    assign = torch.zeros((e, n), dtype=torch.int32, device=xy.device)
    done = torch.zeros(e, dtype=torch.bool, device=xy.device)
    for t in range(reseed.shape[1]):
        cx, cy = centers[..., 0:1], centers[..., 1:2]
        new = torch.zeros_like(assign)
        best = (x - cx[:, 0, :]) ** 2 + (y - cy[:, 0, :]) ** 2
        for i in range(1, k):
            di = (x - cx[:, i, :]) ** 2 + (y - cy[:, i, :]) ** 2
            closer = di < best
            new = torch.where(closer, i, new)
            best = torch.where(closer, di, best)
        changed = torch.any(new != assign, dim=-1)
        update = changed & ~done
        means, counts = [], []
        for i in range(k):
            mi = (new == i).to(torch.float32)
            ci = torch.sum(mi, dim=-1)
            counts.append(ci)
            means.append(torch.stack([torch.sum(mi * x, dim=-1),
                                      torch.sum(mi * y, dim=-1)], dim=-1)
                         / torch.clamp(ci, min=1.0)[:, None])
        means = torch.where((torch.stack(counts, dim=-1) > 0)[..., None],
                            torch.stack(means, dim=-2), reseed[:, t])
        centers = torch.where(update[:, None, None], means, centers)
        assign = torch.where(update[:, None], new, assign)
        done = done | ~changed
    return centers, assign


def confidence(parts, w, threshold, draws: dict, cc: dict,
               weighted: bool = False):
    """(confidence [E], best pose [E, 3] or the -1 sentinel, centers
    [E, K, 2]).  The heaviest cluster by the weights `w` is the best.
    Unweighted: the share of particles within near_radius of its k-means
    center, and that center with its members' circular mean heading.
    `weighted` (the ESS gate's carried weights): the share of the weight
    within near_radius of the best cluster's weighted mean, and that mean
    with the weighted circular mean; the centers are then every
    cluster's weighted mean, the best one's the pose's."""
    x, y = parts[..., 0], parts[..., 1]
    centers, assign = kmeans(parts[..., :2], draws["kmeans_init"],
                             draws["kmeans_reseed"])
    k = centers.shape[1]
    cluster_w = torch.stack([torch.sum(torch.where(assign == i, w, 0.0),
                                       dim=-1) for i in range(k)], dim=-1)
    best = torch.argmax(cluster_w, dim=-1)
    th = parts[..., 2]
    r2 = cc["near_radius"] ** 2
    if weighted:
        means = []
        for i in range(k):
            mw = (assign == i).to(torch.float32) * w
            mw_sum = torch.clamp(torch.sum(mw, dim=-1), min=1e-30)
            means.append(torch.stack([torch.sum(mw * x, dim=-1) / mw_sum,
                                      torch.sum(mw * y, dim=-1) / mw_sum],
                                     dim=-1))
        centers = torch.stack(means, dim=-2)
    cx = torch.take_along_dim(centers[..., 0], best[:, None], dim=-1)[:, 0]
    cy = torch.take_along_dim(centers[..., 1], best[:, None], dim=-1)[:, 0]
    member = (assign == best[:, None]).to(torch.float32)
    d2 = (x - cx[:, None]) ** 2 + (y - cy[:, None]) ** 2
    if weighted:
        mw = member * w
        theta = torch.atan2((torch.sin(th) * mw).sum(-1),
                            (torch.cos(th) * mw).sum(-1))
        ratio = torch.sum(torch.where(d2 <= r2, w, 0.0), dim=-1) / (
            torch.clamp(torch.sum(w, dim=-1), min=1e-30))
    else:
        theta = torch.atan2((torch.sin(th) * member).sum(-1),
                            (torch.cos(th) * member).sum(-1))
        ratio = torch.sum((d2 <= r2).to(torch.float32),
                          dim=-1) * recip(parts.shape[1])
    pose = torch.where((ratio > threshold)[:, None],
                       torch.stack([cx, cy, theta], dim=-1), -1.0)
    return ratio, pose, centers


def orientation(theta):
    """The 45-degree bands of the published orientation."""
    two_pi = 2.0 * math.pi
    wrapped = torch.remainder(theta, two_pi)
    deg = torch.where(wrapped < 0, wrapped + two_pi, wrapped) * (
        180.0 / math.pi)
    out = torch.zeros_like(deg, dtype=torch.int32)
    out = torch.where((deg >= 225.0) & (deg < 315.0), 1, out)
    out = torch.where((deg >= 135.0) & (deg < 225.0), 2, out)
    out = torch.where((deg >= 45.0) & (deg < 135.0), 3, out)
    return out.to(torch.int32)


def cell_pose(pose, cell_meters: float):
    """(row, col, orientation) of world poses [E, 3]; (-1, -1, -1) for a
    pose off the map."""
    inv = recip(cell_meters)
    col = torch.floor((pose[:, 0] - 0.5 * cell_meters) * inv + 0.5).to(
        torch.int32)
    row = torch.floor((pose[:, 1] - 0.5 * cell_meters) * inv + 0.5).to(
        torch.int32)
    bad = (pose[:, 0] < 0) | (pose[:, 1] < 0)
    return torch.where(bad[:, None], -1, torch.stack(
        [row, col, orientation(pose[:, 2])], dim=-1)).to(torch.int32)


def tick(st: State, enc, ranges, mask, angles, mz: Maze, cfg: dict,
         draws: dict, dtype=torch.float32):
    """One tick of every filter: encoders [E, 2], ranges and mask [E, B],
    beam table [B]; returns (State, Output)."""
    h = cfg["hysteresis"]
    conf, thr = st.confidence, st.confident_threshold
    lost, ok = conf < thr, conf > thr
    to_lost = lost & ~st.was_lost
    recovered = ok & st.was_lost
    cluster_thr = torch.where(to_lost, h["lost_cluster_threshold"],
                              torch.where(ok, h["conf_cluster_threshold"],
                                          st.cluster_threshold))
    conf_thr = torch.where(to_lost, h["lost_confident_threshold"],
                           torch.where(ok, h["conf_confident_threshold"],
                                       thr))
    was_lost = torch.where(to_lost, True,
                           torch.where(recovered, False, st.was_lost))
    song = torch.where(to_lost, h["song_lost"],
                       torch.where(recovered, h["song_recovered"], 0)).to(
                           torch.int32)
    conf_to_conf = ok & ~st.was_lost & valid(mz, st.best_pose[:, 0],
                                             st.best_pose[:, 1])
    wanderer_cmd = torch.where(
        to_lost, WANDERER_START,
        torch.where(recovered | conf_to_conf, WANDERER_STOP,
                    WANDERER_NOOP)).to(torch.int32)
    exact = st.best_pose
    cell = cell_pose(exact, mz.cell_meters)
    odom, parts = motion(st, enc[:, 0], enc[:, 1], draws["normals"],
                         cfg["motion"], dtype)
    if cfg["refine"]["iters"] > 0:
        from . import refine  # it imports this module's weights

        parts = refine.refine(mz, parts, ranges, mask, angles, cfg)
    w = weights(mz, parts, ranges, mask, angles, cfg["sensor"]).to(
        torch.float32)
    parts = parts.to(torch.float32)
    gated = cfg["resample"]["ess_threshold"] is not None
    step = ess_gate if gated else resample
    parts, new_w, w_slow, w_fast, n_inj, _ = step(st, parts, w, was_lost,
                                                  draws, cfg)
    ratio, pose, centers = confidence(parts, new_w, conf_thr, draws,
                                      cfg["cluster"], weighted=gated)
    new = State(particles=parts, weights=new_w, odom=odom, w_slow=w_slow,
                w_fast=w_fast, confidence=ratio, was_lost=was_lost,
                cluster_threshold=cluster_thr,
                confident_threshold=conf_thr, best_pose=pose)
    return new, Output(exact_pose=exact, cell_pose=cell, confidence=ratio,
                       song=song, n_injected=n_inj, pose=pose,
                       centers=centers, threshold=conf_thr,
                       prev_confidence=conf, prev_threshold=thr,
                       wanderer_cmd=wanderer_cmd)


def run(st: State, gen, encs, ranges, mask, angles, mz: Maze, cfg: dict,
        dtype=torch.float32):
    """Ticks over encoders [E, T, 2], ranges and mask [E, T, B], drawing
    from `gen`; returns (State, [Output a tick])."""
    outs = []
    for t in range(encs.shape[1]):
        d = draw_tick(gen, mz, cfg, encs.shape[0])
        st, o = tick(st, encs[:, t], ranges[:, t], mask[:, t], angles, mz,
                     cfg, d, dtype)
        outs.append(o)
    return st, outs


def beam_table(beams: dict):
    """The beam table [B] (radians, float32) of a configuration's
    `beams`: evenly spread from min_deg to max_deg."""
    return torch.from_numpy(np.deg2rad(np.linspace(
        beams["min_deg"], beams["max_deg"], beams["count"])).astype(
            np.float32))


def from_program(st, gen_state: Optional[torch.Tensor] = None):
    """A reference State from a program's filter state (its field names:
    particles, weights, odom.{x, y, theta, encoder_left, encoder_right},
    inj.{w_slow, w_fast}, confidence, was_lost, the thresholds,
    best_pose), with a leading episode dim added to a single filter's."""
    one = st.particles.dim() == 2

    def lead(v):
        v = v.detach()
        return v[None] if one else v

    o = st.odom
    return State(particles=lead(st.particles), weights=lead(st.weights),
                 odom=torch.stack([lead(o.x), lead(o.y), lead(o.theta),
                                   lead(o.encoder_left),
                                   lead(o.encoder_right)], dim=-1),
                 w_slow=lead(st.inj.w_slow), w_fast=lead(st.inj.w_fast),
                 confidence=lead(st.confidence), was_lost=lead(st.was_lost),
                 cluster_threshold=lead(st.cluster_threshold),
                 confident_threshold=lead(st.confident_threshold),
                 best_pose=lead(st.best_pose))
