"""Rao-Blackwellized particle-filter SLAM (occupancy-grid FastSLAM).

Torch counterpart of montecarlolocalisation_tpu/models/slam.py (no
reference counterpart: the reference localizes in a hand-written map and
cannot build one).  Each particle carries a pose and its own occupancy
grid; a tick proposes (odometry plus per-particle noise), weights (the
scan against the particle's own map through a likelihood field),
resamples (ESS-gated, the maps ride along) and folds the scan into every
particle's map (models/mapping's inverse sensor model).

Leading dims stand in for the JAX package's vmaps: a state holds poses
[..., P, 3] and maps [..., P, H, W] with leading dims () for one robot,
[E] for episodes or [E, K] for episodes x replicas, and every reduction
over particles (logsumexp, the ESS, the weighted mean, the argmax of the
scores) runs over the particle axis only.  What branches in JAX (the
ESS-gated resample, the keyframe-gated map update, the closure) is a
per-filter torch.where over both branches, as vmap turns lax.cond into a
select (the map update's gate is mapping.update_map's `paint`, whose
kernel on the card copies a closed gate's maps instead): the tick never
waits for the host.

The likelihood field's bilinear sample is a four-tap gather (the JAX
package contracts tent weights on the MXU, a TPU workaround for
per-lane gathers) with the JAX edges kept: samples outside the pixel-
centre hull of the full map read 0, a coordinate clipped to the last
pixel gives its missing tap weight 0, and an integer coordinate reads its
pixel.  The blur is two small matrix products per map.

A tick's random numbers come from the state's torch.Generator, or from
`draws` (SLAMDraws), so a caller can replay the JAX package's draws.
Episodes run their ticks in CUDA graphs (models/compiled); on CUDA a
tick is captured or the call raises.

Telemetry (utils/profiling).  On CUDA a stage mark precedes each of the
tick's four stages and `emit` follows the last, as in the filter tick
(ops/marks.py):
  * `slam_motion`: odometry, the proposal's noise and propagation (with
    proposal_candidates > 1, the candidates too);
  * `slam_field`: the field windows, the likelihood field and its blur,
    the scan's bilinear samples (and the scan matcher, where
    refine_iters > 0), the weights' normalisation and the evidence: the
    work mclbench's `slam_field_bound` counts;
  * `slam_resample`: the ESS gate, the gathers of poses, maps and
    scores, the weighted mean pose, the keyframe criterion and the
    closure;
  * `slam_map`: the inverse sensor model with its keyframe gate
    (mapping.update_map: on the card one kernel, csrc/ism.cu), kf_pose
    and the best pose: the work mclbench's `ism_bound` counts.
The draws, before `slam_motion`, follow `begin` or the last tick's
`emit` and so belong to the bookkeeping.  Each call adds 1 to the
counter `slam.calls` and E x K x P x B (the filters' particles times the
beams) to `slam.rays`; under a CUDA graph the captured ticks count, not
the replays, so their ratio is the rays a tick.  Marks change no value.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import SLAMConfig
from ..utils import profiling
from ..utils.angles import normalize_angle
from . import compiled, mapping, motion
from .resample import systematic_indices


@dataclasses.dataclass(frozen=True)
class SLAMState:
    """Joint (pose, map) particle posterior and the shared odometry; the
    per-filter fields have the leading dims."""

    poses: torch.Tensor        # [..., P, 3] world (x, y, theta)
    logodds: torch.Tensor      # [..., P, H, W] per-particle log-odds
    weights: torch.Tensor      # [..., P] normalized importance weights
    scores: torch.Tensor       # [..., P] the last pre-resample weights,
    #                            permuted with the particles (best_map)
    odom: motion.OdometryState
    gen: torch.Generator
    kf_pose: torch.Tensor      # [..., 3] mean pose at the last keyframe
    closure_cool: torch.Tensor  # [...] int32 keyframes until the closure
    #                             may fire again
    log_evidence: torch.Tensor  # [...] sum_t log p(z_t | z_{1:t-1})

    @property
    def batch(self) -> tuple:
        return tuple(self.poses.shape[:-2])


@dataclasses.dataclass(frozen=True)
class SLAMDraws:
    """One tick's random numbers: the motion normals [..., 3, P] (or
    [..., 3, P, K] with K proposal candidates), the Gumbel uniforms
    [..., P, K] in [1e-37, 1) (None without candidates), and the
    systematic resample's offset u0 [...]."""

    normals: torch.Tensor
    gumbel: Optional[torch.Tensor]
    u0: torch.Tensor


def draw_slam(gen: torch.Generator, cfg: SLAMConfig, batch=(),
              device="cuda") -> SLAMDraws:
    """A tick's draws from `gen` with leading dims `batch`; u0 is drawn
    on every tick, as JAX draws it whether or not the tick resamples."""
    b = tuple(batch)
    p, k = cfg.num_particles, cfg.proposal_candidates
    normals = torch.randn(b + (3, p) + ((k,) if k > 1 else ()),
                          generator=gen, device=device)
    gumbel = (torch.rand(b + (p, k), generator=gen, device=device
                         ).clamp_min(1e-37) if k > 1 else None)
    u0 = torch.rand(b, generator=gen, device=device)
    return SLAMDraws(normals=normals, gumbel=gumbel, u0=u0)


def init_slam(seed: int, start_pose, cfg: SLAMConfig, batch=(),
              device="cuda") -> SLAMState:
    """Every particle at the known start pose ([3], or [..., 3] one a
    filter), empty maps, uniform weights; the generator seeded with
    `seed`.  The map frame is anchored at the start pose."""
    b = tuple(batch)
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    p = cfg.num_particles
    f32 = torch.float32
    sp = _on_device(start_pose, dev).expand(b + (3,))
    weights = torch.full(b + (p,), 1.0 / p, dtype=f32, device=dev)
    zero = torch.zeros(b, dtype=f32, device=dev)
    return SLAMState(
        poses=sp[..., None, :].expand(b + (p, 3)).clone(),
        logodds=torch.zeros(b + (p, cfg.mapping.height, cfg.mapping.width),
                            dtype=f32, device=dev),
        weights=weights, scores=weights.clone(),
        odom=motion.OdometryState(x=sp[..., 0].clone(), y=sp[..., 1].clone(),
                                  theta=sp[..., 2].clone(),
                                  encoder_left=zero, encoder_right=zero),
        gen=gen, kf_pose=torch.full(b + (3,), -1e6, dtype=f32, device=dev),
        closure_cool=torch.zeros(b, dtype=torch.int32, device=dev),
        log_evidence=zero.clone())


def _origin(poses, cfg: SLAMConfig):
    """The ray origins (ox, oy) and headings of poses [..., 3]."""
    theta = poses[..., 2:3]
    ox = poses[..., 0:1] + cfg.sensor.laser_offset * torch.cos(theta)
    oy = poses[..., 1:2] + cfg.sensor.laser_offset * torch.sin(theta)
    return ox, oy, theta


def _sign(cfg: SLAMConfig) -> float:
    return -1.0 if cfg.sensor.negate_beam_angle else 1.0


def _endpoints(poses, ranges, angles, cfg: SLAMConfig):
    """Scan endpoints per (particle, beam), [..., P, B] x and y: the wall
    pixel's centre, half a pixel past each return; poses [..., P, 3],
    ranges [..., B] or [B]."""
    ox, oy, theta = _origin(poses, cfg)
    ray = theta + _sign(cfg) * angles
    r = ranges[..., None, :] + 0.5 * cfg.mapping.resolution
    return ox + r * torch.cos(ray), oy + r * torch.sin(ray)


def field_window_px(cfg: SLAMConfig) -> int:
    """Per-particle field window side (pixels, odd): every point the scan
    model samples, the blur's reach and a 2 px margin."""
    reach = (cfg.sensor.laser_offset + cfg.mapping.max_trusted_range
             + cfg.mapping.resolution)
    half = (int(math.ceil(reach / cfg.mapping.resolution))
            + cfg.field_radius_px + 2)
    return 2 * half + 1


def _window_origins(poses, cfg: SLAMConfig, sh: int, sw: int):
    """Top-left (row, col) [...] of each pose's sh x sw window, clamped so
    that the window lies inside the grid."""
    mcfg = cfg.mapping
    ci = torch.floor((poses[..., 0] - mcfg.origin_x)
                     / mcfg.resolution).to(torch.int64)
    ri = torch.floor((poses[..., 1] - mcfg.origin_y)
                     / mcfg.resolution).to(torch.int64)
    r0 = torch.clamp(ri - sh // 2, 0, mcfg.height - sh)
    c0 = torch.clamp(ci - sw // 2, 0, mcfg.width - sw)
    return r0, c0


def _windows(grids, r0, c0, sh: int, sw: int):
    """grids [..., H, W] -> windows [..., sh, sw] at (r0, c0) [...]."""
    w = grids.shape[-1]
    rows = r0[..., None] + torch.arange(sh, device=grids.device)
    cols = c0[..., None] + torch.arange(sw, device=grids.device)
    idx = (rows[..., :, None] * w + cols[..., None, :]).flatten(-2)
    return torch.gather(grids.flatten(-2), -1, idx).unflatten(-1, (sh, sw))


def field_windows(logodds, poses, cfg: SLAMConfig):
    """Per-particle field windows: ([..., P, s, s] log-odds, (r0, c0)
    [..., P]), or (logodds, None) when the map is small enough that the
    window is the map (a side under 2 * field_window_px, the default
    maze's 49 px among them)."""
    s = field_window_px(cfg)
    h, w = logodds.shape[-2], logodds.shape[-1]
    if 2 * s > min(h, w):
        return logodds, None
    sh, sw = min(s, h), min(s, w)
    r0, c0 = _window_origins(poses, cfg, sh, sw)
    return _windows(logodds, r0, c0, sh, sw), (r0, c0)


def _blur_matrix(n: int, sigma_px: float, radius: int, device="cpu"):
    """Banded 1-D Gaussian [n, n] with unit centre weight: a learned wall
    keeps field ~1 on the wall and decays as exp(-d^2 / 2 sigma^2)."""
    idx = torch.arange(n, dtype=torch.float32, device=device)
    d = torch.abs(idx[:, None] - idx[None, :])
    k = torch.exp(-0.5 * (d / sigma_px) ** 2)
    return torch.where(d <= radius, k, 0.0)


def hit_field(logodds, cfg: SLAMConfig):
    """Likelihood fields of maps [..., h, w]: (blurred, sharp).  The
    wallness sigmoid(4 (logodds - l_occ / 2)) is rebased so that unknown
    (0) is exactly zero wall mass; the blurred field (two banded products,
    clipped at 1) feeds the endpoint model, the sharp one the free-space
    term."""
    h, w = logodds.shape[-2], logodds.shape[-1]
    s = torch.sigmoid(4.0 * (logodds - 0.5 * cfg.mapping.l_occ))
    s0 = 1.0 / (1.0 + math.exp(2.0 * cfg.mapping.l_occ))
    wall = torch.clamp_min((s - s0) / (1.0 - s0), 0.0)
    kh = _blur_matrix(h, cfg.field_sigma_px, cfg.field_radius_px,
                      logodds.device)
    kw = _blur_matrix(w, cfg.field_sigma_px, cfg.field_radius_px,
                      logodds.device)
    blurred = torch.clamp(torch.matmul(torch.matmul(kh, wall), kw), 0.0,
                          1.0)
    return blurred, wall


def _bilinear(field, ex, ey, mcfg, offsets=None):
    """Bilinear samples of fields [..., P, h, w] at world points ex, ey
    [..., P, S] -> [..., P, S], a four-tap gather.  Points outside the
    pixel-centre hull of the full map read zero; with `offsets` (r0, c0)
    [..., P] the fields are windows and the points rebase into them."""
    h, w = field.shape[-2], field.shape[-1]
    # Times the reciprocal, as XLA folds the JAX package's division by a
    # constant: the pixel coordinate then has JAX's rounding.
    inv = float(np.float32(1.0) / np.float32(mcfg.resolution))
    u = (ex - mcfg.origin_x) * inv - 0.5                          # cols
    v = (ey - mcfg.origin_y) * inv - 0.5                          # rows
    fh = mcfg.height if offsets is not None else h
    fw = mcfg.width if offsets is not None else w
    in_bounds = ((u >= 0.0) & (u <= fw - 1.0)
                 & (v >= 0.0) & (v <= fh - 1.0)).to(field.dtype)
    if offsets is not None:
        r0, c0 = offsets
        u = u - c0[..., None].to(u.dtype)
        v = v - r0[..., None].to(v.dtype)
    u = torch.clamp(u, 0.0, w - 1.0)
    v = torch.clamp(v, 0.0, h - 1.0)
    u0, v0 = torch.floor(u).detach(), torch.floor(v).detach()
    # The tent weights max(0, 1 - |coord - index|) of the two neighbours:
    # the second is 0 at an integer coordinate and at the last pixel,
    # whose clamped index then reads a pixel of weight 0.
    wu0 = 1.0 - torch.abs(u - u0)
    wu1 = torch.clamp_min(1.0 - torch.abs(u - (u0 + 1.0)), 0.0)
    wv0 = 1.0 - torch.abs(v - v0)
    wv1 = torch.clamp_min(1.0 - torch.abs(v - (v0 + 1.0)), 0.0)
    iu0, iv0 = u0.to(torch.int64), v0.to(torch.int64)
    iu1 = torch.clamp(iu0 + 1, max=w - 1)
    iv1 = torch.clamp(iv0 + 1, max=h - 1)
    flat = field.flatten(-2)

    def tap(iv, iu):
        return torch.gather(flat, -1, iv * w + iu)

    val = (wv0 * (wu0 * tap(iv0, iu0) + wu1 * tap(iv0, iu1))
           + wv1 * (wu0 * tap(iv1, iu0) + wu1 * tap(iv1, iu1)))
    return in_bounds * val


def _beam_masks(ranges, mask, cfg: SLAMConfig):
    """(valid, returned) [..., B] float masks of a scan."""
    valid = mask.to(torch.float32) * (
        ranges <= cfg.mapping.max_trusted_range).to(torch.float32)
    returned = valid * (
        ranges < cfg.sensor.max_range - 1e-6).to(torch.float32)
    return valid, returned


def _free_stations(ranges, cfg: SLAMConfig):
    """Distances of the free-space stations [..., B, F]: fractions of
    (r - free_margin), so the last one stays out of the endpoint wall's
    own blur."""
    span = torch.clamp_min(ranges - cfg.free_margin, 0.0)
    fracs = (torch.arange(1, cfg.free_samples + 1, dtype=torch.float32,
                          device=ranges.device) / cfg.free_samples)
    return span[..., None] * fracs


def scan_loglik_multi(field, cand, ranges, angles, mask, cfg: SLAMConfig,
                      offsets=None):
    """Scan log-likelihood of candidate poses [..., P, K, 3] on each
    particle's own field (fields [..., P, h, w]; ranges and mask [..., B]
    or [B]) -> [..., P, K].  Two terms per valid beam: the endpoint
    log(z_hit * field + z_rand) for returned beams, and free-space
    consistency sum log(1 - z_short * wall) over the stations inside the
    ray."""
    field_hit, field_wall = field
    ranges = ranges.to(torch.float32)
    k_n, b_n = cand.shape[-2], ranges.shape[-1]
    ox, oy, theta = _origin(cand, cfg)                       # [..., P, K, 1]
    ray = theta + _sign(cfg) * angles                        # [..., P, K, B]
    rb = ranges[..., None, None, :]                          # [..., 1, 1, B]
    r = rb + 0.5 * cfg.mapping.resolution
    ex = (ox + r * torch.cos(ray)).flatten(-2)
    ey = (oy + r * torch.sin(ray)).flatten(-2)
    f = _bilinear(field_hit, ex, ey, cfg.mapping, offsets).unflatten(
        -1, (k_n, b_n))
    valid, returned = _beam_masks(rb, mask[..., None, None, :], cfg)
    per_beam = torch.log(cfg.z_hit * f + cfg.z_rand) * returned
    if cfg.z_short > 0.0 and cfg.free_samples > 0:
        cr, sr = torch.cos(ray), torch.sin(ray)
        s = _free_stations(rb, cfg)                          # [.., 1, 1, B, F]
        f_n = cfg.free_samples
        shape = ray.shape + (f_n,)
        sx = torch.broadcast_to(ox[..., None] + s * cr[..., None],
                                shape).flatten(-3)
        sy = torch.broadcast_to(oy[..., None] + s * sr[..., None],
                                shape).flatten(-3)
        fk = _bilinear(field_wall, sx, sy, cfg.mapping, offsets).unflatten(
            -1, (k_n, b_n, f_n))
        per_beam = per_beam + (
            torch.sum(torch.log1p(-cfg.z_short * fk), dim=-1) * valid)
    return torch.sum(per_beam, dim=-1)


def scan_log_likelihood(field, poses, ranges, angles, mask,
                        cfg: SLAMConfig, offsets=None):
    """Per-particle scan log-likelihood [..., P] of poses [..., P, 3] on
    their own fields (scan_loglik_multi's two terms)."""
    field_hit, field_wall = field
    ranges = ranges.to(torch.float32)
    ex, ey = _endpoints(poses, ranges, angles, cfg)
    f = _bilinear(field_hit, ex, ey, cfg.mapping, offsets)
    rb = ranges[..., None, :]                                # [..., 1, B]
    valid, returned = _beam_masks(rb, mask[..., None, :], cfg)
    per_beam = torch.log(cfg.z_hit * f + cfg.z_rand) * returned
    if cfg.z_short > 0.0 and cfg.free_samples > 0:
        ox, oy, theta = _origin(poses, cfg)
        ray = theta + _sign(cfg) * angles                    # [..., P, B]
        cr, sr = torch.cos(ray), torch.sin(ray)
        s = _free_stations(rb, cfg)                          # [..., 1, B, F]
        shape = ray.shape + (cfg.free_samples,)
        sx = torch.broadcast_to(ox[..., None] + s * cr[..., None],
                                shape).flatten(-2)
        sy = torch.broadcast_to(oy[..., None] + s * sr[..., None],
                                shape).flatten(-2)
        fk = _bilinear(field_wall, sx, sy, cfg.mapping, offsets).unflatten(
            -1, (ray.shape[-1], cfg.free_samples))
        per_beam = per_beam + (
            torch.sum(torch.log1p(-cfg.z_short * fk), dim=-1) * valid)
    return torch.sum(per_beam, dim=-1)


def _refine_poses(poses, field, ranges, angles, mask, cfg: SLAMConfig,
                  offsets=None):
    """Gradient scan matching on each particle's own field:
    cfg.refine_iters steps of sign-gradient ascent (torch.autograd),
    each kept only where the likelihood improved.  The fields are
    constants; only the poses move."""
    field = tuple(f.detach() for f in field)

    def score(p):
        return scan_log_likelihood(field, p, ranges, angles, mask, cfg,
                                   offsets)

    step = torch.full((3,), cfg.refine_step_xy, dtype=torch.float32,
                      device=poses.device)
    step[2] = cfg.refine_step_theta
    p, s = poses, score(poses)
    for _ in range(cfg.refine_iters):
        with torch.enable_grad():
            q = p.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(torch.sum(score(q)), q)
        cand = p + step * torch.sign(g)
        s_cand = score(cand)
        better = s_cand > s
        p = torch.where(better[..., None], cand, p)
        s = torch.where(better, s_cand, s)
    return p


def consensus_map(state: SLAMState):
    """Importance-weighted mean of the particle maps: [..., H, W]."""
    return torch.einsum("...p,...phw->...hw", state.weights, state.logodds)


def _linspace(start: float, stop: float, num: int, device):
    """jnp.linspace's float32 values as XLA folds them under jit:
    start (1 - t) + stop t at t = i * (1 / (num - 1)), the last value stop
    itself; made on `device` (no copy from the host)."""
    t = (torch.arange(num - 1, dtype=torch.float32, device=device)
         * float(np.float32(1.0 / (num - 1))))
    out = float(np.float32(start)) * (1.0 - t) + float(np.float32(stop)) * t
    return torch.cat([out, torch.full((1,), float(np.float32(stop)),
                                      dtype=torch.float32, device=device)])


def closure_deltas(cfg: SLAMConfig, device="cpu"):
    """The closure's candidate offsets [C, 3], (dx, dy, dtheta) on an odd
    grid, dtheta fastest."""
    nxy, nth = cfg.closure_xy_steps, cfg.closure_theta_steps
    if nxy % 2 != 1 or nth % 2 != 1:
        raise ValueError("closure steps must be odd")
    dx = _linspace(-cfg.closure_xy_range, cfg.closure_xy_range, nxy, device)
    dth = _linspace(-cfg.closure_theta_range, cfg.closure_theta_range, nth,
                    device)
    gx, gy, gt = torch.meshgrid(dx, dx, dth, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1), gt.reshape(-1)],
                       dim=-1)


def closure_correction(logodds, w, mean_pose, ranges, angles, mask,
                       cfg: SLAMConfig):
    """Correlative scan match against the consensus map: (delta [..., 3],
    gain [...]).  The scan is scored from mean_pose plus every offset of
    closure_deltas on the likelihood field of the importance-weighted mean
    map; only returned beams whose endpoint at the mean pose already
    reads painted wall (field > 0.3) count (the frontier-suction gate).
    delta is the best offset where it beats the zero offset by
    closure_margin nats with at least closure_min_beams such beams, its
    dtheta kept only where it buys closure_theta_margin nats over
    dtheta = 0; zeros elsewhere."""
    mcfg = cfg.mapping
    h, wd = mcfg.height, mcfg.width
    pad = int(math.ceil(cfg.closure_xy_range / mcfg.resolution)) + 1
    s = field_window_px(cfg) + 2 * pad
    if 2 * s > min(h, wd):
        cons = torch.einsum("...p,...phw->...hw", w, logodds)[..., None, :, :]
        offsets = None
    else:
        sh, sw = min(s, h), min(s, wd)
        r0, c0 = _window_origins(mean_pose[..., None, :], cfg, sh, sw)
        p_n = logodds.shape[-3]
        win = _windows(logodds, r0.expand(r0.shape[:-1] + (p_n,)),
                       c0.expand(c0.shape[:-1] + (p_n,)), sh, sw)
        cons = torch.einsum("...p,...phw->...hw", w, win)[..., None, :, :]
        offsets = (r0, c0)
    field = hit_field(cons, cfg)
    nxy, nth = cfg.closure_xy_steps, cfg.closure_theta_steps
    deltas = closure_deltas(cfg, logodds.device)
    cand = mean_pose[..., None, None, :] + deltas            # [..., 1, C, 3]

    rr = ranges.to(torch.float32)
    ex_c, ey_c = _endpoints(mean_pose[..., None, :], rr, angles, cfg)
    f_c = _bilinear(field[0], ex_c, ey_c, mcfg, offsets)[..., 0, :]
    beam_ok = (f_c > 0.3) & (rr < cfg.sensor.max_range - 1e-6)
    mask = mask.to(torch.float32) * beam_ok.to(torch.float32)
    n_matched = torch.sum(mask, dim=-1)

    ll = scan_loglik_multi(field, cand, rr, angles, mask, cfg,
                           offsets)[..., 0, :]               # [..., C]
    center = (nxy // 2) * nxy * nth + (nxy // 2) * nth + nth // 2
    best = torch.argmax(ll, dim=-1)

    def at(i):
        return torch.gather(ll, -1, i[..., None])[..., 0]

    best_xy0 = best - best % nth + nth // 2
    use_theta = (at(best) - at(best_xy0)) >= cfg.closure_theta_margin
    best = torch.where(use_theta, best, best_xy0)
    gain = at(best) - ll[..., center]
    fire = (gain >= cfg.closure_margin) & (n_matched >= cfg.closure_min_beams)
    # index_select: a 0-d index tensor would be read on the host.
    picked = deltas.index_select(0, best.reshape(-1)).reshape(
        best.shape + (3,))
    delta = torch.where(fire[..., None], cfg.closure_gain * picked, 0.0)
    return delta, gain


def _apply_rigid_delta(poses, mean_pose, delta):
    """Rotate the cloud [..., P, 3] by delta's theta about the mean pose
    [..., 3] and translate it by delta's (dx, dy): the spread is kept."""
    c = torch.cos(delta[..., 2:3])
    s = torch.sin(delta[..., 2:3])
    rx = poses[..., 0] - mean_pose[..., 0:1]
    ry = poses[..., 1] - mean_pose[..., 1:2]
    nx = mean_pose[..., 0:1] + delta[..., 0:1] + c * rx - s * ry
    ny = mean_pose[..., 1:2] + delta[..., 1:2] + s * rx + c * ry
    nt = normalize_angle(poses[..., 2] + delta[..., 2:3])
    return torch.stack([nx, ny, nt], dim=-1)


def _on_device(v, device):
    """A tick input as a float32 tensor on `device`; a Python number is
    filled in there (a copy from the host would wait for the card)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    if np.ndim(v) == 0:
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(np.asarray(v, np.float32), device=device)


def slam_step(state: SLAMState, encoder_left, encoder_right, ranges,
              angles, mask, cfg: SLAMConfig,
              draws: Optional[SLAMDraws] = None):
    """One SLAM tick of every filter of the state: propose (odometry and
    per-particle noise, or K candidates of the Monte-Carlo optimal
    proposal), weight (the scan on each particle's pre-update map),
    resample (where the ESS falls below ess_threshold * P; the maps and
    scores ride along), the closure (opt-in) and the map update
    (keyframe-gated when keyframe_* > 0).  Encoders [...], ranges and mask
    [..., B] or [B], angles [B].

    Returns (new state, info): pose (the weighted mean, [..., 3]),
    best_pose, ess, resampled, mapped, closure_delta and log_evidence."""
    batch = state.batch
    dev = state.poses.device
    p_count = state.poses.shape[-2]
    k_cand = cfg.proposal_candidates
    if draws is None:
        draws = draw_slam(state.gen, cfg, batch, dev)
    f32 = torch.float32
    enc_l = _on_device(encoder_left, dev).expand(batch)
    enc_r = _on_device(encoder_right, dev).expand(batch)
    ranges = _on_device(ranges, dev)
    angles = _on_device(angles, dev)
    mask = _on_device(mask, dev)
    ranges = ranges.expand(batch + ranges.shape[-1:])
    mask = mask.expand(ranges.shape)
    profiling.count("slam.calls")
    profiling.count("slam.rays", state.poses[..., 0].numel()
                    * ranges.shape[-1])

    # 1. Motion proposal: shared encoder integration, per-particle noise.
    # Each stage follows its mark (module docstring).
    profiling.mark("slam_motion", dev)
    # With trans ~ 0 the split between rot1 and rot2 is unobservable and
    # the reference's rot1 = atan2(~0, ~0) - theta is garbage: rot1 = 0,
    # rot2 = the whole turn.
    new_odom, rot1, trans, rot2 = motion.diff_drive_update(
        state.odom, enc_l, enc_r, cfg.motion)
    turning_in_place = trans < 1e-4
    rot2 = torch.where(turning_in_place, rot1 + rot2, rot2)
    rot1 = torch.where(turning_in_place, 0.0, rot1)
    m = cfg.motion
    a1, a2, a3, a4 = (m.alpha_1 * cfg.alpha_scale, m.alpha_2 * cfg.alpha_scale,
                      m.alpha_3 * cfg.alpha_scale, m.alpha_4 * cfg.alpha_scale)
    sd_r1 = torch.sqrt(a1 * torch.abs(rot1) + a2 * trans)
    sd_tr = torch.sqrt(a3 * trans + a4 * (torch.abs(rot1) + torch.abs(rot2)))
    sd_r2 = torch.sqrt(a1 * torch.abs(rot2) + a2 * trans)
    n1, n2, n3 = draws.normals.unbind(-3 if k_cand > 1 else -2)
    # The per-filter scalars against [..., P] or [..., P, K] draws.
    extra = (None, None) if k_cand > 1 else (None,)

    def per(v):
        return v[(..., *extra)]

    n_rot1 = per(rot1) + per(sd_r1) * n1
    n_trans = per(trans) + per(sd_tr) * n2
    n_rot2 = per(rot2) + per(sd_r2) * n3

    if k_cand > 1:
        # 2-3. The Monte-Carlo optimal proposal: K motion draws a
        # particle, one kept with probability proportional to its scan
        # likelihood (Gumbel-max), the weight times the candidates' mean
        # likelihood.  The field is the one at the noise-free pose.
        cand = motion.propagate_particles(state.poses[..., None, :], n_rot1,
                                          n_trans, n_rot2)
        cand = torch.cat([cand[..., :2], normalize_angle(cand[..., 2:3])],
                         dim=-1)
        center = motion.propagate_particles(state.poses, rot1[..., None],
                                            trans[..., None],
                                            rot2[..., None])
        profiling.mark("slam_field", dev)
        win, offsets = field_windows(state.logodds, center, cfg)
        field = hit_field(win, cfg)
        ll = scan_loglik_multi(field, cand, ranges, angles, mask, cfg,
                               offsets)                      # [..., P, K]
        gum = -torch.log(-torch.log(draws.gumbel))
        pick = torch.argmax(ll + gum, dim=-1)
        poses = torch.take_along_dim(cand, pick[..., None, None],
                                     dim=-2)[..., 0, :]
        loglik = (torch.logsumexp(ll, dim=-1)
                  - torch.log(torch.full((), float(k_cand), dtype=f32,
                                         device=dev)))
    else:
        poses = motion.propagate_particles(state.poses, n_rot1, n_trans,
                                           n_rot2)
        poses = torch.cat([poses[..., :2], normalize_angle(poses[..., 2:3])],
                          dim=-1)
        # The field of each particle's pre-update map, shared by the scan
        # matcher and the weights (a window around the proposal on large
        # maps).
        profiling.mark("slam_field", dev)
        win, offsets = field_windows(state.logodds, poses, cfg)
        field = hit_field(win, cfg)
        if cfg.refine_iters > 0:
            poses = _refine_poses(poses, field, ranges, angles, mask, cfg,
                                  offsets)
        loglik = scan_log_likelihood(field, poses, ranges, angles, mask,
                                     cfg, offsets)
    logw = torch.log(state.weights) + loglik
    log_evidence = state.log_evidence + torch.logsumexp(logw, dim=-1)
    logw = logw - torch.amax(logw, dim=-1, keepdim=True)
    w = torch.exp(logw)
    w = w / torch.sum(w, dim=-1, keepdim=True)

    # 4. ESS-gated systematic resampling: both branches, a per-filter
    # select.  The CDF accumulates in float64, so the card's sum does not
    # change from run to run.
    profiling.mark("slam_resample", dev)
    ess = 1.0 / torch.sum(w * w, dim=-1)
    resampled = ess < cfg.ess_threshold * p_count
    cdf = torch.cumsum(w.double(), dim=-1).to(f32)
    idx = systematic_indices(cdf, draws.u0).to(torch.int64)
    fire = resampled[..., None]
    poses = torch.where(fire[..., None],
                        torch.take_along_dim(poses, idx[..., None], dim=-2),
                        poses)
    logodds = torch.where(
        fire[..., None, None],
        torch.take_along_dim(state.logodds, idx[..., None, None], dim=-3),
        state.logodds)
    scores = torch.where(fire, torch.take_along_dim(w, idx, dim=-1), w)
    w = torch.where(fire, torch.full_like(w, 1.0 / p_count), w)

    # The weighted mean pose (circular theta).
    mean_pose = torch.stack([
        torch.sum(w * poses[..., 0], dim=-1),
        torch.sum(w * poses[..., 1], dim=-1),
        torch.atan2(torch.sum(w * torch.sin(poses[..., 2]), dim=-1),
                    torch.sum(w * torch.cos(poses[..., 2]), dim=-1))],
        dim=-1)

    # Keyframe criterion, before the map update.
    crit = []
    if cfg.keyframe_trans > 0.0:
        crit.append(torch.hypot(mean_pose[..., 0] - state.kf_pose[..., 0],
                                mean_pose[..., 1] - state.kf_pose[..., 1])
                    >= cfg.keyframe_trans)
    if cfg.keyframe_rot > 0.0:
        crit.append(torch.abs(normalize_angle(
            mean_pose[..., 2] - state.kf_pose[..., 2])) >= cfg.keyframe_rot)
    moved = torch.ones(batch, dtype=torch.bool, device=dev)
    for i, c in enumerate(crit):
        moved = c if i == 0 else (moved | c)

    # 4b. The consensus-anchored closure (opt-in): a rigid correction of
    # the whole cloud, never on turning ticks, after a cooldown of
    # keyframes, and a fired tick skips its own map update.
    closure_delta = torch.zeros(batch + (3,), dtype=f32, device=dev)
    fired = torch.zeros(batch, dtype=torch.bool, device=dev)
    closure_cool = state.closure_cool
    if cfg.closure:
        turn_ok = torch.abs(rot1 + rot2) < cfg.closure_max_turn
        can_fire = moved & turn_ok & (closure_cool <= 0)
        delta, _ = closure_correction(logodds, w, mean_pose, ranges, angles,
                                      mask, cfg)
        closure_delta = torch.where(can_fire[..., None], delta, 0.0)
        poses = _apply_rigid_delta(poses, mean_pose, closure_delta)
        mean_pose = torch.stack([
            mean_pose[..., 0] + closure_delta[..., 0],
            mean_pose[..., 1] + closure_delta[..., 1],
            normalize_angle(mean_pose[..., 2] + closure_delta[..., 2])],
            dim=-1)
        fired = torch.sum(torch.abs(closure_delta), dim=-1) > 0.0
        closure_cool = torch.where(
            fired, torch.full_like(closure_cool, cfg.closure_cooldown),
            torch.clamp_min(closure_cool - moved.to(torch.int32), 0))

    # 5. Map update: each particle folds the scan into its map at its
    # pose, keyframe-gated.
    profiling.mark("slam_map", dev)
    do_paint = (moved & ~fired) if crit else ~fired
    logodds = mapping.update_map(
        logodds, poses, ranges[..., None, :], angles, mask[..., None, :],
        cfg.mapping, cfg.sensor,
        paint=do_paint[..., None] if crit or cfg.closure else None)
    kf_pose = (torch.where(moved[..., None], mean_pose, state.kf_pose)
               if crit else mean_pose)

    best = torch.argmax(scores, dim=-1)
    info = dict(pose=mean_pose,
                best_pose=torch.take_along_dim(poses, best[..., None, None],
                                               dim=-2)[..., 0, :],
                ess=ess, resampled=resampled, mapped=do_paint,
                closure_delta=closure_delta, log_evidence=log_evidence)
    profiling.mark("emit", dev)
    new_state = SLAMState(poses=poses, logodds=logodds, weights=w,
                          scores=scores, odom=new_odom, gen=state.gen,
                          kf_pose=kf_pose, closure_cool=closure_cool,
                          log_evidence=log_evidence)
    return new_state, info


def _tick(state: SLAMState, x: dict, consts: dict, cfg: SLAMConfig):
    """slam_step on a tick's inputs: encoders [..., 2], ranges and mask
    [..., B], and the tick's draws where given; the beam table in
    consts."""
    enc = x["encoders"]
    return slam_step(state, enc[..., 0], enc[..., 1], x["ranges"],
                     consts["angles"], x["mask"], cfg, x.get("draws"))


def run_slam_ticks(state: SLAMState, encoders, ranges, mask, angles,
                   cfg: SLAMConfig, draws: Optional[SLAMDraws] = None):
    """K = encoders.shape[lead] ticks through one graph of
    models/compiled (one replay on CUDA): encoders [..., K, 2], ranges
    and mask [..., K, B], angles [B], `draws` with the tick axis after the
    state's leading dims.  Returns (state, infos [..., K, ...]), both the
    graph's buffers."""
    lead = len(state.batch)
    xs = dict(encoders=encoders, ranges=ranges, mask=mask)
    if draws is not None:
        xs["draws"] = draws
    consts = dict(angles=angles)
    graph = compiled.cached(None, _tick, state, xs, consts, lead, cfg=cfg)
    return graph(state, xs, consts)


def _episode_inputs(encoders, scan_ranges, scan_angles, scan_mask, batch,
                    device):
    """The episode's tensors on `device`, broadcast to the state's leading
    dims: encoders [*batch, T, 2], ranges and mask [*batch, T, B]."""
    enc = torch.as_tensor(encoders, dtype=torch.float32, device=device)
    ranges = torch.as_tensor(scan_ranges, dtype=torch.float32,
                             device=device)
    angles = torch.as_tensor(scan_angles, dtype=torch.float32,
                             device=device)
    mask = (torch.ones(ranges.shape, dtype=torch.float32, device=device)
            if scan_mask is None else torch.as_tensor(
                scan_mask, device=device).to(torch.float32))
    b = tuple(batch)
    return (enc.expand(b + enc.shape[-2:]),
            ranges.expand(b + ranges.shape[-2:]),
            mask.expand(b + mask.shape[-2:]), angles)


def run_slam_episode(seed: int, encoders, scan_ranges, scan_angles,
                     cfg: SLAMConfig, start_pose, scan_mask=None,
                     state0: Optional[SLAMState] = None,
                     draws: Optional[Sequence[SLAMDraws]] = None,
                     batch=None, device=None):
    """A whole episode: encoders [..., T, 2] cumulative wheel radians,
    scan_ranges [..., T, B], scan_angles [B]; the state init_slam(seed,
    start_pose) with the inputs' leading dims (or `batch`, to which the
    inputs broadcast), or `state0`.  `draws` holds one SLAMDraws a tick.
    The ticks run in graphs of compiled.TICKS_PER_GRAPH ticks, one replay
    each on CUDA.  Returns (final state, weighted-mean poses [..., T, 3]),
    the caller's own tensors.  `device` defaults to state0's, else the
    encoders' if a tensor, else the card."""
    if device is None:
        device = (state0.poses.device if state0 is not None
                  else encoders.device if isinstance(encoders, torch.Tensor)
                  else "cuda")
    if state0 is None:
        if batch is None:
            batch = (encoders.shape if isinstance(encoders, torch.Tensor)
                     else np.shape(encoders))[:-2]
        state0 = init_slam(seed, start_pose, cfg, batch, device)
    b = state0.batch
    enc, ranges, mask, angles = _episode_inputs(
        encoders, scan_ranges, scan_angles, scan_mask, b, state0.poses.device)
    lead = len(b)
    carry = [state0]

    def chunk(t0: int, n: int):
        def part(v):
            return v.narrow(lead, t0, n)

        d = (None if draws is None
             else compiled.stack_ticks(list(draws[t0:t0 + n]), lead))
        carry[0], ys = run_slam_ticks(carry[0], part(enc), part(ranges),
                                      part(mask), angles, cfg, d)
        return ys["pose"]

    poses = compiled.run_chunked(chunk, enc.shape[lead], lead)
    return compiled.detach_state(carry[0]), poses


def _pick(tree, idx, lead: int):
    """Every tensor of `tree` indexed by idx [...] along axis `lead` (the
    replica axis after the leading dims ...); generators kept."""
    def take(v):
        if isinstance(v, torch.Generator):
            return v
        i = idx.reshape(idx.shape + (1,) * (v.dim() - lead))
        return torch.take_along_dim(v, i, dim=lead).squeeze(lead)

    return compiled.tree_map(take, tree)


def run_slam_replicas(seed: int, encoders, scan_ranges, scan_angles,
                      cfg: SLAMConfig, start_pose, replicas: int = 4,
                      scan_mask=None, tick_chunk=None, device=None):
    """`replicas` independent SLAM filters over the same episode
    (encoders [..., T, 2]) as one state [..., K], the winner of each
    episode by accumulated log evidence (argmax over the replica axis, on
    the device).  Returns (winner's final state [...], its poses
    [..., T, 3], dict(log_evidence [..., K], chosen [...])).
    `tick_chunk` is accepted for the JAX package's signature and changes
    nothing: the ticks already run in graphs of compiled.TICKS_PER_GRAPH
    ticks."""
    if replicas < 1:
        raise ValueError("replicas must be >= 1")
    if tick_chunk is not None and tick_chunk < 1:
        raise ValueError("tick_chunk must be >= 1")
    enc = torch.as_tensor(encoders, dtype=torch.float32,
                          device=device if device is not None
                          else encoders.device
                          if isinstance(encoders, torch.Tensor) else "cuda")
    dev = enc.device
    lead = enc.dim() - 2
    ranges = torch.as_tensor(scan_ranges, dtype=torch.float32, device=dev)
    mask = (None if scan_mask is None
            else torch.as_tensor(scan_mask, device=dev).unsqueeze(lead))
    start = _on_device(start_pose, dev)
    if start.dim() > 1:
        start = start.unsqueeze(-2)
    final, ests = run_slam_episode(
        seed, enc.unsqueeze(lead), ranges.unsqueeze(lead), scan_angles, cfg,
        start, scan_mask=mask, batch=enc.shape[:-2] + (replicas,),
        device=dev)
    best = torch.argmax(final.log_evidence, dim=-1)
    return (_pick(final, best, lead), _pick(ests, best, lead),
            dict(log_evidence=final.log_evidence, chosen=best))


def best_map(state: SLAMState):
    """The highest-score particle's map [..., H, W] (scores, not weights:
    after a resample the weights are uniform)."""
    best = torch.argmax(state.scores, dim=-1)
    return torch.take_along_dim(state.logodds, best[..., None, None, None],
                                dim=-3)[..., 0, :, :]


def best_pose(state: SLAMState):
    """The highest-score particle's pose [..., 3]."""
    best = torch.argmax(state.scores, dim=-1)
    return torch.take_along_dim(state.poses, best[..., None, None],
                                dim=-2)[..., 0, :]
