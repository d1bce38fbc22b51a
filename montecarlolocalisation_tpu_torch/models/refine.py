"""Gradient-guided particle refinement: scan matching by the gradient of
the beam likelihood.

Torch counterpart of montecarlolocalisation_tpu/models/refine.py (no
reference counterpart).  The differentiable casters ("dda" by default,
refine.ray_mode) compute the hit distance in closed arithmetic form, so
the gradient of the summed objective sum_i log(w_i + eps) gives
d log p(z | x) / d(x, y, theta) for every particle: the particles
decouple, and so do the episodes of a batch ([E, N, 3]).  Each round
steps every particle step_xy along its normalized xy gradient and
step_theta along sign(d/dtheta), and keeps the step only where the
likelihood improved.

Acceptance scores with the filter's own sensor model (its ray_mode
included), as the JAX package scores on its XLA path (refine.py:101-109):
the gradient guides, the filter's likelihood decides.  Where the JAX
package runs jax.grad on XLA, the port chooses by the configuration and
the particles' device alone:

- CUDA particles under a configuration the kernels implement
  (ops/refine.kernels_take: the "dda" objective, the fixed march scoring
  in sum mode, one map, validity at one pixel of offset) run two
  hand-written kernels (csrc/refine.cu): `refine_grad_kernel` a round,
  which walks each ray once, stops at its hit and writes the proposal
  from the distance's closed-form derivative, and `refine_score_kernel`
  for the start and after each, which scores with the fixed march and
  accepts in place.  No autograd runs.
- Everything else, CPU particles included, runs the dense path: on the
  "dda" objective `likelihood_and_grad` computes the gradient in closed
  form (`closed_form_grad`: raycast.dda_walk and dda_vjp, then the sensor
  model's derivative), on another objective caster by autograd.

The closed form applies each derivative in the order autograd's backward
applies it and sums over the beams with torch's own reduction, so it
gives autograd's bits on any device; the kernels compute the same
function, their beam sums in the order of torch's CUDA reduction
(ops/refine.reduce_width).

Telemetry (utils/profiling).  models/filter's `refine` mark opens the
refinement and its first scoring; each round then runs under two stage
marks, `refine_grad` (the gradient and the step) and `refine_score`
(the proposal scored by the filter's own caster, and the acceptance).
Each call with iters > 0 adds 1 to the counter `refine.calls` and E x N
x B x (1 + 2 iters) to `refine.rays`, the rays its castings score: the
start, then a gradient and a proposal a round.  Under a CUDA graph the
counters count the ticks that were captured, not the replays, so their
ratio is the rays a tick.  They count the castings, not how they run:
the kernels record the same numbers.  What the kernel's DDA walks cost, a
tick's steps and the lane-steps its warps spend on them, is counted apart
from the filter's launches, by ops/refine.walk_stats into the counters
`refine.walk_steps` and `refine.walk_slots`.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..config import FilterConfig, RefineConfig, SensorModelConfig
from ..maps.grid import MazeMap, f32_reciprocal, is_valid_pos
from ..utils import profiling
from ..utils.angles import normalize_angle
from . import raycast, sensor

NORM_EPS = 1e-20   # the xy step's guard: g / (|g| + NORM_EPS)


def _objective_cfg(cfg: SensorModelConfig, rcfg: RefineConfig):
    """The differentiable variant of the filter's sensor model."""
    return dataclasses.replace(cfg, ray_mode=rcfg.ray_mode,
                               lookup_mode="auto")


def closed_form_grad(m: MazeMap, particles, scan: sensor.Scan,
                     cfg: SensorModelConfig, rcfg: RefineConfig,
                     valid_offset: float = 0.1):
    """`likelihood_and_grad` on the "dda" objective in closed form: the
    dense path's likelihood [..., N] (its bits), and the gradient of
    sum log(w + eps) [..., N, 3] with every derivative applied as
    autograd's backward applies it, so that on the card the two agree to
    the last bit (module docstring); the DDA's part is raycast.dda_vjp."""
    dcfg = _objective_cfg(cfg, rcfg)
    x, y, th = particles[..., 0], particles[..., 1], particles[..., 2]
    cos_t, sin_t = torch.cos(th), torch.sin(th)
    ox = x + cfg.laser_offset * cos_t
    oy = y + cfg.laser_offset * sin_t
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    ray = th[..., None] + sign * scan.angles
    ox_b, oy_b, ray = torch.broadcast_tensors(ox[..., None], oy[..., None],
                                              ray)
    walk = raycast.dda_walk(m, ox_b, oy_b, ray, dcfg)
    obs = scan.ranges[..., None, :]
    raw = obs - walk.dist
    diff = torch.abs(raw)
    k_exp = f32_reciprocal(2.0 * cfg.sigma * cfg.sigma)
    k_pdf = f32_reciprocal(cfg.sigma * math.sqrt(2.0 * math.pi))
    e = torch.exp(-(diff * diff) * k_exp)
    inr = (diff >= 0.0) & (diff <= cfg.gauss_max_diff)
    per_beam = (cfg.w_hit * torch.where(inr, e * k_pdf, 0.0)
                + cfg.w_rand * (torch.abs(obs - cfg.max_range)
                                < cfg.rand_window).to(torch.float32))
    mask = scan.mask.to(torch.float32)[..., None, :]
    valid = is_valid_pos(m, x, y, valid_offset)
    log_mode = cfg.beam_combine == "log"
    if log_mode:
        clamped = torch.clamp(per_beam, min=1e-6)
        logs = sensor.beam_sum(torch.log(clamped) * mask) * f32_reciprocal(
            cfg.log_temperature)
        top = torch.amax(logs, dim=-1, keepdim=True)
        prob = torch.exp(logs - top)
    else:
        prob = sensor.beam_sum(per_beam * mask)
    w = torch.where(valid, prob, 0.0)

    # The backward, op for op.
    g_prob = torch.where(valid, 1.0 / (w + rcfg.eps), 0.0)
    if log_mode:
        g_z = g_prob * prob
        is_top = (logs == top).to(torch.float32)
        g_top = -g_z.sum(dim=-1, keepdim=True)
        g_logs = g_z + g_top / is_top.sum(dim=-1, keepdim=True) * is_top
        g_acc = g_logs * f32_reciprocal(cfg.log_temperature)
        g_lt = g_acc[..., None] * mask
        g_pb = torch.where(per_beam >= 1e-6, g_lt / clamped, 0.0)
    else:
        g_pb = g_prob[..., None] * mask
    g_pdf = torch.where(inr, g_pb * cfg.w_hit, 0.0)
    g_q = g_pdf * k_pdf * e
    g_sq = -(g_q * k_exp) * diff
    g_expected = -((g_sq + g_sq) * torch.sign(raw))
    # The broadcast origins' and the ray angles' sums over the beams, as
    # autograd's sum_to takes them (on the card in the order of
    # ops/refine.reduce_width),
    # then theta's three paths in the order autograd's engine adds them.
    g_ox, g_oy, g_ray = (v.sum(dim=-1)
                         for v in raycast.dda_vjp(m, walk, g_expected, dcfg))
    g_th = (g_ray + g_oy * cfg.laser_offset * cos_t) + (
        g_ox * cfg.laser_offset * -sin_t)
    return w, torch.stack([g_ox, g_oy, g_th], dim=-1)


def likelihood_and_grad(m: MazeMap, particles, scan: sensor.Scan,
                        cfg: SensorModelConfig, rcfg: RefineConfig,
                        valid_offset: float = 0.1):
    """(likelihood [..., N], d log-likelihood / d pose [..., N, 3]): in
    closed form on the "dda" objective, else from one dense evaluation
    and one backward pass."""
    if rcfg.ray_mode == "dda":
        return closed_form_grad(m, particles, scan, cfg, rcfg, valid_offset)
    dcfg = _objective_cfg(cfg, rcfg)
    with torch.enable_grad():
        p = particles.detach().requires_grad_(True)
        w = sensor.beam_weights_dense(m, p, scan, dcfg, valid_offset)
        obj = torch.sum(torch.log(w + rcfg.eps))
        (grads,) = torch.autograd.grad(obj, p)
    return w.detach(), grads


def propose(p, g, rcfg: RefineConfig):
    """One round's proposal from the gradient: step_xy along the xy
    gradient over its norm, step_theta along the sign of d/dtheta."""
    gx, gy, gt = g[..., 0], g[..., 1], g[..., 2]
    gnorm = torch.sqrt(gx * gx + gy * gy)
    dx = rcfg.step_xy * gx / (gnorm + NORM_EPS)
    dy = rcfg.step_xy * gy / (gnorm + NORM_EPS)
    dt = rcfg.step_theta * torch.sign(gt)
    return torch.stack([p[..., 0] + dx, p[..., 1] + dy,
                        normalize_angle(p[..., 2] + dt)], dim=-1)


def refine_particles(m: MazeMap, particles, scan: sensor.Scan,
                     cfg: FilterConfig):
    """cfg.refine.iters rounds of hill-climbing, [..., N, 3] ->
    [..., N, 3]; iters == 0 returns the input (the reference path)."""
    from ..ops import refine as kernels

    rcfg = cfg.refine
    if rcfg.iters <= 0:
        return particles
    dev = particles.device
    profiling.count("refine.calls")
    profiling.count("refine.rays", particles[..., 0].numel()
                    * scan.ranges.shape[-1] * (1 + 2 * rcfg.iters))
    if kernels.kernels_take(m, particles, cfg):
        p, angles, ranges, mask = kernels.beam_inputs(particles, scan, cfg)
        w = kernels.refine_score_cuda(m, p, angles, ranges, mask, cfg)
        for _ in range(rcfg.iters):
            profiling.mark("refine_grad", dev)
            prop = kernels.refine_grad_cuda(m, p, angles, ranges, mask, cfg)
            profiling.mark("refine_score", dev)
            kernels.refine_score_cuda(m, p, angles, ranges, mask, cfg, w,
                                      prop)
        return p.reshape(particles.shape)
    acc_cfg = dataclasses.replace(cfg.sensor, lookup_mode="auto")

    def value(p):
        return sensor.beam_weights_dense(m, p, scan, acc_cfg,
                                         cfg.valid_pos_offset)

    p = particles
    w = value(p)
    for _ in range(rcfg.iters):
        profiling.mark("refine_grad", dev)
        _, g = likelihood_and_grad(m, p, scan, cfg.sensor, rcfg,
                                   cfg.valid_pos_offset)
        prop = propose(p, g, rcfg)
        profiling.mark("refine_score", dev)
        w_prop = value(prop)
        better = (w_prop > w)[..., None]
        p = torch.where(better, prop, p)
        w = torch.maximum(w_prop, w)
    return p
