"""Gradient-guided particle refinement: scan matching by autograd.

Torch counterpart of montecarlolocalisation_tpu/models/refine.py (no
reference counterpart).  The differentiable casters ("dda" by default,
refine.ray_mode) compute the hit distance in closed arithmetic form, so
one backward pass of the summed objective sum_i log(w_i + eps) gives
d log p(z | x) / d(x, y, theta) for every particle: the particles
decouple, and so do the episodes of a batch ([E, N, 3]).  Each round
steps every particle step_xy along its normalized xy gradient and
step_theta along sign(d/dtheta), and keeps the step only where the
likelihood improved.

Acceptance scores with the filter's own sensor model (its ray_mode
included) on the dense torch path, as the JAX package scores on its XLA
path (refine.py:101-109): the gradient guides, the filter's likelihood
decides.  The whole module is plain torch on every device, where the JAX
package runs XLA; the caster's arithmetic is the dense path's.

Telemetry (utils/profiling).  models/filter's `refine` mark opens the
refinement and its first scoring; each round then runs under two stage
marks, `refine_grad` (the differentiable caster's dense forward and its
backward, and the step) and `refine_score` (the proposal scored by the
filter's own caster, and the acceptance).  Each call with iters > 0 adds
1 to the counter `refine.calls` and E x N x B x (1 + 2 iters) to
`refine.rays`, the rays its castings score: the start, then a gradient
and a proposal a round.  Under a CUDA graph the counters count the
ticks that were captured, not the replays, so their ratio is the rays a
tick.  They count the castings, not how they run: an implementation
that fuses them records the same numbers.
"""
from __future__ import annotations

import dataclasses

import torch

from ..config import FilterConfig, RefineConfig, SensorModelConfig
from ..maps.grid import MazeMap
from ..utils import profiling
from ..utils.angles import normalize_angle
from . import sensor


def _objective_cfg(cfg: SensorModelConfig, rcfg: RefineConfig):
    """The differentiable variant of the filter's sensor model."""
    return dataclasses.replace(cfg, ray_mode=rcfg.ray_mode,
                               lookup_mode="auto")


def likelihood_and_grad(m: MazeMap, particles, scan: sensor.Scan,
                        cfg: SensorModelConfig, rcfg: RefineConfig,
                        valid_offset: float = 0.1):
    """(likelihood [..., N], d log-likelihood / d pose [..., N, 3]) from
    one dense evaluation and one backward pass."""
    dcfg = _objective_cfg(cfg, rcfg)
    with torch.enable_grad():
        p = particles.detach().requires_grad_(True)
        w = sensor.beam_weights_dense(m, p, scan, dcfg, valid_offset)
        obj = torch.sum(torch.log(w + rcfg.eps))
        (grads,) = torch.autograd.grad(obj, p)
    return w.detach(), grads


def refine_particles(m: MazeMap, particles, scan: sensor.Scan,
                     cfg: FilterConfig):
    """cfg.refine.iters rounds of hill-climbing, [..., N, 3] ->
    [..., N, 3]; iters == 0 returns the input (the reference path)."""
    rcfg = cfg.refine
    if rcfg.iters <= 0:
        return particles
    dev = particles.device
    profiling.count("refine.calls")
    profiling.count("refine.rays", particles[..., 0].numel()
                    * scan.ranges.shape[-1] * (1 + 2 * rcfg.iters))
    acc_cfg = dataclasses.replace(cfg.sensor, lookup_mode="auto")

    def value(p):
        return sensor.beam_weights_dense(m, p, scan, acc_cfg,
                                         cfg.valid_pos_offset)

    eps = 1e-20
    p = particles
    w = value(p)
    for _ in range(rcfg.iters):
        profiling.mark("refine_grad", dev)
        _, g = likelihood_and_grad(m, p, scan, cfg.sensor, rcfg,
                                   cfg.valid_pos_offset)
        gx, gy, gt = g[..., 0], g[..., 1], g[..., 2]
        gnorm = torch.sqrt(gx * gx + gy * gy)
        dx = rcfg.step_xy * gx / (gnorm + eps)
        dy = rcfg.step_xy * gy / (gnorm + eps)
        dt = rcfg.step_theta * torch.sign(gt)
        prop = torch.stack([p[..., 0] + dx, p[..., 1] + dy,
                            normalize_angle(p[..., 2] + dt)], dim=-1)
        profiling.mark("refine_score", dev)
        w_prop = value(prop)
        better = (w_prop > w)[..., None]
        p = torch.where(better, prop, p)
        w = torch.maximum(w_prop, w)
    return p
