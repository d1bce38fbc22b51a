"""Ray casting against the occupancy raster, in plain torch.

Torch counterpart of montecarlolocalisation_tpu/models/raycast.py:
  * "fixed"    — the reference march: r = 0, 0.1, ... < max_range, the first
                 r whose sample pixel is occupied, else max_range; the march
                 stops at the first out-of-map sample
                 (monte_carlo.cpp:350-390).
  * "dda"      — exact Amanatides-Woo grid traversal, bounded iterations.
  * "analytic" — the closed-form slab caster (ops/analytic); DDA on rasters
                 that are not gridline-structured.

These are the plain versions the beam weight kernel (ops/weights) is held
to.  On a map stack each episode's rays read its own map
(maps/grid.lookup); the analytic cast takes DDA unless every map of the
stack is gridline-structured.  Like the JAX package, the ~1-degree
direction quantization of the reference (monte_carlo.cpp:355-363) sits
behind `quantize_ray_deg`.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import SensorModelConfig
from ..maps.grid import MazeMap, lookup, world_to_map
from ..ops import analytic


def maybe_quantize(angle, cfg: SensorModelConfig):
    if not cfg.quantize_ray_deg:
        return angle
    return torch.round(angle * (180.0 / math.pi)) * (math.pi / 180.0)


def march_steps(cfg: SensorModelConfig):
    """The march's sample distances, as float32 products step * s."""
    return [float(np.float32(cfg.ray_step) * np.float32(s))
            for s in range(cfg.num_ray_steps)]


def raycast_fixed(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig):
    """Fixed-step ray march (reference mode)."""
    angle = maybe_quantize(angle, cfg)
    dx = torch.cos(angle)
    dy = torch.sin(angle)
    dist = torch.full_like(ox, cfg.max_range)
    alive = torch.ones_like(ox, dtype=torch.bool)
    for r in march_steps(cfg):
        mx, my, inb = world_to_map(m, ox + r * dx, oy + r * dy)
        hit = lookup(m.occ, mx, my, m.episode_maps) & alive
        dist = torch.minimum(dist, torch.where(hit, r, cfg.max_range))
        alive = alive & inb
    return dist


def raycast_dda(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig):
    """Exact grid traversal; returns the distance to the entered wall cell
    (bounded-iteration Amanatides-Woo, every lane the same iterations)."""
    return _dda(m, ox, oy, angle, cfg, track=False)


def dda_iters(m: MazeMap, cfg: SensorModelConfig) -> int:
    """The bounded traversal's steps: enough for any ray of max_range."""
    return int(math.ceil(cfg.max_range / m.resolution)) * 2 + 2


@dataclasses.dataclass(frozen=True)
class DDAWalk:
    """The bounded DDA's walk of each ray, and what the distance's
    derivative reads.  The distance is t_max + k * t_delta on the axis of
    the step that entered the wall pixel (k earlier steps along that axis,
    the float adds of the traversal), so it is differentiable only where
    that step exists (`hit`): nowhere on a wall origin, off the map, or at
    max_range."""

    dist: torch.Tensor      # distance (m)
    hit: torch.Tensor       # bool: a step entered a wall pixel
    axis_x: torch.Tensor    # bool: that step crossed a vertical pixel edge
    steps: torch.Tensor     # int32: earlier steps along that axis
    angle: torch.Tensor     # the ray angle as cast (quantized if set)
    dx: torch.Tensor
    dy: torch.Tensor
    lead_x: torch.Tensor    # frac_x * res, the first crossing's factor
    lead_y: torch.Tensor
    inv_dx: torch.Tensor
    inv_dy: torch.Tensor


def dda_walk(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig) -> DDAWalk:
    """raycast_dda's traversal of every ray (its distance, bit for bit),
    recording each ray's hit axis and its steps along it.  csrc/refine.cu
    walks each ray with the same arithmetic and leaves the loop where the
    ray is done."""
    return _dda(m, ox, oy, angle, cfg, track=True)


def _dda(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig, track: bool):
    """The bounded traversal for dda_iters steps, each value frozen once
    its ray is done: the distance, or with `track` the DDAWalk (the
    bookkeeping only where asked, so raycast_dda pays for none of it)."""
    angle = maybe_quantize(angle, cfg)
    res = m.resolution
    eps = 1e-9
    dx = torch.cos(angle)
    dy = torch.sin(angle)
    inv = m.inv_resolution
    gx = (ox - m.origin_x) * inv
    gy = (oy - m.origin_y) * inv
    ix = torch.floor(gx).to(torch.int32)
    iy = torch.floor(gy).to(torch.int32)
    step_x = torch.where(dx >= 0, 1, -1).to(torch.int32)
    step_y = torch.where(dy >= 0, 1, -1).to(torch.int32)
    inv_dx = torch.abs(1.0 / torch.where(torch.abs(dx) < eps, eps, dx))
    inv_dy = 1.0 / torch.abs(torch.where(torch.abs(dy) < eps, eps, dy))
    lead_x = torch.where(dx >= 0, 1.0 - (gx - ix), gx - ix) * res
    lead_y = torch.where(dy >= 0, 1.0 - (gy - iy), gy - iy) * res
    t_max_x = lead_x * inv_dx
    t_max_y = lead_y * inv_dy
    t_delta_x = res * inv_dx
    t_delta_y = res * inv_dy

    def in_bounds(ix, iy):
        return (ix >= 0) & (iy >= 0) & (ix < m.width) & (iy < m.height)

    start_hit = lookup(m.occ, ix, iy, m.episode_maps)
    dist = torch.where(start_hit, 0.0, cfg.max_range)
    done = start_hit | ~in_bounds(ix, iy)
    if track:
        hit_any = torch.zeros_like(done)
        axis_x = torch.zeros_like(done)
        kx = torch.zeros_like(ix)
        ky = torch.zeros_like(iy)
    for _ in range(dda_iters(m, cfg)):
        take_x = t_max_x < t_max_y
        t = torch.where(take_x, t_max_x, t_max_y)
        nix = torch.where(take_x, ix + step_x, ix)
        niy = torch.where(take_x, iy, iy + step_y)
        n_t_max_x = torch.where(take_x, t_max_x + t_delta_x, t_max_x)
        n_t_max_y = torch.where(take_x, t_max_y, t_max_y + t_delta_y)
        hit = (lookup(m.occ, nix, niy, m.episode_maps) & ~done
               & (t < cfg.max_range))
        out = (~in_bounds(nix, niy) | (t >= cfg.max_range)) & ~done
        dist = torch.where(hit, t, dist)
        if track:
            hit_any = hit_any | hit
            axis_x = torch.where(hit, take_x, axis_x)
        done = done | hit | out
        ix = torch.where(done, ix, nix)
        iy = torch.where(done, iy, niy)
        t_max_x = torch.where(done, t_max_x, n_t_max_x)
        t_max_y = torch.where(done, t_max_y, n_t_max_y)
        if track:
            kx = kx + (~done & take_x).to(torch.int32)
            ky = ky + (~done & ~take_x).to(torch.int32)
    if not track:
        return dist
    return DDAWalk(dist=dist, hit=hit_any, axis_x=axis_x,
                   steps=torch.where(axis_x, kx, ky), angle=angle, dx=dx,
                   dy=dy, lead_x=lead_x, lead_y=lead_y, inv_dx=inv_dx,
                   inv_dy=inv_dy)


def dda_vjp(m: MazeMap, walk: DDAWalk, grad, cfg: SensorModelConfig):
    """(d/d ox, d/d oy, d/d angle) of the distance times `grad` (the
    upstream derivative of each ray), in closed form, applied in the
    order autograd's backward through `raycast_dda` applies it: `grad`
    reaches the hit axis's first crossing t_max = lead * inv_d once and
    its t_delta = res * inv_d once for each earlier step (summed one
    after another), then flows through inv_d = |1 / d| into the
    direction (zero under the eps clamp) and through lead into the
    origin.  A quantized angle has no derivative (round's is zero)."""
    res, inv = m.resolution, m.inv_resolution
    g_t = torch.where(walk.hit, grad, 0.0)
    zero = torch.zeros_like(g_t)

    def axis(on, lead, inv_d, d):
        g = torch.where(on, g_t, zero)
        g_delta = zero
        for k in range(dda_iters(m, cfg)):
            g_delta = torch.where(walk.steps > k, g_delta + g, g_delta)
        g_inv = g * lead + g_delta * res
        clamped = torch.where(torch.abs(d) < 1e-9, 1e-9, d)
        r = 1.0 / clamped
        g_d = -(g_inv * torch.sign(clamped)) * (r * r)
        g_d = torch.where(torch.abs(d) < 1e-9, 0.0, g_d)
        g_lead = g * inv_d * res
        return g_d, torch.where(d >= 0, -g_lead, g_lead) * inv

    g_dx, g_ox = axis(walk.axis_x, walk.lead_x, walk.inv_dx, walk.dx)
    g_dy, g_oy = axis(~walk.axis_x, walk.lead_y, walk.inv_dy, walk.dy)
    g_angle = g_dx * -torch.sin(walk.angle) + g_dy * torch.cos(walk.angle)
    if cfg.quantize_ray_deg:
        g_angle = torch.zeros_like(g_angle)
    return g_ox, g_oy, g_angle


def raycast_analytic(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig):
    """Closed-form slab intersection; DDA for rasters that are not
    gridline-structured."""
    if not m.gridline:
        return raycast_dda(m, ox, oy, angle, cfg)
    angle = maybe_quantize(angle, cfg)
    return analytic.cast_dir(m, ox, oy, torch.cos(angle), torch.sin(angle),
                             cfg.max_range)


def raycast(m: MazeMap, ox, oy, angle, cfg: SensorModelConfig):
    ox, oy, angle = torch.broadcast_tensors(
        torch.as_tensor(ox, dtype=torch.float32, device=m.device),
        torch.as_tensor(oy, dtype=torch.float32, device=m.device),
        torch.as_tensor(angle, dtype=torch.float32, device=m.device))
    if cfg.ray_mode == "fixed":
        return raycast_fixed(m, ox, oy, angle, cfg)
    if cfg.ray_mode == "dda":
        return raycast_dda(m, ox, oy, angle, cfg)
    if cfg.ray_mode == "analytic":
        return raycast_analytic(m, ox, oy, angle, cfg)
    raise ValueError(f"unknown ray_mode {cfg.ray_mode!r}")
