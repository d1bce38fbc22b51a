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
    frac_x = torch.where(dx >= 0, 1.0 - (gx - ix), gx - ix)
    frac_y = torch.where(dy >= 0, 1.0 - (gy - iy), gy - iy)
    t_max_x = frac_x * res * inv_dx
    t_max_y = frac_y * res * inv_dy
    t_delta_x = res * inv_dx
    t_delta_y = res * inv_dy

    def in_bounds(ix, iy):
        return (ix >= 0) & (iy >= 0) & (ix < m.width) & (iy < m.height)

    start_hit = lookup(m.occ, ix, iy, m.episode_maps)
    dist = torch.where(start_hit, 0.0, cfg.max_range)
    done = start_hit | ~in_bounds(ix, iy)
    iters = int(math.ceil(cfg.max_range / m.resolution)) * 2 + 2
    for _ in range(iters):
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
        done = done | hit | out
        ix = torch.where(done, ix, nix)
        iy = torch.where(done, iy, niy)
        t_max_x = torch.where(done, t_max_x, n_t_max_x)
        t_max_y = torch.where(done, t_max_y, n_t_max_y)
    return dist


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
