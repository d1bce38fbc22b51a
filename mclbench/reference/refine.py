"""Gradient refinement in plain torch: the production schedule's
hill-climb of every particle up its beam likelihood, between the motion
and the weights.

Each of `refine.iters` rounds, for every particle independently:

  1. the gradient, in x, y and theta, of log(w + refine.eps), with w the
     beam likelihood under the `refine.ray_mode` caster ("dda", the exact
     grid traversal below, which autograd differentiates);
  2. a proposal: a step of step_xy along the xy gradient over its norm
     (the norm + 1e-20), and a step of step_theta along the sign of the
     theta gradient, theta wrapped;
  3. the proposal is kept only where the filter's own likelihood (its
     sensor's ray_mode) is strictly higher than the particle's.

Refinement draws no random numbers.  It computes in the dtype of the
particles it is given (the control: bfloat16).
"""
from __future__ import annotations

import math

import torch

from . import caster
from . import filter as ref
from .caster import EPS, recip
from .maze import Maze

NORM_EPS = 1e-20


def dda(mz: Maze, ox, oy, angle, max_range: float):
    """Amanatides-Woo traversal of the raster's pixels from (ox, oy) along
    `angle` (broadcast), a bounded number of steps for every ray: the
    distance (m) at which the ray enters the first wall pixel, 0 where
    its origin pixel is a wall, max_range where it leaves the raster or
    reaches max_range first.  Differentiable in the origin and the angle
    through the crossing distances."""
    ox, oy, angle = torch.broadcast_tensors(ox, oy, angle)
    res = mz.resolution
    dx, dy = torch.cos(angle), torch.sin(angle)
    inv = recip(res)
    gx = (ox - 0.0) * inv
    gy = (oy - 0.0) * inv
    ix = torch.floor(gx).to(torch.int32)
    iy = torch.floor(gy).to(torch.int32)
    step_x = torch.where(dx >= 0, 1, -1).to(torch.int32)
    step_y = torch.where(dy >= 0, 1, -1).to(torch.int32)
    inv_dx = torch.abs(1.0 / torch.where(torch.abs(dx) < EPS, EPS, dx))
    inv_dy = 1.0 / torch.abs(torch.where(torch.abs(dy) < EPS, EPS, dy))
    # Distance to the first crossing of a pixel edge on each axis.
    frac_x = torch.where(dx >= 0, 1.0 - (gx - ix), gx - ix)
    frac_y = torch.where(dy >= 0, 1.0 - (gy - iy), gy - iy)
    t_x = frac_x * res * inv_dx
    t_y = frac_y * res * inv_dy
    dt_x = res * inv_dx
    dt_y = res * inv_dy

    def inside(ix, iy):
        return (ix >= 0) & (iy >= 0) & (ix < mz.width) & (iy < mz.height)

    start = caster.pixel(mz.occ, ix, iy)
    dist = torch.where(start, 0.0, max_range).to(gx.dtype)
    done = start | ~inside(ix, iy)
    for _ in range(int(math.ceil(max_range / res)) * 2 + 2):
        take_x = t_x < t_y
        t = torch.where(take_x, t_x, t_y)
        nix = torch.where(take_x, ix + step_x, ix)
        niy = torch.where(take_x, iy, iy + step_y)
        n_tx = torch.where(take_x, t_x + dt_x, t_x)
        n_ty = torch.where(take_x, t_y, t_y + dt_y)
        hit = caster.pixel(mz.occ, nix, niy) & ~done & (t < max_range)
        out = (~inside(nix, niy) | (t >= max_range)) & ~done
        dist = torch.where(hit, t, dist)
        done = done | hit | out
        ix = torch.where(done, ix, nix)
        iy = torch.where(done, iy, niy)
        t_x = torch.where(done, t_x, n_tx)
        t_y = torch.where(done, t_y, n_ty)
    return dist


def _cast_dda(mz: Maze, ox, oy, angle, sensor: dict):
    return dda(mz, ox, oy, angle, sensor["max_range"])


def gradient(mz: Maze, parts, ranges, mask, angles, sensor: dict,
             rc: dict, block: int = 1 << 22):
    """d log(w + eps) / d(x, y, theta) [E, N, 3] of the beam likelihood w
    under the refine caster, a block of filters at a time (the particles
    decouple, so a block's sum gives each particle's own gradient)."""
    if rc["ray_mode"] != "dda":
        raise ValueError(f"the reference refines with 'dda', not "
                         f"{rc['ray_mode']!r}")
    e, n = parts.shape[:2]
    rows = max(1, block // (n * angles.shape[0]))
    grads = []
    for e0 in range(0, e, rows):
        with torch.enable_grad():
            p = parts[e0:e0 + rows].detach().requires_grad_(True)
            w = ref.weights(mz, p, ranges[e0:e0 + rows],
                            mask[e0:e0 + rows], angles, sensor,
                            cast=_cast_dda)
            (g,) = torch.autograd.grad(torch.sum(torch.log(w + rc["eps"])),
                                       p)
        grads.append(g)
    return torch.cat(grads)


def refine(mz: Maze, parts, ranges, mask, angles, cfg: dict):
    """cfg's `refine.iters` rounds of the hill-climb on particles
    [E, N, 3] (module docstring)."""
    rc, sensor = cfg["refine"], cfg["sensor"]
    p = parts

    def value(q):
        return ref.weights(mz, q, ranges, mask, angles, sensor)

    w = value(p)
    for _ in range(rc["iters"]):
        g = gradient(mz, p, ranges, mask, angles, sensor, rc)
        gx, gy, gt = g.unbind(-1)
        norm = torch.sqrt(gx * gx + gy * gy)
        dx = rc["step_xy"] * gx / (norm + NORM_EPS)
        dy = rc["step_xy"] * gy / (norm + NORM_EPS)
        dt = rc["step_theta"] * torch.sign(gt)
        prop = torch.stack([p[..., 0] + dx, p[..., 1] + dy,
                            ref.wrap(p[..., 2] + dt)], dim=-1)
        w_prop = value(prop)
        better = w_prop > w
        p = torch.where(better[..., None], prop, p)
        w = torch.maximum(w_prop, w)
    return p

