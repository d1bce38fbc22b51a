"""Ray casting against the reference raster, in plain torch.

`march` is the reference node's fixed 0.1 m march (monte_carlo.cpp
rayCast): the first sample r = 0, 0.1, ... below max_range whose pixel is
a wall, else max_range; the march stops at its first sample off the map.
`slabs` is the exact first hit against a maze raster, whose walls are
1-pixel slabs on the multiple-of-8 gridlines: per axis, the candidate
slabs in ray order, the pixel band the ray crosses inside each, and the
first wall pixel of that band.  Both take `dtype` for their arithmetic
(the control computes in bfloat16).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .maze import CELL_PX, Maze

EPS = 1e-9
INF = 3e38


def recip(c: float) -> float:
    """1/c as float32 arithmetic rounds it."""
    return float(np.float32(1.0) / np.float32(c))


def to_pixel(mz: Maze, wx, wy):
    """World -> pixel, truncated toward zero, and whether it is on the
    raster."""
    inv = recip(mz.resolution)
    mx = ((wx - 0.0) * inv).to(torch.int32)
    my = ((wy - 0.0) * inv).to(torch.int32)
    inb = (mx >= 0) & (my >= 0) & (mx < mz.width) & (my < mz.height)
    return mx, my, inb


def pixel(table: torch.Tensor, mx, my):
    """table[my, mx], False off the raster."""
    h, w = table.shape
    inb = (mx >= 0) & (my >= 0) & (mx < w) & (my < h)
    flat = my.clamp(0, h - 1).long() * w + mx.clamp(0, w - 1).long()
    return inb & torch.take(table, flat)


def march_distances(max_range: float, step: float) -> list:
    n = int(math.ceil(max_range / step))
    return [float(np.float32(step) * np.float32(s)) for s in range(n)]


def march(mz: Maze, ox, oy, angle, max_range: float, step: float):
    dx, dy = torch.cos(angle), torch.sin(angle)
    dist = torch.full_like(ox, max_range)
    alive = torch.ones_like(ox, dtype=torch.bool)
    for r in march_distances(max_range, step):
        mx, my, inb = to_pixel(mz, ox + r * dx, oy + r * dy)
        hit = pixel(mz.occ, mx, my) & alive
        dist = torch.minimum(dist, torch.where(hit, r, max_range))
        alive = alive & inb
    return dist


def slab_constants(mz: Maze, max_range: float):
    """(cast length in pixels, candidate slabs per axis, the most pixels a
    band can hold)."""
    smax = max_range / mz.resolution
    return (float(np.float32(smax)), int(math.ceil(smax / CELL_PX)) + 1,
            int(math.ceil(smax)) + 2)


def _line_pixel(mz: Maze, vertical: bool, k, r):
    """Pixel r along gridline k (a column for vertical lines)."""
    if vertical:
        return pixel(mz.occ, k * CELL_PX, r)
    return pixel(mz.occ, r, k * CELL_PX)


def _axis(mz: Maze, vertical: bool, gu, gv, du, dv, smax, n_cand, span):
    """First hit (pixels along the ray) against the gridlines across u."""
    length = mz.height if vertical else mz.width
    across = mz.width if vertical else mz.height
    n_lines = (across - 1) // CELL_PX + 1
    k0 = torch.floor(gu * (1.0 / CELL_PX)).to(torch.int32)
    line0 = (k0 * CELL_PX).to(gu.dtype)
    inside0 = (gu >= line0) & (gu < line0 + 1.0)
    origin0 = (inside0 & (k0 >= 0) & (k0 < n_lines)
               & _line_pixel(mz, vertical, k0,
                             torch.floor(gv).to(torch.int32)))
    small = torch.abs(du) < EPS
    inv_du = 1.0 / torch.where(small, EPS, du)
    sgn = torch.where(du >= 0, 1, -1).to(torch.int32)
    fwd = dv >= 0
    small_v = torch.abs(dv) < EPS
    inv_dv = 1.0 / torch.where(small_v, EPS, dv)
    best = torch.where(origin0, 0.0, INF).to(gu.dtype)
    for c in range(n_cand):
        k = k0 + sgn * c
        line = (k * CELL_PX).to(gu.dtype)
        t_near = (line - gu) * inv_du
        t_far = (line + 1.0 - gu) * inv_du
        t_in = torch.minimum(t_near, t_far)
        t_out = torch.maximum(t_near, t_far)
        if c == 0:
            t_in = torch.where(small, torch.where(inside0, 0.0, INF), t_in)
            t_out = torch.where(small, torch.where(inside0, smax, -INF),
                                t_out)
        else:
            t_in = torch.where(small, INF, t_in)
            t_out = torch.where(small, -INF, t_out)
        t_in = torch.clamp(t_in, min=0.0)
        t_out = torch.clamp(t_out, max=smax)
        r_in = torch.floor(gv + t_in * dv).to(torch.int32)
        r_out = torch.floor(gv + t_out * dv).to(torch.int32)
        lo = torch.minimum(r_in, r_out).clamp(min=0)
        hi = torch.maximum(r_in, r_out).clamp(max=length - 1)
        found = torch.zeros_like(fwd)
        row = torch.zeros_like(lo)
        for j in range(span):
            rj = torch.where(fwd, lo + j, hi - j)
            hit = (lo + j <= hi) & _line_pixel(mz, vertical, k, rj) & ~found
            row = torch.where(hit, rj, row)
            found = found | hit
        edge = torch.where(fwd, row, row + 1).to(gu.dtype)
        t_row = torch.where(small_v, 0.0, (edge - gv) * inv_dv)
        s_hit = torch.maximum(t_in, t_row)
        ok = ((t_in < t_out) & (k >= 0) & (k < n_lines) & found
              & (s_hit < smax))
        best = torch.minimum(best, torch.where(ok, s_hit, INF))
    return best


def slabs(mz: Maze, ox, oy, angle, max_range: float):
    """Exact first-hit distance (m) on a gridline raster; max_range when
    nothing is hit within it or the origin is off the map."""
    smax, n_cand, span = slab_constants(mz, max_range)
    dx, dy = torch.cos(angle), torch.sin(angle)
    inv = recip(mz.resolution)
    gx = (ox - 0.0) * inv
    gy = (oy - 0.0) * inv
    inb = (gx >= 0.0) & (gy >= 0.0) & (gx < float(mz.width)) & (
        gy < float(mz.height))
    sv = _axis(mz, True, gx, gy, dx, dy, smax, n_cand, span)
    sh = _axis(mz, False, gy, gx, dy, dx, smax, n_cand, span)
    s = torch.clamp(torch.minimum(sv, sh), max=smax)
    s = torch.where(inb, s, smax)
    return s * mz.resolution


def cast(mz: Maze, ox, oy, angle, sensor: dict):
    """The configured caster ("fixed" or "analytic") on broadcast
    origins and angles."""
    ox, oy, angle = torch.broadcast_tensors(ox, oy, angle)
    if sensor["ray_mode"] == "fixed":
        return march(mz, ox, oy, angle, sensor["max_range"],
                     sensor["ray_step"])
    if sensor["ray_mode"] == "analytic":
        return slabs(mz, ox, oy, angle, sensor["max_range"])
    raise ValueError(f"the reference casts 'fixed' or 'analytic', not "
                     f"{sensor['ray_mode']!r}")
