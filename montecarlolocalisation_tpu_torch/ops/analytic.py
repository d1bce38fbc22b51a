"""Analytic slab ray casting: exact first-hit distances in closed form.

Torch counterpart of montecarlolocalisation_tpu/ops/analytic.py
(make_analytic_caster :290, prepare :431, cast_prepared :459).  Maze rasters
place wall pixels only on the multiple-of-8 gridline rows and columns, so
the obstacles are 1-px slabs on a 0.8 m lattice and a ray of length
max_range meets at most ceil(smax/8)+1 of them per axis.  Per candidate
slab: the entry and exit times, the pixel rows (columns) the ray touches
inside it, and the first occupied one along the ray; the hit is the
earliest over both axes.

The TPU version packs each gridline into bit words and finds the first set
bit with float-exponent tricks; here the touched band (at most `span`
pixels) is read straight from the raster, pixel by pixel.  The float
operations and their order are those of the JAX caster, so the two agree
to float rounding.  This module is the plain version of the analytic cast
inside the beam weight kernel (csrc/weights.cu), which repeats the same
float operations but finds the band's first occupied pixel in 32-bit words
of the gridline with __ffs/__clz; it gives this loop's row.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..maps.grid import MazeMap, lookup

CELL_PX = 8
EPS = 1e-9
INF = 3e38


def cast_constants(m: MazeMap, max_range: float):
    """(smax, n_cand, span): the cast length in pixels, the candidate
    slabs per axis, and the bound on a band's pixel count."""
    smax_f = max_range / m.resolution
    n_cand = int(math.ceil(smax_f / CELL_PX)) + 1
    span = int(math.ceil(smax_f)) + 2
    return float(np.float32(smax_f)), n_cand, span


class _Axis:
    """Gridlines perpendicular to one axis.  u is the coordinate across
    the lines, v the coordinate along them; line k sits at u = 8k and is
    `length` pixels long."""

    def __init__(self, m: MazeMap, vertical: bool):
        self.occ = m.occ
        self.maps = m.episode_maps
        self.vertical = vertical
        self.length = m.height if vertical else m.width
        across = m.width if vertical else m.height
        self.n_lines = (across - 1) // CELL_PX + 1

    def bit(self, k, r):
        """Pixel r of line k (False off the line or the map)."""
        if self.vertical:
            return lookup(self.occ, k * CELL_PX, r, self.maps)
        return lookup(self.occ, r, k * CELL_PX, self.maps)


def _axis_prepare(gu, gv, ax: _Axis):
    k0 = torch.floor(gu * (1.0 / CELL_PX)).to(torch.int32)
    r0 = torch.floor(gv).to(torch.int32)
    line_u0 = (k0 * CELL_PX).to(torch.float32)
    inside0 = (gu >= line_u0) & (gu < line_u0 + 1.0)
    valid0 = (k0 >= 0) & (k0 < ax.n_lines)
    origin0 = inside0 & valid0 & ax.bit(k0, r0)
    return k0, inside0, origin0


def _band_scan(ax: _Axis, k, lo_r, hi_r, fwd, span):
    """Whether line k has a set pixel in rows [lo_r, hi_r] (clipped to the
    line), and the first such row along the scan direction."""
    lo = lo_r.clamp(min=0)
    hi = hi_r.clamp(max=ax.length - 1)
    found = torch.zeros_like(fwd)
    rr = torch.zeros_like(lo)
    for j in range(span):
        row = torch.where(fwd, lo + j, hi - j)
        hit = (lo + j <= hi) & ax.bit(k, row) & ~found
        rr = torch.where(hit, row, rr)
        found = found | hit
    return found, rr


class _Ray(NamedTuple):
    """Rays against one axis's lines: direction u across them, v along."""

    small: torch.Tensor     # |du| < EPS: parallel to the lines
    inv_du: torch.Tensor
    sgn: torch.Tensor       # the lines' order along the ray
    fwd: torch.Tensor       # v grows along the ray
    small_v: torch.Tensor
    inv_dv: torch.Tensor
    dv: torch.Tensor


def _axis_ray(du, dv) -> _Ray:
    small = torch.abs(du) < EPS
    small_v = torch.abs(dv) < EPS
    return _Ray(small=small, inv_du=1.0 / torch.where(small, EPS, du),
                sgn=torch.where(du >= 0, 1, -1).to(torch.int32),
                fwd=dv >= 0, small_v=small_v,
                inv_dv=1.0 / torch.where(small_v, EPS, dv), dv=dv)


def _slab(gu, gv, ray: _Ray, ax: _Axis, prep, c: int, smax, span):
    """Candidate slab c of one axis, line k0 + sgn * c in ray order: its
    entry time t_in (clamped at 0) and its hit s (pixel units), INF where
    it has none."""
    k0, inside0, _ = prep
    k = k0 + ray.sgn * c
    line_u = (k * CELL_PX).to(torch.float32)
    t_near = (line_u - gu) * ray.inv_du
    t_far = (line_u + 1.0 - gu) * ray.inv_du
    t_in = torch.minimum(t_near, t_far)
    t_out = torch.maximum(t_near, t_far)
    if c == 0:
        t_in = torch.where(ray.small, torch.where(inside0, 0.0, INF), t_in)
        t_out = torch.where(ray.small, torch.where(inside0, smax, -INF),
                            t_out)
    else:
        t_in = torch.where(ray.small, INF, t_in)
        t_out = torch.where(ray.small, -INF, t_out)
    t_in = torch.clamp(t_in, min=0.0)
    t_out_c = torch.clamp(t_out, max=smax)
    window = t_in < t_out_c
    valid_k = (k >= 0) & (k < ax.n_lines)
    r_in = torch.floor(gv + t_in * ray.dv).to(torch.int32)
    r_out = torch.floor(gv + t_out_c * ray.dv).to(torch.int32)
    lo_r = torch.minimum(r_in, r_out)
    hi_r = torch.maximum(r_in, r_out)
    any_hit, rr = _band_scan(ax, k, lo_r, hi_r, ray.fwd, span)
    row_edge = torch.where(ray.fwd, rr, rr + 1).to(torch.float32)
    t_row = torch.where(ray.small_v, 0.0, (row_edge - gv) * ray.inv_dv)
    s_hit = torch.maximum(t_in, t_row)
    ok = window & valid_k & any_hit & (s_hit < smax)
    return t_in, torch.where(ok, s_hit, INF)


def _axis_hits(gu, gv, du, dv, ax: _Axis, prep, smax, n_cand, span):
    """First-hit s (pixel units) against the slabs of one axis."""
    ray = _axis_ray(du, dv)
    best = torch.where(prep[2], 0.0, INF)
    for c in range(n_cand):
        best = torch.minimum(best, _slab(gu, gv, ray, ax, prep, c, smax,
                                         span)[1])
    return best


def cast_dir(m: MazeMap, ox, oy, dx, dy, max_range: float):
    """First-hit distance (m) along UNIT directions (dx, dy) from (ox, oy),
    against a gridline-structured raster; max_range when nothing is hit
    or the origin is off the map."""
    smax, n_cand, span = cast_constants(m, max_range)
    inv = m.inv_resolution
    gx = (ox - m.origin_x) * inv
    gy = (oy - m.origin_y) * inv
    inb = (gx >= 0.0) & (gy >= 0.0) & (gx < float(m.width)) & (
        gy < float(m.height))
    v_ax, h_ax = _Axis(m, vertical=True), _Axis(m, vertical=False)
    sv = _axis_hits(gx, gy, dx, dy, v_ax, _axis_prepare(gx, gy, v_ax),
                    smax, n_cand, span)
    sh = _axis_hits(gy, gx, dy, dx, h_ax, _axis_prepare(gy, gx, h_ax),
                    smax, n_cand, span)
    s = torch.clamp(torch.minimum(sv, sh), max=smax)
    s = torch.where(inb, s, smax)
    return s * m.resolution
