"""A plain-torch mirror of refine_grad_kernel's DDA walks (csrc/refine.cu)
and of what they cost a warp, for ops/refine.walk_stats.

Each ray is walked as raycast_dda walks it, and left where it is done: a
wall pixel entered, the map left, max_range reached or its dda_iters steps
taken.  `walks` gives each ray's distance, its hit code (steps along the
hit axis << 1 | the axis is x, -1 without a hit) and the steps it took (0
where it is done before its first step: an origin on a wall pixel or off
the map).

The kernel runs one thread a particle, the beams in order, so a warp of 32
particles walks each beam until its longest ray ends (`counts`): 32
lane-steps for each of those steps, twice for the beams past the records
(RECORDS beams), which pass 2 walks again.  The steps over the lane-steps
are the walk's lane share.  Imports torch and the port only (the card's
host has no JAX).
"""
from __future__ import annotations

import os
import re

import torch

from montecarlolocalisation_tpu_torch.maps.grid import lookup
from montecarlolocalisation_tpu_torch.models import raycast
from montecarlolocalisation_tpu_torch.ops import build

WARP = 32


def _constant(name: str) -> int:
    with open(os.path.join(build.CSRC, "refine.cu")) as f:
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             f.read()).group(1))


RECORDS = _constant("kRecords")


def walks(m, particles, angles, cfg) -> dict:
    """Every ray of particles [..., N, 3] at the signed beam angles [B]
    (the sensor's negation applied): `dist` (m), `code` and `steps`
    [..., N, B], from the ray origin laser_offset ahead, as the kernel
    walks it."""
    x, y, th = particles[..., 0], particles[..., 1], particles[..., 2]
    ox = (x + cfg.laser_offset * torch.cos(th))[..., None]
    oy = (y + cfg.laser_offset * torch.sin(th))[..., None]
    ox, oy, ray = torch.broadcast_tensors(ox, oy, th[..., None] + angles)
    ray = raycast.maybe_quantize(ray, cfg)
    dx, dy = torch.cos(ray), torch.sin(ray)
    eps, res = 1e-9, m.resolution
    gx = (ox - m.origin_x) * m.inv_resolution
    gy = (oy - m.origin_y) * m.inv_resolution
    ix = torch.floor(gx).to(torch.int32)
    iy = torch.floor(gy).to(torch.int32)
    sx = torch.where(dx >= 0, 1, -1).to(torch.int32)
    sy = torch.where(dy >= 0, 1, -1).to(torch.int32)
    inv_dx = torch.abs(1.0 / torch.where(torch.abs(dx) < eps, eps, dx))
    inv_dy = 1.0 / torch.abs(torch.where(torch.abs(dy) < eps, eps, dy))
    tx = torch.where(dx >= 0, 1.0 - (gx - ix), gx - ix) * res * inv_dx
    ty = torch.where(dy >= 0, 1.0 - (gy - iy), gy - iy) * res * inv_dy
    ddx, ddy = res * inv_dx, res * inv_dy

    def inside(a, b):
        return (a >= 0) & (b >= 0) & (a < m.width) & (b < m.height)

    start_wall = lookup(m.occ, ix, iy)
    dist = torch.where(start_wall, 0.0, cfg.max_range)
    code = torch.full(ix.shape, -1, dtype=torch.int32, device=ix.device)
    steps = torch.zeros(ix.shape, dtype=torch.int32, device=ix.device)
    done = start_wall | ~inside(ix, iy)
    kx, ky = torch.zeros_like(ix), torch.zeros_like(iy)
    for _ in range(raycast.dda_iters(m, cfg)):
        steps = steps + (~done).to(torch.int32)
        take_x = tx < ty
        t = torch.where(take_x, tx, ty)
        nix = torch.where(take_x, ix + sx, ix)
        niy = torch.where(take_x, iy, iy + sy)
        hit = ~done & lookup(m.occ, nix, niy) & (t < cfg.max_range)
        dist = torch.where(hit, t, dist)
        code = torch.where(hit, torch.where(take_x, kx * 2 + 1, ky * 2),
                           code)
        done = done | hit | ~inside(nix, niy) | (t >= cfg.max_range)
        ix, iy = torch.where(done, ix, nix), torch.where(done, iy, niy)
        kx = torch.where(done | ~take_x, kx, kx + 1)
        ky = torch.where(done | take_x, ky, ky + 1)
        tx = torch.where(done | ~take_x, tx, tx + ddx)
        ty = torch.where(done | take_x, ty, ty + ddy)
    return dict(dist=dist, code=code, steps=steps)


def counts(steps) -> dict:
    """The kernel's tallies of the walks' steps [..., N, B]: `steps` (their
    sum) and `slots` (32 lane-steps for each step of a warp of 32
    consecutive rows, as many as its longest ray of the beam took, twice
    past RECORDS beams), as ops/refine.walk_stats returns them."""
    flat = steps.reshape(-1, steps.shape[-1]).to(torch.int64)
    pad = (-flat.shape[0]) % WARP
    longest = torch.nn.functional.pad(flat, (0, 0, 0, pad)).reshape(
        -1, WARP, flat.shape[-1]).amax(1)
    twice = (torch.arange(flat.shape[-1], device=flat.device)
             >= RECORDS).to(torch.int64) + 1
    return dict(steps=int(flat.sum()),
                slots=int((WARP * longest * twice).sum()))
