"""Hard cases of the refinement's DDA walk and gradient, without JAX (the
CPU tests in tests/test_torch_refine.py and the card's in
tests/test_torch_card_refine.py share them).

`rays` gives ray origins and angles for raycast's closed form; `particles`
gives poses whose ray origins (laser_offset ahead) land where the walk is
hard; `beam_table` holds beams along each axis.  The kinds:

- "uniform": anywhere on the map and around it, any heading;
- "edges": origins on pixel edges, and within 1e-6 of them, on either axis;
- "axes": rays along each axis (a ray at angle 0 has sin = 0, under the
  DDA's eps clamp);
- "walls": origins inside wall pixels (the distance 0, no derivative);
- "off_map": origins off the raster (max_range, no derivative);
- "cloud": poses near free-space poses, where most rays hit a wall within
  max_range and the gradient is large;
- "invalid": poses on or next to walls, or off the map, which the
  validity gate weighs 0.
"""
from __future__ import annotations

import math

import numpy as np
import torch

KINDS = ("uniform", "edges", "axes", "walls", "off_map", "cloud", "invalid")
AXES = (0.0, math.pi / 2, math.pi, -math.pi / 2, -math.pi)


def _free_poses(m, n, rng):
    """n poses at free pixels (not in the dilated raster), any heading."""
    free = np.argwhere(~m.occ_dilated.cpu().numpy())
    pick = free[rng.integers(0, len(free), n)]
    u = rng.uniform(0.0, 1.0, (n, 2))
    return np.stack([(pick[:, 1] + u[:, 0]) * m.resolution,
                     (pick[:, 0] + u[:, 1]) * m.resolution,
                     rng.uniform(-math.pi, math.pi, n)], -1)


def _origins(kind, m, n, rng):
    """(ox, oy, angle) float64 [n] of one kind."""
    res, w, h = m.resolution, m.width, m.height
    ox = rng.uniform(-0.3, w * res + 0.3, n)
    oy = rng.uniform(-0.3, h * res + 0.3, n)
    ang = rng.uniform(-math.pi, math.pi, n)
    if kind == "edges":
        near = rng.choice([0.0, 1e-6, -1e-6], (n, 2))
        on_x = rng.uniform(size=n) < 0.5
        ox = np.where(on_x, rng.integers(0, w, n) * res + near[:, 0], ox)
        oy = np.where(~on_x | (rng.uniform(size=n) < 0.3),
                      rng.integers(0, h, n) * res + near[:, 1], oy)
    if kind in ("edges", "axes"):
        ox = np.clip(ox, 0.0, w * res - 1e-3)
        oy = np.clip(oy, 0.0, h * res - 1e-3)
    if kind == "axes":
        ang = rng.choice(AXES, n)
    if kind == "walls":
        wall = np.argwhere(m.occ.cpu().numpy())
        pick = wall[rng.integers(0, len(wall), n)]
        u = rng.uniform(0.0, 1.0, (n, 2))
        ox, oy = (pick[:, 1] + u[:, 0]) * res, (pick[:, 0] + u[:, 1]) * res
    elif kind == "off_map":
        side = rng.uniform(size=n) < 0.5
        far = rng.uniform(size=n) < 0.5
        u = rng.uniform(0.01, 0.5, n)
        ox = np.where(side, np.where(far, w * res + u, -u), ox)
        oy = np.where(~side, np.where(far, h * res + u, -u), oy)
    elif kind in ("cloud", "invalid"):
        p = _free_poses(m, n, rng)
        ox, oy, ang = p[:, 0], p[:, 1], p[:, 2]
    return ox, oy, ang


def rays(m, n: int, kind: str, seed: int = 0):
    """Ray origins and angles, float32 numpy [n] each."""
    ox, oy, ang = _origins(kind, m, n, np.random.default_rng(seed))
    return (ox.astype(np.float32), oy.astype(np.float32),
            ang.astype(np.float32))


def particles(m, n: int, kind: str, seed: int = 0,
              laser_offset: float = 0.1):
    """Poses [n, 3] float32 numpy whose ray origins, laser_offset ahead,
    are of the given kind (for "edges" and "axes" the heading is along an
    axis, so the origin stays on or near its pixel edge)."""
    rng = np.random.default_rng(seed)
    if kind == "cloud":
        centre = _free_poses(m, 1 + n // 50, rng)
        p = centre[rng.integers(0, len(centre), n)] + rng.normal(
            0.0, [0.15, 0.15, 0.2], (n, 3))
        return p.astype(np.float32)
    if kind == "invalid":
        wall = np.argwhere(m.occ_dilated.cpu().numpy())
        pick = wall[rng.integers(0, len(wall), n)]
        u = rng.uniform(0.0, 1.0, (n, 2))
        p = np.stack([(pick[:, 1] + u[:, 0]) * m.resolution,
                      (pick[:, 0] + u[:, 1]) * m.resolution,
                      rng.uniform(-math.pi, math.pi, n)], -1)
        off = rng.uniform(size=n) < 0.2
        p[off, 0] = -p[off, 0] - 0.05
        return p.astype(np.float32)
    ox, oy, ang = _origins(kind, m, n, rng)
    th = rng.choice(AXES, n) if kind in ("edges", "axes") else ang
    return np.stack([ox - laser_offset * np.cos(th),
                     oy - laser_offset * np.sin(th), th], -1).astype(
        np.float32)


def beam_table(nb: int):
    """nb beam angles (float32 radians): every axis direction and the rest
    evenly over +-118 degrees."""
    axes = np.array([0.0, 90.0, -90.0, 180.0])
    rest = np.linspace(-118.0, 118.0, nb - len(axes))
    return np.deg2rad(np.concatenate([axes, rest])).astype(np.float32)


def scan_arrays(nb: int, episodes: int, seed: int = 0,
                max_range: float = 1.0):
    """(ranges, mask) numpy [episodes, nb]: ranges over [0, 1.1 max_range]
    with a tenth at exactly max_range, a tenth of the beams masked."""
    rng = np.random.default_rng(seed)
    ranges = rng.uniform(0.0, 1.1 * max_range, (episodes, nb))
    ranges[rng.uniform(size=ranges.shape) < 0.1] = max_range
    mask = rng.uniform(size=ranges.shape) > 0.1
    return ranges.astype(np.float32), mask


def as_tensor(a, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
