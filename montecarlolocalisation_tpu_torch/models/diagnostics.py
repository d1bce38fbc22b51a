"""Auxiliary estimators and diagnostics from the reference's variant files,
in plain torch (montecarlolocalisation_tpu/models/diagnostics.py).

  * weighted-mean pose       estimateWeightedPose (monte_carlo.cpp:782-800,
                             defined but never called in the reference)
  * pairwise-density ratio   playground.cpp's O(N^2) lost detector
                             (playground.cpp:745-774), in blocks
  * max-weight confidence    localisationConfinent (playground.cpp:812-855)
  * Bresenham line of sight  isPathValid (playground.cpp:288-320)

Nothing on the filter's path runs them.
"""
from __future__ import annotations

import torch

from ..maps.grid import MazeMap, lookup, world_to_map
from ..utils.angles import circular_mean


def weighted_mean_pose(particles, weights):
    """Weight-averaged (x, y) and the weighted circular mean of theta
    (monte_carlo.cpp:782-800)."""
    w = weights / torch.clamp(torch.sum(weights), min=1e-30)
    x = torch.sum(w * particles[:, 0])
    y = torch.sum(w * particles[:, 1])
    theta = circular_mean(particles[:, 2], weights=w)
    return torch.stack([x, y, theta])


def pairwise_density_ratio(particles, radius: float = 0.4,
                           block: int = 1024):
    """The share of particle pairs within `radius` of each other
    (playground.cpp:745-774), counted `block` rows at a time so that no
    [N, N] matrix is made."""
    xy = particles[:, :2]
    n = xy.shape[0]
    r2 = radius * radius
    total = torch.zeros((), dtype=torch.float32, device=xy.device)
    for i in range(0, n, block):
        d2 = torch.sum((xy[i:i + block, None, :] - xy[None, :, :]) ** 2,
                       dim=-1)
        total = total + torch.sum((d2 <= r2).to(torch.float32))
    return total / (float(n) * n)


def max_weight_confidence(particles, weights, radius: float = 0.4):
    """The share of particles within `radius` of the single max-weight
    particle (playground.cpp:812-855), and that particle's pose."""
    best = torch.argmax(weights)
    bx, by = particles[best, 0], particles[best, 1]
    d2 = (particles[:, 0] - bx) ** 2 + (particles[:, 1] - by) ** 2
    ratio = torch.mean((d2 <= radius * radius).to(torch.float32))
    return ratio, particles[best]


def bresenham_path_valid(m: MazeMap, x0, y0, x1, y1, max_steps: int = 128):
    """Integer Bresenham line of sight between two world points
    (playground.cpp:288-320 isPathValid): True where both ends are on the
    map, the line reaches its end within `max_steps` pixels and no wall
    pixel lies on it.  Broadcasts over its inputs."""
    def f32(v):
        return torch.as_tensor(v, dtype=torch.float32, device=m.device)

    ax, ay, a_in = world_to_map(m, f32(x0), f32(y0))
    bx, by, b_in = world_to_map(m, f32(x1), f32(y1))
    ax, ay, bx, by = torch.broadcast_tensors(ax, ay, bx, by)
    dx = torch.abs(bx - ax)
    dy = -torch.abs(by - ay)
    sx = torch.where(ax < bx, 1, -1).to(torch.int32)
    sy = torch.where(ay < by, 1, -1).to(torch.int32)
    cx, cy, err = ax, ay, dx + dy
    blocked = torch.zeros(ax.shape, dtype=torch.bool, device=m.device)
    done = torch.zeros_like(blocked)
    w1, h1 = m.width - 1, m.height - 1
    for _ in range(max_steps):
        # The reference's getCell clamps; the caller masks off-map ends.
        blocked = blocked | lookup(m.occ, cx.clamp(0, w1), cy.clamp(0, h1),
                                   m.episode_maps)
        done = done | ((cx == bx) & (cy == by))
        e2 = 2 * err
        step_x = (e2 >= dy) & ~done
        step_y = (e2 <= dx) & ~done
        err = err + torch.where(step_x, dy, 0) + torch.where(step_y, dx, 0)
        cx = cx + torch.where(step_x, sx, 0)
        cy = cy + torch.where(step_y, sy, 0)
    return a_in & b_in & done & ~blocked
