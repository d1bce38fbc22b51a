"""The traffic generator: robots wandering the maze, with their encoder
and LIDAR logs, in plain torch on the device.

Each robot starts at its own pose (a random cell, an offset of up to
`start_offset` in it, a random heading), drives straight at `speed` m a
tick and, when the ray straight ahead meets a wall within `obstacle_stop`,
turns in place toward the freer of the +-60 degree probe rays for a
random number of ticks.  Encoders accumulate wheel radians as the filter
expects them (arc = delta * wheel_size / 2).  With `slip`, each wheel's
arc on the ground is the commanded arc times (1 + slip N(0, 1)): the robot
moves by the slipped arcs while the encoders record the commanded ones
(the encoders lie), and the LIDAR casts from the true pose; the slip's
normals are drawn after every other draw, so a log without slip is the
same with or without the option.  Every tick's scan is the
exact ray cast from the laser, 0.1 m ahead, along the negated beam angles,
plus Gaussian range noise, clamped to [0, max_range].  The same seed gives
the same logs on the same device.

`wander` is the scripted explorer of the reference robot's wanderer
(wanderer_try_final.cpp), the same tick as the program's simulator with
its explore option, restated so that the benchmark's traffic cannot move
with the program.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .reference import caster
from .reference.caster import recip
from .reference.maze import Maze


@dataclasses.dataclass(frozen=True)
class Wander:
    speed: float = 0.04
    obstacle_stop: float = 0.4
    turn_ticks: int = 10
    scan_noise: float = 0.02
    start_offset: float = 0.2
    slip: float = 0.0


class Walls:
    """The raster's wall pixels as a few axis-aligned rectangles (pixel
    units), for the exact first hit of many rays in a few launches: each
    ray against every rectangle at once (the slab test), the nearest
    kept.  A pixel is the square [mx, mx + 1) x [my, my + 1)."""

    def __init__(self, mz: Maze):
        occ = mz.occ.cpu().numpy().astype(bool)
        seen = np.zeros_like(occ)
        rects = []
        h, w = occ.shape
        for y in range(h):
            for x in range(w):
                if not occ[y, x] or seen[y, x]:
                    continue
                x1 = x
                while x1 + 1 < w and occ[y, x1 + 1] and not seen[y, x1 + 1]:
                    x1 += 1
                y1 = y
                while y1 + 1 < h and occ[y1 + 1, x:x1 + 1].all() and not \
                        seen[y1 + 1, x:x1 + 1].any():
                    y1 += 1
                seen[y:y1 + 1, x:x1 + 1] = True
                rects.append((x, x1 + 1, y, y1 + 1))
        r = torch.tensor(rects, dtype=torch.float32, device=mz.device)
        self.x0, self.x1, self.y0, self.y1 = r.unbind(-1)
        self.mz = mz

    def cast(self, ox, oy, angle, sensor: dict):
        """First-hit distance (m) from (ox, oy) along `angle`, broadcast;
        max_range when nothing is hit within it or the origin is off the
        map."""
        mz = self.mz
        ox, oy, angle = torch.broadcast_tensors(ox, oy, angle)
        smax = sensor["max_range"] / mz.resolution
        inv = recip(mz.resolution)
        gx, gy = (ox * inv)[..., None], (oy * inv)[..., None]
        dx, dy = torch.cos(angle)[..., None], torch.sin(angle)[..., None]
        eps = caster.EPS

        def slab(g, d, lo, hi):
            small = torch.abs(d) < eps
            inv_d = 1.0 / torch.where(small, eps, d)
            a, b = (lo - g) * inv_d, (hi - g) * inv_d
            inside = (g >= lo) & (g < hi)
            t0 = torch.where(small, torch.where(inside, -caster.INF,
                                                caster.INF),
                             torch.minimum(a, b))
            t1 = torch.where(small, torch.where(inside, caster.INF,
                                                -caster.INF),
                             torch.maximum(a, b))
            return t0, t1

        tx0, tx1 = slab(gx, dx, self.x0, self.x1)
        ty0, ty1 = slab(gy, dy, self.y0, self.y1)
        t_in = torch.maximum(tx0, ty0)
        t_out = torch.minimum(tx1, ty1)
        hit = (t_in < t_out) & (t_out > 0)
        s = torch.where(hit, torch.clamp(t_in, min=0.0), smax).amin(-1)
        s = torch.clamp(s, max=smax)
        inb = (ox >= 0) & (oy >= 0) & (ox * inv < mz.width) & (
            oy * inv < mz.height)
        return torch.where(inb, s, smax) * mz.resolution


def seeds(seed: int, n: int) -> list:
    """n independent 32-bit seeds derived from a run's seed."""
    return [int(v) for v in np.random.SeedSequence(int(seed)).generate_state(
        n, dtype=np.uint32)]


def start_poses(gen, mz: Maze, robots: int, offset: float):
    """[E, 3] poses: a random cell's center, +-offset in x and y, a
    heading in [-pi, pi)."""
    dev = mz.device
    e = (robots,)
    rows = torch.randint(0, mz.n_rows, e, generator=gen, device=dev)
    cols = torch.randint(0, mz.n_cols, e, generator=gen, device=dev)
    u = torch.rand((robots, 3), generator=gen, device=dev)
    cm = mz.cell_meters
    x = cols.to(torch.float32) * cm + 0.5 * cm + offset * (2 * u[:, 0] - 1)
    y = rows.to(torch.float32) * cm + 0.5 * cm + offset * (2 * u[:, 1] - 1)
    return torch.stack([x, y, math.pi * (2 * u[:, 2] - 1)], dim=-1)


def draws(gen, robots: int, ticks: int, beams: int, turn_ticks: int,
          device) -> dict:
    """The wander's random numbers: range noise [E, T, B], the turn
    side's tie-break normals [E, T] and turn lengths [E, T]."""
    et = (robots, ticks)
    return dict(
        noise=torch.randn(et + (beams,), generator=gen, device=device),
        tie=torch.randn(et, generator=gen, device=device),
        dur=torch.randint(max(turn_ticks // 2, 1), 2 * turn_ticks + 1, et,
                          generator=gen, device=device))


def wander(mz: Maze, angles, sensor: dict, motion: dict, start, d: dict,
           w: Wander, cast=None):
    """Robots from `start` [E, 3] over the draws' T ticks -> (encoders
    [E, T, 2], ranges [E, T, B], poses [E, T, 3]).  `sensor` gives the
    max range, laser offset and beam sign; `cast(mz, ox, oy, angle,
    sensor)` casts the rays (default: the reference's caster of the
    sensor's ray_mode); d["slip"] [E, T, 2], where w.slip is set, the
    wheels' slip normals."""
    cast = cast or caster.cast
    dev = mz.device
    angles = angles.to(dev)
    e, t_len = d["tie"].shape
    x, y, th = (v.clone() for v in start.to(dev).unbind(-1))
    enc_l = torch.zeros(e, device=dev)
    enc_r = torch.zeros(e, device=dev)
    turning = torch.zeros(e, dtype=torch.int32, device=dev)
    tsign = torch.ones(e, device=dev)
    turn_arc = (math.pi / 2) * motion["wheel_space"] / (2.0 * w.turn_ticks)
    inv_tick = recip(motion["wheel_size"] * 0.5)
    sign = -1.0 if sensor["negate_beam_angle"] else 1.0

    def ray(theta):
        return cast(mz, x, y, theta, sensor)

    encs, ranges, poses = [], [], []
    for t in range(t_len):
        start_turn = (ray(th) < w.obstacle_stop) & (turning == 0)
        free_l = ray(th + math.pi / 3)
        free_r = ray(th - math.pi / 3)
        new_sign = torch.where(free_l + 0.05 * d["tie"][:, t] > free_r,
                               1.0, -1.0)
        tsign = torch.where(start_turn, new_sign, tsign)
        turning = torch.where(start_turn, d["dur"][:, t].to(torch.int32),
                              turning)
        is_turning = turning > 0
        d_left = torch.where(is_turning, tsign * turn_arc, w.speed)
        d_right = torch.where(is_turning, -tsign * turn_arc, w.speed)
        if w.slip:
            # The ground takes the slipped arcs; the encoders, below,
            # record the commanded ones.
            g_left = d_left * (1.0 + w.slip * d["slip"][:, t, 0])
            g_right = d_right * (1.0 + w.slip * d["slip"][:, t, 1])
        else:
            g_left, g_right = d_left, d_right
        d_center = 0.5 * (g_left + g_right)
        d_theta = (g_left - g_right) * recip(motion["wheel_space"])
        x = x + d_center * torch.cos(th + 0.5 * d_theta)
        y = y + d_center * torch.sin(th + 0.5 * d_theta)
        th = torch.atan2(torch.sin(th + d_theta), torch.cos(th + d_theta))
        enc_l = enc_l + d_left * inv_tick
        enc_r = enc_r + d_right * inv_tick
        turning = torch.clamp(turning - 1, min=0)
        off = sensor["laser_offset"]
        expected = cast(
            mz, (x + off * torch.cos(th))[:, None],
            (y + off * torch.sin(th))[:, None],
            th[:, None] + sign * angles, sensor)
        ranges.append(torch.clamp(
            expected + w.scan_noise * d["noise"][:, t], 0.0,
            sensor["max_range"]))
        encs.append(torch.stack([enc_l, enc_r], dim=-1))
        poses.append(torch.stack([x, y, th], dim=-1))
    return (torch.stack(encs, dim=1), torch.stack(ranges, dim=1),
            torch.stack(poses, dim=1))


def logs(seed: int, mz: Maze, angles, sensor: dict, motion: dict,
         robots: int, ticks: int, w: Wander = Wander()):
    """Every robot's log for a run's seed: (encoders [E, T, 2], ranges
    [E, T, B], true poses [E, T, 3]), every ray cast exactly (Walls)
    whatever the filter casts with."""
    gen = _generator(seed, mz)
    start = start_poses(gen, mz, robots, w.start_offset)
    d = draws(gen, robots, ticks, angles.shape[0], w.turn_ticks, mz.device)
    if w.slip:
        d["slip"] = torch.randn((robots, ticks, 2), generator=gen,
                                device=mz.device)
    walls = Walls(mz)
    return wander(mz, angles, sensor, motion, start, d, w,
                  cast=lambda _mz, ox, oy, a, s: walls.cast(ox, oy, a, s))


def _generator(seed: int, mz: Maze):
    gen = torch.Generator(device=mz.device)
    gen.manual_seed(seeds(seed, 1)[0])
    return gen


def starts(seed: int, mz: Maze, robots: int, w: Wander = Wander()):
    """[E, 3] the poses the robots of `logs(seed, ...)` start from, before
    their first tick."""
    return start_poses(_generator(seed, mz), mz, robots, w.start_offset)
