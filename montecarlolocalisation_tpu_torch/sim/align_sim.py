"""End-to-end wall alignment in simulation: the align_call service flow.

Torch counterpart of montecarlolocalisation_tpu/sim/align_sim.py.
Reference flow (align_server.cpp laserCallback + align:758-798): scan ->
RANSAC lines -> faceWall/driveFromWall timed motions.  Here the same
pipeline closes through the simulated dynamics of one robot on the map's
device: simulate a full-circle scan from the true pose, extract walls,
build the AlignPlan, and execute its rotate/drive actions tick by tick.

Host-driven, as in the JAX package (the service is a one-shot behavior,
not the filter's tick): its loops read the scan and each action's end on
the host and run eagerly.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig, FilterConfig
from ..control import align, timed
from ..maps.grid import MazeMap
from ..models import sensor
from . import robot as R


def full_circle_scan(m: MazeMap, pose, cfg: FilterConfig, n_beams: int = 360):
    """Simulate a 360-degree scan and return robot-frame points (numpy).

    simulate_scan casts beam a along world angle theta - a (the reference's
    negated-mount convention), so the return lies at robot-frame angle -a:
    convert with negated angles to stay in the physical robot frame.
    """
    angles = np.linspace(-np.pi, np.pi, n_beams, endpoint=False).astype(
        np.float32)
    scan = sensor.simulate_scan(m, pose, angles, cfg.sensor)
    r = scan.ranges.cpu().numpy()
    # Returns at max_range are non-returns for RANSAC purposes.
    mask = r < cfg.sensor.max_range - 1e-4
    px = r * np.cos(-angles)
    py = r * np.sin(-angles)
    return px, py, mask


def _run_timed(rb, st, dt, mcfg, max_ticks):
    """Execute one timed rotate/drive action through the dynamics."""
    for _ in range(max_ticks):
        if bool(timed.is_done(st)):
            break
        st, (wl, wr), _ = timed.timed_tick(st)
        dl, dr = R.wheel_arcs_from_speeds(wl, wr, dt, mcfg)
        rb = R.step_dynamics(rb, dl, dr, mcfg)
    return rb


def _sector_scan(m: MazeMap, pose, cfg: FilterConfig, n_beams: int = 24):
    """Forward-sector scan in the wanderer's lane order (±118°)."""
    angles = np.deg2rad(np.linspace(-118.0, 118.0, n_beams)).astype(
        np.float32)
    scan = sensor.simulate_scan(m, pose, angles, cfg.sensor)
    return scan.ranges.cpu().numpy()


def run_align(m: MazeMap, cfg: FilterConfig, start_pose,
              acfg: AlignConfig = AlignConfig(), dt: float = 0.1,
              max_ticks_per_action: int = 400,
              max_explore_ticks: int = 300,
              avoid_thresh: float = 0.18,
              explore_speed: float = 5.0, seed: int = 0,
              draws: Optional[Sequence[Sequence]] = None,
              ) -> Tuple[R.RobotState, List[align.AlignAction]]:
    """Full align service: returns (final robot state, executed plan).

    When fewer than 2 RANSAC lines lock, the reference does NOT give up:
    it explores — forward at diff_drive 5/5 while the path is clear,
    `avoidObstacle(0.18)` (a π/3 timed rotation away from the fuller
    half, the wanderer's halves-compare rule) when blocked — re-running
    RANSAC every 10 Hz tick until two walls lock
    (align_server.cpp:779-793 + wanderer_try_final.cpp:153-191).  Same
    loop here through the simulated dynamics, budgeted by
    `max_explore_ticks`; an exhausted budget returns an empty plan.

    RANSAC's pair indices come from a generator seeded with `seed`, or
    from `draws`: draws[t] holds explore tick t's pairs, one (i1, i2) a
    RANSAC round (align.ransac_extract).
    """
    dev = m.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rb = R.make_robot(*start_pose, batch=None, device=dev)
    for tick in range(max_explore_ticks):
        px, py, mask = full_circle_scan(m, rb.pose, cfg)
        lines = align.ransac_extract(
            torch.as_tensor(px, device=dev), torch.as_tensor(py, device=dev),
            mask, acfg, gen=gen, pairs=None if draws is None else draws[tick])
        if len(lines) >= 2:
            break
        # Explore step (one 10 Hz tick): the threshold/halves decision
        # reads the forward sector (the reference's scan_filtered feed).
        r = _sector_scan(m, rb.pose, cfg)
        if float(np.min(r)) <= avoid_thresh:
            # avoidObstacle: π/3 rotation; sum1 >= sum2 -> ROTATE_RIGHT =
            # positive start_rotate angle (dL+, dR-) — the same
            # halves-compare convention as controllers.wanderer_tick
            # (wanderer_try_final.cpp:176-188).
            half = len(r) // 2
            direction = 1.0 if float(np.sum(r[:half])) >= float(
                np.sum(r[half:])) else -1.0
            st = timed.start_rotate(direction * np.pi / 3.0, explore_speed,
                                    dt, cfg.motion, device=dev)
            rb = _run_timed(rb, st, dt, cfg.motion, max_ticks_per_action)
        else:
            dl, dr = R.wheel_arcs_from_speeds(explore_speed, explore_speed,
                                              dt, cfg.motion)
            rb = R.step_dynamics(rb, dl, dr, cfg.motion)
    else:
        return rb, []
    plan = align.align_plan(lines[0], lines[1], acfg)
    for act in plan:
        if act.kind == "rotate":
            st = timed.start_rotate(np.deg2rad(act.value), abs(act.speed),
                                    dt, cfg.motion, device=dev)
        else:
            st = timed.start_drive(act.value, act.speed, dt, cfg.motion,
                                   device=dev)
        rb = _run_timed(rb, st, dt, cfg.motion, max_ticks_per_action)
    return rb, plan
