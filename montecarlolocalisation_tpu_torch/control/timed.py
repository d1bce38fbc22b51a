"""Timed open-loop motion primitives (rotate_degree / drive_distance).

Torch counterpart of montecarlolocalisation_tpu/control/timed.py.
Reference: wanderer_try_final.cpp:63-124 (also linked into PID/align/
execute_plan as `wanderer_lib`): rotation/drive durations derive from the
wheel kinematics omega = speed * (wheel_size/2) / (wheel_space/2) and
v = speed * wheel_size/2; the reference then BLOCKS in ros::Duration
sleeps.  Here each primitive is a tick-counted command stream.

drive_distance carries the obstacle abort of execute_plan_server.cpp:375-439
with the INTENDED min-range semantics.  (The reference's wandererThreshold1
at :358-368 compares `laser_data.size()/2` — the beam COUNT — to the 0.2 m
threshold, so its abort can never fire on a real scan; a preserved-bug
mode is available via `count_bug_compat=True`.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from ..config import MotionModelConfig

SONG_ABORT = 1  # failure song played on abort (execute_plan_server.cpp:404)


def rotate_ticks(angle_rad: float, speed: float, dt: float = 0.1,
                 cfg: MotionModelConfig = MotionModelConfig()) -> int:
    """Number of ticks for a timed in-place rotation
    (calculate_rotate_time, wanderer_try_final.cpp:63-72)."""
    omega = speed * (cfg.wheel_size / 2.0) / (cfg.wheel_space / 2.0)
    if omega == 0:
        return 0
    return max(int(math.ceil(abs(angle_rad) / omega / dt)), 0)


def drive_ticks(distance_m: float, speed: float, dt: float = 0.1,
                cfg: MotionModelConfig = MotionModelConfig()) -> int:
    """Ticks for a timed straight drive (calculate_drive_time :74-78)."""
    v = abs(speed) * cfg.wheel_size / 2.0
    if v == 0:
        return 0
    return max(int(math.ceil(abs(distance_m) / v / dt)), 0)


@dataclasses.dataclass(frozen=True)
class TimedState:
    ticks_left: torch.Tensor   # int32
    aborted: torch.Tensor      # bool
    wheel_left: torch.Tensor
    wheel_right: torch.Tensor


def _state(n: int, left: float, right: float, device) -> TimedState:
    return TimedState(
        ticks_left=torch.tensor(n, dtype=torch.int32, device=device),
        aborted=torch.tensor(False, device=device),
        wheel_left=torch.tensor(left, dtype=torch.float32, device=device),
        wheel_right=torch.tensor(right, dtype=torch.float32, device=device))


def start_rotate(angle_rad: float, speed: float, dt: float = 0.1,
                 cfg: MotionModelConfig = MotionModelConfig(),
                 device="cpu") -> TimedState:
    """Rotation command: positive angle turns 'right' (dL=+, dR=-),
    matching rotate_radian's Direction handling (:81-112)."""
    n = rotate_ticks(angle_rad, speed, dt, cfg)
    s = speed if angle_rad >= 0 else -speed
    return _state(n, s, -s, device)


def start_drive(distance_m: float, speed: float, dt: float = 0.1,
                cfg: MotionModelConfig = MotionModelConfig(),
                device="cpu") -> TimedState:
    """Straight drive; negative speed backs up (driveFromWall uses -5)."""
    return _state(drive_ticks(distance_m, speed, dt, cfg), speed, speed,
                  device)


def timed_tick(st: TimedState, scan_ranges=None, scan_mask=None,
               abort_range: float = 0.2,
               count_bug_compat: bool = False
               ) -> Tuple[TimedState, Tuple[torch.Tensor, torch.Tensor],
                          torch.Tensor]:
    """One tick -> (state, (wheel_l, wheel_r), song_event).

    The laser abort (ranges [..., B]) stops the drive and emits the
    failure song (execute_plan_server.cpp:398-411).
    """
    active = (st.ticks_left > 0) & ~st.aborted
    abort = torch.zeros_like(active)
    if scan_ranges is not None:
        if count_bug_compat:
            # Preserved reference bug: 'min_range' = beam count / 2.
            abort = active & (scan_ranges.shape[-1] // 2 <= abort_range)
        else:
            r = scan_ranges if scan_mask is None else torch.where(
                scan_mask, scan_ranges, 9.99)
            abort = active & (torch.amin(r, dim=-1) <= abort_range)
    aborted = st.aborted | abort
    run = active & ~abort
    left = torch.where(run, st.wheel_left, 0.0)
    right = torch.where(run, st.wheel_right, 0.0)
    ticks = torch.where(run, st.ticks_left - 1, st.ticks_left)
    song = torch.where(abort, SONG_ABORT, 0).to(torch.int32)
    return (dataclasses.replace(st, ticks_left=ticks, aborted=aborted),
            (left, right), song)


def is_done(st: TimedState):
    return (st.ticks_left <= 0) | st.aborted
