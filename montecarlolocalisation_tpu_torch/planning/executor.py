"""Plan execution: cell paths -> direction actions -> drive targets.

Torch-port copy of montecarlolocalisation_tpu/planning/executor.py (plain
Python).

Reference semantics reproduced:
  * direction codes RIGHT=0, UP=1, LEFT=2, DOWN=3 (msg/Pose.msg), with the
    y-down convention: UP decreases y/row, DOWN increases
    (execute_plan_server.cpp:266-333).
  * directionToAngle (:266-274): RIGHT=0, UP=-90deg, LEFT=180deg, DOWN=+90deg.
  * getVectorToNextCell (:290-339): if the pose is off the 0.4 m grid
    lattice, first emit a snap-correction to the nearest cell-size multiple;
    otherwise move one cell (0.8 m) along the direction.
  * the local drive target is the world vector rotated into the robot frame
    by the best-estimate heading (:482-484).
  * waypoint-follow executor (moveToPosition_server.cpp:564-606): drive
    cell-center to cell-center on /exact_pose feedback with 0.2 m arrival
    tolerance, abort on the (-1,-1) delocalized sentinel.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Sequence, Tuple

from ..config import DIR_RIGHT, DIR_UP, DIR_LEFT, DIR_DOWN

_STEP = {DIR_RIGHT: (0.8, 0.0), DIR_UP: (0.0, -0.8),
         DIR_LEFT: (-0.8, 0.0), DIR_DOWN: (0.0, 0.8)}


def direction_to_angle(direction: int) -> float:
    """directionToAngle (execute_plan_server.cpp:266-274), radians."""
    return {DIR_RIGHT: 0.0, DIR_UP: -math.pi / 2.0, DIR_LEFT: math.pi,
            DIR_DOWN: math.pi / 2.0}[int(direction)]


def rotate_to_dir(direction: int, cur_theta: float) -> float:
    """Rotation needed to face `direction` (:276-284), normalized."""
    err = direction_to_angle(direction) - cur_theta
    return math.atan2(math.sin(err), math.cos(err))


def path_to_actions(path: Sequence[Tuple[int, int]]) -> List[int]:
    """Cell path -> direction codes (inverse of the BFS deltas).

    (r, c) -> (r, c+1) = RIGHT; (r-1, c) = UP; etc.
    """
    actions = []
    for (r0, c0), (r1, c1) in zip(path, path[1:]):
        delta = (r1 - r0, c1 - c0)
        code = {(0, 1): DIR_RIGHT, (-1, 0): DIR_UP, (0, -1): DIR_LEFT,
                (1, 0): DIR_DOWN}.get(delta)
        if code is None:
            raise ValueError(f"non-adjacent path step {delta}")
        actions.append(code)
    return actions


@dataclasses.dataclass(frozen=True)
class DriveTarget:
    """One executor step: a world-frame move plus bookkeeping."""

    dx: float
    dy: float
    distance: float
    target_x: float
    target_y: float
    is_snap: bool  # grid-snap correction, not a cell move


def vector_to_next_cell(x: float, y: float, direction: int,
                        cell_size: float = 0.8) -> DriveTarget:
    """getVectorToNextCell (execute_plan_server.cpp:290-339)."""
    half = cell_size / 2.0

    def is_multiple(v: float) -> bool:
        m = math.fmod(v, half)
        return m < 1e-4 or m > half - 1e-4

    if not is_multiple(x) or not is_multiple(y):
        cx = round(x / cell_size) * cell_size
        cy = round(y / cell_size) * cell_size
        dx, dy = cx - x, cy - y
        return DriveTarget(dx=dx, dy=dy, distance=math.hypot(dx, dy),
                           target_x=cx, target_y=cy, is_snap=True)
    sx, sy = _STEP[int(direction)]
    return DriveTarget(dx=sx, dy=sy, distance=cell_size,
                       target_x=x + sx, target_y=y + sy, is_snap=False)


def world_to_local(dx: float, dy: float, theta: float) -> Tuple[float, float]:
    """Rotate a world vector into the robot frame (:482-484)."""
    c, s = math.cos(theta), math.sin(theta)
    return c * dx + s * dy, -s * dx + c * dy


def plan_step_command(x_best: float, y_best: float, theta_best: float,
                      cur_dir: int, next_dir: int) -> dict:
    """One execute_plan action -> the local drive request the reference
    would issue (execute_plan_server.cpp:471-520 AVF branch).

    Returns dict(local_x, local_y, degree, diff): the PID/APF service call
    arguments (local +-0.8 moves chosen by the direction diff) plus the
    rotation-to-face in degrees.
    """
    theta_best = math.atan2(math.sin(theta_best), math.cos(theta_best))
    angle_deg = math.degrees(rotate_to_dir(next_dir, theta_best))
    diff = next_dir - cur_dir
    if diff in (-2, 2):
        local = (-0.8, 0.0) if diff == -2 else (0.8, 0.0)
    elif diff in (-1, 3):
        local = (0.0, 0.8)
    elif diff in (1, -3):
        local = (0.0, -0.8)
    else:  # same direction
        local = (0.8, 0.0)
    return dict(local_x=local[0], local_y=local[1], degree=angle_deg,
                diff=diff)


def generate_subgoals(start_xy: Tuple[float, float], plan: Sequence[int],
                      cell_size: float = 0.8) -> List[Tuple[float, float]]:
    """Compress a RIGHT/UP/LEFT/DOWN plan into straight-segment waypoints
    (avf.cpp:187-222 generateSubgoals).

    Runs of the same direction collapse into ONE waypoint at the segment
    end, so the APF drives long straights instead of cell-by-cell; a U-turn
    (opposite direction after a single step) still emits the intermediate
    waypoint, exactly like the reference's run-length loop.  The reference's
    avf node uses a y-up world frame (UP: y += n*cell); this repo's maze
    world is y-down (cell_center: y from row), so UP maps to -y here —
    same compression semantics, flipped vertical sign.
    """
    goals: List[Tuple[float, float]] = []
    if len(plan) == 0:
        return goals
    units = {DIR_RIGHT: (1.0, 0.0), DIR_UP: (0.0, -1.0),
             DIR_LEFT: (-1.0, 0.0), DIR_DOWN: (0.0, 1.0)}
    x, y = float(start_xy[0]), float(start_xy[1])
    cur = int(plan[0])
    count = 1
    for d in list(plan[1:]):
        d = int(d)
        if d == cur:
            count += 1
        else:
            ux, uy = units[cur]
            x += ux * count * cell_size
            y += uy * count * cell_size
            goals.append((x, y))
            cur = d
            count = 1
    ux, uy = units[cur]
    x += ux * count * cell_size
    y += uy * count * cell_size
    goals.append((x, y))
    return goals


def cell_center(row: int, col: int, cell_size: float = 0.8):
    return (col * cell_size + 0.5 * cell_size,
            row * cell_size + 0.5 * cell_size)


def waypoint_targets(path: Sequence[Tuple[int, int]],
                     cell_size: float = 0.8) -> List[Tuple[float, float]]:
    """Cell path -> world waypoints (moveToPosition_server.cpp:574-575;
    x from column, y from row)."""
    return [cell_center(r, c, cell_size) for r, c in path]
