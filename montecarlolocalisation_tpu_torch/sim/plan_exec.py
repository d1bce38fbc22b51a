"""execute_plan-style navigation: direction-code plans via local-frame PID.

Torch counterpart of montecarlolocalisation_tpu/sim/plan_exec.py.  The
reference has TWO navigation paths: moveToPosition's global waypoint
follower (sim/closed_loop.py here) and execute_plan_server's local-frame
action executor — per action it computes the vector to the next cell,
rotates it into the robot frame by the pose estimate's heading, and issues
a PID/APF drive with the canonical +-0.8 m local target chosen by the
direction diff (execute_plan_server.cpp:450-560).  This module closes that
second path through the simulated dynamics of one robot (make_robot with
batch=None), on its tensors' device.  Host-driven, as in the JAX package:
each PID tick reads its `done` flag on the host, so these loops run eagerly
and are not captured.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from ..config import FilterConfig, PIDConfig
from ..control import controllers as C
from ..planning import executor
from ..utils.angles import quantize_orientation
from . import robot as R


def _run_pid(rb: R.RobotState, local_x: float, local_y: float,
             speed: float, cfg: FilterConfig,
             pid_cfg: PIDConfig = PIDConfig(), dt: float = 0.1,
             max_ticks: int = 400) -> R.RobotState:
    st = C.pid_start(local_x, local_y, speed, rb.encoder_left,
                     rb.encoder_right)
    for _ in range(max_ticks):
        st, (wl, wr), done = C.pid_tick(st, rb.encoder_left,
                                        rb.encoder_right, pid_cfg)
        if bool(done):
            break
        dl, dr = R.wheel_arcs_from_speeds(wl, wr, dt, cfg.motion)
        rb = R.step_dynamics(rb, dl, dr, cfg.motion)
    return rb


def _truth(rb: R.RobotState):
    return float(rb.x), float(rb.y), float(rb.theta)


def execute_plan(
    rb: R.RobotState, plan: Sequence[int], cfg: FilterConfig,
    speed: float = 6.0, pose_provider=None,
) -> Tuple[R.RobotState, List[Tuple[float, float]]]:
    """Run a RIGHT/UP/LEFT/DOWN action plan through local PID drives.

    pose_provider(rb) -> (x, y, theta) supplies the pose estimate per
    action (the reference reads x_best/theta_best from the MCL topics);
    default is ground truth.  Returns (final robot, per-action end poses).
    """
    trace: List[Tuple[float, float]] = []
    for next_dir in plan:
        x, y, th = (pose_provider or _truth)(rb)
        cur_dir = int(quantize_orientation(
            torch.tensor(th, dtype=torch.float32)))
        # NOTE: the reference computes getVectorToNextCell (including its
        # grid-snap correction) but the AVF/PID branches never DRIVE that
        # vector — motion uses only the canonical +-0.8 local targets
        # selected by the direction diff (execute_plan_server.cpp:471-520).
        # Executing the snap would bounce the robot to cell CORNERS
        # (round(x/0.8)*0.8), so it stays unexecuted here too.
        cmd = executor.plan_step_command(x, y, th, cur_dir, int(next_dir))
        rb = _run_pid(rb, cmd["local_x"], cmd["local_y"], speed, cfg)
        trace.append((float(rb.x), float(rb.y)))
    return rb, trace


def execute_plan_subgoals(
    rb: R.RobotState, plan: Sequence[int], cfg: FilterConfig,
    speed: float = 6.0, pose_provider=None, max_ticks: int = 1200,
) -> Tuple[R.RobotState, List[Tuple[float, float]]]:
    """Subgoal-compressed plan execution (avf.cpp:187-222 + :224-356).

    The reference's APF node first collapses the plan into straight-segment
    waypoints via generateSubgoals, then drives each subgoal with ONE local
    motion instead of cell-by-cell hops.  Here each compressed segment
    becomes one PID drive of the world-frame delta rotated into the robot
    frame (executor.world_to_local).  Returns (final robot, one trace entry
    PER SUBGOAL) — a 5-straight plan issues exactly one drive.
    """
    trace: List[Tuple[float, float]] = []
    pose_provider = pose_provider or _truth
    x, y, _ = pose_provider(rb)
    subgoals = executor.generate_subgoals((x, y), plan)
    for gx, gy in subgoals:
        x, y, th = pose_provider(rb)
        lx, ly = executor.world_to_local(gx - x, gy - y, th)
        rb = _run_pid(rb, lx, ly, speed, cfg, max_ticks=max_ticks)
        trace.append((float(rb.x), float(rb.y)))
    return rb, trace
