"""Ground-truth robot simulator: diff-drive dynamics + synthetic sensor logs.

Torch counterpart of montecarlolocalisation_tpu/sim/robot.py.  Wheel arcs
integrate through the midpoint diff-drive kinematics the filter assumes
(monte_carlo.cpp:719-739), encoders accumulate radians (arc = delta *
wheel_size * 0.5), and scans come from the filter's own ray caster
(models/sensor.simulate_scan).

Every robot quantity has a leading [E]: the wander is a Python loop over
ticks that advances E robots at once.  Its random numbers are an argument
(WanderDraws), so a caller can replay another implementation's exact
draws; `draw_wander` makes them from a torch.Generator.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config import FilterConfig, MotionModelConfig
from ..maps.grid import MazeMap, f32_reciprocal
from ..models import sensor
from ..models.raycast import raycast
from ..utils.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class RobotState:
    """Ground-truth poses + cumulative encoder readings (radians), [E]."""

    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor
    encoder_left: torch.Tensor
    encoder_right: torch.Tensor

    @property
    def pose(self):
        return torch.stack([self.x, self.y, self.theta], dim=-1)


def make_robot(x, y, theta, batch: int = 1, device="cpu") -> RobotState:
    """`batch` robots at one pose, encoders at zero."""
    def full(v):
        return torch.full((batch,), float(v), dtype=torch.float32,
                          device=device)

    return RobotState(x=full(x), y=full(y), theta=full(theta),
                      encoder_left=full(0.0), encoder_right=full(0.0))


def step_dynamics(state: RobotState, d_left, d_right,
                  cfg: MotionModelConfig) -> RobotState:
    """Advance the truth by per-wheel arc lengths (meters).  Encoder
    radians accumulate so that the filter's delta * wheel_size * 0.5
    recovers the arcs."""
    d_center = 0.5 * (d_left + d_right)
    delta_theta = (d_left - d_right) * f32_reciprocal(cfg.wheel_space)
    x = state.x + d_center * torch.cos(state.theta + 0.5 * delta_theta)
    y = state.y + d_center * torch.sin(state.theta + 0.5 * delta_theta)
    theta = normalize_angle(state.theta + delta_theta)
    inv_tick = f32_reciprocal(cfg.wheel_size * 0.5)
    return RobotState(
        x=x, y=y, theta=theta,
        encoder_left=state.encoder_left + d_left * inv_tick,
        encoder_right=state.encoder_right + d_right * inv_tick)


def wheel_arcs_from_speeds(speed_left, speed_right, dt,
                           cfg: MotionModelConfig):
    """Wheel angular velocities (rad/s, the create_fundamentals
    convention) -> arc meters per tick: omega * dt * wheel_size * 0.5
    (wanderer_try_final.cpp:63-78)."""
    k = dt * cfg.wheel_size * 0.5
    return speed_left * k, speed_right * k


@dataclasses.dataclass(frozen=True)
class WanderDraws:
    """The random numbers of a wander, [E, T, ...]: each tick's scan draws
    (sensor.ScanDraws fields, [E, T, B]), the wheel-slip normals [E, T, 2],
    and, with `explore`, the turn-side tie-break normals [E, T] and turn
    durations [E, T].  Fields a wander does not read are None."""

    scan: sensor.ScanDraws
    slip: Optional[torch.Tensor] = None
    tie: Optional[torch.Tensor] = None
    dur: Optional[torch.Tensor] = None


def draw_wander(gen: torch.Generator, batch: int, num_ticks: int,
                num_beams: int, device, turn_ticks: int = 10,
                dropout_p: float = 0.0, outlier_p: float = 0.0,
                slip_noise: float = 0.0,
                explore: bool = False) -> WanderDraws:
    """A wander's draws from `gen`; the stressors that are off draw
    nothing."""
    et = (batch, num_ticks)
    scan = sensor.draw_scan(gen, et + (num_beams,), device, dropout_p,
                            outlier_p)
    slip = (torch.randn(et + (2,), generator=gen, device=device)
            if slip_noise else None)
    tie = dur = None
    if explore:
        tie = torch.randn(et, generator=gen, device=device)
        dur = torch.randint(max(turn_ticks // 2, 1), 2 * turn_ticks + 1, et,
                            generator=gen, device=device)
    return WanderDraws(scan=scan, slip=slip, tie=tie, dur=dur)


def _tick_scan_draws(d: sensor.ScanDraws, t: int) -> sensor.ScanDraws:
    return sensor.ScanDraws(**{
        f.name: (None if getattr(d, f.name) is None
                 else getattr(d, f.name)[:, t])
        for f in dataclasses.fields(d)})


def generate_wander_episode(
    gen: Optional[torch.Generator],
    m: MazeMap,
    cfg: FilterConfig,
    scan_angles,
    num_ticks: int,
    batch: int = 1,
    start_pose=(1.25, 1.25, 0.0),
    speed: float = 0.04,
    obstacle_stop: float = 0.4,
    turn_ticks: int = 10,
    scan_noise: float = 0.02,
    kidnap_tick=None,
    kidnap_pose=(0.45, 0.45, 0.0),
    dropout_p: float = 0.0,
    outlier_p: float = 0.0,
    moving_obstacle=None,
    slip_noise: float = 0.0,
    explore: bool = False,
    draws: Optional[WanderDraws] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Scripted wall-avoiding wander of `batch` robots -> (encoders
    [E, T, 2], scan ranges [E, T, B], poses [E, T, 3]) (robot.py:79).

    Drives straight `speed` m/tick; when the forward ray reports an
    obstacle within `obstacle_stop`, rotates in place ~90 degrees over
    `turn_ticks` ticks (wanderer_try_final.cpp:167-191).  Stressors, all
    off by default: `kidnap_tick` teleports the truth to `kidnap_pose`
    while the encoders integrate on; `dropout_p`/`outlier_p` per-beam
    sensor faults; `moving_obstacle` = (cx, cy, orbit_radius, disc_radius,
    rad_per_tick), an unmapped disc circling (cx, cy); `slip_noise`, the
    std of a per-tick multiplicative wheel slip that the encoders do not
    see.  `explore` turns toward the freer of the +-60 degree probe rays
    for a random duration instead of a fixed 90 degree turn.  Random
    numbers come from `draws`, or from `gen`."""
    dev = m.device
    angles = torch.as_tensor(scan_angles, dtype=torch.float32, device=dev)
    mcfg = cfg.motion
    if draws is None:
        draws = draw_wander(gen, batch, num_ticks, angles.shape[0], dev,
                            turn_ticks, dropout_p, outlier_p, slip_noise,
                            explore)
    turn_arc = (math.pi / 2) * mcfg.wheel_space / (2.0 * turn_ticks)
    inv_tick = f32_reciprocal(mcfg.wheel_size * 0.5)
    robot = make_robot(*start_pose, batch=batch, device=dev)
    turning = torch.zeros(batch, dtype=torch.int32, device=dev)
    tsign = torch.ones(batch, dtype=torch.float32, device=dev)
    encs, ranges, poses = [], [], []
    for tick in range(num_ticks):
        if kidnap_tick is not None and tick == kidnap_tick:
            robot = dataclasses.replace(
                robot, x=torch.full_like(robot.x, kidnap_pose[0]),
                y=torch.full_like(robot.y, kidnap_pose[1]),
                theta=torch.full_like(robot.theta, kidnap_pose[2]))
        ahead = raycast(m, robot.x, robot.y, robot.theta, cfg.sensor)
        start_turn = (ahead < obstacle_stop) & (turning == 0)
        if explore:
            free_l = raycast(m, robot.x, robot.y, robot.theta + math.pi / 3,
                             cfg.sensor)
            free_r = raycast(m, robot.x, robot.y, robot.theta - math.pi / 3,
                             cfg.sensor)
            tie = 0.05 * draws.tie[:, tick]
            new_sign = torch.where(free_l + tie > free_r, 1.0, -1.0)
            dur = draws.dur[:, tick].to(torch.int32)
        else:
            new_sign = torch.ones_like(tsign)
            dur = torch.full_like(turning, turn_ticks)
        tsign = torch.where(start_turn, new_sign, tsign)
        turning = torch.where(start_turn, dur, turning)
        is_turning = turning > 0
        d_left = torch.where(is_turning, tsign * turn_arc, speed)
        d_right = torch.where(is_turning, -tsign * turn_arc, speed)
        if slip_noise:
            eps = slip_noise * draws.slip[:, tick]
            enc_l, enc_r = robot.encoder_left, robot.encoder_right
            robot = step_dynamics(robot, d_left * (1.0 + eps[:, 0]),
                                  d_right * (1.0 + eps[:, 1]), mcfg)
            # The encoders record the COMMANDED arcs: the wheel turned as
            # commanded and the ground contact slipped.
            robot = dataclasses.replace(
                robot, encoder_left=enc_l + d_left * inv_tick,
                encoder_right=enc_r + d_right * inv_tick)
        else:
            robot = step_dynamics(robot, d_left, d_right, mcfg)
        turning = torch.clamp(turning - 1, min=0)
        obstacle = None
        if moving_obstacle is not None:
            ocx, ocy, orbit_r, disc_r, omega = moving_obstacle
            phase = torch.tensor(omega, dtype=torch.float32) * float(tick)
            obstacle = (ocx + orbit_r * torch.cos(phase).to(dev),
                        ocy + orbit_r * torch.sin(phase).to(dev), disc_r)
        scan = sensor.simulate_scan(
            m, robot.pose, angles, cfg.sensor, noise_sigma=scan_noise,
            dropout_p=dropout_p, outlier_p=outlier_p, obstacle=obstacle,
            draws=_tick_scan_draws(draws.scan, tick))
        encs.append(torch.stack([robot.encoder_left, robot.encoder_right],
                                dim=-1))
        ranges.append(scan.ranges)
        poses.append(robot.pose)
    return (torch.stack(encs, dim=1), torch.stack(ranges, dim=1),
            torch.stack(poses, dim=1))
