"""Ground-truth robot simulator: diff-drive dynamics + synthetic sensor logs.

Torch counterpart of montecarlolocalisation_tpu/sim/robot.py.  Wheel arcs
integrate through the midpoint diff-drive kinematics the filter assumes
(monte_carlo.cpp:719-739), encoders accumulate radians (arc = delta *
wheel_size * 0.5), and scans come from the filter's own ray caster
(models/sensor.simulate_scan).

The wander's robots have a leading [E]: it advances E robots at
once, a tick at a time (`_wander_tick`), in CUDA graphs of
models/compiled.TICKS_PER_GRAPH ticks (the JAX package runs its wander
under jit).  Its random numbers are an argument (WanderDraws), so a caller
can replay another implementation's exact draws; `draw_wander` makes them
from a torch.Generator.  What changes by the tick (the draws, the kidnap
and the moving obstacle's place) enters each tick as its slice of an
input slab.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config import FilterConfig, MotionModelConfig
from ..maps.grid import MazeMap, f32_reciprocal
from ..models import compiled, sensor
from ..models.raycast import raycast
from ..utils.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class RobotState:
    """Ground-truth poses + cumulative encoder readings (radians), [E] or
    0-d for one robot."""

    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor
    encoder_left: torch.Tensor
    encoder_right: torch.Tensor

    @property
    def pose(self):
        return torch.stack([self.x, self.y, self.theta], dim=-1)


def make_robot(x, y, theta, batch: Optional[int] = 1,
               device="cpu") -> RobotState:
    """`batch` robots at one pose, encoders at zero; batch=None is one
    robot of 0-d tensors, the JAX package's robot."""
    shape = () if batch is None else (batch,)

    def full(v):
        return torch.full(shape, float(v), dtype=torch.float32,
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


@dataclasses.dataclass(frozen=True)
class _Wander:
    """A wander's static settings (hashable: a graph's key)."""

    speed: float
    obstacle_stop: float
    turn_ticks: int
    scan_noise: float
    kidnap_pose: tuple
    dropout_p: float
    outlier_p: float
    obstacle: Optional[tuple]     # (cx, cy, orbit radius, disc radius)
    slip_noise: float
    explore: bool


def _wander_tick(carry: dict, x: dict, consts: dict, m: MazeMap,
                 cfg: FilterConfig, w: _Wander):
    """One tick of E robots: carry holds the robots, their turn countdown
    and turn side; x the tick's draws (x["scan"], "slip", "tie", "dur"),
    its kidnap flag and the obstacle's cos/sin phase where those are on.
    Returns the carry and (encoders [E, 2], ranges [E, B], poses
    [E, 3])."""
    mcfg = cfg.motion
    turn_arc = (math.pi / 2) * mcfg.wheel_space / (2.0 * w.turn_ticks)
    inv_tick = f32_reciprocal(mcfg.wheel_size * 0.5)
    robot, turning, tsign = carry["robot"], carry["turning"], carry["tsign"]
    if "kidnap" in x:
        kid = x["kidnap"]
        robot = dataclasses.replace(
            robot, x=torch.where(kid, w.kidnap_pose[0], robot.x),
            y=torch.where(kid, w.kidnap_pose[1], robot.y),
            theta=torch.where(kid, w.kidnap_pose[2], robot.theta))
    ahead = raycast(m, robot.x, robot.y, robot.theta, cfg.sensor)
    start_turn = (ahead < w.obstacle_stop) & (turning == 0)
    if w.explore:
        free_l = raycast(m, robot.x, robot.y, robot.theta + math.pi / 3,
                         cfg.sensor)
        free_r = raycast(m, robot.x, robot.y, robot.theta - math.pi / 3,
                         cfg.sensor)
        tie = 0.05 * x["tie"]
        new_sign = torch.where(free_l + tie > free_r, 1.0, -1.0)
        dur = x["dur"].to(torch.int32)
    else:
        new_sign = torch.ones_like(tsign)
        dur = torch.full_like(turning, w.turn_ticks)
    tsign = torch.where(start_turn, new_sign, tsign)
    turning = torch.where(start_turn, dur, turning)
    is_turning = turning > 0
    d_left = torch.where(is_turning, tsign * turn_arc, w.speed)
    d_right = torch.where(is_turning, -tsign * turn_arc, w.speed)
    if w.slip_noise:
        eps = w.slip_noise * x["slip"]
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
    if w.obstacle is not None:
        ocx, ocy, orbit_r, disc_r = w.obstacle
        obstacle = (ocx + orbit_r * x["obstacle_cos"][:, None],
                    ocy + orbit_r * x["obstacle_sin"][:, None], disc_r)
    scan = sensor.simulate_scan(
        m, robot.pose, consts["angles"], cfg.sensor,
        noise_sigma=w.scan_noise, dropout_p=w.dropout_p,
        outlier_p=w.outlier_p, obstacle=obstacle, draws=x["scan"])
    enc = torch.stack([robot.encoder_left, robot.encoder_right], dim=-1)
    return (dict(robot=robot, turning=turning, tsign=tsign),
            (enc, scan.ranges, robot.pose))


def _phases(omega: float, num_ticks: int, batch: int, device):
    """The moving obstacle's cos and sin phase a tick, [E, T] each: each
    tick's phase omega * tick and its cos and sin in float32 on the CPU,
    one tick at a time."""
    cos, sin = [], []
    for tick in range(num_ticks):
        phase = torch.tensor(omega, dtype=torch.float32) * float(tick)
        cos.append(torch.cos(phase))
        sin.append(torch.sin(phase))
    return tuple(torch.stack(v).to(device).expand(batch, num_ticks)
                 for v in (cos, sin))


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
    if draws is None:
        draws = draw_wander(gen, batch, num_ticks, angles.shape[0], dev,
                            turn_ticks, dropout_p, outlier_p, slip_noise,
                            explore)
    w = _Wander(speed=speed, obstacle_stop=obstacle_stop,
                turn_ticks=turn_ticks, scan_noise=scan_noise,
                kidnap_pose=tuple(kidnap_pose), dropout_p=dropout_p,
                outlier_p=outlier_p,
                obstacle=(None if moving_obstacle is None
                          else tuple(moving_obstacle[:4])),
                slip_noise=slip_noise, explore=explore)
    xs = dict(scan=draws.scan)
    if slip_noise:
        xs["slip"] = draws.slip
    if explore:
        xs["tie"], xs["dur"] = draws.tie, draws.dur
    if kidnap_tick is not None:
        xs["kidnap"] = (torch.arange(num_ticks, device=dev)
                        == kidnap_tick).expand(batch, num_ticks)
    if moving_obstacle is not None:
        xs["obstacle_cos"], xs["obstacle_sin"] = _phases(
            moving_obstacle[4], num_ticks, batch, dev)
    carry = [dict(robot=make_robot(*start_pose, batch=batch, device=dev),
                  turning=torch.zeros(batch, dtype=torch.int32, device=dev),
                  tsign=torch.ones(batch, dtype=torch.float32, device=dev))]
    consts = dict(angles=angles)

    def chunk(t0: int, n: int):
        part = compiled.tree_map(lambda v: v.narrow(1, t0, n), xs)
        graph = compiled.cached(None, _wander_tick, carry[0], part, consts,
                                1, m=m, cfg=cfg, w=w)
        carry[0], ys = graph(carry[0], part, consts)
        return ys

    return compiled.run_chunked(chunk, num_ticks, 1)
