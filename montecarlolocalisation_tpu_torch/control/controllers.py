"""Closed-loop motion controllers as plain per-tick functions on tensors.

Torch counterpart of montecarlolocalisation_tpu/control/controllers.py:
the reference's controller NODES (each a blocking ROS service loop) as
`(ctrl_state, sensors) -> (ctrl_state, wheel_cmd, done)` ticks.

  * PID two-phase drive      — src/PID_drive.cpp (service PID_drive)
  * APF goal-seeking drive   — src/avf.cpp (Potential_drive) and
                               src/potential_field.cpp (Potential_drive_1),
                               selected via APFConfig presets
  * global-frame APF / P-law — src/moveToPosition_server.cpp:448-554
  * wanderer                 — src/wanderer_try_final.cpp (service Wanderer)
  * APF wanderer             — src/avf_wanderer.cpp (autonomous)

Every quantity has leading episode dims [...] (0-d for one robot, [E] for
a batch, the JAX package's vmap written out); scan quantities add the beam
axis [..., B], and every reduction runs over it alone.  Wheel commands are
wheel angular velocities in the reference's diff_drive units; the
simulator integrates them with arc = omega * dt * wheel_size/2
(wanderer_try_final.cpp:63-78 kinematics).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..config import APFConfig, AVFWandererConfig, PIDConfig, WandererConfig
from ..utils.angles import normalize_angle


def _f32(v, device=None) -> torch.Tensor:
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    """A command argument on ref's device, with ref's leading dims."""
    v = _f32(v, ref.device)
    return v.expand(torch.broadcast_shapes(v.shape, ref.shape))


def clamp_wheels(left, right, limit: float = 100.0):
    """drive_motor clamp (PID_drive.cpp:66-90)."""
    return torch.clamp(left, -limit, limit), torch.clamp(right, -limit, limit)


# ---------------------------------------------------------------------------
# Odometry integration shared by the controllers (each reference node carries
# its own copy of this dead-reckoning; PID_drive.cpp:97-145).
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class LocalOdom:
    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor
    enc_left: torch.Tensor
    enc_right: torch.Tensor

    @staticmethod
    def reset(enc_left, enc_right) -> "LocalOdom":
        enc_left = _f32(enc_left)
        z = torch.zeros_like(enc_left)
        return LocalOdom(x=z, y=z, theta=z, enc_left=enc_left,
                         enc_right=_f32(enc_right, enc_left.device))


def _integrate(o: LocalOdom, enc_l, enc_r, wheel_size=0.062,
               wheel_space=0.265, wrap_theta: bool = False) -> LocalOdom:
    enc_l = _f32(enc_l, o.enc_left.device)
    enc_r = _f32(enc_r, o.enc_left.device)
    d_left = (enc_l - o.enc_left) * wheel_size * 0.5
    d_right = (enc_r - o.enc_right) * wheel_size * 0.5
    d_center = 0.5 * (d_left + d_right)
    dtheta = (d_left - d_right) / wheel_space
    theta = o.theta + dtheta
    x = o.x + d_center * torch.cos(o.theta + 0.5 * dtheta)
    y = o.y + d_center * torch.sin(o.theta + 0.5 * dtheta)
    if wrap_theta:
        theta = normalize_angle(theta)
    return LocalOdom(x=x, y=y, theta=theta, enc_left=enc_l, enc_right=enc_r)


# ---------------------------------------------------------------------------
# PID two-phase drive (src/PID_drive.cpp:197-279 drive_PID)
# ---------------------------------------------------------------------------
PID_ROTATE, PID_DRIVE, PID_DONE = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class PIDState:
    odom: LocalOdom
    phase: torch.Tensor         # int32: ROTATE -> DRIVE -> DONE
    target_x: torch.Tensor
    target_y: torch.Tensor
    base_speed: torch.Tensor


def pid_start(target_x, target_y, base_speed, enc_left, enc_right) -> PIDState:
    """Service entry: reset the local frame to zero (PID_drive.cpp:199-221)."""
    odom = LocalOdom.reset(enc_left, enc_right)
    return PIDState(
        odom=odom,
        phase=torch.full_like(odom.x, PID_ROTATE, dtype=torch.int32),
        target_x=_like(target_x, odom.x), target_y=_like(target_y, odom.x),
        base_speed=_like(base_speed, odom.x))


def pid_tick(st: PIDState, enc_left, enc_right,
             cfg: PIDConfig = PIDConfig()):
    """One 10 Hz PID tick -> (state, (wheel_l, wheel_r), done)."""
    odom = _integrate(st.odom, enc_left, enc_right)

    # Phase 1: rotate in place toward atan2(ty, tx) (PID_drive.cpp:147-189).
    rot_target = torch.atan2(st.target_y, st.target_x)
    rot_err = normalize_angle(rot_target - odom.theta)
    rot_cmd = cfg.heading_gain * rot_err
    rot_done = torch.abs(rot_err) < cfg.rotate_exit_rad

    # Phase 2: heading-P toward the point (PID_drive.cpp:97-145).
    theta_m = torch.atan2(st.target_y - odom.y, st.target_x - odom.x)
    drv_err = normalize_angle(theta_m - odom.theta)
    drv_cmd = cfg.heading_gain * drv_err
    dist = torch.hypot(st.target_x - odom.x, st.target_y - odom.y)
    drv_done = dist < cfg.dist_exit_m

    phase = st.phase
    phase = torch.where((phase == PID_ROTATE) & rot_done, PID_DRIVE, phase)
    phase = torch.where((phase == PID_DRIVE) & drv_done, PID_DONE, phase)

    in_rot = phase == PID_ROTATE
    in_drv = phase == PID_DRIVE
    left = torch.where(in_rot, rot_cmd,
                       torch.where(in_drv, st.base_speed + drv_cmd, 0.0))
    right = torch.where(in_rot, -rot_cmd,
                        torch.where(in_drv, st.base_speed - drv_cmd, 0.0))
    left, right = clamp_wheels(left, right, cfg.max_wheel_speed)
    new_st = dataclasses.replace(st, odom=odom, phase=phase)
    return new_st, (left, right), phase == PID_DONE


# ---------------------------------------------------------------------------
# APF drives (src/avf.cpp:225-380, src/potential_field.cpp:200-366)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class APFState:
    odom: LocalOdom
    target_x: torch.Tensor
    target_y: torch.Tensor
    base_speed: torch.Tensor
    done: torch.Tensor


def apf_start(target_x, target_y, base_speed, enc_left, enc_right) -> APFState:
    odom = LocalOdom.reset(enc_left, enc_right)
    return APFState(
        odom=odom, target_x=_like(target_x, odom.x),
        target_y=_like(target_y, odom.x),
        base_speed=_like(base_speed, odom.x),
        done=torch.zeros_like(odom.x, dtype=torch.bool))


def _per_beam(v):
    """A per-robot value [...] against a scan's [..., B]."""
    return v[..., None] if isinstance(v, torch.Tensor) else v


def repulsive_force(points_x, points_y, mask, influence_radius, repel_gain,
                    cfg: APFConfig):
    """Sum of 1/d-style repulsion over scan points [..., B] in the ROBOT
    frame (avf.cpp:255-276; sign and *0.5 factor are preset-dependent);
    the radius and gain are numbers or per-robot tensors [...]."""
    radius, gain = _per_beam(influence_radius), _per_beam(repel_gain)
    d = torch.hypot(points_x, points_y)
    act = mask & (d < radius) & (d > cfg.min_obstacle_dist)
    safe_d = torch.clamp(d, min=cfg.min_obstacle_dist)
    scale = gain * (1.0 / safe_d - 1.0 / radius) / (safe_d**2)
    if cfg.repel_half:
        scale = scale * 0.5
    ux = cfg.repel_sign * points_x / safe_d
    uy = cfg.repel_sign * points_y / safe_d
    act_f = act.to(torch.float32)
    return (torch.sum(act_f * scale * ux, dim=-1),
            torch.sum(act_f * scale * uy, dim=-1))


def apf_forces(target_x, target_y, x, y, points_x, points_y, mask,
               cfg: APFConfig):
    """The APF field at pose (x, y): gain-scheduled repulsion + attraction.

    Shared by the control tick below and the debug-marker renderer
    (utils/viz.render_apf).  Returns a dict with fx_att/fy_att (world
    frame), fx_rep/fy_rep (robot frame sum over scan points), the ACTIVE
    influence radius after near-goal scheduling, and the distance-to-goal.
    """
    dist = torch.hypot(target_x - x, target_y - y)
    # Near-goal gain scheduling (avf.cpp:366-370, potential_field.cpp:272-276).
    near = dist < cfg.near_goal_dist
    repel_gain = torch.where(near, cfg.near_goal_repel, cfg.repel_gain)
    radius = torch.where(near, cfg.near_goal_radius, cfg.influence_radius)
    # Fade factor (avf.cpp:250-254).
    if cfg.fade_exponent > 0:
        fade = torch.clamp((dist / cfg.influence_radius) ** cfg.fade_exponent,
                           0.0, 1.0)
        repel_gain = repel_gain * fade
    fx_rep, fy_rep = repulsive_force(points_x, points_y, mask, radius,
                                     repel_gain, cfg)
    fx_att = cfg.attract_gain * (target_x - x)
    fy_att = cfg.attract_gain * (target_y - y)
    return dict(fx_att=fx_att, fy_att=fy_att, fx_rep=fx_rep, fy_rep=fy_rep,
                radius=radius, dist=dist)


def apf_tick(st: APFState, enc_left, enc_right, points_x, points_y, mask,
             cfg: APFConfig):
    """One APF control tick -> (state, (wheel_l, wheel_r), done).

    points_*: scan points in the robot/laser frame ([..., B]); mask marks
    valid.
    """
    odom = _integrate(st.odom, enc_left, enc_right, wrap_theta=True)
    f = apf_forces(st.target_x, st.target_y, odom.x, odom.y,
                   points_x, points_y, mask, cfg)
    dist = f["dist"]
    fx_att, fy_att = f["fx_att"], f["fy_att"]
    attract_mag = torch.hypot(fx_att, fy_att)
    fx, fy = fx_att + f["fx_rep"], fy_att + f["fy_rep"]

    heading = torch.atan2(fy, fx)
    err = heading - odom.theta if cfg.subtract_theta else heading
    err = normalize_angle(err)
    omega = cfg.heading_gain * err
    left = st.base_speed + cfg.mix_sign * omega
    right = st.base_speed - cfg.mix_sign * omega

    if cfg.use_attract_exit:
        done = (dist < cfg.dist_exit_m) & (attract_mag < cfg.attract_mag_exit)
    else:
        done = dist < cfg.dist_exit_m
    done = st.done | done
    left = torch.where(done, 0.0, left)
    right = torch.where(done, 0.0, right)
    new_st = dataclasses.replace(st, odom=odom, done=done)
    return new_st, (left, right), done


def global_p_drive(world_pose, target_xy, base_speed, gain: float = 7.0,
                   stop_dist: float = 0.1):
    """goToTargetGlobal (moveToPosition_server.cpp:529-554): heading-P with
    cos-gated linear speed in the WORLD frame, fed by the MCL pose
    ([..., 3]; the target [..., 2])."""
    dx = target_xy[..., 0] - world_pose[..., 0]
    dy = target_xy[..., 1] - world_pose[..., 1]
    distance = torch.hypot(dx, dy)
    err = normalize_angle(torch.atan2(dy, dx) - world_pose[..., 2])
    omega = gain * err
    linear = base_speed * torch.clamp(torch.cos(err), min=0.0)
    stop = distance < stop_dist
    linear = torch.where(stop, 0.0, linear)
    omega = torch.where(stop, 0.0, omega)
    return linear + omega, linear - omega, stop


# ---------------------------------------------------------------------------
# Wanderer (src/wanderer_try_final.cpp)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WandererState:
    turn_ticks_left: torch.Tensor   # int32 remaining rotation ticks
    turn_dir: torch.Tensor          # int32: +1 right (dL>0), -1 left


def wanderer_init(batch=(), device="cpu") -> WandererState:
    def full(v):
        return torch.full(batch, v, dtype=torch.int32, device=device)

    return WandererState(turn_ticks_left=full(0), turn_dir=full(1))


def wanderer_turn_ticks(cfg: WandererConfig, dt: float) -> int:
    """Ticks of one timed rotation: omega_robot = speed * (wheel_size/2) /
    (wheel_space/2); ticks = ceil(angle / (omega * dt)) in float32
    (calculate_rotate_time :63-72)."""
    omega = cfg.turn_speed * (cfg.wheel_size / 2.0) / (cfg.wheel_space / 2.0)
    return int(math.ceil(np.float32(cfg.turn_angle / (omega * dt))))


def wanderer_tick(st: WandererState, ranges, mask, enabled,
                  cfg: WandererConfig = WandererConfig(), dt: float = 0.1):
    """One 10 Hz wanderer tick -> (state, (wheel_l, wheel_r)).

    Forward at `forward_speed` while the min range over the beams [..., B]
    is above `threshold`; else rotate turn_angle away from the nearer side
    at turn_speed (timerWandererCallback + avoidObstacle,
    wanderer_try_final.cpp:167-245).  The reference's blocking timed
    rotation becomes `turn_ticks_left` counted down tick by tick.
    `enabled` is a bool tensor [...].
    """
    r = torch.where(mask, ranges, 9.99)
    min_range = torch.amin(r, dim=-1)
    n = ranges.shape[-1]
    half = n // 2
    lane = torch.arange(n, device=ranges.device)
    # Pad lanes (mask False) are nonexistent beams and contribute nothing
    # to the side sums (the reference's 9.99 fill-in applies only to real
    # invalid READINGS, wanderer_try_final.cpp:32-48).
    r_sum = torch.where(mask, ranges, 0.0)
    sum1 = torch.sum(torch.where(lane < half, r_sum, 0.0), dim=-1)
    sum2 = torch.sum(torch.where(lane >= half, r_sum, 0.0), dim=-1)

    blocked = min_range <= cfg.threshold
    start_turn = blocked & (st.turn_ticks_left == 0)
    turn_dir = torch.where(start_turn,
                           torch.where(sum1 >= sum2, 1, -1).to(torch.int32),
                           st.turn_dir)
    ticks = torch.where(start_turn, wanderer_turn_ticks(cfg, dt),
                        st.turn_ticks_left)

    turning = ticks > 0
    fwd = cfg.forward_speed
    left = torch.where(turning, cfg.turn_speed * turn_dir, fwd)
    right = torch.where(turning, -cfg.turn_speed * turn_dir, fwd)
    # Disabled -> stop (hasStopped branch, :276-283).
    left = torch.where(enabled, left, 0.0)
    right = torch.where(enabled, right, 0.0)
    ticks = torch.where(enabled, torch.clamp(ticks - 1, min=0), ticks)
    return WandererState(turn_ticks_left=ticks, turn_dir=turn_dir), (left,
                                                                     right)


def avf_wanderer_tick(points_x, points_y, mask,
                      cfg: AVFWandererConfig = AVFWandererConfig()):
    """Pure-repulsion drift (src/avf_wanderer.cpp:173-233): heading from the
    repulsive field alone, P-gain 5, constant base speed."""
    apf = APFConfig(repel_gain=cfg.repel_gain,
                    influence_radius=cfg.influence_radius,
                    repel_half=True, repel_sign=1.0)
    fx, fy = repulsive_force(points_x, points_y, mask,
                             cfg.influence_radius, cfg.repel_gain, apf)
    err = normalize_angle(torch.atan2(fy, fx))
    omega = cfg.heading_gain * err
    return cfg.base_speed + omega, cfg.base_speed - omega
