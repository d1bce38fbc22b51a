"""Odometry / motion model: diff-drive dead reckoning + rot1-trans-rot2 noise.

Torch counterpart of montecarlolocalisation_tpu/models/motion.py
(reference: monte_carlo.cpp:695-761).  The noise normals are an argument,
so a caller can hand in the exact draws of another implementation;
`draw_motion_normals` makes them from a torch.Generator.

Every function takes leading episode dims: particles [..., N, 3], the
odometry fields and encoders [...] ([] for one filter, [E] for a batch).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from ..config import MotionModelConfig
from ..maps.grid import f32_reciprocal
from ..utils.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class OdometryState:
    """Dead-reckoned robot pose + last-seen encoder values (radians)."""

    x: torch.Tensor
    y: torch.Tensor
    theta: torch.Tensor
    encoder_left: torch.Tensor
    encoder_right: torch.Tensor

    @staticmethod
    def zero(device="cpu", batch=()) -> "OdometryState":
        z = torch.zeros(batch, dtype=torch.float32, device=device)
        return OdometryState(x=z, y=z, theta=z, encoder_left=z,
                             encoder_right=z)


def _on_device(v, device):
    """`v` as a float32 tensor on `device`.  A Python number is filled in
    there: a copy from the host would wait for the card."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    if np.ndim(v) == 0:
        return torch.full((), float(v), dtype=torch.float32, device=device)
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def diff_drive_update(
    state: OdometryState, encoder_left, encoder_right, cfg: MotionModelConfig
) -> Tuple[OdometryState, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Integrate encoders -> new odometry state + noise-free (rot1,trans,rot2)
    (diffDriveModel + the decomposition of sampleMotionModelOdometry,
    monte_carlo.cpp:695-739)."""
    dev = state.x.device
    enc_l, enc_r = (_on_device(e, dev) for e in (encoder_left,
                                                  encoder_right))
    d_left = (enc_l - state.encoder_left) * cfg.wheel_size * 0.5
    d_right = (enc_r - state.encoder_right) * cfg.wheel_size * 0.5
    d_center = 0.5 * (d_left + d_right)
    if isinstance(cfg.wheel_space, torch.Tensor):
        # A trial value being fitted (models/calibrate): divided by, as
        # JAX divides by its traced value, so the gradient flows.
        delta_theta = (d_left - d_right) / cfg.wheel_space
    else:
        delta_theta = (d_left - d_right) * f32_reciprocal(cfg.wheel_space)
    theta = state.theta + delta_theta
    x = state.x + d_center * torch.cos(state.theta + 0.5 * delta_theta)
    y = state.y + d_center * torch.sin(state.theta + 0.5 * delta_theta)
    new = OdometryState(x=x, y=y, theta=normalize_angle(theta),
                        encoder_left=enc_l, encoder_right=enc_r)
    rot1 = torch.atan2(y - state.y, x - state.x) - state.theta
    trans = torch.sqrt((y - state.y) ** 2 + (x - state.x) ** 2)
    rot2 = new.theta - state.theta - rot1
    return new, rot1, trans, rot2


def draw_motion_normals(gen: torch.Generator, n: int,
                        cfg: MotionModelConfig, device,
                        batch=()) -> torch.Tensor:
    """The standard normals of one tick: [..., 3] with the reference's
    shared noise (monte_carlo.cpp:695-715), [..., 3, n] with per-particle
    noise; `batch` is the leading episode shape."""
    shape = (3,) if cfg.shared_noise else (3, n)
    return torch.randn(tuple(batch) + shape, generator=gen, device=device)


def sample_motion_noise(rot1, trans, rot2, cfg: MotionModelConfig, normals):
    """Noisy (rot1, trans, rot2) per sampleMotionModelOdometry.  The alphas
    parameterize VARIANCE (std = sqrt(alpha-combination),
    monte_carlo.cpp:410-414).  rot1/trans/rot2 are [...]; the results are
    [...] with shared noise (normals [..., 3]) and [..., N] with
    per-particle noise (normals [..., 3, N])."""
    var_r1 = cfg.alpha_1 * torch.abs(rot1) + cfg.alpha_2 * trans
    var_tr = cfg.alpha_3 * trans + cfg.alpha_4 * (torch.abs(rot1)
                                                  + torch.abs(rot2))
    var_r2 = cfg.alpha_1 * torch.abs(rot2) + cfg.alpha_2 * trans
    if cfg.shared_noise:
        n1, n2, n3 = normals.unbind(-1)
    else:
        n1, n2, n3 = normals.unbind(-2)
        rot1, trans, rot2 = rot1[..., None], trans[..., None], rot2[..., None]
        var_r1, var_tr, var_r2 = (var_r1[..., None], var_tr[..., None],
                                  var_r2[..., None])
    n_rot1 = rot1 + torch.sqrt(var_r1) * n1
    n_trans = trans + torch.sqrt(var_tr) * n2
    n_rot2 = rot2 + torch.sqrt(var_r2) * n3
    return n_rot1, n_trans, n_rot2


def propagate_particles(particles, rot1, trans, rot2):
    """updateParticlePos (monte_carlo.cpp:740-755).  theta is NOT re-wrapped
    here, matching the reference (it wraps only at resampling)."""
    theta = particles[..., 2]
    moved = theta + rot1
    dx = trans * torch.cos(moved)
    dy = trans * torch.sin(moved)
    return torch.stack(
        [particles[..., 0] + dx, particles[..., 1] + dy, theta + rot1 + rot2],
        dim=-1)


def motion_update(particles, state: OdometryState, encoder_left,
                  encoder_right, cfg: MotionModelConfig, normals):
    """One odometry tick: integrate encoders, add noise, propagate.
    Returns (new_odometry_state, new_particles)."""
    new_state, rot1, trans, rot2 = diff_drive_update(
        state, encoder_left, encoder_right, cfg)
    n_rot1, n_trans, n_rot2 = sample_motion_noise(rot1, trans, rot2, cfg,
                                                  normals)
    if cfg.shared_noise:
        # One noisy triple per episode, broadcast over its particles.
        n_rot1, n_trans, n_rot2 = (n_rot1[..., None], n_trans[..., None],
                                   n_rot2[..., None])
    return new_state, propagate_particles(particles, n_rot1, n_trans, n_rot2)
