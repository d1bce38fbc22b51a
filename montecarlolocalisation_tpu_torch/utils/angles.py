"""Angle helpers on torch tensors (montecarlolocalisation_tpu/utils/angles)."""
from __future__ import annotations

import math

import torch

TWO_PI = 2.0 * math.pi


def wrap_to_2pi(angle):
    """[0, 2pi) wrap (reference: monte_carlo.cpp:951-957 wrapTo2Pi)."""
    wrapped = torch.remainder(angle, TWO_PI)
    return torch.where(wrapped < 0, wrapped + TWO_PI, wrapped)


def normalize_angle(angle):
    """(-pi, pi] wrap via atan2 (reference idiom, e.g. monte_carlo.cpp:549)."""
    return torch.atan2(torch.sin(angle), torch.cos(angle))


def quantize_orientation(theta):
    """45-degree-banded orientation quantizer (monte_carlo.cpp:981-994):
    [45,135) -> DOWN(3); [135,225) -> LEFT(2); [225,315) -> UP(1); else 0."""
    deg = wrap_to_2pi(theta) * (180.0 / math.pi)
    out = torch.zeros_like(deg, dtype=torch.int32)
    out = torch.where((deg >= 225.0) & (deg < 315.0), 1, out)
    out = torch.where((deg >= 135.0) & (deg < 225.0), 2, out)
    out = torch.where((deg >= 45.0) & (deg < 135.0), 3, out)
    return out.to(torch.int32)


def yaw_to_quaternion_z(theta):
    """Yaw -> the z component sin(theta / 2) of the pure-yaw quaternion,
    the ExactPose.thetaQuaternion field (msg/ExactPose.msg), which the
    reference declares and never assigns.  A tensor in, a tensor out; a
    Python number in, a float out (in double precision)."""
    if isinstance(theta, torch.Tensor):
        return torch.sin(0.5 * theta)
    return math.sin(0.5 * theta)


def circular_mean(theta, weights=None, dim=None):
    """Mean angle via sin/cos sums (reference: monte_carlo.cpp:925-934)."""
    s = torch.sin(theta)
    c = torch.cos(theta)
    if weights is not None:
        s = s * weights
        c = c * weights
    if dim is None:
        return torch.atan2(s.sum(), c.sum())
    return torch.atan2(s.sum(dim), c.sum(dim))
