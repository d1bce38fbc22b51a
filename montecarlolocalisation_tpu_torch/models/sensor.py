"""Beam sensor model: likelihood, dispatch to the beam weight kernel, and
scan simulation.

Torch counterpart of montecarlolocalisation_tpu/models/sensor.py
(computeWeight, monte_carlo.cpp:623-682): every used beam casts a ray from
`laser_offset` ahead of the particle along the NEGATED beam angle;
per-beam prob = w_hit * TruncGauss(|obs - exp|; sigma)
+ w_rand * 1[|obs - max_range| < 0.01], summed over beams (or, with
beam_combine="log", the product via summed logs); particles failing
isValidPos weigh 0.

Beams are fixed-size tensors (angles [B], ranges [B], mask [B]).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..config import SensorModelConfig
from ..maps.grid import MazeMap, f32_reciprocal, is_valid_pos
from .raycast import raycast


@dataclasses.dataclass(frozen=True)
class Scan:
    """Fixed-size filtered scan: the observation fed to the filter step."""

    angles: torch.Tensor  # [B] beam angles (radians, LIDAR frame)
    ranges: torch.Tensor  # [B] observed radii (m)
    mask: torch.Tensor    # [B] bool — False lanes contribute nothing


def default_beam_angles(
    cfg: SensorModelConfig = SensorModelConfig(),
    angle_min_deg: float = -135.0,
    angle_increment_deg: float = 0.352,
    n_raw_beams: int = 726,
) -> np.ndarray:
    """Nominal beam table of the reference LIDAR (monte_carlo.cpp:637-639:
    0.352 deg/beam, angle_min -135 deg), filtered and subsampled."""
    angles = angle_min_deg + np.arange(n_raw_beams) * angle_increment_deg
    angles = angles[(angles > -cfg.angle_crop_deg)
                    & (angles < cfg.angle_crop_deg)]
    angles = angles[:: cfg.beam_skip]
    return np.deg2rad(angles).astype(np.float32)


def _tensor(x, dtype, device):
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def make_scan(angles, ranges, mask=None, device="cpu") -> Scan:
    angles = _tensor(angles, torch.float32, device)
    ranges = _tensor(ranges, torch.float32, device)
    if mask is None:
        mask = torch.ones(angles.shape, dtype=torch.bool, device=device)
    return Scan(angles=angles, ranges=ranges.expand(angles.shape),
                mask=_tensor(mask, torch.bool, device))


def gauss_pdf(diff, cfg: SensorModelConfig):
    """Truncated N(0, sigma) pdf: zero outside [0, gauss_max_diff]
    (GaussianLookup, monte_carlo.cpp:139-177)."""
    denom = cfg.sigma * math.sqrt(2.0 * math.pi)
    pdf = (torch.exp(-(diff * diff)
                     * f32_reciprocal(2.0 * cfg.sigma * cfg.sigma))
           * f32_reciprocal(denom))
    return torch.where((diff >= 0.0) & (diff <= cfg.gauss_max_diff), pdf, 0.0)


def expected_ranges(m: MazeMap, poses, scan_angles, cfg: SensorModelConfig):
    """Raycast expected distances for poses [..., 3] x beams [B] -> [..., B]
    (ray origin laser_offset ahead along the heading, monte_carlo.cpp:643-645;
    beam angle negated when cfg.negate_beam_angle, :653)."""
    x, y, theta = poses[..., 0], poses[..., 1], poses[..., 2]
    ox = x + cfg.laser_offset * torch.cos(theta)
    oy = y + cfg.laser_offset * torch.sin(theta)
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    ray_angle = theta[..., None] + sign * scan_angles
    return raycast(m, ox[..., None], oy[..., None], ray_angle, cfg)


def per_beam_likelihood(m: MazeMap, particles, scan: Scan,
                        cfg: SensorModelConfig):
    """[N, B] per-beam probabilities p_hit + p_rand."""
    expected = expected_ranges(m, particles, scan.angles, cfg)
    observed = scan.ranges
    p_hit = cfg.w_hit * gauss_pdf(torch.abs(observed - expected), cfg)
    p_rand = cfg.w_rand * (torch.abs(observed - cfg.max_range)
                           < cfg.rand_window).to(torch.float32)
    return p_hit + p_rand


def beam_sum(terms):
    """Sum over the last (beam) dim one beam after another.  This is the
    beam weight kernel's order, so the kernel, its plain version and the
    dense path round alike and a tick through either resamples the same
    particles."""
    acc = torch.zeros(terms.shape[:-1], dtype=terms.dtype,
                      device=terms.device)
    for b in range(terms.shape[-1]):
        acc = acc + terms[..., b]
    return acc


def finish_log_weights(m: MazeMap, cfg: SensorModelConfig, particles,
                       raw_logs):
    """Log-combine epilogue (sensor.py:293): temperature, global max-log
    shift, validity gate.  The kernel emits raw log-sums because one thread
    cannot see the global max."""
    logs = raw_logs * f32_reciprocal(cfg.log_temperature)
    prob = torch.exp(logs - torch.max(logs))
    return torch.where(
        is_valid_pos(m, particles[..., 0], particles[..., 1], m.resolution),
        prob, 0.0)


def kernel_eligible(m: MazeMap, particles, cfg: SensorModelConfig,
                    valid_offset: float) -> bool:
    """The JAX package's dispatch rule (sensor.py:154-179) with "on a TPU"
    read as "on CUDA": the fused kernel takes one filter's particles at
    one pixel of validity offset, for the fixed march on any raster and
    the analytic caster on gridline rasters."""
    if cfg.lookup_mode not in ("auto", "pallas"):
        return False
    if not (particles.is_cuda and particles.dim() == 2
            and abs(valid_offset - m.resolution) < 1e-9
            and cfg.beam_combine in ("sum", "log")):
        return False
    if cfg.ray_mode == "analytic":
        return m.gridline
    return cfg.ray_mode == "fixed"


def beam_weights(m: MazeMap, particles, scan: Scan, cfg: SensorModelConfig,
                 valid_offset: float = 0.1):
    """computeWeight: unnormalized weights [N] for particles [N, 3]
    (monte_carlo.cpp:623-682).  Invalid positions get exactly 0.

    CUDA tensors go through the beam weight kernel (ops/weights) where the
    JAX package would launch its Pallas kernel; everything else, including
    ray_mode="dda" on the card, runs the dense torch path."""
    if kernel_eligible(m, particles, cfg, valid_offset):
        from ..ops import weights

        out = weights.beam_weights(m, particles, scan, cfg)
        if cfg.beam_combine == "log":
            out = finish_log_weights(m, cfg, particles, out)
        return out
    return beam_weights_dense(m, particles, scan, cfg, valid_offset)


def beam_weights_dense(m: MazeMap, particles, scan: Scan,
                       cfg: SensorModelConfig, valid_offset: float = 0.1):
    """The dense torch path (sensor.py:193 _beam_weights_dense)."""
    per_beam = per_beam_likelihood(m, particles, scan, cfg)
    mask = scan.mask.to(torch.float32)
    if cfg.beam_combine == "log":
        logs = beam_sum(torch.log(torch.clamp(per_beam, min=1e-6))
                        * mask) * f32_reciprocal(cfg.log_temperature)
        prob = torch.exp(logs - torch.max(logs))
    else:
        prob = beam_sum(per_beam * mask)
    valid = is_valid_pos(m, particles[..., 0], particles[..., 1],
                         valid_offset)
    return torch.where(valid, prob, 0.0)


def simulate_scan(m: MazeMap, pose, scan_angles, cfg: SensorModelConfig,
                  gen: Optional[torch.Generator] = None,
                  noise_sigma: Optional[float] = None) -> Scan:
    """Observed scan from a ground-truth pose, with the geometry the filter
    predicts with; with `gen`, Gaussian range noise (sigma defaults to the
    sensor's).  Ranges clamp to [0, max_range]."""
    pose = torch.as_tensor(pose, dtype=torch.float32, device=m.device)
    angles = torch.as_tensor(scan_angles, dtype=torch.float32,
                             device=m.device)
    ranges = expected_ranges(m, pose, angles, cfg)
    if gen is not None:
        sigma = cfg.sigma if noise_sigma is None else noise_sigma
        ranges = ranges + sigma * torch.randn(
            ranges.shape, generator=gen, device=m.device)
    ranges = torch.clamp(ranges, 0.0, cfg.max_range)
    return make_scan(angles, ranges, device=m.device)
