"""Beam sensor model: likelihood, dispatch to the beam weight kernel, and
scan simulation.

Torch counterpart of montecarlolocalisation_tpu/models/sensor.py
(computeWeight, monte_carlo.cpp:623-682): every used beam casts a ray from
`laser_offset` ahead of the particle along the NEGATED beam angle;
per-beam prob = w_hit * TruncGauss(|obs - exp|; sigma)
+ w_rand * 1[|obs - max_range| < 0.01], summed over beams (or, with
beam_combine="log", the product via summed logs); particles failing
isValidPos weigh 0.

Beams are fixed-size tensors (angles [B], ranges [..., B], mask [..., B]).
Particles carry leading episode dims: [N, 3] is one filter and [E, N, 3]
a batch of episodes, which shares one beam table `angles` [B] and has its
own observations, ranges and mask [E, B].  On a map stack (maps/grid)
each episode reads its own map, so a stack needs a batch of episodes.
`filter_scan` turns a raw (ragged) LaserScan into that form on the host;
`beam_weights_partial` scores particles on a partial learned map.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from ..config import SensorModelConfig
from ..maps.grid import MazeMap, f32_reciprocal, is_valid_pos, select_maps
from .raycast import raycast


@dataclasses.dataclass(frozen=True)
class Scan:
    """Fixed-size filtered scan: the observation fed to the filter step."""

    angles: torch.Tensor  # [B] beam angles (radians, LIDAR frame)
    ranges: torch.Tensor  # [..., B] observed radii (m)
    mask: torch.Tensor    # [..., B] bool — False lanes contribute nothing


def filter_scan(
    ranges: np.ndarray,
    angle_min: float,
    angle_increment: float,
    range_min: float,
    range_max: float,
    cfg: SensorModelConfig = SensorModelConfig(),
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """filterLaserReadings + filterAngles + the beam skip on the host
    (monte_carlo.cpp:254-278, :610-620, :650; sensor.py:45-86 of the JAX
    package): non-finite beams become cfg.invalid_beam_range at their
    nominal angle, finite beams outside [range_min, range_max] are dropped
    (which shifts the later beams' indices), beams strictly inside
    +-angle_crop_deg are kept, then every beam_skip-th.  Returns numpy
    (angles [B], ranges [B], mask [B]), padded to `pad_to` lanes."""
    ranges = np.asarray(ranges, dtype=np.float64)
    idx = np.arange(len(ranges))
    angles = angle_min + idx * angle_increment
    bad = ~np.isfinite(ranges)
    keep = bad | ((ranges >= range_min) & (ranges <= range_max))
    radii = np.where(bad, cfg.invalid_beam_range, ranges)[keep]
    angles = angles[keep]
    deg = angles * 180.0 / math.pi
    crop = (deg > -cfg.angle_crop_deg) & (deg < cfg.angle_crop_deg)
    radii, angles = radii[crop], angles[crop]
    radii = radii[:: cfg.beam_skip]
    angles = angles[:: cfg.beam_skip]
    mask = np.ones(len(radii), dtype=bool)
    if pad_to is not None:
        pad = pad_to - len(radii)
        if pad < 0:
            raise ValueError(f"pad_to={pad_to} < {len(radii)} beams")
        radii = np.pad(radii, (0, pad))
        angles = np.pad(angles, (0, pad))
        mask = np.pad(mask, (0, pad))
    return angles.astype(np.float32), radii.astype(np.float32), mask


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
    ranges = ranges.expand(torch.broadcast_shapes(ranges.shape, angles.shape))
    if mask is None:
        mask = torch.ones(ranges.shape, dtype=torch.bool, device=device)
    return Scan(angles=angles, ranges=ranges,
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
    """[..., N, B] per-beam probabilities p_hit + p_rand."""
    expected = expected_ranges(m, particles, scan.angles, cfg)
    observed = scan.ranges[..., None, :]
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
    """Log-combine epilogue (sensor.py:293): temperature, max-log shift,
    validity gate.  The shift is each episode's own max (the last dim of
    raw_logs [..., N]).  The kernel emits raw log-sums because one thread
    cannot see the max."""
    logs = raw_logs * f32_reciprocal(cfg.log_temperature)
    prob = torch.exp(logs - torch.amax(logs, dim=-1, keepdim=True))
    return torch.where(
        is_valid_pos(m, particles[..., 0], particles[..., 1], m.resolution),
        prob, 0.0)


def kernel_eligible(m: MazeMap, particles, cfg: SensorModelConfig,
                    valid_offset: float) -> bool:
    """The JAX package's dispatch rule (sensor.py:154-179) with "on a TPU"
    read as "on CUDA": the fused kernel takes particles at one pixel of
    validity offset, for the fixed march on any raster and the analytic
    caster on gridline rasters; one filter [N, 3] or a batch of episodes
    [..., N, 3] (the JAX package's episode-batched launch, sensor.py:
    328-371, without its TPU tile-padding gate), also on a map stack
    (every map gridline for the analytic caster), where the JAX package
    runs XLA on traced maps and K1 batched reads a raster per episode."""
    if cfg.lookup_mode not in ("auto", "pallas"):
        return False
    if not (particles.is_cuda and particles.dim() >= 2
            and abs(valid_offset - m.resolution) < 1e-9
            and cfg.beam_combine in ("sum", "log")):
        return False
    if cfg.ray_mode == "analytic":
        return m.gridline
    return cfg.ray_mode == "fixed"


def beam_weights(m: MazeMap, particles, scan: Scan, cfg: SensorModelConfig,
                 valid_offset: float = 0.1):
    """computeWeight: unnormalized weights [..., N] for particles
    [..., N, 3] (monte_carlo.cpp:623-682).  Invalid positions get
    exactly 0.

    CUDA tensors go through the beam weight kernel (ops/weights: K1 for
    one filter, K1 batched for episodes, its map-stack form on a map
    stack) where the JAX package would launch its Pallas kernel;
    everything else, including ray_mode="dda" on the card, runs the dense
    torch path.  A map stack needs particles [..., N, 3] whose leading
    dims are its index's."""
    if m.is_stack and tuple(particles.shape[:-2]) != tuple(
            m.episode_maps.shape):
        raise ValueError(f"a map stack of {tuple(m.episode_maps.shape)} "
                         f"episodes got particles {tuple(particles.shape)}")
    if kernel_eligible(m, particles, cfg, valid_offset):
        from ..ops import weights

        if particles.dim() == 2:
            out = weights.beam_weights(m, particles, scan, cfg)
        else:
            lead = particles.shape[:-2]
            nb = scan.angles.shape[-1]
            flat = Scan(angles=scan.angles,
                        ranges=scan.ranges.expand(lead + (nb,)).reshape(
                            -1, nb),
                        mask=scan.mask.expand(lead + (nb,)).reshape(-1, nb))
            # A stack's map index flattens with the episode dims.
            fm = (select_maps(m, m.episode_maps.reshape(-1))
                  if m.is_stack and len(lead) > 1 else m)
            out = weights.beam_weights_batched(
                fm, particles.reshape(-1, *particles.shape[-2:]), flat,
                cfg).reshape(particles.shape[:-1])
        if cfg.beam_combine == "log":
            out = finish_log_weights(m, cfg, particles, out)
        return out
    return beam_weights_dense(m, particles, scan, cfg, valid_offset)


def beam_weights_dense(m: MazeMap, particles, scan: Scan,
                       cfg: SensorModelConfig, valid_offset: float = 0.1):
    """The dense torch path (sensor.py:193 _beam_weights_dense)."""
    prob = _combine(per_beam_likelihood(m, particles, scan, cfg),
                    scan.mask.to(torch.float32)[..., None, :], cfg)
    valid = is_valid_pos(m, particles[..., 0], particles[..., 1],
                         valid_offset)
    return torch.where(valid, prob, 0.0)


def _combine(per_beam, mask, cfg: SensorModelConfig):
    """Masked beam combine [..., N, B] -> [..., N]: the sum, or in log mode
    the temperature-scaled log-sum shifted by each episode's max."""
    if cfg.beam_combine == "log":
        logs = beam_sum(torch.log(torch.clamp(per_beam, min=1e-6))
                        * mask) * f32_reciprocal(cfg.log_temperature)
        return torch.exp(logs - torch.amax(logs, dim=-1, keepdim=True))
    return beam_sum(per_beam * mask)


def beam_weights_partial(m: MazeMap, known: MazeMap, particles, scan: Scan,
                         cfg: SensorModelConfig, valid_offset: float = 0.1):
    """computeWeight on a partial learned map (sensor.py:225-291 of the
    JAX package).  `m` is the conservative fit (unexplored edges closed),
    `known` the same fit with them open, so a beam cast on both stays in
    mapped space where the two distances agree, and crosses the
    exploration frontier at d_cons where d_cons < d_known.  A measurement
    at or beyond that frontier gets the unknown credit (flat:
    unknown_credit of the peak hit probability; "interval": the density of
    a wall uniform over the unknown stretch, capped at the peak) instead
    of the score against a phantom wall; every other beam keeps the
    reference score against d_known.  Validity uses `m`.

    Plain torch on every device: the JAX package runs XLA here too."""
    d_cons = expected_ranges(m, particles, scan.angles, cfg)     # [..., N, B]
    d_known = expected_ranges(known, particles, scan.angles, cfg)
    observed = scan.ranges[..., None, :]
    frontier = d_cons < d_known - 1e-4
    beyond = observed >= d_cons - cfg.sigma
    peak = 1.0 / (cfg.sigma * math.sqrt(2.0 * math.pi))
    p_hit = cfg.w_hit * gauss_pdf(torch.abs(observed - d_known), cfg)
    if cfg.unknown_credit_mode == "interval":
        interval = torch.clamp(cfg.max_range - d_cons, min=0.0) + cfg.sigma
        credit = cfg.w_hit * torch.clamp(1.0 / interval, max=peak)
    else:
        credit = torch.full_like(p_hit, float(np.float32(
            cfg.unknown_credit * cfg.w_hit * peak)))
    p_hit = torch.where(frontier & beyond, credit, p_hit)
    p_rand = cfg.w_rand * (torch.abs(observed - cfg.max_range)
                           < cfg.rand_window).to(torch.float32)
    prob = _combine(p_hit + p_rand, scan.mask.to(torch.float32)[..., None, :],
                    cfg)
    valid = is_valid_pos(m, particles[..., 0], particles[..., 1],
                         valid_offset)
    return torch.where(valid, prob, 0.0)


def ray_disc_distance(ox, oy, angle, cx, cy, radius, max_range):
    """Distance along the ray to a disc obstacle, max_range if it misses
    (sensor.py:413): the closed-form ray/circle hit of an UNMAPPED disc,
    which the scan sees and the map raster does not."""
    dx = torch.cos(angle)
    dy = torch.sin(angle)
    fx = ox - cx
    fy = oy - cy
    b = fx * dx + fy * dy
    c = fx * fx + fy * fy - radius * radius
    disc = b * b - c
    t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
    hit = (disc >= 0.0) & (t >= 0.0) & (t < max_range)
    return torch.where(hit, t, max_range)


@dataclasses.dataclass(frozen=True)
class ScanDraws:
    """The random numbers of one simulated scan, each shaped like its
    ranges [..., B]: standard normals for the range noise, and uniforms
    in [0, 1) for the dropout test, the outlier test and the outlier value
    (scaled by max_range).  Fields a scan does not read may be None."""

    noise: torch.Tensor
    drop: Optional[torch.Tensor] = None
    out: Optional[torch.Tensor] = None
    outv: Optional[torch.Tensor] = None


def draw_scan(gen: torch.Generator, shape, device, dropout_p: float = 0.0,
              outlier_p: float = 0.0) -> ScanDraws:
    """A scan's draws from `gen`; the stressors that are off draw
    nothing."""
    def u():
        return torch.rand(shape, generator=gen, device=device)

    noise = torch.randn(shape, generator=gen, device=device)
    out, outv = (u(), u()) if outlier_p > 0.0 else (None, None)
    drop = u() if dropout_p > 0.0 else None
    return ScanDraws(noise=noise, drop=drop, out=out, outv=outv)


def simulate_scan(m: MazeMap, pose, scan_angles, cfg: SensorModelConfig,
                  gen: Optional[torch.Generator] = None,
                  noise_sigma: Optional[float] = None,
                  dropout_p: float = 0.0, outlier_p: float = 0.0,
                  obstacle=None, draws: Optional[ScanDraws] = None) -> Scan:
    """Observed scan from ground-truth poses [..., 3], with the geometry
    the filter predicts with (sensor.py:432).  Ranges clamp to
    [0, max_range].

    With `gen` or `draws`: Gaussian range noise (sigma defaults to the
    sensor's), then the stressors: `outlier_p`, the per-beam chance of a
    uniform [0, max_range) spurious return, and `dropout_p`, the per-beam
    chance of the dead-beam radius cfg.invalid_beam_range.  `obstacle` =
    (cx, cy, radius) is an unmapped disc the rays hit first."""
    pose = torch.as_tensor(pose, dtype=torch.float32, device=m.device)
    angles = torch.as_tensor(scan_angles, dtype=torch.float32,
                             device=m.device)
    ranges = expected_ranges(m, pose, angles, cfg)
    if obstacle is not None:
        cx, cy, radius = obstacle
        x, y, theta = pose[..., 0], pose[..., 1], pose[..., 2]
        ox = x + cfg.laser_offset * torch.cos(theta)
        oy = y + cfg.laser_offset * torch.sin(theta)
        sign = -1.0 if cfg.negate_beam_angle else 1.0
        ray_angle = theta[..., None] + sign * angles
        d_obs = ray_disc_distance(ox[..., None], oy[..., None], ray_angle,
                                  cx, cy, radius, cfg.max_range)
        ranges = torch.minimum(ranges, d_obs)
    if draws is None and gen is not None:
        draws = draw_scan(gen, ranges.shape, m.device, dropout_p, outlier_p)
    if draws is not None:
        sigma = cfg.sigma if noise_sigma is None else noise_sigma
        ranges = ranges + sigma * draws.noise
        ranges = torch.clamp(ranges, 0.0, cfg.max_range)
        if outlier_p > 0.0:
            ranges = torch.where(draws.out < outlier_p,
                                 draws.outv * cfg.max_range, ranges)
        if dropout_p > 0.0:
            ranges = torch.where(draws.drop < dropout_p,
                                 cfg.invalid_beam_range, ranges)
    else:
        ranges = torch.clamp(ranges, 0.0, cfg.max_range)
    return make_scan(angles, ranges, device=m.device)
