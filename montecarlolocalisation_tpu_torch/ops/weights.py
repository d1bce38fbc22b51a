"""K1: the beam weight kernel's wrapper, its plain version and launch count.

`beam_weights` takes the plain torch version for a tensor on the CPU and
launches csrc/weights.cu for a CUDA tensor; any other device raises.  Sum
mode returns validity-gated weights; log mode returns the RAW per-particle
log-sums, which models/sensor.finish_log_weights finishes (temperature,
global max shift, validity), as the JAX package does after its Pallas
kernel (ops/weights_pallas.py:330).
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..config import SensorModelConfig
from ..maps.grid import MazeMap, f32_reciprocal, is_valid_pos
from ..models import sensor
from . import analytic, build

MAX_BEAMS = 1024   # beam table in shared memory next to a <= 32 KB raster


def beam_weights_plain(m: MazeMap, particles, scan: sensor.Scan,
                       cfg: SensorModelConfig):
    """What the kernel computes, in plain torch."""
    per_beam = sensor.per_beam_likelihood(m, particles, scan, cfg)
    mask = scan.mask.to(torch.float32)
    if cfg.beam_combine == "log":
        return sensor.beam_sum(torch.log(torch.clamp(per_beam, min=1e-6))
                               * mask)
    prob = sensor.beam_sum(per_beam * mask)
    valid = is_valid_pos(m, particles[:, 0], particles[:, 1], m.resolution)
    return torch.where(valid, prob, 0.0)


def _params(m: MazeMap, cfg: SensorModelConfig):
    smax, n_cand, span = analytic.cast_constants(m, cfg.max_range)
    denom = cfg.sigma * math.sqrt(2.0 * math.pi)
    fp = [m.origin_x, m.origin_y, m.inv_resolution, m.resolution,
          m.extent_x, m.extent_y, cfg.laser_offset, cfg.max_range,
          cfg.ray_step, cfg.w_hit, cfg.w_rand, cfg.gauss_max_diff,
          f32_reciprocal(2.0 * cfg.sigma * cfg.sigma), f32_reciprocal(denom),
          cfg.rand_window, smax, 180.0 / math.pi, math.pi / 180.0]
    ip = [0 if cfg.ray_mode == "fixed" else 1,
          int(cfg.beam_combine == "log"), int(cfg.quantize_ray_deg),
          cfg.num_ray_steps, n_cand, span,
          (m.width - 1) // analytic.CELL_PX + 1,
          (m.height - 1) // analytic.CELL_PX + 1]
    return build.floats(fp), build.ints(ip)


def beam_weights_cuda(m: MazeMap, particles, scan: sensor.Scan,
                      cfg: SensorModelConfig):
    """Launch the beam weight kernel on CUDA tensors."""
    if not particles.is_cuda or m.device != particles.device:
        raise ValueError("beam_weights_cuda needs particles and map on the "
                         f"same CUDA device, got {particles.device} and "
                         f"{m.device}")
    if particles.dtype != torch.float32 or particles.dim() != 2 \
            or particles.shape[1] != 3:
        raise ValueError(f"particles must be float32 [N, 3], got "
                         f"{particles.dtype} {tuple(particles.shape)}")
    if cfg.ray_mode not in ("fixed", "analytic") or cfg.beam_combine not in (
            "sum", "log"):
        raise ValueError(f"no kernel for ray_mode={cfg.ray_mode!r}, "
                         f"beam_combine={cfg.beam_combine!r}")
    if cfg.ray_mode == "analytic" and not m.gridline:
        raise ValueError("the analytic cast needs a gridline raster")
    nb = scan.angles.shape[0]
    if nb > MAX_BEAMS:
        raise ValueError(f"{nb} beams > {MAX_BEAMS}")
    lib = build.library()
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    table = torch.stack([sign * scan.angles, scan.ranges.expand(nb),
                         scan.mask.to(torch.float32)]).contiguous()
    parts = particles.contiguous()
    occ = m.occ.contiguous()
    dil = m.occ_dilated.contiguous()
    out = torch.empty(parts.shape[0], dtype=torch.float32,
                      device=parts.device)
    fp, ip = _params(m, cfg)
    err = lib.mcl_beam_weights(
        parts.data_ptr(), parts.shape[0], table.data_ptr(), nb,
        occ.data_ptr(), dil.data_ptr(), m.height, m.width,
        ctypes.addressof(fp), ctypes.addressof(ip), out.data_ptr(),
        build.stream_handle(parts.device))
    build.check(err, "mcl_beam_weights")
    beam_weights_cuda.launches += 1
    return out


beam_weights_cuda.launches = 0


def beam_weights(m: MazeMap, particles, scan: sensor.Scan,
                 cfg: SensorModelConfig):
    """Beam weights [N] for particles [N, 3]: plain torch on the CPU, the
    kernel on CUDA."""
    if particles.device.type == "cpu":
        return beam_weights_plain(m, particles, scan, cfg)
    if particles.is_cuda:
        return beam_weights_cuda(m, particles, scan, cfg)
    raise ValueError(f"no beam weight path for device {particles.device}")
