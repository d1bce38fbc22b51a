"""Occupancy-grid mapping from scans: learn the map the filter localizes in.

Torch counterpart of montecarlolocalisation_tpu/models/mapping.py (no
reference counterpart: the reference needs a hand-written map.txt).

The update is the JAX package's dense inverse sensor model: for every
(pixel, beam) pair, closed-form ray geometry (the projection along the
beam and the distance across it) classifies the pixel as free space
(crossed short of the return), hit (the wall pixel's body just past the
return) or untouched, and the per-pixel log-odds delta is l_occ times the
hits minus l_free times the crossings.  The sensor geometry is the
filter's: the ray starts `laser_offset` ahead of the pose and the beam
angle is negated under the reference convention (monte_carlo.cpp:643-653).

Leading dims stand in for the JAX package's vmaps: `update_map` takes
log-odds [..., H, W] and poses [..., 3], one map a pose (particles in
models/slam, robots in `map_episode`), and an optional keyframe gate
`paint` [...]: a map whose entry is False comes back unchanged.

On maps whose side exceeds twice `sensor_window_px`, the classification
runs on one window a map around the ray origin (border-clamped), as the
JAX package's dynamic_slice does; smaller maps, the default 49 px maze
among them, take the dense grid.

On the card (float32 maps on CUDA, ops/ism.kernel_takes) both forms run
one hand-written kernel, csrc/ism.cu: each map's pixels against all the
beams in registers, a closed gate's map copied, a fresh output.  The
plain torch form (`update_map_plain`) is the definition: the CPU and
other dtypes run it, the tests hold it against the JAX package, and the
kernel gives its bits.  JAX fuses the [h, w, B] classification into one
XLA kernel; the plain form sums the hit and free counts over chunks of
beams into [..., H, W] counters, so no [..., h, w, B] tensor exists at
once, and windowed maps gather their window and scatter it back.  The
counts are small integers, exact in float32, so the chunking changes no
bit (`beam_chunk`, at most ISM_ELEMENTS elements a chunk), and then
`torch.where` applies the gate.

Episodes (`map_episode`, `dead_reckon_poses`) run their ticks in CUDA
graphs of compiled.TICKS_PER_GRAPH ticks, the JAX package's lax.scan.
`fit_walls`, `wall_metrics` and `to_trinary` are host numpy, as in JAX.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from ..config import (MappingConfig, MotionModelConfig, SensorModelConfig,
                      WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP)
from ..ops import ism
from . import compiled, motion

# Elements of one [..., h, w, chunk] tensor of the classification: the
# beams of a chunk are as many as keep it under this (at least one).
ISM_ELEMENTS = 1 << 24


def init_map(cfg: MappingConfig, device="cuda", batch=()):
    """Uniform-prior log-odds grids [..., H, W] (0 = unknown)."""
    return torch.zeros(tuple(batch) + (cfg.height, cfg.width),
                       dtype=torch.float32, device=device)


def sensor_window_px(cfg: MappingConfig) -> int:
    """Window side (pixels, odd) covering one scan's whole reach:
    max_trusted_range + hit_depth along the ray, half_width across it, and
    a pixel for the origin's offset inside its pixel."""
    reach = cfg.max_trusted_range + cfg.hit_depth + cfg.half_width
    return 2 * (int(math.ceil(reach / cfg.resolution)) + 1) + 1


def _ism_delta(window, rows, cols, ox, oy, ray, ranges, valid, returned,
               cfg: MappingConfig, beam_chunk: Optional[int] = None):
    """The inverse-sensor-model update of `window` [..., h, w], whose pixel
    (i, j) sits at raster row rows[..., i] and col cols[..., j]; ox, oy
    [...], ray, ranges, valid and returned [..., B] (or broadcastable).
    The hit and free counts accumulate over chunks of `beam_chunk` beams
    (None: as many as ISM_ELEMENTS allows); every chunking gives the same
    bits."""
    res = cfg.resolution
    cb, sb = torch.cos(ray), torch.sin(ray)
    pxx = cfg.origin_x + (cols.to(torch.float32) + 0.5) * res
    pxy = cfg.origin_y + (rows.to(torch.float32) + 0.5) * res
    dxp = (pxx[..., None, :] - ox[..., None, None])[..., None]  # [.., 1, w, 1]
    dyp = (pxy[..., :, None] - oy[..., None, None])[..., None]  # [.., h, 1, 1]
    n_beams = ray.shape[-1]
    if beam_chunk is None:
        beam_chunk = ISM_ELEMENTS // max(window.numel(), 1)
    beam_chunk = min(max(int(beam_chunk), 1), n_beams)
    hits = frees = None
    for b0 in range(0, n_beams, beam_chunk):
        def beams(v):
            return v[..., None, None, b0:b0 + beam_chunk]

        c, s, r = beams(cb), beams(sb), beams(ranges)
        proj = dxp * c + dyp * s                       # [..., h, w, chunk]
        perp = torch.abs(dyp * c - dxp * s)
        on_ray = (perp <= cfg.half_width).to(torch.float32) * beams(valid)
        free = on_ray * ((proj >= 0.0)
                         & (proj < r - cfg.hit_margin)).to(torch.float32)
        hit = on_ray * beams(returned) * (
            (proj >= r - cfg.hit_margin)
            & (proj <= r + cfg.hit_depth)).to(torch.float32)
        h_sum, f_sum = torch.sum(hit, dim=-1), torch.sum(free, dim=-1)
        hits = h_sum if hits is None else hits + h_sum
        frees = f_sum if frees is None else frees + f_sum
    delta = cfg.l_occ * hits - cfg.l_free * frees
    return torch.clamp(window + delta, -cfg.clamp, cfg.clamp)


def _scan_geometry(pose, ranges, angles, mask, cfg: MappingConfig,
                   sensor_cfg: SensorModelConfig):
    """(ox, oy [...], the ray origin; ray, r, valid, returned [..., B],
    the beams' angles, ranges and 0/1 validity and return) of one scan."""
    x, y, theta = pose.unbind(-1)
    ox = x + sensor_cfg.laser_offset * torch.cos(theta)
    oy = y + sensor_cfg.laser_offset * torch.sin(theta)
    sign = -1.0 if sensor_cfg.negate_beam_angle else 1.0
    ray = theta[..., None] + sign * angles                  # [..., B]
    r = ranges.to(torch.float32)
    valid = mask.to(torch.float32) * (
        r <= cfg.max_trusted_range).to(torch.float32)
    returned = (r < sensor_cfg.max_range - 1e-6).to(torch.float32)
    return ox, oy, ray, r, valid, returned


def _window(ox, oy, h: int, w: int, cfg: MappingConfig):
    """None where the dense grid runs, else (rows0, cols0 [...], sh, sw):
    each map's window around its ray origin, border-clamped."""
    s = sensor_window_px(cfg)
    if 2 * s > min(h, w):
        return None
    sh, sw = min(s, h), min(s, w)
    ri = torch.floor((oy - cfg.origin_y) / cfg.resolution).to(torch.int64)
    ci = torch.floor((ox - cfg.origin_x) / cfg.resolution).to(torch.int64)
    return (torch.clamp(ri - sh // 2, 0, h - sh),
            torch.clamp(ci - sw // 2, 0, w - sw), sh, sw)


def _update(logodds, pose, ranges, angles, mask, cfg: MappingConfig,
            sensor_cfg: SensorModelConfig, paint, beam_chunk: Optional[int],
            kernel: bool):
    """update_map (`kernel` True: csrc/ism.cu where ops/ism.kernel_takes)
    or update_map_plain (`kernel` False)."""
    ox, oy, ray, r, valid, returned = _scan_geometry(
        pose, ranges, angles, mask, cfg, sensor_cfg)
    h, w = logodds.shape[-2], logodds.shape[-1]
    window = _window(ox, oy, h, w, cfg)
    if kernel and ism.kernel_takes(logodds, pose, ray):
        return ism.ism_update_cuda(logodds, ox, oy, ray, r, valid, returned,
                                   cfg, window, paint)
    dev = logodds.device
    if window is None:
        new = _ism_delta(logodds, torch.arange(h, device=dev),
                         torch.arange(w, device=dev), ox, oy, ray, r,
                         valid, returned, cfg, beam_chunk)
    else:
        rows0, cols0, sh, sw = window
        rows = rows0[..., None] + torch.arange(sh, device=dev)  # [..., sh]
        cols = cols0[..., None] + torch.arange(sw, device=dev)  # [..., sw]
        # One window a map, so each map's indices are distinct: the
        # scatter has one writer a pixel.
        idx = (rows[..., :, None] * w + cols[..., None, :]).flatten(-2)
        flat = logodds.flatten(-2)
        win = torch.gather(flat, -1, idx).unflatten(-1, (sh, sw))
        upd = _ism_delta(win, rows, cols, ox, oy, ray, r, valid, returned,
                         cfg, beam_chunk)
        new = flat.scatter(-1, idx, upd.flatten(-2)).unflatten(-1, (h, w))
    if paint is None:
        return new
    return torch.where(paint[..., None, None], new, logodds)


def update_map(logodds, pose, ranges, angles, mask, cfg: MappingConfig,
               sensor_cfg: SensorModelConfig, paint=None):
    """One scan's inverse-sensor-model update of each map: logodds
    [..., H, W], pose [..., 3], ranges and mask [B] or broadcastable to
    [..., B], angles [B]; `paint` None (every map) or bool [...]: a map
    whose entry is False comes back unchanged (the keyframe gate).  Beams
    at or past max_range carve free space but deposit no hit; masked
    beams and beams past max_trusted_range add nothing.  Maps larger than
    twice sensor_window_px update a window around each ray origin, bit
    for bit the full-grid result.  Returns a new tensor; on the card
    (ops/ism.kernel_takes) csrc/ism.cu computes it, elsewhere
    `update_map_plain`, with the same bits."""
    return _update(logodds, pose, ranges, angles, mask, cfg, sensor_cfg,
                   paint, None, True)


def update_map_plain(logodds, pose, ranges, angles, mask,
                     cfg: MappingConfig, sensor_cfg: SensorModelConfig,
                     beam_chunk: Optional[int] = None, paint=None):
    """update_map in plain torch on any device: the hit and free counts
    over chunks of `beam_chunk` beams (None: as many as ISM_ELEMENTS
    allows), then the gate's torch.where."""
    return _update(logodds, pose, ranges, angles, mask, cfg, sensor_cfg,
                   paint, beam_chunk, False)


def _map_tick(carry, x: dict, consts: dict, cfg: MappingConfig,
              sensor_cfg: SensorModelConfig):
    lo = update_map(carry, x["pose"], x["ranges"], consts["angles"],
                    x["mask"], cfg, sensor_cfg)
    return lo, {}


def map_episode(poses, scan_ranges, scan_angles, cfg: MappingConfig,
                sensor_cfg: SensorModelConfig, scan_mask=None,
                logodds=None):
    """Fold an episode's scans into one map a robot: poses [..., T, 3]
    (true or estimated), scan_ranges [..., T, B], scan_angles [B],
    scan_mask [..., T, B] optional.  Returns log-odds [..., H, W]; the
    ticks run in CUDA graphs (models/compiled) on the card."""
    poses = torch.as_tensor(poses, dtype=torch.float32)
    dev = poses.device
    ranges = torch.as_tensor(scan_ranges, dtype=torch.float32, device=dev)
    angles = torch.as_tensor(scan_angles, dtype=torch.float32, device=dev)
    mask = (torch.ones(ranges.shape, dtype=torch.float32, device=dev)
            if scan_mask is None else torch.as_tensor(
                scan_mask, device=dev).to(torch.float32))
    lead = poses.dim() - 2
    if logodds is None:
        logodds = init_map(cfg, dev, poses.shape[:-2])
    carry = [logodds]
    xs = dict(pose=poses, ranges=ranges, mask=mask)
    consts = dict(angles=angles)

    def chunk(t0: int, n: int):
        part = compiled.tree_map(lambda v: v.narrow(lead, t0, n), xs)
        graph = compiled.cached(None, _map_tick, carry[0], part, consts,
                                lead, cfg=cfg, sensor_cfg=sensor_cfg)
        carry[0], ys = graph(carry[0], part, consts)
        return ys

    compiled.run_chunked(chunk, poses.shape[lead], lead)
    return carry[0].clone()


def _reckon_tick(odom: motion.OdometryState, x: dict, consts,
                 motion_cfg: MotionModelConfig):
    enc = x["encoders"]
    new, _, _, _ = motion.diff_drive_update(odom, enc[..., 0], enc[..., 1],
                                            motion_cfg)
    return new, torch.stack([new.x, new.y, new.theta], dim=-1)


def dead_reckon_poses(encoders, start_pose, motion_cfg: MotionModelConfig):
    """Cumulative encoder radians [..., T, 2] -> dead-reckoned poses
    [..., T, 3] from a known start pose ([3] or [..., 3]), through the
    reference's midpoint diff-drive model; row t is the pose after tick t
    (the simulator's truth rows)."""
    enc = torch.as_tensor(encoders, dtype=torch.float32)
    dev = enc.device
    lead = enc.dim() - 2
    sp = torch.as_tensor(start_pose, dtype=torch.float32, device=dev)
    sp = sp.expand(enc.shape[:-2] + (3,))
    zero = torch.zeros(enc.shape[:-2], dtype=torch.float32, device=dev)
    carry = [motion.OdometryState(x=sp[..., 0].clone(),
                                  y=sp[..., 1].clone(),
                                  theta=sp[..., 2].clone(),
                                  encoder_left=zero, encoder_right=zero)]
    xs = dict(encoders=enc)

    def chunk(t0: int, n: int):
        part = dict(encoders=enc.narrow(lead, t0, n))
        graph = compiled.cached(None, _reckon_tick, carry[0], part, None,
                                lead, motion_cfg=motion_cfg)
        carry[0], ys = graph(carry[0], part)
        return ys

    return compiled.run_chunked(chunk, enc.shape[lead], lead)


def fuse_maps(logodds_stack):
    """Maps of independent robots or episodes fused: log-odds add."""
    return torch.sum(logodds_stack, dim=0)


def to_occupancy(logodds, threshold: float = 0.0):
    """Log-odds -> boolean occupancy raster (True = wall)."""
    return logodds > threshold


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v)


def to_trinary(logodds, occ_threshold: float = 0.5,
               free_threshold: float = -0.5):
    """Log-odds -> map_server trinary int8: 100 occupied, 0 free, -1
    unknown."""
    lo = _host(logodds)
    return np.where(lo > occ_threshold, 100,
                    np.where(lo < free_threshold, 0, -1)).astype(np.int8)


def export_learned_map(logodds, cfg: MappingConfig, pgm_path: str,
                       yaml_path=None) -> None:
    """Write a learned map as a ROS map_server trinary PGM (+ YAML)."""
    from ..maps import pgm

    pgm.export_raster(to_trinary(logodds), cfg.resolution, cfg.origin_x,
                      cfg.origin_y, pgm_path, yaml_path)


def fit_walls(logodds, cell_px: int = 8, explored_abs: float = 0.5,
              min_explored_frac: float = 0.4,
              unexplored_is_wall: bool = True,
              return_explored: bool = False,
              offset_tol: int = 2) -> np.ndarray:
    """Snap a learned map onto the reference's cell lattice -> [R, C, 4]
    (mapping.py:193-318 of the JAX package, host numpy).

    Each lattice edge pools the log-odds over its open band (its pixels
    but the two corner pixels); pixels with |log-odds| <= explored_abs are
    unobserved.  A band observed on at least min_explored_frac of its
    pixels is decided by the sign of its summed evidence; an unobserved
    band falls back to unexplored_is_wall.  With offset_tol, an edge the
    lattice band does not vote a wall is also read shifted +-k px across
    its line, and turns to a wall where a shifted band is well observed
    and nearly pure positive evidence (drift-displaced walls).
    return_explored also returns the [R, C, 4] mask of observed edges."""
    lo = _host(logodds)
    h, w = lo.shape
    # Shifted bands must stay inside the cell interior, or a neighbouring
    # line's wall would vote here.
    offset_tol = min(offset_tol, max((cell_px - 1) // 2 - 1, 0))
    n_rows = max(1, (h - 1) // cell_px)
    n_cols = max(1, (w - 1) // cell_px)
    walls = np.zeros((n_rows, n_cols, 4), dtype=bool)
    seen = np.zeros((n_rows, n_cols, 4), dtype=bool)

    def band_sum(rr0, rr1, cc0, cc1):
        """(net evidence, explored fraction, purity) of one band; None off
        the grid."""
        if rr0 < 0 or cc0 < 0 or rr0 >= h or cc0 >= w or rr1 > h \
                or cc1 > w:
            return None
        band = lo[rr0:rr1, cc0:cc1]
        if band.size == 0:
            return None
        explored = np.abs(band) > explored_abs
        net = float(np.sum(band[explored]))
        tot = float(np.sum(np.abs(band[explored])))
        return net, float(np.mean(explored)), net / max(tot, 1e-9)

    def band_vote(r0, r1, c0, c1, drow, dcol):
        if r0 >= h or c0 >= w or r1 > h or c1 > w:
            return True, False          # off-raster edges are walls
        base = band_sum(r0, r1, c0, c1)
        base_ok = base is not None and base[1] >= min_explored_frac
        wall = base_ok and base[0] > 0.0
        seen_any = base_ok
        if not wall:
            for k in range(-offset_tol, offset_tol + 1):
                if k == 0:
                    continue
                s = band_sum(r0 + k * drow, r1 + k * drow,
                             c0 + k * dcol, c1 + k * dcol)
                if s is None or s[1] < max(min_explored_frac, 0.6):
                    continue
                seen_any = True
                if s[2] >= 0.8 and s[0] >= 5.0 * explored_abs:
                    wall = True
                    break
        if not seen_any:
            return unexplored_is_wall, False
        return wall, True

    for r in range(n_rows):
        for c in range(n_cols):
            r0, c0 = r * cell_px, c * cell_px
            for edge, (rr0, rr1, cc0, cc1, drow, dcol) in (
                (WALL_TOP, (r0, r0 + 1, c0 + 1, c0 + cell_px, 1, 0)),
                (WALL_BOTTOM, (r0 + cell_px, r0 + cell_px + 1,
                               c0 + 1, c0 + cell_px, 1, 0)),
                (WALL_LEFT, (r0 + 1, r0 + cell_px, c0, c0 + 1, 0, 1)),
                (WALL_RIGHT, (r0 + 1, r0 + cell_px,
                              c0 + cell_px, c0 + cell_px + 1, 0, 1)),
            ):
                walls[r, c, edge], seen[r, c, edge] = band_vote(
                    rr0, rr1, cc0, cc1, drow, dcol)
    if return_explored:
        return walls, seen
    return walls


def wall_metrics(learned: np.ndarray, truth: np.ndarray,
                 mask: np.ndarray = None) -> dict:
    """Precision, recall and F1 of a learned wall tensor against the
    truth, over the edges where `mask` is True (all without one)."""
    learned = np.asarray(_host(learned), bool)
    truth = np.asarray(_host(truth), bool)
    if mask is not None:
        mask = np.asarray(_host(mask), bool)
        learned, truth = learned[mask], truth[mask]
    tp = float(np.sum(learned & truth))
    fp = float(np.sum(learned & ~truth))
    fn = float(np.sum(~learned & truth))
    prec = tp / max(tp + fp, 1.0)
    rec = tp / max(tp + fn, 1.0)
    f1 = 2 * prec * rec / max(prec + rec, 1e-9)
    return dict(precision=prec, recall=rec, f1=f1)
