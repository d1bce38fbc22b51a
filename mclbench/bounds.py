"""The least time an H100 could take for the beam-weight kernel (K1), the
k-means kernel (K3), and SLAM's map update (the inverse sensor model) and
likelihood field, on given inputs: the yardstick of the roofline metrics.

A bound is the larger of the bytes the call must move over the card's
memory rate and the float32 operations it must do over the card's float32
rate (NVIDIA's H100 SXM data sheet: 3.35 TB/s, 67 TFLOP/s outside the
tensor cores, at 700 W).  Each input is read once and each output written
once; the work that depends on the data is counted for these inputs: the
march samples up to each beam's first hit, the analytic cast's candidate
slabs up to each axis's first hit, and the Lloyd iterations the k-means
early exit lets run, and the (pixel, beam) pairs a scan's beams reach.
The count is the same whatever implements the kernel.
"""
from __future__ import annotations

import torch

from .reference import caster
from .reference import slam as ref_slam
from .reference.maze import CELL_PX, Maze

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
# Float operations of a beam weight whatever the cast (the ray's angle,
# cosine and sine, the likelihood's difference, Gaussian, max-range term
# and masked sum), and of a particle (its laser origin, pixel and validity).
BEAM_FLOPS, PARTICLE_FLOPS = 15, 16
MARCH_SAMPLE_FLOPS = 8     # a sample's world point and its pixel
SLAB_FLOPS = 10            # one candidate slab of one axis
KMEANS_POINT_FLOPS = 26    # a point's K = 3 distances, argmin and sums
# SLAM: a (pixel, beam) pair of the inverse sensor model (the distance
# along the beam and across it, the band tests, the count); a pixel's
# wallness (the sigmoid and its rebase); one tap of the separable blur on
# one axis (a multiply-add); a bilinear sample (its pixel coordinate, the
# four weights and the blend) with the log term it feeds.
ISM_PAIR_FLOPS = 10
WALL_PIXEL_FLOPS = 8
BLUR_TAP_FLOPS = 2
SAMPLE_FLOPS = 20


def bound(n_bytes: float, flops: float) -> dict:
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def _origins(parts, angles, sensor: dict):
    x, y, th = parts[..., 0], parts[..., 1], parts[..., 2]
    off = sensor["laser_offset"]
    ox = (x + off * torch.cos(th))[..., None]
    oy = (y + off * torch.sin(th))[..., None]
    sign = -1.0 if sensor["negate_beam_angle"] else 1.0
    ray = th[..., None] + sign * angles
    return ox, oy, torch.cos(ray), torch.sin(ray)


def march_samples(mz: Maze, parts, angles, sensor: dict) -> int:
    """Samples the march needs: each beam's up to its first hit, its first
    sample off the map, or all of them."""
    ox, oy, dx, dy = _origins(parts, angles, sensor)
    alive = torch.ones(dx.shape, dtype=torch.bool, device=parts.device)
    count = torch.zeros(dx.shape, dtype=torch.int32, device=parts.device)
    for r in caster.march_distances(sensor["max_range"],
                                    sensor["ray_step"]):
        count += alive.to(torch.int32)
        mx, my, inb = caster.to_pixel(mz, ox + r * dx, oy + r * dy)
        alive = alive & inb & ~caster.pixel(mz.occ, mx, my)
    return int(count.sum())


def slab_candidates(mz: Maze, parts, angles, sensor: dict) -> int:
    """Candidate slabs the analytic casts need: per beam and axis, the
    slabs in ray order up to the first hit, every one where there is none,
    one where the ray runs along the axis's lines, none where the origin
    is off the map or on a wall pixel of that axis's gridline."""
    smax, n_cand, span = caster.slab_constants(mz, sensor["max_range"])
    ox, oy, dx, dy = _origins(parts, angles, sensor)
    inv = caster.recip(mz.resolution)
    gx, gy = ox * inv, oy * inv
    inb = (gx >= 0.0) & (gy >= 0.0) & (gx < float(mz.width)) & (
        gy < float(mz.height))
    total = 0
    for vertical, gu, gv, du, dv in ((True, gx, gy, dx, dy),
                                     (False, gy, gx, dy, dx)):
        gu, gv = gu.expand(du.shape), gv.expand(du.shape)
        length = mz.height if vertical else mz.width
        n_lines = ((mz.width if vertical else mz.height) - 1) // CELL_PX + 1

        def line_pixel(k, r):
            if vertical:
                return caster.pixel(mz.occ, k * CELL_PX, r)
            return caster.pixel(mz.occ, r, k * CELL_PX)

        k0 = torch.floor(gu * (1.0 / CELL_PX)).to(torch.int32)
        line0 = (k0 * CELL_PX).to(torch.float32)
        inside0 = (gu >= line0) & (gu < line0 + 1.0)
        origin0 = inside0 & (k0 >= 0) & (k0 < n_lines) & line_pixel(
            k0, torch.floor(gv).to(torch.int32))
        small = torch.abs(du) < caster.EPS
        inv_du = 1.0 / torch.where(small, caster.EPS, du)
        sgn = torch.where(du >= 0, 1, -1).to(torch.int32)
        fwd = dv >= 0
        inv_dv = 1.0 / torch.where(torch.abs(dv) < caster.EPS, caster.EPS,
                                   dv)
        done = ~inb | origin0
        for c in range(n_cand):
            total += int((~done).sum())
            k = k0 + sgn * c
            line = (k * CELL_PX).to(torch.float32)
            t_near, t_far = (line - gu) * inv_du, (line + 1.0 - gu) * inv_du
            t_in = torch.clamp(torch.minimum(t_near, t_far), min=0.0)
            t_out = torch.clamp(torch.maximum(t_near, t_far), max=smax)
            if c == 0:
                t_in = torch.where(small, torch.where(inside0, 0.0, 3e38),
                                   t_in)
                t_out = torch.where(small, torch.where(inside0, smax, -3e38),
                                    t_out)
            r_in = torch.floor(gv + t_in * dv).to(torch.int32)
            r_out = torch.floor(gv + t_out * dv).to(torch.int32)
            lo = torch.minimum(r_in, r_out).clamp(min=0)
            hi = torch.maximum(r_in, r_out).clamp(max=length - 1)
            found = torch.zeros_like(fwd)
            row = torch.zeros_like(lo)
            for j in range(span):
                rj = torch.where(fwd, lo + j, hi - j)
                hit = (lo + j <= hi) & line_pixel(k, rj) & ~found
                row = torch.where(hit, rj, row)
                found = found | hit
            edge = torch.where(fwd, row, row + 1).to(torch.float32)
            s_hit = torch.maximum(t_in, (edge - gv) * inv_dv)
            ok = (t_in < t_out) & (k >= 0) & (k < n_lines) & found & (
                s_hit < smax)
            done = done | ok | small | (t_in >= smax)
    return total


def k1_bound(mz: Maze, parts, angles, sensor: dict) -> dict:
    """K1 on particles [..., N, 3] and one scan a filter of B beams: read
    the particles, the beam table, the ranges and mask and the raster,
    write the weights; the operations every beam and particle need and the
    cast's, counted on these inputs."""
    n = parts.numel() // 3
    nb = angles.shape[-1]
    n_ep = n // parts.shape[-2]
    n_bytes = 12 * n + 4 * n + 4 * nb + 8 * n_ep * nb + 2 * mz.height \
        * mz.width
    base = n * nb * BEAM_FLOPS + n * PARTICLE_FLOPS
    if sensor["ray_mode"] == "fixed":
        return bound(n_bytes, base + MARCH_SAMPLE_FLOPS
                     * march_samples(mz, parts, angles, sensor))
    return bound(n_bytes, base + SLAB_FLOPS
                 * slab_candidates(mz, parts, angles, sensor))


def kmeans_iterations(xy, c0, rs) -> int:
    """Lloyd iterations the early exit lets run, summed over filters:
    xy [E, N, 2], start centers c0 [E, K, 2], reseeds rs [E, I, K, 2]."""
    k = c0.shape[-2]
    centers = c0
    assign = torch.zeros(xy.shape[:-1], dtype=torch.long, device=xy.device)
    done = torch.zeros(xy.shape[:-2], dtype=torch.bool, device=xy.device)
    runs = torch.zeros_like(done, dtype=torch.int64)
    for t in range(rs.shape[-3]):
        runs += (~done).to(torch.int64)
        d2 = ((xy[..., None, :] - centers[..., None, :, :]) ** 2).sum(-1)
        new = torch.argmin(d2, dim=-1)
        changed = (new != assign).any(-1)
        upd = changed & ~done
        onehot = torch.nn.functional.one_hot(new, k).to(xy.dtype)
        cnt = onehot.sum(-2)
        means = (onehot[..., None] * xy[..., None, :]).sum(-3) \
            / torch.clamp(cnt, min=1.0)[..., None]
        means = torch.where((cnt > 0)[..., None], means, rs[..., t, :, :])
        centers = torch.where(upd[..., None, None], means, centers)
        assign = torch.where(upd[..., None], new, assign)
        done = done | ~changed
    return int(runs.sum())


def k3_bound(xy, c0, rs) -> dict:
    """K3: read the points, the start centers and the reseeds once, write
    the assignments and the centers; the operations of every point in
    every iteration the early exit lets run."""
    n = xy.numel() // 2
    n_bytes = 8 * n + 4 * n + 2 * c0.numel() * 4 + rs.numel() * 4
    return bound(n_bytes, KMEANS_POINT_FLOPS * xy.shape[-2]
                 * kmeans_iterations(xy, c0, rs))


def ism_bound(poses, ranges, mask, angles, mapped, cfg: dict) -> dict:
    """SLAM's map update in one tick: the pixels that the scans of the
    mapped filters (mapped [...]) reach, each read once and written once,
    and the operations of every (pixel, beam) pair a beam reaches (within
    half_width of it, short of its return or in its hit band), counted
    on these poses [..., P, 3] and scans (ranges and mask [..., B])."""
    sel = mapped.reshape(-1)
    if not bool(sel.any()):
        return bound(0.0, 0.0)
    p = poses.shape[-2]
    flat = poses.reshape((-1, p, 3))[sel]
    rb = ranges.reshape((-1, ranges.shape[-1]))[sel]
    mb = mask.reshape((-1, mask.shape[-1]))[sel]
    hits, frees = ref_slam.ism_counts(flat, rb, mb, angles, cfg)
    pairs = hits + frees
    n_bytes = 8 * int((pairs > 0).sum()) + flat.numel() * 4 \
        + rb.numel() * 4
    return bound(n_bytes, ISM_PAIR_FLOPS * float(pairs.sum()))


def slam_field_bound(filters: int, cfg: dict, beams: int) -> dict:
    """SLAM's likelihood field and scan likelihood in one tick of
    `filters` filters: every particle's map read once; its wallness and
    the separable blur's taps on both axes (2 radius + 1 a pixel each, as
    many as the map holds); P B (1 + free_samples) bilinear samples a
    filter."""
    mp = cfg["mapping"]
    h, w = mp["height"], mp["width"]
    taps = min(2 * cfg["field_radius_px"] + 1, h) + min(
        2 * cfg["field_radius_px"] + 1, w)
    maps = filters * cfg["num_particles"]
    samples = maps * beams * (1 + cfg["free_samples"])
    flops = (maps * h * w * (WALL_PIXEL_FLOPS + BLUR_TAP_FLOPS * taps)
             + SAMPLE_FLOPS * samples)
    return bound(4.0 * maps * h * w, flops)
