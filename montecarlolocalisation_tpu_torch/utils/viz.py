"""Debug visualization: the stand-in for the RViz publishers.

Torch-port copy of montecarlolocalisation_tpu/utils/viz.py: numpy images,
whose inputs may be numpy arrays or torch tensors on any device.

The reference debugs through RViz topics (resampled_particles /
zero_weight_particles / localised_pos PoseArrays, raycast LINE_LIST,
RANSAC lines — SURVEY.md §4.3).  Here the same artifacts render to a plain
RGB numpy image (no plotting dependency) for notebooks, logs, or tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

# Colors (RGB)
C_BG = (250, 250, 250)
C_WALL = (40, 40, 40)
C_PARTICLE = (70, 130, 220)
C_ZERO = (200, 200, 200)
C_BEST = (220, 60, 60)
C_TRUE = (40, 170, 90)
C_RAY = (240, 160, 60)


def _np(v, dtype=None) -> np.ndarray:
    """An input as a host numpy array."""
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, dtype)


def render_map(occ: np.ndarray, scale: int = 8) -> np.ndarray:
    """Occupancy raster -> RGB image (y-down rows match world y)."""
    occ = _np(occ, bool)
    img = np.empty(occ.shape + (3,), dtype=np.uint8)
    img[...] = C_BG
    img[occ] = C_WALL
    return np.repeat(np.repeat(img, scale, axis=0), scale, axis=1)


def _to_px(x, y, resolution: float, scale: int):
    return (np.asarray(y) / resolution * scale).astype(int), \
           (np.asarray(x) / resolution * scale).astype(int)


def draw_points(img: np.ndarray, xs, ys, color, resolution: float = 0.1,
                scale: int = 8, size: int = 1) -> np.ndarray:
    rows, cols = _to_px(xs, ys, resolution, scale)
    h, w = img.shape[:2]
    for dr in range(-size, size + 1):
        for dc in range(-size, size + 1):
            r = np.clip(rows + dr, 0, h - 1)
            c = np.clip(cols + dc, 0, w - 1)
            img[r, c] = color
    return img


def draw_segment(img: np.ndarray, x0, y0, x1, y1, color,
                 resolution: float = 0.1, scale: int = 8,
                 n: int = 64) -> np.ndarray:
    t = np.linspace(0.0, 1.0, n)
    return draw_points(img, x0 + (x1 - x0) * t, y0 + (y1 - y0) * t, color,
                       resolution, scale, size=0)


def render_filter(occ: np.ndarray, particles=None, weights=None,
                  best_pose=None, true_pose=None,
                  rays: Optional[Tuple] = None, resolution: float = 0.1,
                  scale: int = 8) -> np.ndarray:
    """One frame: map + particle cloud (+zero-weight grey), best, truth,
    rays.  `rays` = (ox, oy, angles, dists)."""
    img = render_map(occ, scale)
    if particles is not None:
        p = _np(particles)
        if weights is not None:
            w = _np(weights)
            zero = w == 0.0
            draw_points(img, p[zero, 0], p[zero, 1], C_ZERO, resolution,
                        scale)
            draw_points(img, p[~zero, 0], p[~zero, 1], C_PARTICLE,
                        resolution, scale)
        else:
            draw_points(img, p[:, 0], p[:, 1], C_PARTICLE, resolution, scale)
    if rays is not None:
        ox, oy, angles, dists = [_np(v) for v in rays]
        for a, d in zip(np.atleast_1d(angles), np.atleast_1d(dists)):
            draw_segment(img, ox, oy, ox + d * np.cos(a),
                         oy + d * np.sin(a), C_RAY, resolution, scale)
    if true_pose is not None:
        tp = _np(true_pose)
        draw_points(img, [tp[0]], [tp[1]], C_TRUE, resolution, scale, size=3)
    if best_pose is not None:
        bp = _np(best_pose)
        if bp[0] >= 0:
            draw_points(img, [bp[0]], [bp[1]], C_BEST, resolution, scale,
                        size=3)
    return img


C_SCAN = (150, 150, 150)
C_INLIER = (70, 130, 220)
C_LINE = (220, 60, 60)
C_PERP = (40, 170, 90)
C_INTERSECT = (150, 60, 200)
C_ORIGIN = (40, 40, 40)


def render_align(px, py, mask, lines, intersection=None,
                 extent_m: float = 1.6, resolution: float = 0.02,
                 scale: int = 1) -> np.ndarray:
    """Align-pipeline debug frame — the RANSAC marker surface the
    reference publishes to RViz (`ransac_lines`, `perpenducular_line`,
    `intersect_line`, align_server.cpp:806-810).

    Robot-frame view centered on the laser: scan points (grey), each
    line's inliers (blue) + fitted segment (red), the origin→foot
    perpendicular (green, perpendicular_foot), and the wall intersection
    (purple).  `lines` are control.align.Line; `intersection` defaults to
    intersect_lines(lines[0], lines[1]) when two lines are present.
    """
    from ..control import align as align_mod

    side = int(round(2 * extent_m / resolution)) + 1
    img = np.empty((side, side, 3), dtype=np.uint8)
    img[...] = C_BG

    def shift(x, y):
        return np.asarray(x) + extent_m, np.asarray(y) + extent_m

    px = _np(px)
    py = _np(py)
    mask = _np(mask, bool)
    draw_points(img, *shift(px[mask], py[mask]), C_SCAN, resolution, scale,
                size=0)
    for ln in lines:
        inl = np.asarray(ln.inlier_mask, bool)
        if inl.any():
            draw_points(img, *shift(px[inl], py[inl]), C_INLIER,
                        resolution, scale, size=0)
        (x0, y0), (x1, y1) = ln.first_inlier, ln.last_inlier
        sx0, sy0 = shift(x0, y0)
        sx1, sy1 = shift(x1, y1)
        draw_segment(img, sx0, sy0, sx1, sy1, C_LINE, resolution, scale,
                     n=256)
        fx, fy = align_mod.perpendicular_foot(ln)
        sfx, sfy = shift(fx, fy)
        sox, soy = shift(0.0, 0.0)
        draw_segment(img, sox, soy, sfx, sfy, C_PERP, resolution, scale,
                     n=128)
        draw_points(img, [sfx], [sfy], C_PERP, resolution, scale, size=2)
    if intersection is None and len(lines) >= 2:
        intersection = align_mod.intersect_lines(lines[0], lines[1])
    if intersection is not None:
        ix, iy = shift(intersection[0], intersection[1])
        draw_points(img, [ix], [iy], C_INTERSECT, resolution, scale, size=3)
    ox, oy = shift(0.0, 0.0)
    draw_points(img, [ox], [oy], C_ORIGIN, resolution, scale, size=2)
    return img


C_ATTRACT = (220, 60, 60)    # red, avf.cpp:293
C_REPEL = (70, 130, 220)     # blue, avf.cpp:294
C_TOTAL = (150, 60, 200)
C_CIRCLE = (60, 60, 220)     # blue LINE_STRIP, publishInfluenceRadius
C_HEADING = (220, 60, 60)    # red ARROW, moveToPosition_server.cpp:124-127


def draw_circle(img: np.ndarray, cx, cy, radius, color,
                resolution: float = 0.1, scale: int = 8,
                segments: int = 100) -> np.ndarray:
    """Parametric circle outline (the reference's 100-segment LINE_STRIP,
    moveToPosition/avf publishInfluenceRadius)."""
    a = np.linspace(0.0, 2.0 * np.pi, segments + 1)
    return draw_points(img, cx + radius * np.cos(a), cy + radius * np.sin(a),
                       color, resolution, scale, size=0)


def draw_arrow(img: np.ndarray, x0, y0, x1, y1, color,
               resolution: float = 0.1, scale: int = 8) -> np.ndarray:
    """Shaft + two head strokes — the RViz ARROW marker in 2D."""
    draw_segment(img, x0, y0, x1, y1, color, resolution, scale)
    dx, dy = x1 - x0, y1 - y0
    mag = float(np.hypot(dx, dy))
    if mag < 1e-9:
        return img
    head = 0.2 * mag
    ang = np.arctan2(dy, dx)
    for da in (np.deg2rad(150.0), -np.deg2rad(150.0)):
        draw_segment(img, x1, y1, x1 + head * np.cos(ang + da),
                     y1 + head * np.sin(ang + da), color, resolution, scale,
                     n=16)
    return img


def render_apf(points_x, points_y, mask, forces: dict,
               extent_m: float = 1.6, resolution: float = 0.02,
               scale: int = 1, force_scale: float = 0.5) -> np.ndarray:
    """APF controller debug frame — the potential_field Attract/Repel
    arrows + influence_radius_marker circle the reference publishes to
    RViz (avf.cpp:292-294 publishVectorArrow/publishInfluenceRadius;
    potential_field.cpp:446-447).

    Robot/laser-frame view centered on the robot: scan points (grey),
    the ACTIVE influence circle (blue; near-goal scheduling may shrink
    it), the attractive force (red), summed repulsion (blue), and their
    total (purple).  `forces` is control.controllers.apf_forces output;
    arrows are normalized so the largest spans `force_scale` meters.
    """
    side = int(round(2 * extent_m / resolution)) + 1
    img = np.empty((side, side, 3), dtype=np.uint8)
    img[...] = C_BG

    def shift(x, y):
        return np.asarray(x, np.float64) + extent_m, \
               np.asarray(y, np.float64) + extent_m

    px = _np(points_x)
    py = _np(points_y)
    mk = _np(mask, bool)
    draw_points(img, *shift(px[mk], py[mk]), C_SCAN, resolution, scale,
                size=0)
    draw_circle(img, *shift(0.0, 0.0), float(forces["radius"]), C_CIRCLE,
                resolution, scale)
    fa = np.array([float(forces["fx_att"]), float(forces["fy_att"])])
    fr = np.array([float(forces["fx_rep"]), float(forces["fy_rep"])])
    ft = fa + fr
    norm = max(np.hypot(*fa), np.hypot(*fr), np.hypot(*ft), 1e-9)
    ox, oy = shift(0.0, 0.0)
    for vec, color in ((fa, C_ATTRACT), (fr, C_REPEL), (ft, C_TOTAL)):
        v = vec / norm * force_scale
        draw_arrow(img, ox, oy, ox + v[0], oy + v[1], color, resolution,
                   scale)
    draw_points(img, [ox], [oy], C_ORIGIN, resolution, scale, size=2)
    return img


def draw_heading_error(img: np.ndarray, pose, error_theta,
                       length: float = 0.5, resolution: float = 0.1,
                       scale: int = 8) -> np.ndarray:
    """World-frame heading-error arrow onto an existing map frame — the
    reference's red ARROW from the robot position along
    theta + error_theta with length 0.5 m
    (moveToPosition_server.cpp:94-130 publishHeadingErrorArrow, :623)."""
    p = _np(pose, np.float64)
    display = p[2] + float(error_theta)
    return draw_arrow(img, p[0], p[1], p[0] + length * np.cos(display),
                      p[1] + length * np.sin(display), C_HEADING,
                      resolution, scale)


def save_ppm(img: np.ndarray, path: str) -> None:
    """Write RGB uint8 image as binary PPM (no imaging dependency)."""
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(img).tobytes())
