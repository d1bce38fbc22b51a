"""RANSAC wall alignment (reference: src/align_server.cpp, 824 LoC).

Torch counterpart of montecarlolocalisation_tpu/control/align.py: scan ->
cartesian points -> sequential RANSAC line extraction (<= 2 lines) -> an
AlignPlan of primitive rotate/drive actions that centers the robot in its
cell at the reference's 0.40 m wall standoff.  All `max_iterations`
candidate lines are scored at once against the point cloud ([iters,
points] distances) instead of the reference's sequential trial loop
(align_server.cpp:292-366) — same acceptance rules (normalized line,
inlier distance 0.05, >= 50 inliers, best-count wins).

A round's random numbers are its point-pair indices (i1, i2), each
[iters]: `ransac_extract` takes them as an argument, one pair a round,
or draws them from a torch.Generator (`draw_pairs`).  The lines are
host-side objects: alignment runs at service rate, not in the filter's
tick.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import AlignConfig

WALL_RIGHT_SIDE, WALL_LEFT_SIDE, WALL_FRONT = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class Line:
    """Normalized line a*x + b*y + c = 0 with inlier bookkeeping."""

    a: float
    b: float
    c: float
    inlier_mask: np.ndarray       # [P] over the input points
    first_inlier: Tuple[float, float]
    last_inlier: Tuple[float, float]

    @property
    def num_inliers(self) -> int:
        return int(self.inlier_mask.sum())


def polar_to_cartesian(ranges, angles, mask=None):
    """Scan -> robot-frame points (align_server.cpp:165-182)."""
    ranges = torch.as_tensor(ranges, dtype=torch.float32)
    angles = torch.as_tensor(angles, dtype=torch.float32,
                             device=ranges.device)
    x = ranges * torch.cos(angles)
    y = ranges * torch.sin(angles)
    if mask is None:
        mask = torch.ones(ranges.shape, dtype=torch.bool,
                          device=ranges.device)
    return x, y, torch.as_tensor(mask, device=ranges.device)


def draw_pairs(gen: torch.Generator, n_points: int, n_iters: int,
               device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """One RANSAC round's point-pair indices (i1, i2) [n_iters] from
    `gen`."""
    def idx():
        return torch.randint(0, n_points, (n_iters,), generator=gen,
                             device=device)

    return idx(), idx()


def _fit_candidates(px, py, mask, i1, i2):
    """The point pairs (i1, i2) -> normalized candidate lines."""
    x1, y1 = px[i1], py[i1]
    x2, y2 = px[i2], py[i2]
    a = y2 - y1
    b = x1 - x2
    c = -(a * x1 + b * y1)
    norm = torch.sqrt(a * a + b * b)
    degenerate = (norm < 1e-9) | ~mask[i1] | ~mask[i2]
    norm = torch.where(degenerate, 1.0, norm)
    return a / norm, b / norm, c / norm, degenerate


def ransac_extract(px, py, mask, cfg: AlignConfig = AlignConfig(),
                   gen: Optional[torch.Generator] = None,
                   pairs: Optional[Sequence] = None) -> List[Line]:
    """Sequential RANSAC: extract up to cfg.max_lines lines from the points
    px, py [P] where `mask`.  Round r's pair indices are pairs[r], or a
    draw from `gen`."""
    px = torch.as_tensor(px, dtype=torch.float32)
    py = torch.as_tensor(py, dtype=torch.float32, device=px.device)
    active = torch.as_tensor(mask).cpu().numpy().astype(bool)
    pxn = px.cpu().numpy()
    pyn = py.cpu().numpy()
    lines: List[Line] = []
    for round_i in range(cfg.max_lines):
        if active.sum() < cfg.min_inliers:
            break
        if pairs is None:
            i1, i2 = draw_pairs(gen, px.shape[0], cfg.max_iterations,
                                px.device)
        else:
            i1, i2 = (torch.as_tensor(i, device=px.device)
                      for i in pairs[round_i])
        act = torch.as_tensor(active, device=px.device)
        a, b, c, degenerate = _fit_candidates(px, py, act, i1, i2)
        # [iters, P] point-line distances.
        d = torch.abs(a[:, None] * px[None, :] + b[:, None] * py[None, :]
                      + c[:, None])
        inl = (d < cfg.distance_threshold) & act[None, :]
        counts = torch.where(degenerate, -1, torch.sum(inl, dim=1))
        best = int(torch.argmax(counts))
        if int(counts[best]) < cfg.min_inliers:
            break
        inlier_mask = inl[best].cpu().numpy()
        idxs = np.nonzero(inlier_mask)[0]
        lines.append(Line(
            a=float(a[best]), b=float(b[best]), c=float(c[best]),
            inlier_mask=inlier_mask,
            first_inlier=(float(pxn[idxs[0]]), float(pyn[idxs[0]])),
            last_inlier=(float(pxn[idxs[-1]]), float(pyn[idxs[-1]]))))
        active &= ~inlier_mask
    return lines


# ---------------------------------------------------------------------------
# Line geometry (align_server.cpp:200-300)
# ---------------------------------------------------------------------------
def line_angle_deg(l1: Line, l2: Line) -> float:
    """Acute angle between two lines in degrees (getLineAngleDeg:268-282)."""
    num = abs(l1.a * l2.b - l2.a * l1.b)
    den = l1.a * l2.a + l1.b * l2.b
    if den == 0:
        return 90.0
    return float(np.degrees(np.arctan(num / den)))


def perpendicular_foot(line: Line) -> Tuple[float, float]:
    """Foot of the perpendicular from the origin (laser) to the line
    (perpendicularPointToOrigin:283-291)."""
    den = line.a**2 + line.b**2
    return (-line.a * line.c / den, -line.b * line.c / den)


def distance_to_line(line: Line) -> float:
    """|c| for a normalized line: laser-to-wall distance."""
    return abs(line.c) / float(np.hypot(line.a, line.b))


def intersect_lines(l1: Line, l2: Line) -> Optional[Tuple[float, float]]:
    """Cramer's-rule intersection (intersectLines:200-231); None if parallel."""
    det = l1.a * l2.b - l2.a * l1.b
    if abs(det) < 1e-9:
        return None
    x = (-l1.c * l2.b + l2.c * l1.b) / det
    y = (-l1.a * l2.c + l2.a * l1.c) / det
    return (x, y)


def classify_wall_side(line: Line) -> int:
    """RIGHT/LEFT/FRONT by the perpendicular foot's y sign
    (classifyWallSide:522-536)."""
    _, y = perpendicular_foot(line)
    if y < 0:
        return WALL_RIGHT_SIDE
    if y > 0:
        return WALL_LEFT_SIDE
    return WALL_FRONT


def is_corner(l1: Line, l2: Line, threshold: float = 0.5,
              angle_tol: float = 10.0) -> bool:
    """checkIfIntersectInLines (:640-670): the intersection is a maze corner
    when it is near an endpoint of each inlier segment and the lines are
    within 10 degrees of perpendicular."""
    p = intersect_lines(l1, l2)
    if p is None:
        return False

    def near(a, b):
        return float(np.hypot(a[0] - b[0], a[1] - b[1])) <= threshold

    # |angle|: getLineAngleDeg's plain atan gives -90 for perpendicular
    # lines when the normal dot-product is negative, which would make the
    # reference's `abs(angle - 90) <= 10` check fail on a sign coin-flip
    # (align_server.cpp:662); the intended magnitude is used.
    ang = abs(line_angle_deg(l1, l2))
    return ((near(l1.first_inlier, p) or near(l1.last_inlier, p))
            and (near(l2.first_inlier, p) or near(l2.last_inlier, p))
            and abs(ang - 90.0) <= angle_tol)


# ---------------------------------------------------------------------------
# Alignment plan (faceWall + driveFromWall, align_server.cpp:538-755)
# ---------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class AlignAction:
    kind: str        # "rotate" | "drive"
    value: float     # degrees (rotate, +right/-left) or meters (drive)
    speed: float


def face_wall_action(line: Line) -> Optional[AlignAction]:
    """Rotation to face a wall (faceWall:538-566): acute angle to the x-axis,
    direction by which side the wall is on; skip under 1 degree."""
    x_axis = Line(a=1.0, b=0.0, c=0.0, inlier_mask=np.zeros(0, bool),
                  first_inlier=(0, 0), last_inlier=(0, 0))
    angle = abs(line_angle_deg(line, x_axis))
    if angle < 1.0:
        return None
    side = classify_wall_side(line)
    if side == WALL_FRONT:
        return None
    sign = 1.0 if side == WALL_RIGHT_SIDE else -1.0
    return AlignAction(kind="rotate", value=sign * angle, speed=5.0)


def align_plan(l1: Line, l2: Line,
               cfg: AlignConfig = AlignConfig()) -> List[AlignAction]:
    """Two-wall centering plan (driveFromWall:712-755).

    Preserves the reference's cm-unit bookkeeping and +0.1/+0.08 correction
    offsets: drive (d1 - 0.40 + 0.1) toward/away from wall 1 (backward at
    speed -5 when closer than 0.40 m), rotate 90 degrees toward wall 2,
    drive (d2 - 0.40 + 0.08).
    """
    actions: List[AlignAction] = []
    fw = face_wall_action(l1)
    if fw is not None:
        actions.append(fw)
    d1_cm = distance_to_line(l1) * 100.0
    move1 = d1_cm / 100.0 - cfg.wall_standoff + 0.1
    actions.append(AlignAction(
        kind="drive", value=move1, speed=-5.0 if d1_cm < 40.0 else 5.0))
    side2 = classify_wall_side(l2)
    sign = 1.0 if side2 == WALL_RIGHT_SIDE else -1.0
    actions.append(AlignAction(kind="rotate", value=sign * 90.0, speed=5.0))
    d2_cm = distance_to_line(l2) * 100.0
    move2 = d2_cm / 100.0 - cfg.wall_standoff + 0.08
    actions.append(AlignAction(
        kind="drive", value=move2, speed=-5.0 if d2_cm < 40.0 else 5.0))
    return actions
