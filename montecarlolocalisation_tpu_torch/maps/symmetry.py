"""Maze symmetry group + alias-aware convergence metrics.

Torch counterpart of montecarlolocalisation_tpu/maps/symmetry.py.  A maze
whose wall layout is invariant under members of D4 can be localized only
up to that group: a filter locked onto a symmetric alias has, physically,
converged.  The sweep metrics therefore score the best alias of the truth.

A group element g acts on world poses as
    (x, y)  -> M @ (x, y) + t
    theta   -> s * theta + dtheta          (s = +1 rotation, -1 reflection)
and on the wall tensor by a cell permutation + direction-channel
permutation.  `maze_symmetries` (numpy) enumerates the 8 D4 candidates and
keeps those that leave the wall tensor invariant; the metrics take torch
tensors with any leading dims.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

# Direction channels: RIGHT=0, TOP=1, LEFT=2, BOTTOM=3.
_FLIP_H = dict(cell=lambda w: w[:, ::-1], perm=(2, 1, 0, 3),
               M=np.array([[-1., 0.], [0., 1.]]), t=("W", 0.0),
               s=-1.0, dth=np.pi)
_FLIP_V = dict(cell=lambda w: w[::-1, :], perm=(0, 3, 2, 1),
               M=np.array([[1., 0.], [0., -1.]]), t=(0.0, "H"),
               s=-1.0, dth=0.0)
_TRANSPOSE = dict(cell=lambda w: np.swapaxes(w, 0, 1), perm=(3, 2, 1, 0),
                  M=np.array([[0., 1.], [1., 0.]]), t=(0.0, 0.0),
                  s=-1.0, dth=np.pi / 2)
_IDENTITY = dict(cell=lambda w: w, perm=(0, 1, 2, 3),
                 M=np.eye(2), t=(0.0, 0.0), s=1.0, dth=0.0)


@dataclasses.dataclass(frozen=True)
class SymmetryGroup:
    """Stacked pose actions of the maze's wall-preserving isometries.
    Index 0 is always the identity."""

    M: np.ndarray      # [G, 2, 2]
    t: np.ndarray      # [G, 2] world-frame translation (meters)
    s: np.ndarray      # [G] theta sign
    dth: np.ndarray    # [G] theta offset
    names: Tuple[str, ...]

    @property
    def size(self) -> int:
        return self.M.shape[0]

    def apply(self, pose):
        """pose [..., 3] -> aliased poses [..., G, 3]."""
        dev = pose.device
        m = torch.as_tensor(self.M, dtype=torch.float32, device=dev)
        tt = torch.as_tensor(self.t, dtype=torch.float32, device=dev)
        xy2 = torch.einsum("gij,...j->...gi", m, pose[..., :2]) + tt
        th = (torch.as_tensor(self.s, dtype=torch.float32, device=dev)
              * pose[..., None, 2]
              + torch.as_tensor(self.dth, dtype=torch.float32, device=dev))
        th = torch.atan2(torch.sin(th), torch.cos(th))
        return torch.cat([xy2, th[..., None]], dim=-1)


def _apply_wall(op, walls):
    return op["cell"](walls)[..., list(op["perm"])]


def _compose(a, b):
    """b after a, on walls and poses: perm_comp[d] = a.perm[b.perm[d]]."""
    return dict(
        cell=lambda w, A=a, B=b: B["cell"](A["cell"](w)),
        perm=tuple(a["perm"][b["perm"][d]] for d in range(4)),
        M=b["M"] @ a["M"],
        t=("compose", a, b),
        s=b["s"] * a["s"],
        dth=b["s"] * a["dth"] + b["dth"],
    )


def _concrete_t(op, W, H):
    t = op["t"]
    if isinstance(t, tuple) and t and t[0] == "compose":
        _, a, b = t
        return b["M"] @ _concrete_t(a, W, H) + _concrete_t(b, W, H)
    return np.array([W if v == "W" else (H if v == "H" else float(v))
                     for v in t])


def maze_symmetries(walls, cell_meters: float = 0.8) -> SymmetryGroup:
    """D4 elements that leave the wall tensor walls [R, C, 4] invariant,
    as pose actions in world meters (extent W = C * cell, H = R * cell)."""
    w = np.asarray(walls)
    rows, cols = w.shape[:2]
    W, H = cols * cell_meters, rows * cell_meters
    h, v, tr = _FLIP_H, _FLIP_V, _TRANSPOSE
    candidates = [("id", _IDENTITY), ("flip_h", h), ("flip_v", v),
                  ("rot180", _compose(h, v))]
    if rows == cols:
        candidates += [
            ("transpose", tr),
            ("rot90", _compose(tr, h)),
            ("rot270", _compose(tr, v)),
            ("anti_transpose", _compose(_compose(h, v), tr)),
        ]
    keep = [(name, op) for name, op in candidates
            if _apply_wall(op, w).shape == w.shape
            and np.array_equal(_apply_wall(op, w), w)]
    return SymmetryGroup(
        M=np.stack([op["M"] for _, op in keep]).astype(np.float32),
        t=np.stack([_concrete_t(op, W, H) for _, op in keep]).astype(
            np.float32),
        s=np.array([op["s"] for _, op in keep], np.float32),
        dth=np.array([op["dth"] for _, op in keep], np.float32),
        names=tuple(n for n, _ in keep),
    )


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _at(v, idx):
    """v[..., idx] for v [..., G] and idx [...]."""
    return torch.take_along_dim(v, idx[..., None], dim=-1)[..., 0]


def mixture_tracking(particles, weights, truth, sym: SymmetryGroup,
                     stray_radius: float = 0.4) -> dict:
    """The cloud as a mixture over the truth's symmetry orbit
    (symmetry.py:151): each particle joins the nearest alias of the truth,
    particles farther than `stray_radius` from every alias are stray, and
    each mode is scored by its mass and weighted RMS xy radius.

    particles [..., N, 3], weights [..., N], truth [..., 3].  Returns
    mode_mass, mode_rmse_xy [..., G], stray_mass, dominant_mode,
    dominant_mass and tracking_rmse_xy [...]."""
    aliases = sym.apply(truth.to(torch.float32))             # [..., G, 3]
    p = particles.to(torch.float32)
    w = weights.to(torch.float32)
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-30)
    d = p[..., :, None, :2] - aliases[..., None, :, :2]      # [..., N, G, 2]
    dist2 = torch.sum(d * d, dim=-1)                          # [..., N, G]
    # At a symmetry fixed point distinct aliases coincide in xy; a small
    # wrapped-theta term separates them (<= 1e-3 * pi^2 m^2).
    dth = _wrap(p[..., :, None, 2] - aliases[..., None, :, 2])
    gi = torch.argmin(dist2 + 1e-3 * dth * dth, dim=-1)       # [..., N]
    dmin2 = _at(dist2, gi)
    stray = (dmin2 > stray_radius * stray_radius).to(torch.float32)
    onehot = (torch.nn.functional.one_hot(gi, sym.size).to(torch.float32)
              * (1.0 - stray)[..., None])
    wm = w[..., None] * onehot
    mode_mass = torch.sum(wm, dim=-2)                          # [..., G]
    mode_m2 = torch.sum(wm * dmin2[..., None], dim=-2)
    mode_rmse = torch.where(
        mode_mass > 1e-9,
        torch.sqrt(mode_m2 / torch.clamp(mode_mass, min=1e-30)),
        torch.nan)
    dom = torch.argmax(mode_mass, dim=-1)
    return dict(mode_mass=mode_mass, mode_rmse_xy=mode_rmse,
                stray_mass=torch.sum(w * stray, dim=-1),
                dominant_mode=dom, dominant_mass=_at(mode_mass, dom),
                tracking_rmse_xy=_at(mode_rmse, dom))


def alias_errors(best_pose, truth, sym: SymmetryGroup) -> dict:
    """Best-over-aliases pose errors (symmetry.py:209): best_pose [..., 3]
    (may carry the (-1,-1,-1) sentinel), truth [..., 3].  Returns err_xy,
    err_theta and alias_idx (0 = the true pose)."""
    aliases = sym.apply(truth.to(torch.float32))             # [..., G, 3]
    bp = best_pose.to(torch.float32)[..., None, :]
    d = bp[..., :2] - aliases[..., :2]
    err = torch.sqrt(torch.sum(d * d, dim=-1))                # [..., G]
    gi = torch.argmin(err, dim=-1)
    dth = _wrap(bp[..., 2] - aliases[..., 2])
    return dict(err_xy=_at(err, gi), err_theta=_at(torch.abs(dth), gi),
                alias_idx=gi)
