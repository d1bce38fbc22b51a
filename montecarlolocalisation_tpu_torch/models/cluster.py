"""k-means pose clustering + confidence estimation.

Torch counterpart of montecarlolocalisation_tpu/models/cluster.py
(reference: monte_carlo.cpp:802-949): K=3 k-means on the particles' xy with
<=20 iterations from random particles, early exit once assignments stop
changing, empty clusters reseeded from random particles; the best cluster
by summed weight gives the pose (theta as the circular mean of its
members) and the confidence is the share of particles within 0.4 m of its
center.

The random particle indices are arguments (init [..., K], reseed
[..., I, K]); `draw_kmeans` makes them from a torch.Generator.  Particles
carry leading episode dims ([N, 3] one filter, [E, N, 3] a batch); each
episode clusters on its own, with its own early-exit latch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ClusterConfig
from ..maps.grid import f32_reciprocal
from ..ops import kmeans as kmeans_op
from ..utils.angles import circular_mean


def draw_kmeans(gen: torch.Generator, n: int, cfg: ClusterConfig, device,
                batch=()):
    """(init [..., K], reseed [..., I, K]) particle indices in [0, n)."""
    batch = tuple(batch)
    init = torch.randint(0, n, batch + (cfg.k,), generator=gen,
                         device=device)
    reseed = torch.randint(0, n, batch + (cfg.max_iters, cfg.k),
                           generator=gen, device=device)
    return init, reseed


def _take(v, idx):
    """v[..., idx, :] per episode for v [..., N, D] and idx [..., M]."""
    return torch.take_along_dim(v, idx[..., None], dim=-2)


def kmeans(xy, cfg: ClusterConfig, init_idx, reseed_idx):
    """xy [..., N, 2] -> (centers [..., K, 2], assignments [..., N] int32).

    impl "auto"/"pallas" take the k-means kernels on CUDA (ops/kmeans) and
    their plain version on the CPU; "dense" forces the plain version."""
    centers0 = _take(xy, init_idx)
    lead = reseed_idx.shape[:-2]
    reseed = _take(xy, reseed_idx.reshape(lead + (-1,))).reshape(
        reseed_idx.shape + (2,))
    if cfg.impl == "dense":
        return kmeans_op.kmeans_plain(xy, centers0, reseed)
    if cfg.impl not in ("auto", "pallas"):
        raise ValueError(f"unknown cluster impl {cfg.impl!r}")
    return kmeans_op.kmeans(xy, centers0, reseed)


def _pick(v, best):
    """v[..., best] for v [..., K] and best [...]."""
    return torch.take_along_dim(v, best[..., None], dim=-1)[..., 0]


def cluster_confidence(
    particles, weights, threshold, cfg: ClusterConfig, init_idx, reseed_idx,
    weighted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (confidence_ratio [...], best_pose [..., 3] or the (-1,-1,-1)
    sentinel).

    `threshold` is the dynamic confident-level threshold
    (monte_carlo.cpp:935-943); the counting radius is the fixed
    cfg.near_radius regardless of the cluster threshold, a reference quirk.
    `weighted=True` is the importance-weighted form (weight share near the
    center, weighted mean pose of the best cluster)."""
    xy = particles[..., :2]   # a view: the k-means kernel reads its strides
    x, y = xy[..., 0], xy[..., 1]
    centers, assign = kmeans(xy, cfg, init_idx, reseed_idx)
    cluster_w = torch.stack([torch.sum(torch.where(assign == i, weights, 0.0),
                                       dim=-1)
                             for i in range(cfg.k)], dim=-1)
    best = torch.argmax(cluster_w, dim=-1)
    cx, cy = _pick(centers[..., 0], best), _pick(centers[..., 1], best)
    member = (assign == best[..., None]).to(torch.float32)
    r2 = cfg.near_radius ** 2
    if weighted:
        w_sum = torch.clamp(torch.sum(weights, dim=-1), min=1e-30)
        mw = member * weights
        mw_sum = torch.clamp(torch.sum(mw, dim=-1), min=1e-30)
        cx = torch.sum(mw * x, dim=-1) / mw_sum
        cy = torch.sum(mw * y, dim=-1) / mw_sum
        theta = circular_mean(particles[..., 2], weights=mw, dim=-1)
        d2 = (x - cx[..., None]) ** 2 + (y - cy[..., None]) ** 2
        ratio = torch.sum(torch.where(d2 <= r2, weights, 0.0),
                          dim=-1) / w_sum
    else:
        theta = circular_mean(particles[..., 2], weights=member, dim=-1)
        d2 = (x - cx[..., None]) ** 2 + (y - cy[..., None]) ** 2
        ratio = torch.sum((d2 <= r2).to(torch.float32), dim=-1) * \
            f32_reciprocal(xy.shape[-2])
    best_pose = torch.where((ratio > threshold)[..., None],
                            torch.stack([cx, cy, theta], dim=-1), -1.0)
    return ratio, best_pose
