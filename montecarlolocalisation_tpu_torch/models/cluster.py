"""k-means pose clustering + confidence estimation.

Torch counterpart of montecarlolocalisation_tpu/models/cluster.py
(reference: monte_carlo.cpp:802-949): K=3 k-means on the particles' xy with
<=20 iterations from random particles, early exit once assignments stop
changing, empty clusters reseeded from random particles; the best cluster
by summed weight gives the pose (theta as the circular mean of its
members) and the confidence is the share of particles within 0.4 m of its
center.

The random particle indices are arguments (init [K], reseed [I, K]);
`draw_kmeans` makes them from a torch.Generator.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..config import ClusterConfig
from ..maps.grid import f32_reciprocal
from ..ops import kmeans as kmeans_op
from ..utils.angles import circular_mean


def draw_kmeans(gen: torch.Generator, n: int, cfg: ClusterConfig, device):
    """(init [K], reseed [I, K]) particle indices in [0, n)."""
    init = torch.randint(0, n, (cfg.k,), generator=gen, device=device)
    reseed = torch.randint(0, n, (cfg.max_iters, cfg.k), generator=gen,
                           device=device)
    return init, reseed


def kmeans(xy, cfg: ClusterConfig, init_idx, reseed_idx):
    """xy [N, 2] -> (centers [K, 2], assignments [N] int32).

    impl "auto"/"pallas" take the k-means kernel on CUDA (ops/kmeans) and
    its plain version on the CPU; "dense" forces the plain version."""
    centers0 = xy[init_idx]
    reseed = xy[reseed_idx]
    if cfg.impl == "dense":
        return kmeans_op.kmeans_plain(xy, centers0, reseed)
    if cfg.impl not in ("auto", "pallas"):
        raise ValueError(f"unknown cluster impl {cfg.impl!r}")
    return kmeans_op.kmeans(xy, centers0, reseed)


def cluster_confidence(
    particles, weights, threshold, cfg: ClusterConfig, init_idx, reseed_idx,
    weighted: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (confidence_ratio, best_pose[3] or the (-1,-1,-1) sentinel).

    `threshold` is the dynamic confident-level threshold
    (monte_carlo.cpp:935-943); the counting radius is the fixed
    cfg.near_radius regardless of the cluster threshold, a reference quirk.
    `weighted=True` is the importance-weighted form (weight share near the
    center, weighted mean pose of the best cluster)."""
    xy = particles[:, :2]
    centers, assign = kmeans(xy, cfg, init_idx, reseed_idx)
    cluster_w = torch.stack([torch.sum(torch.where(assign == i, weights, 0.0))
                             for i in range(cfg.k)])
    best = torch.argmax(cluster_w)
    cx, cy = centers[best, 0], centers[best, 1]
    member = (assign == best).to(torch.float32)
    r2 = cfg.near_radius ** 2
    if weighted:
        w_sum = torch.clamp(torch.sum(weights), min=1e-30)
        mw = member * weights
        mw_sum = torch.clamp(torch.sum(mw), min=1e-30)
        cx = torch.sum(mw * xy[:, 0]) / mw_sum
        cy = torch.sum(mw * xy[:, 1]) / mw_sum
        theta = circular_mean(particles[:, 2], weights=mw)
        d2 = (xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2
        ratio = torch.sum(torch.where(d2 <= r2, weights, 0.0)) / w_sum
    else:
        theta = circular_mean(particles[:, 2], weights=member)
        d2 = (xy[:, 0] - cx) ** 2 + (xy[:, 1] - cy) ** 2
        ratio = torch.sum((d2 <= r2).to(torch.float32)) * f32_reciprocal(
            xy.shape[0])
    best_pose = torch.where(ratio > threshold, torch.stack([cx, cy, theta]),
                            -1.0)
    return ratio, best_pose
