"""K3: the k-means kernel's wrapper, its plain version and launch count.

Lloyd's k-means on xy [N, 2] from centers0 [K, 2], an empty cluster taking
that iteration's reseed candidate from reseed [I, K, 2], ties to the first
index.  Both versions follow the dense path of the JAX package
(models/cluster.py:83-123) with its early-exit latch: the first iteration
that changes no assignment freezes centers and assignments.
"""
from __future__ import annotations

import torch

from . import build

THREADS = 256
MAX_BLOCKS = 1024


def kmeans_plain(xy, centers0, reseed):
    """The dense torch path: returns (centers [K, 2], assign [N] int32)."""
    n = xy.shape[0]
    k = centers0.shape[0]
    x, y = xy[:, 0], xy[:, 1]
    centers = centers0
    assign = torch.zeros(n, dtype=torch.int32, device=xy.device)
    done = torch.zeros((), dtype=torch.bool, device=xy.device)
    for reseed_t in reseed:
        new_assign = torch.zeros_like(assign)
        best = (x - centers[0, 0]) ** 2 + (y - centers[0, 1]) ** 2
        for i in range(1, k):
            di = (x - centers[i, 0]) ** 2 + (y - centers[i, 1]) ** 2
            closer = di < best
            new_assign = torch.where(closer, i, new_assign)
            best = torch.where(closer, di, best)
        changed = torch.any(new_assign != assign)
        # Early exit BEFORE the update step (monte_carlo.cpp:841-844).
        do_update = changed & ~done
        means, counts = [], []
        for i in range(k):
            mi = (new_assign == i).to(torch.float32)
            ci = torch.sum(mi)
            counts.append(ci)
            means.append(torch.stack([torch.sum(mi * x), torch.sum(mi * y)])
                         / torch.clamp(ci, min=1.0))
        means = torch.where((torch.stack(counts) > 0)[:, None],
                            torch.stack(means), reseed_t)
        centers = torch.where(do_update, means, centers)
        assign = torch.where(do_update, new_assign, assign)
        done = done | ~changed
    return centers, assign


def kmeans_cuda(xy, centers0, reseed):
    """Launch the k-means kernel pair (2 launches an iteration)."""
    dev = xy.device
    if not (xy.is_cuda and centers0.device == dev and reseed.device == dev):
        raise ValueError("kmeans_cuda needs xy, centers0 and reseed on one "
                         f"CUDA device, got {xy.device}, {centers0.device}, "
                         f"{reseed.device}")
    n, k = xy.shape[0], centers0.shape[0]
    if xy.dtype != torch.float32 or xy.shape[1] != 2 \
            or reseed.shape[1:] != (k, 2):
        raise ValueError("need float32 xy [N, 2], centers0 [K, 2], "
                         "reseed [I, K, 2]")
    lib = build.library()
    xy = xy.contiguous()
    reseed = reseed.to(torch.float32).contiguous()
    n_blocks = max(1, min(-(-n // THREADS), MAX_BLOCKS))
    assign = torch.zeros(n, dtype=torch.int32, device=dev)
    centers = centers0.to(torch.float32).clone().contiguous()
    partial = torch.empty(n_blocks * 3 * k, dtype=torch.float32, device=dev)
    changed = torch.empty(n_blocks, dtype=torch.int32, device=dev)
    done = torch.zeros(1, dtype=torch.int32, device=dev)
    err = lib.mcl_kmeans(
        xy.data_ptr(), n, reseed.data_ptr(), reseed.shape[0], k,
        assign.data_ptr(), centers.data_ptr(), partial.data_ptr(),
        changed.data_ptr(), done.data_ptr(), n_blocks,
        build.stream_handle(dev))
    build.check(err, "mcl_kmeans")
    kmeans_cuda.launches += 1
    return centers, assign


kmeans_cuda.launches = 0


def kmeans(xy, centers0, reseed):
    """(centers, assign): plain torch on the CPU, the kernel on CUDA."""
    if xy.device.type == "cpu":
        return kmeans_plain(xy, centers0, reseed)
    if xy.is_cuda:
        return kmeans_cuda(xy, centers0, reseed)
    raise ValueError(f"no k-means path for device {xy.device}")
