"""K3 and K3 batched: the k-means kernel's wrappers, its plain version and
launch counts.

Lloyd's k-means on xy [N, 2] from centers0 [K, 2], an empty cluster taking
that iteration's reseed candidate from reseed [I, K, 2], ties to the first
index.  Both versions follow the dense path of the JAX package
(models/cluster.py:83-123) with its early-exit latch: the first iteration
that changes no assignment freezes centers and assignments.  Episodes
carry leading dims: xy [E, N, 2], centers0 [E, K, 2], reseed [E, I, K, 2],
each episode with its own latch; K3 takes one filter and K3 batched a
batch.
"""
from __future__ import annotations

import torch

from . import build

THREADS = 256
MAX_BLOCKS = 1024


def kmeans_plain(xy, centers0, reseed):
    """The dense torch path: returns (centers [..., K, 2], assign [..., N]
    int32)."""
    n = xy.shape[-2]
    k = centers0.shape[-2]
    x, y = xy[..., 0], xy[..., 1]
    lead = xy.shape[:-2]
    centers = centers0
    assign = torch.zeros(lead + (n,), dtype=torch.int32, device=xy.device)
    done = torch.zeros(lead, dtype=torch.bool, device=xy.device)
    for t in range(reseed.shape[-3]):
        reseed_t = reseed[..., t, :, :]
        cx, cy = centers[..., 0:1], centers[..., 1:2]   # [..., K, 1]
        new_assign = torch.zeros_like(assign)
        best = (x - cx[..., 0, :]) ** 2 + (y - cy[..., 0, :]) ** 2
        for i in range(1, k):
            di = (x - cx[..., i, :]) ** 2 + (y - cy[..., i, :]) ** 2
            closer = di < best
            new_assign = torch.where(closer, i, new_assign)
            best = torch.where(closer, di, best)
        changed = torch.any(new_assign != assign, dim=-1)
        # Early exit BEFORE the update step (monte_carlo.cpp:841-844).
        do_update = changed & ~done
        means, counts = [], []
        for i in range(k):
            mi = (new_assign == i).to(torch.float32)
            ci = torch.sum(mi, dim=-1)
            counts.append(ci)
            means.append(torch.stack([torch.sum(mi * x, dim=-1),
                                      torch.sum(mi * y, dim=-1)], dim=-1)
                         / torch.clamp(ci, min=1.0)[..., None])
        means = torch.where((torch.stack(counts, dim=-1) > 0)[..., None],
                            torch.stack(means, dim=-2), reseed_t)
        centers = torch.where(do_update[..., None, None], means, centers)
        assign = torch.where(do_update[..., None], new_assign, assign)
        done = done | ~changed
    return centers, assign


def _launch(xy, centers0, reseed, rank: int):
    dev = xy.device
    if not (xy.is_cuda and centers0.device == dev and reseed.device == dev):
        raise ValueError("kmeans_cuda needs xy, centers0 and reseed on one "
                         f"CUDA device, got {xy.device}, {centers0.device}, "
                         f"{reseed.device}")
    lead = xy.shape[:-2]
    n, k = xy.shape[-2], centers0.shape[-2]
    if xy.dtype != torch.float32 or xy.dim() != rank or xy.shape[-1] != 2 \
            or centers0.shape != lead + (k, 2) \
            or reseed.dim() != rank + 1 or reseed.shape[:-3] != lead \
            or reseed.shape[-2:] != (k, 2):
        raise ValueError("need float32 xy [..., N, 2], centers0 [..., K, 2], "
                         "reseed [..., I, K, 2]")
    n_ep = 1 if rank == 2 else xy.shape[0]
    if n_ep > build.MAX_EPISODES:
        raise ValueError(f"{n_ep} episodes > {build.MAX_EPISODES}")
    lib = build.library()
    xy = xy.contiguous()
    reseed = reseed.to(torch.float32).contiguous()
    n_blocks = max(1, min(-(-n // THREADS), MAX_BLOCKS))
    assign = torch.zeros(lead + (n,), dtype=torch.int32, device=dev)
    centers = centers0.to(torch.float32).clone().contiguous()
    partial = torch.empty(n_ep * n_blocks * 3 * k, dtype=torch.float32,
                          device=dev)
    changed = torch.empty(n_ep * n_blocks, dtype=torch.int32, device=dev)
    done = torch.zeros(n_ep, dtype=torch.int32, device=dev)
    err = lib.mcl_kmeans(
        xy.data_ptr(), n_ep, n, reseed.data_ptr(), reseed.shape[-3], k,
        assign.data_ptr(), centers.data_ptr(), partial.data_ptr(),
        changed.data_ptr(), done.data_ptr(), n_blocks,
        build.stream_handle(dev))
    build.check(err, "mcl_kmeans")
    return centers, assign


def kmeans_cuda(xy, centers0, reseed):
    """Launch K3 (2 launches an iteration): xy [N, 2]."""
    out = _launch(xy, centers0, reseed, 2)
    kmeans_cuda.launches += 1
    return out


kmeans_cuda.launches = 0


def kmeans_batched_cuda(xy, centers0, reseed):
    """Launch K3 batched (2 launches an iteration): xy [E, N, 2]."""
    out = _launch(xy, centers0, reseed, 3)
    kmeans_batched_cuda.launches += 1
    return out


kmeans_batched_cuda.launches = 0


def kmeans(xy, centers0, reseed):
    """(centers, assign): plain torch on the CPU, K3 (one filter) or K3
    batched (a batch of episodes) on CUDA."""
    if xy.device.type == "cpu":
        return kmeans_plain(xy, centers0, reseed)
    if xy.is_cuda:
        if xy.dim() == 2:
            return kmeans_cuda(xy, centers0, reseed)
        lead = xy.shape[:-2]
        c, a = kmeans_batched_cuda(
            xy.reshape(-1, *xy.shape[-2:]),
            centers0.reshape(-1, *centers0.shape[-2:]),
            reseed.reshape(-1, *reseed.shape[-3:]))
        return c.reshape(*lead, *c.shape[-2:]), a.reshape(*lead, -1)
    raise ValueError(f"no k-means path for device {xy.device}")
