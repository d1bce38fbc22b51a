"""K3 and K3 batched: the k-means kernel's wrappers, its launch plan, its
plain version and launch counts.

Lloyd's k-means on xy [N, 2] from centers0 [K, 2], an empty cluster taking
that iteration's reseed candidate from reseed [I, K, 2], ties to the first
index.  Both versions follow the dense path of the JAX package
(models/cluster.py:83-123) with its early-exit latch: the first iteration
that changes no assignment freezes centers and assignments.  Episodes
carry leading dims: xy [E, N, 2], centers0 [E, K, 2], reseed [E, I, K, 2],
each episode with its own latch; K3 takes one filter and K3 batched a
batch.  The kernel (csrc/kmeans.cu) runs every iteration inside one launch
and reads xy through its strides, so the [..., :2] view of the particles
goes in uncopied.
"""
from __future__ import annotations

import dataclasses

import torch

from . import build

CHUNK = 256          # points one warp sums in a fixed float tree
GROUP_CHUNKS = 32    # chunks one warp adds in a fixed double tree
GROUP = CHUNK * GROUP_CHUNKS
BLOCK_MAX_N = 16_384   # one block an episode: xy and assignments in smem
GRID_THREADS = 1024
MAX_K = 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call runs.  The summation order is fixed by n alone: chunk
    c holds points [c * CHUNK, (c + 1) * CHUNK) of an episode, cut at n,
    and group g chunks [g * GROUP_CHUNKS, (g + 1) * GROUP_CHUNKS); chunk
    sums are float, group sums double, and an episode's groups are added in
    group order.  n <= BLOCK_MAX_N runs one block an episode with one warp
    per chunk up to 8 warps; larger n runs a persistent cooperative grid of
    GRID_THREADS-thread blocks (its size is the card's: as many blocks as
    can be resident)."""
    n: int
    episodes: int
    one_block: bool
    threads: int
    n_chunks: int
    n_groups: int

    def chunk(self, c: int):
        """Points [start, stop) of chunk c of an episode."""
        return c * CHUNK, min((c + 1) * CHUNK, self.n)

    def group_chunks(self, g: int):
        """Chunks [start, stop) of group g."""
        return g * GROUP_CHUNKS, min((g + 1) * GROUP_CHUNKS, self.n_chunks)


def launch_plan(n: int, episodes: int = 1) -> LaunchPlan:
    n_chunks = -(-n // CHUNK)
    one_block = n <= BLOCK_MAX_N
    threads = 32 * min(8, max(1, n_chunks)) if one_block else GRID_THREADS
    return LaunchPlan(n=n, episodes=episodes, one_block=one_block,
                      threads=threads, n_chunks=n_chunks,
                      n_groups=max(1, -(-n // GROUP)))


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
            or xy.stride(-1) != 1 or not 1 <= k <= MAX_K \
            or centers0.shape != lead + (k, 2) \
            or reseed.dim() != rank + 1 or reseed.shape[:-3] != lead \
            or reseed.shape[-2:] != (k, 2):
        raise ValueError("need float32 xy [..., N, 2] with unit column "
                         "stride, centers0 [..., K, 2] with K <= 8, reseed "
                         "[..., I, K, 2]")
    n_ep = 1 if rank == 2 else xy.shape[0]
    lib = build.library()
    plan = launch_plan(n, n_ep)
    centers0 = centers0.to(torch.float32).contiguous()
    reseed = reseed.to(torch.float32).contiguous()
    assign = torch.empty(lead + (n,), dtype=torch.int32, device=dev)
    centers = torch.empty_like(centers0)
    gsum = gflag = None
    if not plan.one_block:
        groups = n_ep * plan.n_groups
        gsum = torch.empty(2 * groups * 3 * k, dtype=torch.float64,
                           device=dev)
        gflag = torch.empty(2 * groups, dtype=torch.int32, device=dev)
    err = lib.mcl_kmeans(
        xy.data_ptr(), xy.stride(0) if rank == 3 else 0, xy.stride(-2),
        n_ep, n, centers0.data_ptr(), reseed.data_ptr(), reseed.shape[-3],
        k, assign.data_ptr(), centers.data_ptr(),
        None if gsum is None else gsum.data_ptr(),
        None if gflag is None else gflag.data_ptr(), int(plan.one_block),
        plan.n_groups, plan.threads, build.stream_handle(dev))
    build.check(err, "mcl_kmeans")
    return centers, assign


def kmeans_cuda(xy, centers0, reseed):
    """Launch K3 (one launch a call): xy [N, 2], any row stride."""
    out = _launch(xy, centers0, reseed, 2)
    kmeans_cuda.launches += 1
    return out


kmeans_cuda.launches = 0


def kmeans_batched_cuda(xy, centers0, reseed):
    """Launch K3 batched (one launch a call): xy [E, N, 2], any row and
    episode stride."""
    out = _launch(xy, centers0, reseed, 3)
    kmeans_batched_cuda.launches += 1
    return out


kmeans_batched_cuda.launches = 0


def device_launches() -> int:
    """Device launches made since the library loaded (one a call), graph
    replays included, as ops/expand.device_launches counts them."""
    return (build.library().mcl_kmeans_device_launches()
            + device_launches.graph_launches)


device_launches.graph_launches = 0


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
