"""K2 and K2 batched: the systematic-expansion kernel's wrappers, its
launch plan, its plain version and launch counts.

drawn[k] = particles[lower_bound(cdf, (k + u0)/N)], through the offspring
counts c_i = clip(floor(N*cdf_i - u0) + 1, 0, N) kept monotone by cummax
(expand_pallas.py:64-74).  The JAX package's `systematic_expand` computes
the counts inside the function that launches its kernel, and so does K2:
the cdf and u0 go in, read on the device, and the drawn rows come out
(csrc/expand.cu), with no torch work and no host sync before the launch.
The copy is exact, so kernel, plain version and the JAX package's
resample.systematic_indices agree bit for bit.  Every function takes
leading episode dims: cdf [..., N], u0 [...], particles [..., N, D]; K2
takes one filter [N, D] and K2 batched episodes [E, N, D].
"""
from __future__ import annotations

import dataclasses

import torch

from . import build

# One block an episode up to SMALL_N sources (csrc/expand.cu kBlockMaxN:
# 4 bytes of shared memory a source, 32 KB), else two launches over source
# tiles (both paths were timed on an H100 up to the limit: CHANGES.md).
SMALL_N = 8192
SCAN_CHUNK = 4096     # csrc/expand.cu kScanChunk: a source tile's multiple


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one call runs: one block an episode and one launch (episodes
    along grid x, any number), or two launches over source tiles
    (csrc/expand.cu picks the tile) with int32 scratch for each episode's
    tile-scanned counts [n] and one maximum for each SCAN_CHUNK sources, at
    most; that path lays episodes along grid y and so launches a batch in
    chunks of build.GRID_Y_MAX episodes."""
    n: int
    episodes: int
    one_block: bool

    @property
    def device_launches(self) -> int:
        if self.one_block:
            return 1
        return 2 * -(-self.episodes // build.GRID_Y_MAX)

    @property
    def scratch_ints(self) -> int:
        return 0 if self.one_block else self.episodes * (
            self.n + -(-self.n // SCAN_CHUNK))


def launch_plan(n: int, episodes: int = 1) -> LaunchPlan:
    return LaunchPlan(n, episodes, n <= SMALL_N)


def offspring_counts(cdf, u0):
    """Cumulative offspring counts c_i = #{k : (k+u0)/N <= cdf_i}, kept
    monotone by cummax (a cumsum can come out a ulp non-monotone)."""
    n = cdf.shape[-1]
    u0 = torch.as_tensor(u0, device=cdf.device)[..., None]
    c = torch.clamp(torch.floor(n * cdf - u0).to(torch.int32) + 1, 0, n)
    return torch.cummax(c, dim=-1).values


def source_indices(counts):
    """Output k's source: the first i whose count exceeds k; outputs past
    the last count take the last source with offspring."""
    n = counts.shape[-1]
    k = torch.arange(n, dtype=torch.int32, device=counts.device)
    key = torch.minimum(k, counts[..., -1:] - 1)
    return torch.searchsorted(counts, key, right=True).clamp(max=n - 1)


def gather_rows(particles, idx):
    """particles[..., idx, :] per episode: [..., N, D] by idx [..., N]."""
    return torch.take_along_dim(particles, idx[..., None].long(), dim=-2)


def systematic_expand_plain(particles, cdf, u0):
    """What the kernels compute: each episode's
    particles[source_indices(offspring_counts(cdf, u0))]."""
    return gather_rows(particles, source_indices(offspring_counts(cdf, u0)))


def _launch(particles, cdf, u0, rank: int):
    dev = particles.device
    if not (particles.is_cuda and isinstance(u0, torch.Tensor)
            and cdf.device == dev and u0.device == dev):
        raise ValueError("systematic_expand_cuda needs particles, cdf and u0 "
                         f"tensors on one CUDA device, got {particles.device}"
                         f", {cdf.device} and "
                         f"{getattr(u0, 'device', type(u0).__name__)}")
    if particles.dtype != torch.float32 or particles.dim() != rank \
            or cdf.dtype != torch.float32 or u0.dtype != torch.float32 \
            or cdf.shape != particles.shape[:-1] \
            or u0.shape != particles.shape[:-2]:
        what = "[N, D], cdf [N] and u0 []" if rank == 2 else \
            "[E, N, D], cdf [E, N] and u0 [E]"
        raise ValueError(f"need float32 particles {what}")
    # Held in locals until the launch is enqueued, so that no copy is freed
    # (and its memory handed to the next copy) before the kernel reads it.
    parts, cdf, u0 = particles.contiguous(), cdf.contiguous(), u0.contiguous()
    n_ep = 1 if rank == 2 else parts.shape[0]
    lib = build.library()
    plan = launch_plan(parts.shape[-2], n_ep)
    out = torch.empty_like(parts)
    scratch = None if plan.one_block else torch.empty(
        plan.scratch_ints, dtype=torch.int32, device=dev)
    err = lib.mcl_systematic_expand(
        parts.data_ptr(), cdf.data_ptr(), u0.data_ptr(), n_ep,
        parts.shape[-2], parts.shape[-1], out.data_ptr(),
        None if scratch is None else scratch.data_ptr(),
        build.stream_handle(dev))
    build.check(err, "mcl_systematic_expand")
    return out


def systematic_expand_cuda(particles, cdf, u0):
    """Launch K2 on CUDA tensors: particles [N, D], cdf [N], u0 []."""
    out = _launch(particles, cdf, u0, 2)
    systematic_expand_cuda.launches += 1
    return out


systematic_expand_cuda.launches = 0


def systematic_expand_batched_cuda(particles, cdf, u0):
    """Launch K2 batched on CUDA tensors: particles [E, N, D], cdf [E, N],
    u0 [E]."""
    out = _launch(particles, cdf, u0, 3)
    systematic_expand_batched_cuda.launches += 1
    return out


systematic_expand_batched_cuda.launches = 0


def device_launches() -> int:
    """Device launches made since the library loaded
    (LaunchPlan.device_launches a call): the C entry's count, which counts
    the calls a CUDA graph captures, plus `graph_launches`, which
    models/compiled lowers by a capture's calls and raises by a replay's."""
    return (build.library().mcl_expand_device_launches()
            + device_launches.graph_launches)


device_launches.graph_launches = 0


def systematic_expand(particles, cdf, u0):
    """drawn[k] = particles[searchsorted(cdf, (k+u0)/N, 'left')] per
    episode: plain torch on the CPU, K2 (one filter) or K2 batched (a
    batch of episodes) on CUDA."""
    if particles.device.type == "cpu":
        return systematic_expand_plain(particles, cdf, u0)
    if particles.is_cuda:
        lead = particles.shape[:-2]
        if not isinstance(u0, torch.Tensor):
            u0 = torch.full(lead, u0, dtype=torch.float32,
                            device=particles.device)
        elif u0.shape != lead:
            u0 = u0.expand(lead)
        if particles.dim() == 2:
            return systematic_expand_cuda(particles, cdf, u0)
        out = systematic_expand_batched_cuda(
            particles.reshape(-1, *particles.shape[-2:]),
            cdf.reshape(-1, cdf.shape[-1]), u0.reshape(-1))
        return out.reshape(*lead, *out.shape[-2:])
    raise ValueError(f"no expansion path for device {particles.device}")
