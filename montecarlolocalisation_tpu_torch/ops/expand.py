"""K2 and K2 batched: the systematic-expansion kernel's wrappers, its
plain version and launch counts.

drawn[k] = particles[lower_bound(cdf, (k + u0)/N)], through the offspring
counts c_i = clip(floor(N*cdf_i - u0) + 1, 0, N) (expand_pallas.py:64-74,
cummax guard included), which stay plain torch as they do in the JAX
package.  The copy is exact, so kernel and plain version agree bit for
bit; both equal resample.systematic_indices of the JAX package.  Every
function takes leading episode dims: cdf [..., N], u0 [...], particles
[..., N, D]; K2 takes one filter [N, D] and K2 batched episodes [E, N, D].
"""
from __future__ import annotations

import torch

from . import build


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


def systematic_expand_plain(particles, counts):
    """What the kernels compute: each episode's
    particles[source_indices(counts)]."""
    return gather_rows(particles, source_indices(counts))


def _launch(particles, counts, rank: int):
    if not (particles.is_cuda and counts.device == particles.device):
        raise ValueError("systematic_expand_cuda needs particles and counts "
                         f"on one CUDA device, got {particles.device} and "
                         f"{counts.device}")
    if particles.dtype != torch.float32 or particles.dim() != rank \
            or counts.dtype != torch.int32 \
            or counts.shape != particles.shape[:-1]:
        what = "[N, D] and int32 counts [N]" if rank == 2 else \
            "[E, N, D] and int32 counts [E, N]"
        raise ValueError(f"need float32 particles {what}")
    parts = particles.contiguous()
    counts = counts.contiguous()
    n_ep = 1 if rank == 2 else parts.shape[0]
    if n_ep > build.MAX_EPISODES:
        raise ValueError(f"{n_ep} episodes > {build.MAX_EPISODES}")
    lib = build.library()
    out = torch.empty_like(parts)
    err = lib.mcl_systematic_expand(
        parts.data_ptr(), counts.data_ptr(), n_ep, parts.shape[-2],
        parts.shape[-1], out.data_ptr(), build.stream_handle(parts.device))
    build.check(err, "mcl_systematic_expand")
    return out


def systematic_expand_cuda(particles, counts):
    """Launch K2 on CUDA tensors: particles [N, D], counts [N]."""
    out = _launch(particles, counts, 2)
    systematic_expand_cuda.launches += 1
    return out


systematic_expand_cuda.launches = 0


def systematic_expand_batched_cuda(particles, counts):
    """Launch K2 batched on CUDA tensors: particles [E, N, D], counts
    [E, N]."""
    out = _launch(particles, counts, 3)
    systematic_expand_batched_cuda.launches += 1
    return out


systematic_expand_batched_cuda.launches = 0


def systematic_expand(particles, cdf, u0):
    """drawn[k] = particles[searchsorted(cdf, (k+u0)/N, 'left')] per
    episode: plain torch on the CPU, K2 (one filter) or K2 batched (a
    batch of episodes) on CUDA."""
    counts = offspring_counts(cdf, u0)
    if particles.device.type == "cpu":
        return systematic_expand_plain(particles, counts)
    if particles.is_cuda:
        if particles.dim() == 2:
            return systematic_expand_cuda(particles, counts)
        lead = particles.shape[:-2]
        out = systematic_expand_batched_cuda(
            particles.reshape(-1, *particles.shape[-2:]),
            counts.reshape(-1, counts.shape[-1]))
        return out.reshape(*lead, *out.shape[-2:])
    raise ValueError(f"no expansion path for device {particles.device}")
