"""K2: the systematic-expansion kernel's wrapper, its plain version and
launch count.

drawn[k] = particles[lower_bound(cdf, (k + u0)/N)], through the offspring
counts c_i = clip(floor(N*cdf_i - u0) + 1, 0, N) (expand_pallas.py:64-74,
cummax guard included), which stay plain torch as they do in the JAX
package.  The copy is exact, so kernel and plain version agree bit for
bit; both equal resample.systematic_indices of the JAX package.
"""
from __future__ import annotations

import torch

from . import build


def offspring_counts(cdf, u0):
    """Cumulative offspring counts c_i = #{k : (k+u0)/N <= cdf_i}, kept
    monotone by cummax (a cumsum can come out a ulp non-monotone)."""
    n = cdf.shape[0]
    c = torch.clamp(torch.floor(n * cdf - u0).to(torch.int32) + 1, 0, n)
    return torch.cummax(c, dim=0).values


def source_indices(counts):
    """Output k's source: the first i whose count exceeds k; outputs past
    the last count take the last source with offspring."""
    n = counts.shape[0]
    k = torch.arange(n, dtype=torch.int32, device=counts.device)
    key = torch.minimum(k, counts[-1] - 1)
    return torch.searchsorted(counts, key, right=True).clamp(max=n - 1)


def systematic_expand_plain(particles, counts):
    """What the kernel computes: particles[source_indices(counts)]."""
    return particles[source_indices(counts)]


def systematic_expand_cuda(particles, counts):
    """Launch the expansion kernel on CUDA tensors."""
    if not (particles.is_cuda and counts.device == particles.device):
        raise ValueError("systematic_expand_cuda needs particles and counts "
                         f"on one CUDA device, got {particles.device} and "
                         f"{counts.device}")
    if particles.dtype != torch.float32 or particles.dim() != 2 \
            or counts.dtype != torch.int32 \
            or counts.shape[0] != particles.shape[0]:
        raise ValueError("need float32 particles [N, D] and int32 counts [N]")
    lib = build.library()
    parts = particles.contiguous()
    counts = counts.contiguous()
    out = torch.empty_like(parts)
    err = lib.mcl_systematic_expand(
        parts.data_ptr(), counts.data_ptr(), parts.shape[0], parts.shape[1],
        out.data_ptr(), build.stream_handle(parts.device))
    build.check(err, "mcl_systematic_expand")
    systematic_expand_cuda.launches += 1
    return out


systematic_expand_cuda.launches = 0


def systematic_expand(particles, cdf, u0):
    """drawn[k] = particles[searchsorted(cdf, (k+u0)/N, 'left')]: plain
    torch on the CPU, the kernel on CUDA."""
    counts = offspring_counts(cdf, u0)
    if particles.device.type == "cpu":
        return systematic_expand_plain(particles, counts)
    if particles.is_cuda:
        return systematic_expand_cuda(particles, counts)
    raise ValueError(f"no expansion path for device {particles.device}")
