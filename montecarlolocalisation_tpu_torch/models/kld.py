"""KLD-sampling statistic: how many particles the posterior needs.

Torch counterpart of montecarlolocalisation_tpu/models/kld.py (Fox,
NIPS 2001; ROS AMCL's kld_err/kld_z): bin the cloud into a fixed
(x, y, theta) histogram, count the occupied bins k, and bound the sample
count so that, with probability 1 - delta, the K-L divergence between the
sample and the true posterior stays below epsilon:

    n(k) = (k - 1) / (2 eps) * [1 - 2/(9(k-1)) + sqrt(2/(9(k-1))) z]^3

(the Wilson-Hilferty chi-square quantile).  The server's
`adapt_mode="kld"` (io/server.py) snaps its particle budget to the
smallest halving of n_max that covers n(k).  The count is over a strided
subsample of at most cfg.subsample particles: sorted bin ids and an
adjacent difference, on the device, with no host sync.
"""
from __future__ import annotations

import math

import torch

from ..config import KLDConfig
from ..maps.grid import MazeMap


def bin_ids(particles, m: MazeMap, cfg: KLDConfig):
    """[..., N, 3] poses -> [..., N] int32 bin ids, x fastest, then y,
    then theta.  Bins are bin_xy meters from the map origin and bin_theta
    radians from -pi; poses outside the map clip into the border bins."""
    nx = max(1, math.ceil((m.extent_x - m.origin_x) / cfg.bin_xy))
    ny = max(1, math.ceil((m.extent_y - m.origin_y) / cfg.bin_xy))
    nt = max(1, math.ceil(2.0 * math.pi / cfg.bin_theta))

    def index(v, lo, width, count):
        return torch.clamp(torch.floor((v - lo) / width).to(torch.int32), 0,
                           count - 1)

    ix = index(particles[..., 0], m.origin_x, cfg.bin_xy, nx)
    iy = index(particles[..., 1], m.origin_y, cfg.bin_xy, ny)
    it = index(particles[..., 2], -math.pi, cfg.bin_theta, nt)
    return (it * ny + iy) * nx + ix


def occupied_bin_count(particles, m: MazeMap, cfg: KLDConfig):
    """Distinct occupied bins among every (N // S)-th particle, S =
    min(N, cfg.subsample): int32 [...].  After a systematic resample the
    particles are ordered by ancestor, so the stride is a stratified draw
    of the posterior; a subsample can only under-count."""
    n = particles.shape[-2]
    s = min(n, cfg.subsample)
    stride = n // s
    ids = torch.sort(bin_ids(particles[..., : s * stride : stride, :], m,
                             cfg), dim=-1).values
    return 1 + torch.sum(ids[..., 1:] != ids[..., :-1], dim=-1,
                         dtype=torch.int32)


def kld_target(k, cfg: KLDConfig):
    """The bound n(k) as float32; 1.0 where k <= 1 (the whole cloud in one
    bin), which the server clamps to its n_min."""
    k = torch.as_tensor(k)
    kf = torch.clamp(k.to(torch.float32) - 1.0, min=1.0)
    a = 2.0 / (9.0 * kf)
    n = kf / (2.0 * cfg.epsilon) * (1.0 - a + torch.sqrt(a) * cfg.z) ** 3
    return torch.where(k <= 1, 1.0, n)


def particle_target(particles, m: MazeMap, cfg: KLDConfig):
    """[..., N, 3] posterior sample -> the KLD-required count, float32
    [...]."""
    return kld_target(occupied_bin_count(particles, m, cfg), cfg)
