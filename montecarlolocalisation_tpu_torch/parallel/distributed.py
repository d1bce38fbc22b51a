"""Multi-GPU MCL: the particle axis sharded over processes.

Torch counterpart of montecarlolocalisation_tpu/parallel/distributed.py.
One process a device, joined by torch.distributed: NCCL for CUDA tensors,
gloo for CPU tensors.  The JAX package's ('episode', 'particle') Mesh is a
DeviceMesh with the same dims (`make_mesh`); its `axis_name` is the
"particle" ProcessGroup, and each collective is one torch call:

  psum                     all_reduce(SUM)
  pmax                     all_reduce(MAX)
  all_gather of a row      all_gather_into_tensor
  axis_index               the rank in the group
  ppermute ring            batch_isend_irecv to rank + 1, from rank - 1

Design, as in the JAX package:

  * each rank holds a contiguous block of particles [..., N/P, 3] and
    weights [..., N/P], in group-rank order; the map and every per-filter
    scalar are replicated, and collectives keep the scalars bit-equal;
  * motion, refinement and the beam weights are per particle: each rank
    runs them on its block (sensor.beam_weights, so K1 on CUDA, K1
    batched on an episode block);
  * resampling needs the global weight distribution but not the global
    cloud: [P] shard totals cross first, then source blocks travel the
    ring and each rank assembles its own N/P output slots (the systematic
    and the multinomial draw), so memory stays O(N/P) a rank; the legacy
    "allgather" exchange replicates the cloud, as in the JAX package;
  * the injection cap is global (first come across ranks) and k-means
    keeps replicated centers over sharded points, its sums all_reduced.

The ring draws and the sharded k-means are plain torch here because the
JAX package runs them in XLA (never K2 or K3).  Cumulative sums accumulate
in float64 and round to float32 (the port's summation order), and the
[P] vectors of shard totals are summed in one float32 order on every rank,
so the block boundaries agree across ranks.

Random draws.  JAX folds the shard index into a shard-invariant key; the
port takes every tick's draws as tensors (ShardDraws, SLAMDraws), and a
sharded state's generator is a ShardGenerators pair: `shared`, seeded the
same on every rank of a particle group, for what JAX draws from a
shard-invariant key (the systematic u0, the multinomial's extra spacing,
the k-means indices, shared motion noise), and `rank`, seeded from
(seed, rank), for the rest.  Both advance by the same draws on every rank.

`make_sharded_step` and its batched and SLAM forms return steps that run
their ticks through models/compiled's TickGraph: one CUDA graph of K
ticks, the collectives captured with the kernels.  On CUDA a tick is
captured or the call raises; the eager tick is what a graph captures and
what the CPU runs.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import FilterConfig
from ..maps.grid import MazeMap, f32_reciprocal
from ..models import cluster, compiled, motion, refine, resample, sensor
from ..models import filter as mcl
from ..utils.angles import normalize_angle

# all_gather_into_tensor took the name all_gather_single in later torch.
_all_gather_into = (getattr(dist, "all_gather_single", None)
                    or dist.all_gather_into_tensor)
AXES = ("episode", "particle")


def make_mesh(n_particle_shards: Optional[int] = None,
              n_episode_shards: int = 1, device_type: Optional[str] = None):
    """The ('episode', 'particle') DeviceMesh over every rank of the
    initialized process group, ranks row-major (a particle group is
    n_particle_shards consecutive ranks).  Unlike the JAX package, the
    mesh covers the whole world: n_episode_shards * n_particle_shards must
    be the world size.  `device_type` defaults to the backend's ("cuda"
    under NCCL, else "cpu")."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_particle_shards is None:
        n_particle_shards = world // n_episode_shards
    if n_particle_shards * n_episode_shards != world:
        raise ValueError(
            f"a {n_episode_shards} x {n_particle_shards} mesh needs "
            f"{n_episode_shards * n_particle_shards} ranks, the world has "
            f"{world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_episode_shards,
                                          n_particle_shards),
                            mesh_dim_names=AXES)


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------
def _rank(group) -> int:
    return dist.get_rank(group)


def _size(group) -> int:
    return dist.get_world_size(group)


def check_group(group, t: torch.Tensor) -> None:
    """NCCL for CUDA tensors, gloo for CPU tensors, or a raise: nothing
    moves a sharded state between the card and the host."""
    backend = dist.get_backend(group)
    if ("nccl" if t.is_cuda else "gloo") not in backend:
        raise ValueError(f"a {backend} group cannot reduce {t.device} "
                         "tensors: NCCL takes CUDA tensors, gloo CPU ones")


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    """all_reduce of a fresh tensor, in place; returns it."""
    dist.all_reduce(x, op=op, group=group)
    return x


def _psum(x, group):
    return _all_reduce(x.contiguous(), group)


def _all_gather(v, group):
    """v [...] of every rank -> [P, ...] in group-rank order."""
    shape = v.shape
    flat = v.contiguous().reshape(1, -1)
    out = torch.empty((_size(group), flat.shape[1]), dtype=v.dtype,
                      device=v.device)
    _all_gather_into(out, flat, group=group)
    return out.reshape((_size(group),) + shape)


def _gather_last(v, group):
    """v [...] of every rank -> [..., P]."""
    return _all_gather(v, group).movedim(0, -1)


def _gather_dim(v, group, dim: int):
    """Blocks [..., n, ...] of every rank concatenated along `dim`."""
    g = _all_gather(v, group)                       # [P, ..., n, ...]
    g = g.movedim(0, dim)                           # [..., P, n, ...]
    return g.flatten(dim, dim + 1)


def _ring_shift(tensors, group):
    """Each rank sends `tensors` to rank + 1 of the group and receives
    rank - 1's (the JAX package's ppermute ring)."""
    p, r = _size(group), _rank(group)
    nxt = dist.get_global_rank(group, (r + 1) % p)
    prv = dist.get_global_rank(group, (r - 1) % p)
    sends = [t.contiguous() for t in tensors]
    recvs = [torch.empty_like(t) for t in sends]
    ops = ([dist.P2POp(dist.isend, t, nxt, group, i)
            for i, t in enumerate(sends)]
           + [dist.P2POp(dist.irecv, t, prv, group, i)
              for i, t in enumerate(recvs)])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recvs


def _f32_cumsum(g):
    """Inclusive sum of [..., P] along the last axis, one float32 add a
    step: the same order on every rank and on every device."""
    acc = [g[..., 0]]
    for s in range(1, g.shape[-1]):
        acc.append(acc[-1] + g[..., s])
    return torch.stack(acc, dim=-1)


def _local_cumsum(v):
    """The port's summation order: float64 accumulation, float32 result."""
    return torch.cumsum(v.double(), dim=-1).float()


def _before(incl, my: int):
    """incl[..., my - 1], or None on rank 0 (nothing comes before it)."""
    return incl[..., my - 1] if my > 0 else None


# ---------------------------------------------------------------------------
# Resampling: the ring offspring exchange
# ---------------------------------------------------------------------------
def _global_cdf_prefix(norm_local, group):
    """(cdf_local [..., n], incl [..., P]): the GLOBAL inclusive CDF at each
    local source, and the global CDF at the end of each rank's block.
    Only the [P] shard totals cross; `incl` is summed from the same
    gathered vector on every rank, and each rank's last CDF value equals
    its entry of `incl` bit for bit."""
    lc = _local_cumsum(norm_local)
    incl = _f32_cumsum(_gather_last(lc[..., -1], group))
    prefix = _before(incl, _rank(group))
    return (lc if prefix is None else prefix[..., None] + lc), incl


def _ring_systematic_draw(particles, norm_local, u0, group):
    """Distributed systematic resampling at O(N/P) memory a rank
    (distributed.py:78-142 of the JAX package).  Each rank computes its
    sources' offspring intervals in global output slots, ends_i =
    clip(floor(N cdf_i - u0) + 1, 0, N); source blocks travel the ring
    (P - 1 steps), and at each step a rank scatters the visiting block's
    interval starts into its own n-slot block, cummax-fills and selects
    the slots in the range that block tiles.  The result is this rank's
    block of particles[systematic_indices(cdf, u0)] on the gathered cdf,
    bit for bit.  particles [..., n, D], norm_local [..., n], u0 [...]."""
    n_loc = norm_local.shape[-1]
    p, my = _size(group), _rank(group)
    n_global = n_loc * p
    base = my * n_loc
    dev = particles.device
    lead = norm_local.shape[:-1]

    cdf_local, incl = _global_cdf_prefix(norm_local, group)
    u = u0[..., None]

    def ends_of(c):
        return torch.clamp(torch.floor(n_global * c - u).to(torch.int32) + 1,
                           0, n_global)

    # Block boundaries from the replicated [P] vector: a global tiling.
    blk_hi_all = torch.cummax(ends_of(incl), dim=-1).values
    blk_hi_all = torch.cat([blk_hi_all[..., :-1],
                            torch.full(lead + (1,), n_global,
                                       dtype=torch.int32, device=dev)], -1)

    def block(j: int):
        lo = _before(blk_hi_all, j)
        lo = torch.zeros_like(blk_hi_all[..., 0]) if lo is None else lo
        return lo, blk_hi_all[..., j]

    blk_lo, blk_hi = block(my)
    # Trailing slots fall to the block's last source.
    ends = torch.minimum(torch.maximum(
        torch.cummax(ends_of(cdf_local), dim=-1).values, blk_lo[..., None]),
        blk_hi[..., None])
    ends = torch.cat([ends[..., :-1], blk_hi[..., None]], -1)
    starts = torch.cat([blk_lo[..., None], ends[..., :-1]], -1)

    slot = base + torch.arange(n_loc, dtype=torch.int32, device=dev)
    ids = torch.arange(n_loc, dtype=torch.int32, device=dev).expand(
        lead + (n_loc,))
    empty = torch.full(lead + (n_loc + 1,), -1, dtype=torch.int32,
                       device=dev)
    drawn = torch.zeros_like(particles)
    v_starts, v_ends, v_parts = starts, ends, particles
    for r in range(p):
        v_lo, v_hi = block((my - r) % p)
        lo = torch.clamp(v_starts - base, 0, n_loc)
        hi = torch.clamp(v_ends - base, 0, n_loc)
        pos = torch.where(hi > lo, lo, n_loc).long()    # n_loc: dropped
        buf = empty.scatter_reduce(-1, pos, ids, reduce="amax")[..., :n_loc]
        buf = torch.cummax(buf, dim=-1).values
        vals = torch.take_along_dim(
            v_parts, torch.clamp(buf, 0, n_loc - 1).long()[..., None], -2)
        inr = (slot >= v_lo[..., None]) & (slot < v_hi[..., None])
        drawn = torch.where(inr[..., None], vals, drawn)
        if r < p - 1:
            v_starts, v_ends, v_parts = _ring_shift(
                [v_starts, v_ends, v_parts], group)
    return drawn


def _sorted_uniforms(spacings, spacing_extra, group):
    """This rank's block of N ascending uniforms (exponential spacings):
    rs = (prefix + cumsum(e)) / (total + e_extra), e = -log(spacings)
    [..., n] of this rank and e_extra = -log(spacing_extra) [...],
    replicated (distributed.py:166-177 of the JAX package)."""
    e = -torch.log(spacings)
    e_extra = -torch.log(spacing_extra)
    se = _local_cumsum(e)
    incl_e = _f32_cumsum(_gather_last(se[..., -1], group))
    pre = _before(incl_e, _rank(group))
    num = se if pre is None else pre[..., None] + se
    return num / (incl_e[..., -1] + e_extra)[..., None]


def _ring_multinomial_draw(particles, norm_local, spacings, spacing_extra,
                           group):
    """Distributed multinomial resampling at O(N/P) a rank
    (distributed.py:145-195 of the JAX package): rank t draws output
    block t of the globally sorted uniforms; source CDF blocks travel the
    ring, and a visiting block answers the uniforms inside its CDF span by
    lower_bound (searchsorted, side="left", the port's counterpart of
    resample.crossrank_counts)."""
    n_loc = norm_local.shape[-1]
    p, my = _size(group), _rank(group)
    rs = _sorted_uniforms(spacings, spacing_extra, group).contiguous()
    cdf_local, incl = _global_cdf_prefix(norm_local, group)
    drawn = torch.zeros_like(particles)
    v_cdf, v_parts = cdf_local, particles
    for r in range(p):
        j = (my - r) % p
        cnt = torch.searchsorted(v_cdf.contiguous(), rs, side="left")
        vals = torch.take_along_dim(
            v_parts, torch.clamp(cnt, 0, n_loc - 1)[..., None], -2)
        inr = torch.ones_like(rs, dtype=torch.bool)
        if j > 0:
            inr = inr & (rs >= incl[..., j - 1, None])
        if j < p - 1:
            inr = inr & (rs < incl[..., j, None])
        drawn = torch.where(inr[..., None], vals, drawn)
        if r < p - 1:
            v_cdf, v_parts = _ring_shift([v_cdf, v_parts], group)
    return drawn


@dataclasses.dataclass(frozen=True)
class ShardGenerators:
    """A sharded state's random streams (module docstring): `shared` the
    same on every rank of a particle group, `rank` this rank's own."""

    shared: torch.Generator
    rank: torch.Generator


@dataclasses.dataclass(frozen=True)
class ShardDraws:
    """One rank's draws of one tick.  motion_normals [..., 3] (shared
    noise: replicated) or [..., 3, n] (this rank's particles); `resample`
    this rank's jitter, fresh particles, injection uniforms (or the
    multinomial uniforms u of the allgather exchange) and the replicated
    systematic u0; kmeans_init [..., K] and kmeans_reseed [..., I, K]
    GLOBAL particle indices, replicated; `spacings` [..., n] (this rank's)
    and `spacing_extra` [...] (replicated), uniforms in [1e-37, 1) of the
    ring multinomial's exponential spacings, else None."""

    motion_normals: torch.Tensor
    resample: resample.ResampleDraws
    kmeans_init: torch.Tensor
    kmeans_reseed: torch.Tensor
    spacings: Optional[torch.Tensor] = None
    spacing_extra: Optional[torch.Tensor] = None


def _rand(gen, shape, device):
    return torch.rand(shape, generator=gen, device=device)


def draw_shard_tick(gens: ShardGenerators, m: MazeMap, n_loc: int,
                    n_shards: int, cfg: FilterConfig,
                    batch=()) -> ShardDraws:
    """One tick's draws of one rank with leading episode shape `batch`:
    first the replicated draws from gens.shared, in one order on every
    rank, then this rank's from gens.rank."""
    dev = m.device
    b = tuple(batch)
    rcfg = cfg.resample
    systematic = rcfg.method == "systematic"
    ring = rcfg.sharded_exchange == "ring"
    shared_noise = cfg.motion.shared_noise
    shared, own = gens.shared, gens.rank
    normals = motion.draw_motion_normals(shared if shared_noise else own,
                                         n_loc, cfg.motion, dev, b)
    u0 = _rand(shared, b, dev) if systematic else None
    extra = (_rand(shared, b, dev).clamp_min(1e-37)
             if ring and not systematic else None)
    init, reseed = cluster.draw_kmeans(shared, n_loc * n_shards, cfg.cluster,
                                       dev, b)
    u = inject_r = spacings = None
    if systematic or ring:
        inject_r = _rand(own, b + (n_loc,), dev)
    else:
        u = _rand(own, b + (n_loc,), dev)
    if extra is not None:
        spacings = _rand(own, b + (n_loc,), dev).clamp_min(1e-37)
    jitter = 2.0 * _rand(own, b + (3, n_loc), dev) - 1.0
    fresh = resample.sample_uniform_particles(own, m, n_loc, cfg.init, b)
    return ShardDraws(
        motion_normals=normals,
        resample=resample.ResampleDraws(jitter=jitter, fresh=fresh, u=u,
                                        u0=u0, inject_r=inject_r),
        kmeans_init=init, kmeans_reseed=reseed, spacings=spacings,
        spacing_extra=extra)


def resample_sharded(particles, weights, inj: resample.InjectionState,
                     jitter_state, m: MazeMap, cfg: FilterConfig, group,
                     draws: ShardDraws, draw_weights=None):
    """Distributed resampling (distributed.py:198-286 of the JAX
    package): resample.resample's semantics on the concatenated blocks.
    `draw_weights` (this rank's block, optional) feeds the CDF draw while
    `weights` feeds the injection bookkeeping.  Returns this rank's
    (particles, weights = 1/N, inj, info)."""
    rcfg = cfg.resample
    rd = draws.resample
    n_loc = particles.shape[-2]
    p, my = _size(group), _rank(group)
    n_global = n_loc * p

    total = _psum(torch.sum(weights, dim=-1), group)
    w_avg = total * f32_reciprocal(n_global)
    reg = resample._regime(jitter_state, rcfg)
    w_slow = inj.w_slow + reg["alpha_slow"] * (w_avg - inj.w_slow)
    w_fast = inj.w_fast + reg["alpha_fast"] * (w_avg - inj.w_fast)
    p_inject = torch.where(
        w_slow > 0.0, torch.clamp(1.0 - w_fast / w_slow, min=0.0), 0.0)

    if draw_weights is None:
        draw_weights, draw_total = weights, total
    else:
        draw_total = _psum(torch.sum(draw_weights, dim=-1), group)
    norm_local = torch.where(draw_total[..., None] > 0.0,
                             draw_weights / draw_total[..., None],
                             1.0 / n_global)

    multinomial = rcfg.method == "multinomial"
    if not multinomial and rcfg.method != "systematic":
        raise ValueError(f"unknown resample method {rcfg.method!r}")
    if rcfg.sharded_exchange == "ring":
        inject_r = rd.inject_r
        if multinomial:
            drawn = _ring_multinomial_draw(particles, norm_local,
                                           draws.spacings,
                                           draws.spacing_extra, group)
        else:
            drawn = _ring_systematic_draw(particles, norm_local, rd.u0,
                                          group)
    elif rcfg.sharded_exchange == "allgather":
        # Legacy: the global CDF and cloud on every rank (O(N) a rank),
        # kept for A/B parity with the ring.
        cdf = _local_cumsum(_gather_dim(norm_local, group,
                                        norm_local.dim() - 1))
        all_parts = _gather_dim(particles, group, particles.dim() - 2)
        if multinomial:
            inject_r = rd.u
            idx = torch.searchsorted(cdf, rd.u.contiguous(),
                                     side="left").clamp(max=n_global - 1)
        else:
            inject_r = rd.inject_r
            idx = resample.systematic_indices(cdf, rd.u0)[
                ..., my * n_loc:(my + 1) * n_loc]
        drawn = resample.expand.gather_rows(all_parts, idx)
    else:
        raise ValueError(f"unknown sharded_exchange {rcfg.sharded_exchange!r}")

    # The global first-come injection cap.
    bern = inject_r < p_inject[..., None]
    counts = _gather_last(torch.sum(bern, dim=-1, dtype=torch.int32), group)
    ahead = torch.sum(counts[..., :my], dim=-1)
    inject = bern & ((ahead[..., None] + torch.cumsum(bern, dim=-1))
                     <= reg["max_injection"][..., None])
    n_injected = _psum(torch.sum(inject, dim=-1, dtype=torch.int32), group)
    jx = rd.jitter[..., 0, :] * reg["jitter_xy"][..., None]
    jy = rd.jitter[..., 1, :] * reg["jitter_xy"][..., None]
    jt = rd.jitter[..., 2, :] * reg["jitter_theta"][..., None]
    drawn = torch.stack([drawn[..., 0] + jx, drawn[..., 1] + jy,
                         normalize_angle(drawn[..., 2] + jt)], dim=-1)
    new_particles = torch.where(inject[..., None], rd.fresh, drawn)
    new_weights = torch.full(particles.shape[:-1], 1.0 / n_global,
                             dtype=torch.float32, device=particles.device)
    info = dict(p_inject=p_inject, n_injected=n_injected, w_avg=w_avg,
                total_weight=total)
    return (new_particles, new_weights,
            resample.InjectionState(w_slow, w_fast), info)


def ess_gated_resample_sharded(particles, likelihood, carried_w,
                               inj: resample.InjectionState, jitter_state,
                               m: MazeMap, cfg: FilterConfig, group,
                               draws: ShardDraws):
    """Sharded ESS-gated SIR (distributed.py:289-326 of the JAX package):
    the gate (the global ESS and the kidnap detector's request) comes from
    all_reduced sums, so every rank takes the same branch; the JAX
    package's lax.cond is a per-episode select over both branches, as in
    models/resample.ess_gated_resample."""
    n_global = particles.shape[-2] * _size(group)
    tau = cfg.resample.ess_threshold
    combined = carried_w * likelihood
    total_c = _psum(torch.sum(combined, dim=-1), group)
    norm = torch.where(total_c[..., None] > 0.0,
                       combined / total_c[..., None], 1.0 / n_global)
    ess = 1.0 / _psum(torch.sum(norm * norm, dim=-1), group)
    drawn, uniform_w, new_inj, info = resample_sharded(
        particles, likelihood, inj, jitter_state, m, cfg, group, draws,
        draw_weights=norm)
    fire = (ess < tau * n_global) | (info["p_inject"] > 0.0)
    info = dict(info, n_injected=torch.where(
        fire, info["n_injected"], torch.zeros_like(info["n_injected"])),
        resampled=fire)
    return (torch.where(fire[..., None, None], drawn, particles),
            torch.where(fire[..., None], uniform_w, norm), new_inj, info)


# ---------------------------------------------------------------------------
# Sharded k-means confidence
# ---------------------------------------------------------------------------
def _global_take(particles, idx, group):
    """Global particle rows by index [..., M] -> [..., M, D], each rank
    holding a contiguous block: the owner's row, zeros elsewhere,
    all_reduced."""
    n_loc = particles.shape[-2]
    local = idx - _rank(group) * n_loc
    ours = (local >= 0) & (local < n_loc)
    vals = torch.take_along_dim(
        particles, torch.clamp(local, 0, n_loc - 1).long()[..., None], -2)
    return _psum(torch.where(ours[..., None], vals, 0.0), group)


def cluster_confidence_sharded(particles, weights, threshold, cfg, group,
                               init_idx, reseed_idx,
                               weighted: bool = False
                               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed k-means confidence (distributed.py:340-420 of the JAX
    package): replicated centers, sharded points, cfg.max_iters Lloyd
    iterations with the dense path's early-exit latch; every sum is
    all_reduced, no particle crosses.  `init_idx` [..., K] and
    `reseed_idx` [..., I, K] are global indices, replicated.  The
    reductions of one iteration travel as one all_reduce: the count of
    changed assignments (a float, of which only the sign is read), each
    cluster's size and its coordinate sums, summed as the single-device
    dense path sums them.  Returns (confidence [...], best pose [..., 3]
    or the (-1, -1, -1) sentinel)."""
    n_global = particles.shape[-2] * _size(group)
    k, iters = cfg.k, reseed_idx.shape[-2]
    lead = particles.shape[:-2]
    xy = particles[..., :2]
    x, y = xy[..., 0], xy[..., 1]
    taken = _global_take(particles, torch.cat(
        [init_idx, reseed_idx.reshape(lead + (iters * k,))], -1), group)
    centers = taken[..., :k, :2]
    reseed = taken[..., k:, :2].reshape(lead + (iters, k, 2))
    assign = torch.zeros(x.shape, dtype=torch.int32, device=x.device)
    done = torch.zeros(lead, dtype=torch.bool, device=x.device)
    for t in range(iters):
        cx, cy = centers[..., 0:1], centers[..., 1:2]
        new_assign = torch.zeros_like(assign)
        best = (x - cx[..., 0, :]) ** 2 + (y - cy[..., 0, :]) ** 2
        for i in range(1, k):
            di = (x - cx[..., i, :]) ** 2 + (y - cy[..., i, :]) ** 2
            closer = di < best
            new_assign = torch.where(closer, i, new_assign)
            best = torch.where(closer, di, best)
        members = [(new_assign == i).to(torch.float32) for i in range(k)]
        sums = _psum(torch.stack(
            [torch.sum(new_assign != assign, dim=-1, dtype=torch.float32)]
            + [torch.sum(mi, dim=-1) for mi in members]
            + [torch.sum(mi * x, dim=-1) for mi in members]
            + [torch.sum(mi * y, dim=-1) for mi in members], dim=-1), group)
        changed = sums[..., 0] > 0
        counts = sums[..., 1:1 + k]
        means = torch.stack([sums[..., 1 + k:1 + 2 * k],
                             sums[..., 1 + 2 * k:]], dim=-1) / torch.clamp(
                                 counts, min=1.0)[..., None]
        means = torch.where((counts > 0)[..., None], means, reseed[..., t,
                                                                   :, :])
        do_update = changed & ~done
        centers = torch.where(do_update[..., None, None], means, centers)
        assign = torch.where(do_update[..., None], new_assign, assign)
        done = done | ~changed

    cluster_w = _psum(torch.stack(
        [torch.sum(torch.where(assign == i, weights, 0.0), dim=-1)
         for i in range(k)], dim=-1), group)
    best = torch.argmax(cluster_w, dim=-1)
    cx = cluster._pick(centers[..., 0], best)
    cy = cluster._pick(centers[..., 1], best)
    member = (assign == best[..., None]).to(torch.float32)
    sin_t, cos_t = torch.sin(particles[..., 2]), torch.cos(particles[..., 2])
    r2 = cfg.near_radius ** 2
    if weighted:
        mw = member * weights
        s = _psum(torch.stack([torch.sum(weights, dim=-1),
                               torch.sum(mw, dim=-1),
                               torch.sum(mw * x, dim=-1),
                               torch.sum(mw * y, dim=-1),
                               torch.sum(mw * sin_t, dim=-1),
                               torch.sum(mw * cos_t, dim=-1)], dim=-1), group)
        w_sum = torch.clamp(s[..., 0], min=1e-30)
        mw_sum = torch.clamp(s[..., 1], min=1e-30)
        cx, cy = s[..., 2] / mw_sum, s[..., 3] / mw_sum
        theta = torch.atan2(s[..., 4], s[..., 5])
        d2 = (x - cx[..., None]) ** 2 + (y - cy[..., None]) ** 2
        ratio = _psum(torch.sum(torch.where(d2 <= r2, weights, 0.0),
                                dim=-1), group) / w_sum
    else:
        d2 = (x - cx[..., None]) ** 2 + (y - cy[..., None]) ** 2
        s = _psum(torch.stack([torch.sum(member * sin_t, dim=-1),
                               torch.sum(member * cos_t, dim=-1),
                               torch.sum((d2 <= r2).to(torch.float32),
                                         dim=-1)], dim=-1), group)
        theta = torch.atan2(s[..., 0], s[..., 1])
        ratio = s[..., 2] * f32_reciprocal(n_global)
    best_pose = torch.where((ratio > threshold)[..., None],
                            torch.stack([cx, cy, theta], dim=-1), -1.0)
    return ratio, best_pose


# ---------------------------------------------------------------------------
# The sharded tick
# ---------------------------------------------------------------------------
def mcl_step_sharded(state: mcl.MCLState, encoder_left, encoder_right,
                     scan: sensor.Scan, m: MazeMap, cfg: FilterConfig,
                     group, draws: Optional[ShardDraws] = None
                     ) -> Tuple[mcl.MCLState, mcl.MCLOutput]:
    """One tick with the particle axis sharded over `group`
    (distributed.py:423-481 of the JAX package): this rank's block of
    particles and weights, replicated scalars, `state.gen` a
    ShardGenerators (or `draws`, this rank's ShardDraws).  Leading episode
    dims ([E, n, 3] blocks, [E] scalars) run every episode at once, the
    collectives per episode."""
    check_group(group, state.particles)
    n_loc = state.particles.shape[-2]
    if draws is None:
        draws = draw_shard_tick(state.gen, m, n_loc, _size(group), cfg,
                                state.batch)
    was_lost, cluster_thr, conf_thr, song, wanderer = mcl._hysteresis(
        state, m, cfg)
    exact_pose = state.best_pose
    cell_pose = mcl.cell_pose_msg(state.best_pose, m.cell_meters)
    odom, particles = motion.motion_update(
        state.particles, state.odom, encoder_left, encoder_right,
        cfg.motion, draws.motion_normals)
    # Refinement is per particle: each rank refines its own block.
    particles = refine.refine_particles(m, particles, scan, cfg)
    weights = sensor.beam_weights(m, particles, scan, cfg.sensor,
                                  cfg.valid_pos_offset)
    gated = cfg.resample.ess_threshold is not None
    if gated:
        particles, weights, inj, info = ess_gated_resample_sharded(
            particles, weights, state.weights, state.inj, was_lost, m, cfg,
            group, draws)
    else:
        particles, weights, inj, info = resample_sharded(
            particles, weights, state.inj, was_lost, m, cfg, group, draws)
    confidence, best_pose = cluster_confidence_sharded(
        particles, weights, conf_thr, cfg.cluster, group, draws.kmeans_init,
        draws.kmeans_reseed, weighted=gated)
    new_state = mcl.MCLState(
        particles=particles, weights=weights, odom=odom, inj=inj,
        confidence=confidence, was_lost=was_lost,
        cluster_threshold=cluster_thr, confident_threshold=conf_thr,
        best_pose=best_pose, gen=state.gen)
    out = mcl.MCLOutput(
        exact_pose=exact_pose, cell_pose=cell_pose, confidence=confidence,
        song=song, wanderer_cmd=wanderer,
        n_injected=info["n_injected"].to(torch.int32),
        p_inject=info["p_inject"], total_weight=info["total_weight"])
    return new_state, out


def _mcl_tick(state, x: dict, consts: dict, m: MazeMap, cfg: FilterConfig,
              group):
    scan = sensor.Scan(angles=consts["angles"], ranges=x["ranges"],
                       mask=x["mask"])
    enc = x["encoders"]
    return mcl_step_sharded(state, enc[..., 0], enc[..., 1], scan, m, cfg,
                            group, x.get("draws"))


class _GraphedTicks:
    """A sharded tick through CUDA graphs: `ticks` runs K ticks in one
    graph (one replay on CUDA), `episode` a whole episode in graphs of
    compiled.TICKS_PER_GRAPH ticks, `one` a single tick.  The tick reads
    encoders [..., 2], ranges and mask [..., B] (the mask as `mask_dtype`)
    and draws from `x`, the beam table from consts; `static` holds its
    other arguments.  The graphs live in this object's cache and die with
    it."""

    def __init__(self, tick, mask_dtype, **static):
        self.tick, self.mask_dtype, self.static = tick, mask_dtype, static
        self.cache = compiled.GraphCache()

    def _inputs(self, encoders, ranges, mask, device):
        enc = torch.as_tensor(encoders, dtype=torch.float32, device=device)
        rng = torch.as_tensor(ranges, dtype=torch.float32, device=device)
        msk = (torch.ones(rng.shape, dtype=self.mask_dtype, device=device)
               if mask is None else torch.as_tensor(mask, device=device).to(
                   self.mask_dtype).expand(rng.shape))
        return enc, rng, msk

    def ticks(self, state, encoders, ranges, mask, angles, draws=None):
        """K ticks: encoders [..., K, 2], ranges and mask [..., K, B]
        (mask None: every beam), angles [B], `draws` with the tick axis
        after the state's leading dims.  Returns (state, outputs
        [..., K, ...]), the graph's buffers."""
        dev = compiled.leaves(state)[0].device
        enc, rng, msk = self._inputs(encoders, ranges, mask, dev)
        xs = dict(encoders=enc, ranges=rng, mask=msk)
        if draws is not None:
            xs["draws"] = draws
        consts = dict(angles=torch.as_tensor(angles, dtype=torch.float32,
                                             device=dev))
        graph = compiled.cached(self.cache, self.tick, state, xs, consts,
                                len(state.batch), **self.static)
        return graph(state, xs, consts)

    def one(self, state, encoder_left, encoder_right, ranges, mask, angles,
            draws=None):
        """One tick: encoders [...] (numbers or tensors), ranges and mask
        [..., B] or [B].  Returns (state, output) of the graph's
        buffers."""
        dev = compiled.leaves(state)[0].device
        b, lead = state.batch, len(state.batch)
        enc = torch.stack([motion._on_device(encoder_left, dev).expand(b),
                           motion._on_device(encoder_right, dev).expand(b)],
                          -1)
        rng = torch.as_tensor(ranges, dtype=torch.float32, device=dev)
        rng = rng.expand(b + rng.shape[-1:])
        msk = torch.as_tensor(mask, device=dev).expand(rng.shape)
        st, ys = self.ticks(
            state, enc.unsqueeze(lead), rng.unsqueeze(lead),
            msk.unsqueeze(lead), angles,
            compiled.tree_map(lambda t: t.unsqueeze(lead), draws))
        return st, compiled.tree_map(lambda t: t.select(lead, 0), ys)

    def episode(self, state, encoders, ranges, angles, mask=None,
                draws=None):
        """T ticks (encoders [..., T, 2], ranges [..., T, B]) in graphs of
        compiled.TICKS_PER_GRAPH ticks; `draws` one draws object a tick.
        Returns (final state, outputs [..., T, ...]), the caller's own."""
        lead = len(state.batch)
        enc, rng, msk = self._inputs(encoders, ranges, mask,
                                     compiled.leaves(state)[0].device)
        carry = [state]

        def chunk(t0: int, n: int):
            d = (None if draws is None
                 else compiled.stack_ticks(list(draws[t0:t0 + n]), lead))
            carry[0], ys = self.ticks(
                carry[0], enc.narrow(lead, t0, n), rng.narrow(lead, t0, n),
                msk.narrow(lead, t0, n), angles, d)
            return ys

        outs = compiled.run_chunked(chunk, rng.shape[lead], lead)
        return compiled.detach_state(carry[0]), outs


class ShardedStep(_GraphedTicks):
    """The sharded MCL tick (make_sharded_step): a call is one tick of
    (state, encoder_left, encoder_right, scan, draws=None)."""

    def __init__(self, group, m: MazeMap, cfg: FilterConfig):
        super().__init__(_mcl_tick, torch.bool, m=m, cfg=cfg, group=group)

    def __call__(self, state: mcl.MCLState, encoder_left, encoder_right,
                 scan: sensor.Scan, draws: Optional[ShardDraws] = None):
        return self.one(state, encoder_left, encoder_right, scan.ranges,
                        scan.mask, scan.angles, draws)


def make_sharded_step(mesh, m: MazeMap, cfg: FilterConfig,
                      axis_name: str = "particle") -> ShardedStep:
    """The sharded tick over the mesh's `axis_name` group, in CUDA graphs
    (the counterpart of the JAX package's jit of shard_map)."""
    return ShardedStep(mesh.get_group(axis_name), m, cfg)


def make_sharded_step_batched(mesh, m: MazeMap, cfg: FilterConfig,
                              episode_axis: str = "episode",
                              particle_axis: str = "particle"
                              ) -> ShardedStep:
    """The episode x particle step (distributed.py:521-570 of the JAX
    package): a rank holds [E_loc, N_loc, 3] of an episode block (the
    episode axis, data parallel) and a particle block (the particle axis,
    its collectives per episode); K1 batched weights each block.  The
    episode axis only lays out the state (shard_state); the tick's
    collectives run in the particle group."""
    if episode_axis not in mesh.mesh_dim_names:
        raise ValueError(f"the mesh has no {episode_axis!r} axis")
    return ShardedStep(mesh.get_group(particle_axis), m, cfg)


def init_batched_state(seed: int, m: MazeMap, cfg: FilterConfig,
                       num_episodes: int) -> mcl.MCLState:
    """The whole batch's start state, the same on every rank that calls it
    with the same seed (shard_state then takes each rank's block)."""
    return mcl.init_state(m, cfg, seed, batch=num_episodes)


def _coords(mesh, axis_name: str, episode_axis: Optional[str]):
    """(particle rank, particle shards, episode rank, episode shards)."""
    ep = (mesh.get_local_rank(episode_axis), mesh.size(
        mesh.mesh_dim_names.index(episode_axis))) if episode_axis else (0, 1)
    return (mesh.get_local_rank(axis_name),
            mesh.size(mesh.mesh_dim_names.index(axis_name))) + ep


def shard_generators(seed: int, episode_rank: int, particle_rank: int,
                     device) -> ShardGenerators:
    """The streams of one rank: `shared` from (seed, episode rank), the
    same across a particle group; `rank` from (seed, episode rank,
    particle rank)."""
    def gen(*key):
        g = torch.Generator(device=device)
        g.manual_seed(int(np.random.SeedSequence(
            [int(seed) & (2**64 - 1)] + list(key)).generate_state(
                1, np.uint64)[0]))
        return g

    return ShardGenerators(shared=gen(episode_rank),
                           rank=gen(episode_rank, particle_rank))


def _block(t, rank: int, shards: int, dim: int):
    n = t.shape[dim]
    if n % shards:
        raise ValueError(f"{n} do not divide over {shards} shards")
    per = n // shards
    return t.narrow(dim, rank * per, per).clone()


def _shard(state, fields, mesh, axis_name, episode_axis, seed):
    pr, pn, er, en = _coords(mesh, axis_name, episode_axis)
    dev = getattr(state, fields[0]).device
    lead = getattr(state, fields[0]).dim() - 2
    seed = state.gen.initial_seed() if seed is None else seed

    def put(name, v):
        if isinstance(v, torch.Generator):
            return v
        if episode_axis:
            v = _block(v, er, en, 0)
        if name in fields:
            v = _block(v, pr, pn, lead)
        return v

    out = {f.name: (compiled.tree_map(lambda v, f=f: put(f.name, v),
                                      getattr(state, f.name)))
           for f in dataclasses.fields(state) if f.name != "gen"}
    return type(state)(gen=shard_generators(seed, er, pr, dev), **out)


def shard_state(state: mcl.MCLState, mesh, axis_name: str = "particle",
                episode_axis: Optional[str] = None,
                seed: Optional[int] = None) -> mcl.MCLState:
    """This rank's block of a whole state (the same on every rank): the
    particles and weights of its particle shard and, with `episode_axis`,
    of its episode block (every per-episode field too); its generators
    are shard_generators(seed) (default: the state's generator's seed).
    The counterpart of the JAX package's device_put onto the mesh."""
    return _shard(state, ("particles", "weights"), mesh, axis_name,
                  episode_axis, seed)


def gather_state(state, mesh, axis_name: str = "particle",
                 episode_axis: Optional[str] = None):
    """A whole state on every rank from the ranks' blocks (an MCLState or
    a SLAMState; the generators are this rank's): the inverse of
    shard_state and shard_slam_state, for tests and tools."""
    fields = (("poses", "logodds", "weights", "scores")
              if hasattr(state, "logodds") else ("particles", "weights"))
    lead = len(state.batch)
    pg = mesh.get_group(axis_name)
    eg = mesh.get_group(episode_axis) if episode_axis else None

    def take(name, v):
        if isinstance(v, torch.Generator):
            return v
        if name in fields:
            v = _gather_dim(v, pg, lead)
        if eg is not None:
            v = _gather_dim(v, eg, 0)
        return v

    return type(state)(**{f.name: compiled.tree_map(
        lambda v, f=f: take(f.name, v), getattr(state, f.name))
        for f in dataclasses.fields(state)})


# ---------------------------------------------------------------------------
# Particle-sharded SLAM
# ---------------------------------------------------------------------------
def draw_shard_slam(gens: ShardGenerators, cfg, p_loc: int, batch=(),
                    device="cuda"):
    """One SLAM tick's draws of one rank: this rank's motion normals
    [..., 3, p_loc] and the replicated systematic u0 [...]."""
    from ..models.slam import SLAMDraws

    b = tuple(batch)
    normals = torch.randn(b + (3, p_loc), generator=gens.rank,
                          device=device)
    return SLAMDraws(normals=normals, gumbel=None,
                     u0=_rand(gens.shared, b, device))


def slam_step_sharded(state, encoder_left, encoder_right, ranges, angles,
                      mask, cfg, group, draws=None):
    """One RBPF SLAM tick with the particle axis (poses and maps) sharded
    over `group` (distributed.py:616-753 of the JAX package): the
    proposal, the likelihood-field weights and the map update are per
    particle; the weight normalization, the ESS and the mean pose are
    all_reduced scalars; the ESS-gated systematic resample is the ring
    draw on (pose, score, flattened map) payload rows, O(P/shards) maps a
    rank; the best particle gathers one (score, pose) a rank.  As in the
    JAX package the sharded tick draws one proposal a particle
    (proposal_candidates and refine_iters are not read) and refuses the
    closure.  The resample is a per-filter select over both branches, as
    in models/slam.slam_step.  `draws`: this rank's SLAMDraws (normals
    [..., 3, p_loc], u0 replicated), else draw_shard_slam from
    state.gen."""
    from ..models import mapping, slam

    if cfg.closure:
        raise NotImplementedError(
            "closure correction is not supported in slam_step_sharded")
    check_group(group, state.poses)
    batch = state.batch
    dev = state.poses.device
    p_loc = state.poses.shape[-2]
    p_glob = p_loc * _size(group)
    if draws is None:
        draws = draw_shard_slam(state.gen, cfg, p_loc, batch, dev)
    enc_l = slam._on_device(encoder_left, dev).expand(batch)
    enc_r = slam._on_device(encoder_right, dev).expand(batch)
    ranges = slam._on_device(ranges, dev)
    angles = slam._on_device(angles, dev)
    mask = slam._on_device(mask, dev)

    new_odom, rot1, trans, rot2 = motion.diff_drive_update(
        state.odom, enc_l, enc_r, cfg.motion)
    turning_in_place = trans < 1e-4
    rot2 = torch.where(turning_in_place, rot1 + rot2, rot2)
    rot1 = torch.where(turning_in_place, 0.0, rot1)
    mcfg = dataclasses.replace(
        cfg.motion, shared_noise=False,
        alpha_1=cfg.motion.alpha_1 * cfg.alpha_scale,
        alpha_2=cfg.motion.alpha_2 * cfg.alpha_scale,
        alpha_3=cfg.motion.alpha_3 * cfg.alpha_scale,
        alpha_4=cfg.motion.alpha_4 * cfg.alpha_scale)
    n_rot1, n_trans, n_rot2 = motion.sample_motion_noise(
        rot1, trans, rot2, mcfg, draws.normals)
    poses = motion.propagate_particles(state.poses, n_rot1, n_trans, n_rot2)
    poses = torch.cat([poses[..., :2], normalize_angle(poses[..., 2:3])],
                      dim=-1)

    win, offsets = slam.field_windows(state.logodds, poses, cfg)
    field = slam.hit_field(win, cfg)
    loglik = slam.scan_log_likelihood(field, poses, ranges, angles, mask,
                                      cfg, offsets)
    logw = torch.log(state.weights) + loglik
    gmax = _all_reduce(torch.amax(logw, dim=-1), group, dist.ReduceOp.MAX)
    w = torch.exp(logw - gmax[..., None])
    tot = _psum(torch.sum(w, dim=-1), group)
    log_evidence = state.log_evidence + gmax + torch.log(tot)
    w = w / tot[..., None]
    ess = 1.0 / _psum(torch.sum(w * w, dim=-1), group)

    resampled = ess < cfg.ess_threshold * p_glob
    h_px, w_px = state.logodds.shape[-2:]
    payload = torch.cat([poses, w[..., None],
                         state.logodds.flatten(-2)], dim=-1)
    drawn = _ring_systematic_draw(payload, w, draws.u0, group)
    fire = resampled[..., None]
    poses = torch.where(fire[..., None], drawn[..., :3], poses)
    logodds = torch.where(fire[..., None, None],
                          drawn[..., 4:].unflatten(-1, (h_px, w_px)),
                          state.logodds)
    scores = torch.where(fire, drawn[..., 3], w)
    w = torch.where(fire, torch.full_like(w, 1.0 / p_glob), w)

    sums = _psum(torch.stack([
        torch.sum(w * poses[..., 0], dim=-1),
        torch.sum(w * poses[..., 1], dim=-1),
        torch.sum(w * torch.sin(poses[..., 2]), dim=-1),
        torch.sum(w * torch.cos(poses[..., 2]), dim=-1)], dim=-1), group)
    mean_pose = torch.stack([sums[..., 0], sums[..., 1],
                             torch.atan2(sums[..., 2], sums[..., 3])], -1)

    crit = []
    if cfg.keyframe_trans > 0.0:
        crit.append(torch.hypot(mean_pose[..., 0] - state.kf_pose[..., 0],
                                mean_pose[..., 1] - state.kf_pose[..., 1])
                    >= cfg.keyframe_trans)
    if cfg.keyframe_rot > 0.0:
        crit.append(torch.abs(normalize_angle(
            mean_pose[..., 2] - state.kf_pose[..., 2])) >= cfg.keyframe_rot)
    moved = torch.ones(batch, dtype=torch.bool, device=dev)
    for i, c in enumerate(crit):
        moved = c if i == 0 else (moved | c)
    rb = ranges.expand(batch + ranges.shape[-1:])
    logodds = mapping.update_map(logodds, poses, rb[..., None, :], angles,
                                 mask.expand(rb.shape)[..., None, :],
                                 cfg.mapping, cfg.sensor,
                                 paint=moved[..., None] if crit else None)
    kf_pose = (torch.where(moved[..., None], mean_pose, state.kf_pose)
               if crit else mean_pose)

    # The global MAP particle: one (score, pose) row a rank crosses.
    loc_best = torch.argmax(scores, dim=-1)
    best_sc = _gather_last(cluster._pick(scores, loc_best), group)  # [.., S]
    best_ps = _gather_dim(torch.take_along_dim(
        poses, loc_best[..., None, None], dim=-2), group, len(batch))
    best_pose = torch.take_along_dim(
        best_ps, torch.argmax(best_sc, dim=-1)[..., None, None],
        dim=-2)[..., 0, :]

    info = dict(pose=mean_pose, best_pose=best_pose, ess=ess,
                resampled=resampled, mapped=moved,
                closure_delta=torch.zeros(batch + (3,), dtype=torch.float32,
                                          device=dev),
                log_evidence=log_evidence)
    new_state = slam.SLAMState(
        poses=poses, logodds=logodds, weights=w, scores=scores,
        odom=new_odom, gen=state.gen, kf_pose=kf_pose,
        closure_cool=state.closure_cool, log_evidence=log_evidence)
    return new_state, info


def _slam_tick(state, x: dict, consts: dict, cfg, group):
    enc = x["encoders"]
    return slam_step_sharded(state, enc[..., 0], enc[..., 1], x["ranges"],
                             consts["angles"], x["mask"], cfg, group,
                             x.get("draws"))


class ShardedSLAMStep(_GraphedTicks):
    """The sharded SLAM tick (make_sharded_slam_step): a call is one tick
    of (state, encoder_left, encoder_right, ranges, angles, mask,
    draws=None)."""

    def __init__(self, group, cfg):
        super().__init__(_slam_tick, torch.float32, cfg=cfg, group=group)

    def __call__(self, state, encoder_left, encoder_right, ranges, angles,
                 mask, draws=None):
        return self.one(state, encoder_left, encoder_right, ranges, mask,
                        angles, draws)


def make_sharded_slam_step(mesh, cfg, axis_name: str = "particle"
                           ) -> ShardedSLAMStep:
    """The sharded SLAM tick over the mesh's `axis_name` group (poses and
    per-particle occupancy grids sharded), in CUDA graphs."""
    return ShardedSLAMStep(mesh.get_group(axis_name), cfg)


def shard_slam_state(state, mesh, axis_name: str = "particle",
                     seed: Optional[int] = None):
    """This rank's block of a whole SLAMState: its poses, maps, weights
    and scores; its generators shard_generators(seed)."""
    return _shard(state, ("poses", "logodds", "weights", "scores"), mesh,
                  axis_name, None, seed)
