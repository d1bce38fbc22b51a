"""Resampling with AMCL-style adaptive injection.

Torch counterpart of montecarlolocalisation_tpu/models/resample.py
(reference: monte_carlo.cpp:457-561 resampleParticles, :415-450
sampleParticles):
  * dual-timescale averages: w_slow += a_slow*(w_avg - w_slow),
    w_fast += a_fast*(w_avg - w_fast); p_inject = max(0, 1 - w_fast/w_slow);
  * multinomial: the SAME uniform r decides injection (r < p_inject) and,
    when not injecting, indexes the CDF via lower_bound; systematic: one
    u0 for the draw (ops/expand) and separate injection uniforms;
  * the first-come injection cap is "first k Bernoulli successes" via a
    cumulative-sum mask;
  * jitter by regime (lost: xy +-0.05, theta +-pi/12; confident: xy +-0.01,
    theta unchanged), theta re-wrapped via atan2.

The random draws are arguments (ResampleDraws), so a caller can hand in
another implementation's exact draws; `draw_resample` makes them from a
torch.Generator.

Particles carry leading episode dims ([N, 3] one filter, [E, N, 3] a
batch); every per-episode scalar (the averages, the regime, p_inject) has
those dims.  A batched pass syncs nothing to the host: the JAX package's
`lax.cond` around the fresh draw (resample.py:441) is a select under vmap,
and here the fresh particles are always drawn.

`ess_gated_resample` is the production SIR schedule (carried importance
weights, a full pass only when the effective sample size falls below
ess_threshold * N); its gate is a per-episode select over both branches,
so it makes no host sync either.  `resize_particles` is the elastic
server's systematic redraw to another particle count.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..config import FilterConfig, InitConfig, ResampleConfig
from ..maps.grid import MazeMap, cell_center, f32_reciprocal
from ..ops import expand
from ..utils.angles import normalize_angle


@dataclasses.dataclass(frozen=True)
class InjectionState:
    """Dual-timescale weight averages (monte_carlo.cpp:125-128)."""

    w_slow: torch.Tensor
    w_fast: torch.Tensor

    @staticmethod
    def zero(device="cpu", batch=()) -> "InjectionState":
        z = torch.zeros(batch, dtype=torch.float32, device=device)
        return InjectionState(w_slow=z, w_fast=z)


@dataclasses.dataclass(frozen=True)
class ResampleDraws:
    """One resampling pass's random numbers.

    u         [..., N] multinomial uniforms in [0, 1) (also the injection
              test)
    u0        [...] systematic offset in [0, 1)
    inject_r  [..., N] systematic injection uniforms in [0, 1)
    jitter    [..., 3, N] uniforms in [-1, 1) for x, y, theta
    fresh     [..., N, 3] uniformly drawn particles for injected slots
    Fields the configured method does not read are None.
    """

    jitter: torch.Tensor
    fresh: torch.Tensor
    u: Optional[torch.Tensor] = None
    u0: Optional[torch.Tensor] = None
    inject_r: Optional[torch.Tensor] = None


def masked_cells(u, mask):
    """Uniforms [...] in [0, 1) -> (row, col) drawn uniformly over the True
    cells of `mask` [R, C] by inverting their CDF (resample.py:47
    _masked_cells); an all-False mask falls back to every cell."""
    flat = mask.reshape(-1).to(torch.float32)
    flat = torch.where(torch.sum(flat) > 0, flat, torch.ones_like(flat))
    cdf = torch.cumsum(flat / torch.sum(flat), dim=0)
    # #{cells with cdf <= u}, the comparison count of the JAX package.
    idx = torch.searchsorted(cdf, u.contiguous(), right=True).clamp(
        max=flat.shape[0] - 1)
    n_cols = mask.shape[1]
    return idx // n_cols, idx % n_cols


def explored_cells(m: MazeMap):
    """[R, C] bool: the cells whose four edges are not all walls, where a
    partial learned map has evidence (filter.py:228 of the JAX package)."""
    return ~torch.all(m.walls, dim=-1)


def sample_uniform_particles(gen: torch.Generator, m: MazeMap, n: int,
                             cfg: InitConfig = InitConfig(), batch=(),
                             cell_mask=None):
    """Uniform global particles (monte_carlo.cpp:415-450 sampleParticles):
    random maze cell, uniform in-cell offset +-cell_offset, yaw in
    [-pi, pi), +global_offset on x and y.  Returns [*batch, n, 3].

    `cell_mask` [R, C] bool draws the cell uniformly over its True cells
    (explored-cell injection on partial maps); None keeps the reference
    distribution."""
    dev = m.device
    shape = tuple(batch) + (n,)

    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    if cell_mask is None:
        rows = torch.randint(0, m.n_rows, shape, generator=gen, device=dev)
        cols = torch.randint(0, m.n_cols, shape, generator=gen, device=dev)
    else:
        rows, cols = masked_cells(
            torch.rand(shape, generator=gen, device=dev), cell_mask)
    cx, cy = cell_center(rows.to(torch.float32), cols.to(torch.float32),
                         m.cell_meters)
    off = cfg.cell_offset
    x = cx + uniform(-off, off)
    y = cy + uniform(-off, off)
    yaw = uniform(-math.pi, math.pi)
    return torch.stack([x + cfg.global_offset, y + cfg.global_offset, yaw],
                       dim=-1).to(torch.float32)


def draw_resample(gen: torch.Generator, m: MazeMap, n: int,
                  cfg: FilterConfig, batch=(),
                  cell_mask=None) -> ResampleDraws:
    """The draws of one resampling pass, from `gen`, with leading episode
    shape `batch`.  The fresh particles are always drawn (the JAX package
    skips them when p_inject == 0, where no slot reads them), so the tick
    needs no host sync; `cell_mask` restricts their cells."""
    dev = m.device
    batch = tuple(batch)

    def rand(*shape):
        return torch.rand(batch + shape, generator=gen, device=dev)

    systematic = cfg.resample.method == "systematic"
    u = None if systematic else rand(n)
    u0 = rand() if systematic else None
    inject_r = rand(n) if systematic else None
    jitter = 2.0 * rand(3, n) - 1.0
    fresh = sample_uniform_particles(gen, m, n, cfg.init, batch, cell_mask)
    return ResampleDraws(jitter=jitter, fresh=fresh, u=u, u0=u0,
                         inject_r=inject_r)


def systematic_indices(cdf, u0):
    """Low-variance resampling's source indices, lower_bound(cdf,
    (k + u0)/N) for k < N, through the offspring counts (resample.py:134
    of the JAX package)."""
    return expand.source_indices(expand.offspring_counts(cdf, u0))


def _regime(jitter_state, cfg: ResampleConfig):
    """Lost/confident scalar parameters (monte_carlo.cpp:472-482).  Under
    the ESS-gated schedule the averages' rates are clamped to <= 1
    (resample.py:316-337 of the JAX package): the reference's
    conf_alpha_fast = 2.0 makes w_fast an oscillator that goes negative,
    and with gated resampling its p_inject > 1 floods sustain
    themselves."""
    def sel(a, b):
        return torch.where(jitter_state, float(a), float(b))

    def rate(a):
        return min(float(a), 1.0) if cfg.ess_threshold is not None else a

    return dict(
        max_injection=sel(cfg.lost_max_injection, cfg.conf_max_injection),
        alpha_slow=sel(rate(cfg.lost_alpha_slow), rate(cfg.conf_alpha_slow)),
        alpha_fast=sel(rate(cfg.lost_alpha_fast), rate(cfg.conf_alpha_fast)),
        jitter_xy=sel(cfg.lost_jitter_xy, cfg.conf_jitter_xy),
        jitter_theta=sel(cfg.lost_jitter_theta, cfg.conf_jitter_theta),
    )


def update_injection(weights, inj: InjectionState, jitter_state,
                     cfg: FilterConfig):
    """Dual-timescale average update (monte_carlo.cpp:487-492).  Returns
    (new InjectionState, p_inject, w_avg, total_weight)."""
    p = _regime(jitter_state, cfg.resample)
    total = torch.sum(weights, dim=-1)
    w_avg = total * f32_reciprocal(weights.shape[-1])
    w_slow = inj.w_slow + p["alpha_slow"] * (w_avg - inj.w_slow)
    w_fast = inj.w_fast + p["alpha_fast"] * (w_avg - inj.w_fast)
    # Guard the 0/0 at startup (C++ std::max(0.0, nan) -> 0.0).
    p_inject = torch.where(
        w_slow > 0.0, torch.clamp(1.0 - w_fast / w_slow, min=0.0), 0.0)
    return InjectionState(w_slow, w_fast), p_inject, w_avg, total


def weight_cdf(weights):
    """The normalized weight CDF [..., N]; degenerate all-zero weights
    fall back to uniform.  Accumulated in float64, rounded to float32:
    torch's CPU cumsum does that for float32 by itself, while its CUDA
    cumsum adds float32 in an order that changes from run to run, and at
    1M particles one ulp of the CDF moves about 1 % of the draws."""
    n = weights.shape[-1]
    total = torch.sum(weights, dim=-1, keepdim=True)
    norm_w = torch.where(total > 0.0, weights / total, 1.0 / n)
    return torch.cumsum(norm_w.double(), dim=-1).float()


def resample(
    particles,              # [..., N, 3]
    weights,                # [..., N] unnormalized (from beam_weights)
    inj: InjectionState,
    jitter_state,           # bool tensor [...]: True = lost regime
    m: MazeMap,
    cfg: FilterConfig,
    draws: ResampleDraws,
    draw_weights=None,      # [..., N] CDF weights (default: `weights`)
) -> Tuple[torch.Tensor, torch.Tensor, InjectionState, dict]:
    """One resampling pass per episode.  Returns (particles, weights=1/N,
    inj, info).  `weights` always feeds the injection bookkeeping;
    `draw_weights`, where given, the draw.  The fresh particles' cell mask
    (explored-cell injection) is in `draws.fresh` already."""
    rcfg = cfg.resample
    n = particles.shape[-2]
    p = {k: v[..., None] for k, v in _regime(jitter_state, rcfg).items()}
    new_inj, p_inject, w_avg, total = update_injection(
        weights, inj, jitter_state, cfg)
    cdf = weight_cdf(weights if draw_weights is None else draw_weights)

    if rcfg.method == "multinomial":
        # "sorted" is the JAX package's TPU workaround for the same
        # multiset; the exact per-slot draw is the semantics.
        if rcfg.multinomial_impl not in ("auto", "exact", "sorted"):
            raise ValueError(
                f"unknown multinomial_impl {rcfg.multinomial_impl!r}")
        inject_r = draws.u
        # CDF draw (lower_bound == side='left'), clipped for round-off.
        idx = torch.searchsorted(cdf, draws.u.contiguous(),
                                 side="left").clamp(max=n - 1)
        drawn = expand.gather_rows(particles, idx)
    elif rcfg.method == "systematic":
        inject_r = draws.inject_r
        if rcfg.expand == "xla":
            drawn = expand.gather_rows(particles,
                                       systematic_indices(cdf, draws.u0))
        else:
            drawn = expand.systematic_expand(particles, cdf, draws.u0)
    else:
        raise ValueError(f"unknown resample method {rcfg.method!r}")

    # Injection: Bernoulli successes, capped first-come (monte_carlo.cpp:518).
    bern = inject_r < p_inject[..., None]
    inject = bern & (torch.cumsum(bern, dim=-1) <= p["max_injection"])
    n_injected = torch.sum(inject, dim=-1)
    jx = draws.jitter[..., 0, :] * p["jitter_xy"]
    jy = draws.jitter[..., 1, :] * p["jitter_xy"]
    jt = draws.jitter[..., 2, :] * p["jitter_theta"]
    drawn = torch.stack([drawn[..., 0] + jx, drawn[..., 1] + jy,
                         normalize_angle(drawn[..., 2] + jt)], dim=-1)
    new_particles = torch.where(inject[..., None], draws.fresh, drawn)
    new_weights = torch.full(particles.shape[:-1], 1.0 / n,
                             dtype=torch.float32, device=particles.device)
    info = dict(p_inject=p_inject, n_injected=n_injected, w_avg=w_avg,
                total_weight=total)
    return new_particles, new_weights, new_inj, info


def ess_gated_resample(
    particles,              # [..., N, 3]
    likelihood,             # [..., N] this tick's beam likelihood
    carried_w,              # [..., N] carried importance weights
    inj: InjectionState,
    jitter_state,           # bool tensor [...]
    m: MazeMap,
    cfg: FilterConfig,
    draws: ResampleDraws,
) -> Tuple[torch.Tensor, torch.Tensor, InjectionState, dict]:
    """ESS-gated SIR resampling (resample.py:452-511 of the JAX package).

    The carried weights take this tick's likelihood (w_t ~ w_{t-1} *
    p(z_t | x_t), normalized); the full pass (CDF draw, jitter,
    injection) runs where the effective sample size 1/sum(w^2) is below
    ess_threshold * N or the kidnap detector asks for injection
    (p_inject > 0).  Elsewhere the particles stay as they are, the weights
    are the normalized carried ones and nothing is injected.  The
    injection averages take this tick's likelihood on both branches.

    The gate is a per-episode torch.where over both branches: the pass's
    draws are made whether or not it fires, so the result is the JAX
    package's lax.cond result, without a host sync, and a batch equals its
    episodes one by one."""
    n = particles.shape[-2]
    tau = cfg.resample.ess_threshold
    combined = carried_w * likelihood
    total_c = torch.sum(combined, dim=-1, keepdim=True)
    norm = torch.where(total_c > 0.0, combined / total_c, 1.0 / n)
    ess = 1.0 / torch.sum(norm * norm, dim=-1)
    drawn, uniform_w, new_inj, info = resample(
        particles, likelihood, inj, jitter_state, m, cfg, draws,
        draw_weights=norm)
    fire = (ess < tau * n) | (info["p_inject"] > 0.0)
    info = dict(info, n_injected=torch.where(
        fire, info["n_injected"], torch.zeros_like(info["n_injected"])),
        resampled=fire)
    return (torch.where(fire[..., None, None], drawn, particles),
            torch.where(fire[..., None], uniform_w, norm), new_inj, info)


def resize_particles(particles, weights, n_new: int, u0):
    """Systematic redraw of n_new particles from a weighted set
    [..., N, 3] (resample.py:209-236 of the JAX package): positions
    (k + u0)/n_new against the weight CDF give the offspring counts
    c_i = clip(floor(n_new * cdf_i - u0) + 1, 0, n_new), kept monotone,
    and output k takes the first source whose count exceeds k.  Returns
    ([..., n_new, 3] particles, [..., n_new] uniform weights)."""
    cdf = weight_cdf(weights)
    u0 = torch.as_tensor(u0, dtype=torch.float32,
                         device=cdf.device)[..., None]
    counts = torch.cummax(torch.clamp(
        torch.floor(n_new * cdf - u0).to(torch.int32) + 1, 0, n_new),
        dim=-1).values
    k = torch.arange(n_new, dtype=torch.int32, device=cdf.device)
    key = torch.minimum(k, counts[..., -1:] - 1).expand(
        counts.shape[:-1] + (n_new,)).contiguous()
    idx = torch.searchsorted(counts, key, right=True).clamp(
        max=particles.shape[-2] - 1)
    return (expand.gather_rows(particles, idx),
            torch.full(particles.shape[:-2] + (n_new,), 1.0 / n_new,
                       dtype=torch.float32, device=particles.device))


def draw_resize(gen: torch.Generator, device, batch=()):
    """resize_particles' offset u0 [...] in [0, 1), from `gen`."""
    return torch.rand(tuple(batch), generator=gen, device=device)
