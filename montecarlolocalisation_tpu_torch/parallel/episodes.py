"""Episode-batched sweeps and evidence-raced replicas.

Torch counterpart of montecarlolocalisation_tpu/parallel/episodes.py.  The
JAX package runs a batch as vmap(init + lax.scan); here a batch of E
episodes is the filter's leading episode dim ([E, N, 3] particles, [E]
scalars), run by models/filter.run_episode in CUDA graphs of several
ticks (models/compiled), every tick one batched launch of each kernel.  Replicas are more
episodes of the same batch ([R*E], replica-major), not a loop of R runs.
A sweep over randomized maps (`run_multimap_sweep`) is one batch on a map
stack (maps/grid), each episode reading its own map.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import FilterConfig
from ..maps import symmetry as _sym
from ..maps.grid import MazeMap, repeat_maps
from ..models import filter as mcl
from ..sim import robot
from ..utils import profiling


def simulate_episode_batch(gen: torch.Generator, m: MazeMap,
                           cfg: FilterConfig, scan_angles, num_ticks: int,
                           batch: int, start_pose=(1.25, 1.25, 0.0)):
    """The scripted wanderer for `batch` robots -> (encoders [E, T, 2],
    scan ranges [E, T, B], poses [E, T, 3]); on a map stack of `batch`
    episodes each robot wanders its own map."""
    return robot.generate_wander_episode(gen, m, cfg, scan_angles,
                                         num_ticks, batch=batch,
                                         start_pose=start_pose)


def run_episode_batch(
    seed: int, m: MazeMap, cfg: FilterConfig, encoders, scan_ranges,
    scan_angles, tick_chunk: Optional[int] = None,
    state: Optional[mcl.MCLState] = None,
    draws: Optional[Sequence[mcl.TickDraws]] = None,
    known_map: Optional[MazeMap] = None,
) -> Tuple[mcl.MCLState, mcl.MCLOutput]:
    """Run the filter over a batch of episodes: encoders [E, T, 2],
    scan_ranges [E, T, B], one beam table [B].  The start state is
    init_state(seed, batch=E) unless `state` is given; `draws` (one
    TickDraws [E, ...] per tick) replays given random numbers;
    `known_map` scores on a partial map (models/filter.mcl_step).

    `tick_chunk` is accepted for the JAX package's signature and changes
    nothing: the JAX package splits the tick scan to bound one device
    execution, and here one replay runs compiled.TICKS_PER_GRAPH ticks
    whatever the episode's length."""
    if tick_chunk is not None and tick_chunk < 1:
        raise ValueError("tick_chunk must be >= 1")
    # One call, one span: run_episode's spans take its id.
    with profiling.span("episode.call"):
        with profiling.span("episode.prep"):
            encoders = torch.as_tensor(encoders, dtype=torch.float32,
                                       device=m.device)
            if state is None:
                state = mcl.init_state(m, cfg, seed, batch=encoders.shape[0],
                                       known_map=known_map)
        return mcl.run_episode(state, encoders, scan_ranges, scan_angles, m,
                               cfg, draws=draws, known_map=known_map)


# The episode stacks of run_multimap_sweep, by (id of the caller's stack,
# episodes_per_map), each dropped when the caller's stack dies: a second
# sweep on the same stack reads the same episode stack, so it replays the
# graphs (models/compiled) that the first built on it.
_episode_stacks: Dict[Tuple[int, int], MazeMap] = {}


def _repeated(maps: MazeMap, episodes_per_map: int) -> MazeMap:
    key = (id(maps), episodes_per_map)
    batch = _episode_stacks.get(key)
    if batch is None:
        batch = _episode_stacks[key] = repeat_maps(maps, episodes_per_map)
        weakref.finalize(maps, _episode_stacks.pop, key, None).atexit = False
    return batch


def run_multimap_sweep(
    seed: int, maps: MazeMap, cfg: FilterConfig, scan_angles,
    num_ticks: int, episodes_per_map: int = 1,
    start_pose=(1.25, 1.25, 0.0),
) -> Tuple[mcl.MCLState, mcl.MCLOutput, torch.Tensor]:
    """Randomized-maps sweep (episodes.py:118-150; BASELINE config 4):
    `episodes_per_map` wander episodes on each map of the stack `maps`
    (maps.generator.generate_map_batch), then the filter over all of them
    as one batch, each episode on its own map.  Returns (final states,
    outputs, true poses [M * episodes_per_map, T, 3]), map-major as in
    the JAX package.  The simulation and the filter draw from two seeds
    derived from `seed`; the JAX package's threefry draws differ, its maps
    do not."""
    if not maps.is_stack:
        raise ValueError("run_multimap_sweep takes a map stack")
    batch = _repeated(maps, episodes_per_map)
    sim_seed, filter_seed = (int(v) for v in
                             np.random.SeedSequence(seed).generate_state(2))
    gen = torch.Generator(device=maps.device)
    gen.manual_seed(sim_seed)
    enc, ranges, truth = simulate_episode_batch(
        gen, batch, cfg, scan_angles, num_ticks,
        maps.maps * episodes_per_map, start_pose=start_pose)
    final, outs = run_episode_batch(filter_seed, batch, cfg, enc, ranges,
                                    scan_angles)
    return final, outs, truth


def _nanmean(v):
    return float(torch.nanmean(v.to(torch.float64)))


def sweep_rmse(final_states: mcl.MCLState, true_poses, sym=None,
               tol_xy: float = 0.4) -> dict:
    """Convergence metrics of a sweep on its final tick (episodes.py:153):
    converged_frac, rmse_xy, rmse_theta and, with `sym` (a
    maps.symmetry.SymmetryGroup), the alias-aware metrics, which score the
    best alias of the truth, and the cloud-as-mixture metrics.  Returns
    floats."""
    best = final_states.best_pose                              # [E, 3]
    truth = torch.as_tensor(true_poses, dtype=torch.float32,
                            device=best.device)[:, -1, :]      # [E, 3]
    ok = best[:, 0] >= 0
    err = torch.where(ok, torch.hypot(best[:, 0] - truth[:, 0],
                                      best[:, 1] - truth[:, 1]), torch.nan)
    dth = torch.atan2(torch.sin(best[:, 2] - truth[:, 2]),
                      torch.cos(best[:, 2] - truth[:, 2]))
    out = dict(
        converged_frac=float(torch.mean(ok.to(torch.float32))),
        rmse_xy=math.sqrt(_nanmean(err ** 2)),
        rmse_theta=math.sqrt(_nanmean(torch.where(ok, dth, torch.nan) ** 2)),
    )
    if sym is not None:
        ae = _sym.alias_errors(best, truth, sym)
        a_err = torch.where(ok, ae["err_xy"], torch.nan)
        near = ok & (ae["err_xy"] < tol_xy)
        out.update(
            alias_rmse_xy=math.sqrt(_nanmean(a_err ** 2)),
            alias_rmse_theta=math.sqrt(_nanmean(
                torch.where(ok, ae["err_theta"], torch.nan) ** 2)),
            alias_converged_frac=float(torch.mean(near.to(torch.float32))),
            true_mode_frac=float(torch.mean(
                (near & (ae["alias_idx"] == 0)).to(torch.float32))),
        )
        mt = _sym.mixture_tracking(final_states.particles,
                                   final_states.weights, truth, sym,
                                   stray_radius=tol_xy)
        tr = mt["tracking_rmse_xy"]
        out.update(
            dominant_mass_mean=float(torch.mean(mt["dominant_mass"])),
            stray_mass_mean=float(torch.mean(mt["stray_mass"])),
            tracking_rmse_xy=math.sqrt(_nanmean(tr ** 2)),
            tracked_episodes_frac=float(torch.mean(
                torch.isfinite(tr).to(torch.float32))),
        )
    return out


def replica_evidence(total_weight, replicas: int) -> np.ndarray:
    """Accumulated log evidence [R, E] of a replica-major batch's
    total_weight [R*E, T]: sum over ticks of log max(total, 1e-30), in
    float64 (episodes.py:239-241)."""
    tw = np.asarray(total_weight.detach().cpu(), np.float64)
    ev = np.log(np.maximum(tw, 1e-30)).sum(axis=-1)
    return ev.reshape(replicas, -1)


def pick_replicas(final: mcl.MCLState, outs: mcl.MCLOutput, replicas: int):
    """Keep, per episode, the replica with the highest log evidence.
    final and outs hold a replica-major batch [R*E, ...].  Returns
    (final [E, ...], outs [E, ...], dict(chosen [E], log_evidence
    [R, E]))."""
    ev = replica_evidence(outs.total_weight, replicas)
    chosen = np.argmax(ev, axis=0)
    n_ep = chosen.shape[0]
    rows = torch.as_tensor(chosen * n_ep + np.arange(n_ep),
                           device=final.particles.device)

    def pick(cls, obj):
        return cls(**{f.name: (getattr(obj, f.name)[rows]
                               if isinstance(getattr(obj, f.name),
                                             torch.Tensor)
                               else getattr(obj, f.name))
                      for f in dataclasses.fields(cls)})

    state = dataclasses.replace(
        pick(mcl.MCLState, final), odom=pick(type(final.odom), final.odom),
        inj=pick(type(final.inj), final.inj))
    return state, pick(mcl.MCLOutput, outs), dict(chosen=chosen,
                                                  log_evidence=ev)


def run_episode_replicas(seed: int, m: MazeMap, cfg: FilterConfig, encoders,
                         scan_ranges, scan_angles, replicas: int = 4,
                         tick_chunk: Optional[int] = None,
                         known_map: Optional[MazeMap] = None):
    """Evidence-selected filter replicas over an episode batch
    (episodes.py:211): every episode runs `replicas` times with
    independent filter draws, in ONE batch of replicas x episodes, and
    keeps the replica with the highest accumulated log total weight.
    Returns (final state of the winners, their outputs, info with
    `chosen` [E] and the [R, E] evidence)."""
    if replicas < 1:
        raise ValueError("replicas must be >= 1")
    dev = m.device
    enc = torch.as_tensor(encoders, dtype=torch.float32, device=dev)
    rng = torch.as_tensor(scan_ranges, dtype=torch.float32, device=dev)
    rep = (replicas,) + (1,) * (enc.dim() - 1)
    final, outs = run_episode_batch(seed, m, cfg, enc.repeat(rep),
                                    rng.repeat(rep), scan_angles,
                                    tick_chunk=tick_chunk,
                                    known_map=known_map)
    return pick_replicas(final, outs, replicas)
