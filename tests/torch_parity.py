"""Shared inputs for the torch-port parity tests (tests/test_torch_*.py).

Both packages get the same numpy arrays.  JAX runs on the CPU under jit
(its Pallas kernels in interpret mode, as the JAX suite runs them); the
port runs on CPU tensors, where every kernel wrapper takes its plain
version.  `jax_tick_draws` rebuilds the JAX package's key-split tree for
one filter tick (filter.py:193, motion.py:80, resample.py:388,
cluster.py:40-47), so the port can replay JAX's exact random numbers;
`jax_episode_draws` does so for every tick of a batch of episodes, and
`jax_slam_draws` for one SLAM tick.
"""
from __future__ import annotations

import dataclasses
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import torch

from montecarlolocalisation_tpu.maps import from_map_file
from montecarlolocalisation_tpu.models import resample as jresample
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import resample as tresample

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation_tpu",
                    "maps", "default_map.txt")


def maps():
    """(JAX map, port map on the CPU) of the default maze."""
    jm = from_map_file(MAP_PATH)
    return jm, interop.maze_from_numpy(jm)


def t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def uniform_particles(jm, n, seed):
    """JAX's reference sampler, as numpy [n, 3]."""
    return np.asarray(jresample.sample_uniform_particles(
        jax.random.PRNGKey(seed), jm, n))


def jax_tick_draws(key, jm, n, cfg) -> tfilter.TickDraws:
    """The random numbers JAX's mcl_step draws from state key `key`."""
    _, k_motion, k_resample, k_cluster = jax.random.split(key, 4)
    shape = () if cfg.motion.shared_noise else (n,)
    normals = jnp.stack([jax.random.normal(k, shape)
                         for k in jax.random.split(k_motion, 3)])
    init, reseed = jax_kmeans_indices(k_cluster, n, cfg.cluster)
    return tfilter.TickDraws(
        motion_normals=t(normals),
        resample=jax_resample_draws(k_resample, jm, n, cfg),
        kmeans_init=t(init, torch.int64),
        kmeans_reseed=t(reseed, torch.int64))


def jax_resample_draws(key, jm, n, cfg) -> tresample.ResampleDraws:
    """The random numbers of resample.resample(key, ...) (:388-444)."""
    k_draw, k_inj, k_jx, k_jy, k_jt, k_fresh = jax.random.split(key, 6)
    jitter = jnp.stack([jax.random.uniform(k, (n,), minval=-1.0, maxval=1.0)
                        for k in (k_jx, k_jy, k_jt)])
    fresh = jresample.sample_uniform_particles(k_fresh, jm, n, cfg.init)
    if cfg.resample.method == "systematic":
        return tresample.ResampleDraws(
            jitter=t(jitter), fresh=t(fresh),
            u0=t(jax.random.uniform(k_draw, ())),
            inject_r=t(jax.random.uniform(k_inj, (n,))))
    return tresample.ResampleDraws(jitter=t(jitter), fresh=t(fresh),
                                   u=t(jax.random.uniform(k_draw, (n,))))


def jax_kmeans_indices(key, n, ccfg):
    """cluster.kmeans's init [K] and reseed [I, K] particle indices."""
    k_init, k_iters = jax.random.split(key)
    init = jax.random.randint(k_init, (ccfg.k,), 0, n)
    reseed = jax.vmap(lambda kk: jax.random.randint(kk, (ccfg.k,), 0, n))(
        jax.random.split(k_iters, ccfg.max_iters))
    return np.asarray(init), np.asarray(reseed)


def _slice(obj, idx):
    """A dataclass of tensors (nested dataclasses, None and generators kept
    as they are) with every tensor indexed by `idx`."""
    if dataclasses.is_dataclass(obj):
        return type(obj)(**{f.name: _slice(getattr(obj, f.name), idx)
                            for f in dataclasses.fields(obj)})
    return obj[idx] if isinstance(obj, torch.Tensor) else obj


def episode(obj, e):
    """Episode e of a batched state, output or TickDraws."""
    return _slice(obj, e)


def stack(objs):
    """Batch a list of per-episode dataclasses of tensors along a new
    leading dim (generators and None taken from the first)."""
    first = objs[0]
    if dataclasses.is_dataclass(first):
        return type(first)(**{f.name: stack([getattr(o, f.name)
                                             for o in objs])
                              for f in dataclasses.fields(first)})
    if isinstance(first, torch.Tensor):
        return torch.stack(objs)
    return first


def jax_episode_draws(states, jm, n, cfg, num_ticks):
    """Per tick, the [E]-batched TickDraws that JAX's vmapped run_episode
    draws from each episode's state key (filter.py:193): the tick's draws
    come from the state key, and the next state key is its first split."""
    keys = [states.key[e] for e in range(states.key.shape[0])]
    out = []
    for _ in range(num_ticks):
        out.append(stack([jax_tick_draws(k, jm, n, cfg) for k in keys]))
        keys = [jax.random.split(k, 4)[0] for k in keys]
    return out


def jax_slam_draws(key, cfg):
    """The random numbers JAX's slam_step draws from state key `key`
    (slam.py:534-537, motion.py:80-86, :589-591, :639), as a port
    SLAMDraws, and the next state key."""
    from montecarlolocalisation_tpu_torch.models import slam as tslam

    p, k = cfg.num_particles, cfg.proposal_candidates
    if k > 1:
        k_noise, k_pick, k_draw, k_next = jax.random.split(key, 4)
    else:
        k_noise, k_draw, k_next = jax.random.split(key, 3)
    shape = (p, k) if k > 1 else (p,)
    normals = jnp.stack([jax.random.normal(kk, shape)
                         for kk in jax.random.split(k_noise, 3)])
    gumbel = (t(jax.random.uniform(k_pick, (p, k),
                                   minval=jnp.float32(1e-37), maxval=1.0))
              if k > 1 else None)
    return tslam.SLAMDraws(normals=t(normals), gumbel=gumbel,
                           u0=t(jax.random.uniform(k_draw, ()))), k_next
