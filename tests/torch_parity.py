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
import os
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


def jax_shard_tick_draws(key, jm, n_loc, n_shards, cfg):
    """Per shard s, the port ShardDraws of the random numbers JAX's
    mcl_step_sharded draws on shard s from the replicated state key
    `key` (distributed.py:433, :443, :228-245, :166-172, :356-373): the
    per-shard keys fold in s, the shard-invariant ones do not."""
    from montecarlolocalisation_tpu_torch.parallel import distributed as sd

    _, k_motion, k_resample, k_cluster = jax.random.split(key, 4)
    rc = cfg.resample
    systematic = rc.method == "systematic"
    ring = rc.sharded_exchange == "ring"
    init, reseed = jax_kmeans_indices(k_cluster, n_loc * n_shards,
                                      cfg.cluster)
    u_key, _ = jax.random.split(jax.random.fold_in(k_resample, 0))
    mn_key = jax.random.split(jax.random.fold_in(k_resample, 0), 8)[7]
    tiny = jnp.float32(1e-37)
    out = []
    for s in range(n_shards):
        shared = cfg.motion.shared_noise
        k_m = k_motion if shared else jax.random.fold_in(k_motion, s)
        normals = jnp.stack([jax.random.normal(k, () if shared else (n_loc,))
                             for k in jax.random.split(k_m, 3)])
        k_draw, k_inj, k_jx, k_jy, k_jt, k_fresh = jax.random.split(
            jax.random.fold_in(k_resample, s), 6)
        jitter = jnp.stack([jax.random.uniform(k, (n_loc,), minval=-1.0,
                                               maxval=1.0)
                            for k in (k_jx, k_jy, k_jt)])
        fresh = jresample.sample_uniform_particles(k_fresh, jm, n_loc,
                                                   cfg.init)
        u = u0 = inject_r = spacings = extra = None
        if systematic:
            u0 = t(jax.random.uniform(u_key, ()))
        if systematic or ring:
            inject_r = t(jax.random.uniform(k_inj, (n_loc,)))
        else:
            u = t(jax.random.uniform(k_draw, (n_loc,)))
        if ring and not systematic:
            spacings = t(jax.random.uniform(jax.random.fold_in(mn_key, s),
                                            (n_loc,), minval=tiny,
                                            maxval=1.0))
            extra = t(jax.random.uniform(
                jax.random.fold_in(mn_key, n_shards), (), minval=tiny,
                maxval=1.0))
        out.append(sd.ShardDraws(
            motion_normals=t(normals),
            resample=tresample.ResampleDraws(jitter=t(jitter), fresh=t(fresh),
                                             u=u, u0=u0, inject_r=inject_r),
            kmeans_init=t(init, torch.int64),
            kmeans_reseed=t(reseed, torch.int64),
            spacings=spacings, spacing_extra=extra))
    return out


def jax_shard_slam_draws(key, p_loc, n_shards):
    """Per shard, the port SLAMDraws of JAX's slam_step_sharded from state
    key `key` (distributed.py:649-650, :667-668, :691), and the next state
    key."""
    from montecarlolocalisation_tpu_torch.models import slam as tslam

    k_noise, k_draw, k_next = jax.random.split(key, 3)
    u0 = t(jax.random.uniform(k_draw, ()))
    out = []
    for s in range(n_shards):
        ks = jax.random.split(jax.random.fold_in(k_noise, s), 3)
        normals = jnp.stack([jax.random.normal(k, (p_loc,)) for k in ks])
        out.append(tslam.SLAMDraws(normals=t(normals), gumbel=None, u0=u0))
    return out, k_next


def as_numpy(tree):
    """A JAX pytree of dataclasses (or a MazeMap) -> nested dicts of numpy
    arrays, the form tests/torch_dist_child.py rebuilds with interop."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: as_numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, (int, float, bool)) or tree is None:
        return tree
    return np.asarray(tree)


CHILD = osp.join(osp.dirname(osp.abspath(__file__)), "torch_dist_child.py")


def spawn_ranks(world, jobs, tmp_path, timeout=240, env_of=None):
    """Run `jobs` ((name, task, kwargs) of tests/torch_dist_child.py) on
    `world` gloo ranks, each a process with one thread, joined by a file
    rendezvous under tmp_path or, with `env_of` (rank -> variables), by
    multihost.initialize reading those variables; returns one
    {name: result} dict a rank."""
    import subprocess
    import sys
    import uuid

    run = tmp_path / f"ranks{world}-{uuid.uuid4().hex[:8]}"
    run.mkdir()
    job = run / "job.pt"
    torch.save(jobs, job)
    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=root)
    procs, logs = [], []
    for r in range(world):
        log = open(run / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, CHILD, str(r), str(world),
             "env" if env_of else str(run / "rdzv"), str(job), str(run)],
            stdout=log, stderr=subprocess.STDOUT,
            env=dict(env, **(env_of(r) if env_of else {}))))
    try:
        rcs = [p.wait(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if any(rcs):
        tails = [(r, (run / f"rank{r}.log").read_text()[-3000:])
                 for r in range(world) if rcs[r]]
        raise AssertionError(f"ranks failed {rcs}: {tails}")
    return [torch.load(run / f"rank{r}.pt", weights_only=False)
            for r in range(world)]
