"""One gloo rank of the port's multi-process tests.

Usage: python torch_dist_child.py RANK WORLD RDZV JOB OUT

tests/test_torch_distributed.py and tests/test_torch_multihost.py start
WORLD of these (torch_parity.spawn_ranks).  Each joins a gloo group
through the file rendezvous RDZV (or, where RDZV is "env", through
multihost.initialize and the MCL_* or torchrun variables the test set),
runs the tasks of JOB (a torch.save'd
list of (name, task, kwargs)) in order and writes {name: result} to
OUT/rank<RANK>.pt, every result numpy arrays and numbers.  It imports
torch and the port only, never JAX: the JAX side of each comparison runs
in the test process and reaches the ranks as arrays and port dataclasses
(configs, draws).
"""
import dataclasses
import os.path as osp
import sys
import types

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

torch.set_num_threads(1)

from montecarlolocalisation_tpu_torch import interop  # noqa: E402
from montecarlolocalisation_tpu_torch.models import (  # noqa: E402
    compiled, sensor,
)
from montecarlolocalisation_tpu_torch.parallel import (  # noqa: E402
    distributed as sd,
)
from montecarlolocalisation_tpu_torch.parallel import (  # noqa: E402
    episodes, multihost,
)


def ns(tree):
    """Nested dicts -> attribute namespaces (interop reads attributes)."""
    if isinstance(tree, dict):
        return types.SimpleNamespace(**{k: ns(v) for k, v in tree.items()})
    return tree


def numpy(tree):
    """Every tensor of a result -> numpy, generators -> their states."""
    if isinstance(tree, torch.Tensor):
        # A copy: a graph's buffers change at its next call.
        return tree.detach().cpu().numpy().copy()
    if isinstance(tree, torch.Generator):
        return tree.get_state().numpy()
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: numpy(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [numpy(v) for v in tree]
    return tree


def _group(world, particle_shards=None):
    mesh = sd.make_mesh(particle_shards or world, world // (
        particle_shards or world))
    return mesh, mesh.get_group("particle")


def ring(rank, world, kind, weights, parts, u0=None, spacings=None,
         spacing_extra=None):
    """This rank's block of a ring draw on the global weights [n] and rows
    [n, D], its global CDF block and (multinomial) its sorted uniforms."""
    _, g = _group(world)
    n_loc = weights.shape[0] // world
    blk = slice(rank * n_loc, (rank + 1) * n_loc)
    w = torch.as_tensor(weights[blk])
    p = torch.as_tensor(parts[blk])
    cdf, _ = sd._global_cdf_prefix(w, g)
    out = dict(cdf=cdf)
    if kind == "systematic":
        out["drawn"] = sd._ring_systematic_draw(p, w, torch.tensor(u0), g)
    else:
        s = torch.as_tensor(spacings[blk])
        e = torch.tensor(spacing_extra)
        out["rs"] = sd._sorted_uniforms(s, e, g)
        out["drawn"] = sd._ring_multinomial_draw(p, w, s, e, g)
    return numpy(out)


def _scan(scan, rows=None):
    r = torch.as_tensor(scan["ranges"])
    m = torch.as_tensor(scan["mask"])
    if rows is not None:
        r = r[rows]
        m = m[rows] if m.dim() == r.dim() else m
    return sensor.Scan(angles=torch.as_tensor(scan["angles"]), ranges=r,
                       mask=m)


def tick(rank, world, cfg, maze, state, enc, scan, draws=None, ticks=1,
         episode_shards=1, seed=None):
    """`ticks` sharded ticks (make_sharded_step, or its batched form on an
    episode x particle mesh) from this rank's block of the whole state;
    `draws` one list of per-rank ShardDraws a tick, else the generators.
    Returns the rank's block, its outputs and its generators' states."""
    m = interop.maze_from_numpy(ns(maze))
    mesh, g = _group(world, world // episode_shards)
    st = interop.state_from_numpy(ns(state))
    ep = "episode" if episode_shards > 1 else None
    block = sd.shard_state(st, mesh, episode_axis=ep, seed=seed)
    if ep:
        step = sd.make_sharded_step_batched(mesh, m, cfg)
        e_loc = block.particles.shape[0]
        rows = slice(mesh.get_local_rank("episode") * e_loc,
                     (mesh.get_local_rank("episode") + 1) * e_loc)
        sc = _scan(scan, rows)
        el, er = (torch.as_tensor(enc[0])[rows],
                  torch.as_tensor(enc[1])[rows])
    else:
        step = sd.make_sharded_step(mesh, m, cfg)
        sc, (el, er) = _scan(scan), enc
    outs = []
    for k in range(ticks):
        d = None if draws is None else draws[k][rank]
        block, out = step(block, el, er, sc, draws=d)
        outs.append(numpy(out))
    return dict(state=numpy(block), outs=outs,
                before=numpy(sd.shard_state(st, mesh, episode_axis=ep,
                                            seed=seed).gen))


def own_draws(rank, world, cfg, maze, n_loc, seed):
    """draw_shard_tick alone from fresh shard generators: what one tick's
    draws advance the generators by."""
    m = interop.maze_from_numpy(ns(maze))
    mesh, g = _group(world)
    gens = sd.shard_generators(seed, 0, rank, "cpu")
    sd.draw_shard_tick(gens, m, n_loc, world, cfg)
    return numpy(gens)


class _Shapes(torch.utils._python_dispatch.TorchDispatchMode):
    """Records the shape of every tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.shapes.append((str(func), tuple(t.shape)))
        return out


def shapes(rank, world, cfgs, maze, state, enc, scan, seed):
    """Every output shape of one eager mcl_step_sharded, per config."""
    m = interop.maze_from_numpy(ns(maze))
    mesh, g = _group(world)
    st = interop.state_from_numpy(ns(state))
    found = {}
    for name, cfg in cfgs.items():
        block = sd.shard_state(st, mesh, seed=seed)
        rec = _Shapes()
        with rec:
            sd.mcl_step_sharded(block, enc[0], enc[1], _scan(scan), m, cfg,
                                g)
        found[name] = rec.shapes
    return found


def slam(rank, world, cfg, state, inputs, draws):
    """Sharded SLAM ticks (make_sharded_slam_step) on JAX's per-rank
    draws: inputs a list of (enc_l, enc_r, ranges, angles, mask)."""
    mesh, g = _group(world)
    st = interop.slam_state_from_numpy(ns(state))
    block = sd.shard_slam_state(st, mesh)
    step = sd.make_sharded_slam_step(mesh, cfg)
    infos = []
    for k, (el, er, rg, an, mk) in enumerate(inputs):
        block, info = step(block, el, er, rg, an, mk, draws=draws[k][rank])
        infos.append(numpy(info))
    return dict(state=numpy(block), infos=infos,
                whole=numpy(sd.gather_state(block, mesh)))


def sweep(rank, world, cfg, maze, seed, encoders, ranges, angles,
          states=None, draws=None):
    """run_multihost_episode_batch on this rank's block of the episodes,
    gathered to every rank: from its own draws, or from the given
    whole states and per-tick TickDraws (sliced here)."""
    m = interop.maze_from_numpy(ns(maze))
    start, count = multihost.process_episode_slice(encoders.shape[0])
    rows = slice(start, start + count)
    st = d = None
    if states is not None:
        st = interop.state_from_numpy(ns(states))
        st = compiled.tree_map(lambda v: v if isinstance(
            v, torch.Generator) else v[rows], st)
        d = [compiled.tree_map(lambda v: v[rows], dt) for dt in draws]
    final, outs = multihost.run_multihost_episode_batch(
        seed, m, cfg, encoders[rows], ranges[rows], angles, state=st,
        draws=d)
    return numpy(dict(final=multihost.all_processes_value(final),
                      outs=multihost.all_processes_value(outs),
                      slice=(start, count)))


def whole_sweep(rank, world, cfg, maze, seed, encoders, ranges, angles):
    """episodes.run_episode_batch over every episode in this one process:
    the single-process sweep the multihost one is held against."""
    m = interop.maze_from_numpy(ns(maze))
    final, outs = episodes.run_episode_batch(seed, m, cfg, encoders, ranges,
                                             angles)
    return numpy(dict(final=final, outs=outs))


def _raises(fn) -> bool:
    try:
        fn()
    except ValueError:
        return True
    return False


def mesh_layout(rank, world, particle_shards, too_many, not_dividing):
    mesh = multihost.make_multihost_mesh(particle_shards=particle_shards)
    raised = _raises(lambda: multihost.make_multihost_mesh(
        particle_shards=too_many))
    # Where the JAX package leaves devices out of the mesh, these raise.
    raised_not_dividing = _raises(lambda: multihost.make_multihost_mesh(
        particle_shards=not_dividing))
    raised_subset = _raises(lambda: sd.make_mesh(1, 1))
    x = np.arange(16, dtype=np.float32).reshape(8, 2)
    start, count = multihost.process_episode_slice(8)
    back = multihost.all_processes_value(multihost.global_episode_array(
        x[start:start + count], mesh, device="cpu"))
    return dict(names=mesh.mesh_dim_names, shape=tuple(mesh.shape),
                raised=raised, raised_not_dividing=raised_not_dividing,
                raised_subset=raised_subset, back=back,
                slice=(start, count))


TASKS = dict(ring=ring, tick=tick, own_draws=own_draws, shapes=shapes,
             slam=slam, sweep=sweep, whole_sweep=whole_sweep,
             mesh_layout=mesh_layout)


def main() -> None:
    rank, world, rdzv, job, out = sys.argv[1:6]
    rank, world = int(rank), int(world)
    if rdzv == "env":
        if not multihost.initialize(device="cpu"):
            raise RuntimeError("initialize started no process group")
        if (dist.get_rank(), dist.get_world_size()) != (rank, world):
            raise RuntimeError("initialize joined another rank or world")
    else:
        dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                                rank=rank, world_size=world)
    results = {}
    for name, task, kwargs in torch.load(job, weights_only=False):
        results[name] = TASKS[task](rank, world, **kwargs)
    torch.save(results, osp.join(out, f"rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
