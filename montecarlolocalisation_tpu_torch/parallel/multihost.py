"""Multi-host scale-out: episode sweeps dealt over processes.

Torch counterpart of montecarlolocalisation_tpu/parallel/multihost.py.
The JAX package runs one process a host (jax.distributed) with the
episode axis across hosts and the particle axis inside one; here a process
drives one device and joins the others through torch.distributed (NCCL
between cards, gloo between CPU processes).  Ranks are host-major, as
torchrun numbers them, so a particle group of consecutive ranks stays
inside a host; episodes are data parallel, and the only traffic of a sweep
is the final gather.

Every helper works in one process with no process group: that is the
single-host case, a strict subset.  The multi-process bring-up:

    from montecarlolocalisation_tpu_torch.parallel import multihost
    multihost.initialize()                     # MCL_* or torchrun's vars
    mesh = multihost.make_multihost_mesh()     # (episode, particle)
    start, count = multihost.process_episode_slice(total_episodes)
    ... build this rank's inputs for episodes [start, start + count) ...
    final, outs = multihost.run_multihost_episode_batch(...)
    conf = multihost.all_processes_value(final.confidence)

`run_multihost_episode_batch` draws the whole sweep's random numbers on
every rank from one generator and keeps the rank's rows, so an episode's
result does not depend on how many ranks share the sweep, and a rank's
episodes cost no host call each: the draws are made on the device inside
the captured tick.  Where the JAX package keys an episode by its global
index alone (fold_in), an episode here also depends on the sweep's total
episode count, as in episodes.run_episode_batch.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..config import FilterConfig
from ..maps.grid import MazeMap
from ..models import compiled
from ..models import filter as mcl
from . import distributed as _dist


def _env_int(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device=None) -> bool:
    """Start torch.distributed for a multi-process run; returns whether a
    process group was started.

    The JAX package's rules and variables: the arguments default to
    MCL_COORDINATOR (host:port of rank 0), MCL_NUM_PROCESSES and
    MCL_PROCESS_ID; one process is a no-op, and MCL_PROCESS_ID is required
    with MCL_NUM_PROCESSES.  With none of them set, torchrun's variables
    (WORLD_SIZE, RANK, MASTER_ADDR, MASTER_PORT) are read through
    init_method="env://", the counterpart of jax.distributed's
    auto-detection; with neither, the run stays one process.  `device`
    (default the card) picks the backend: NCCL with this rank's card
    bound (LOCAL_RANK, else the process id modulo the cards), gloo on the
    CPU.  A failed start raises."""
    num = num_processes if num_processes is not None else _env_int(
        "MCL_NUM_PROCESSES")
    if num is not None and num <= 1:
        return False
    coord = coordinator_address or os.environ.get("MCL_COORDINATOR")
    pid = process_id if process_id is not None else _env_int(
        "MCL_PROCESS_ID")
    if num is None and coord is None:
        world = _env_int("WORLD_SIZE")
        if world is None or world <= 1:
            return False
        num, pid = world, _env_int("RANK")
    if num is None:
        num = _env_int("WORLD_SIZE")
        pid = pid if pid is not None else _env_int("RANK")
        if num is None:
            raise ValueError("MCL_COORDINATOR needs MCL_NUM_PROCESSES (or "
                             "torchrun's WORLD_SIZE)")
        if num <= 1:
            return False
    if pid is None:
        raise ValueError(
            "multi-process run needs a per-host process id: set "
            "MCL_PROCESS_ID (0..num_processes-1) on each host or pass "
            "process_id=")
    dev = torch.device("cuda" if device is None else device)
    kw = {}
    if dev.type == "cuda":
        local = _env_int("LOCAL_RANK")
        index = dev.index if dev.index is not None else (
            local if local is not None else pid % torch.cuda.device_count())
        kw["device_id"] = torch.device("cuda", index)
        torch.cuda.set_device(index)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coord}" if coord else "env://",
        world_size=num, rank=pid, **kw)
    return True


def process_count() -> int:
    """Processes of the run (jax.process_count): the world size, 1 with no
    process group."""
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    """This process's rank (jax.process_index), 0 with no process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def local_process_count() -> int:
    """Processes on this host: torchrun's LOCAL_WORLD_SIZE, else every
    process of the run (one host)."""
    return _env_int("LOCAL_WORLD_SIZE") or process_count()


def make_multihost_mesh(particle_shards: int = 1,
                        episode_axis: str = "episode",
                        particle_axis: str = "particle",
                        device_type: Optional[str] = None):
    """The (episode, particle) DeviceMesh with the episode axis spanning
    hosts.  Particle groups are consecutive ranks inside one host (their
    collectives stay off the network between hosts): more particle shards
    than one host's processes raise, as in the JAX package.  They must
    also divide those processes, or this raises: the JAX package leaves
    the remainder devices out of its mesh, but a rank here drives one
    device, and a rank outside the mesh would have nothing to run."""
    from torch.distributed.device_mesh import init_device_mesh

    local = local_process_count()
    if particle_shards > local:
        raise ValueError(
            f"particle_shards={particle_shards} exceeds the {local} "
            "processes of one host: particle collectives would cross hosts")
    if local % particle_shards:
        raise ValueError(f"particle_shards={particle_shards} does not "
                         f"divide the {local} processes of one host")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(
        device_type, (process_count() // particle_shards, particle_shards),
        mesh_dim_names=(episode_axis, particle_axis))


def process_episode_slice(total_episodes: int) -> Tuple[int, int]:
    """(start, count) of this process's episode block: contiguous equal
    blocks (the total must divide evenly)."""
    n_proc = process_count()
    if total_episodes % n_proc:
        raise ValueError(
            f"{total_episodes} episodes do not divide over {n_proc} "
            "processes")
    per = total_episodes // n_proc
    return process_index() * per, per


def global_episode_array(local_values, mesh=None,
                         episode_axis: str = "episode", device=None):
    """This process's episode block as a tensor on `device` (default the
    card): the port holds a global [total_episodes, ...] array as one
    block a rank, the counterpart of the JAX package's P(episode)-sharded
    array; all_processes_value assembles it."""
    return torch.as_tensor(local_values,
                           device=device if device is not None else "cuda")


def all_processes_value(x, group=None):
    """Every rank's block of `x` (a tensor, or a dataclass of tensors such
    as a state or an output) concatenated along the leading episode axis,
    on every rank, as numpy: the only cross-host collective of a sweep.
    One process: the block itself."""
    def fetch(t):
        if isinstance(t, torch.Generator):
            return t
        if dist.is_initialized() and dist.get_world_size(group) > 1:
            t = _dist._gather_dim(t, group, 0)
        return t.detach().cpu().numpy()

    return compiled.tree_map(fetch, x)


def _global_tick(state, x: dict, consts: dict, m: MazeMap,
                 cfg: FilterConfig, start: int, total: int):
    """One tick of this rank's episodes [start, start + E_local) on its
    rows of the whole sweep's draws: draw_tick for all `total` episodes
    from the state's generator (the same on every rank), narrowed."""
    e_loc = state.particles.shape[0]
    draws = mcl.draw_tick(state.gen, m, state.particles.shape[-2], cfg,
                          (total,))
    draws = compiled.tree_map(lambda v: v.narrow(0, start, e_loc), draws)
    return mcl._tick(state, dict(x, draws=draws), consts, m, cfg, None)


def run_multihost_episode_batch(
    seed: int, m: MazeMap, cfg: FilterConfig, local_encoders,
    local_scan_ranges, scan_angles, mesh=None, episode_axis: str = "episode",
    state: Optional[mcl.MCLState] = None, draws=None,
):
    """Episode sweep with per-process inputs (multihost.py:166-212 of the
    JAX package): each process passes ONLY its own episode block
    ([E_local, T, ...], from process_episode_slice) and runs it on its
    device; `seed` must be the same on every process.  Each rank draws
    the whole sweep's random numbers (init_state and draw_tick over all
    E_local * process_count() episodes, from one generator seeded with
    `seed`) and keeps its own rows, so every episode starts and runs as
    in episodes.run_episode_batch(seed, ...) over the whole sweep, on any
    number of processes.  The draws are made on the device inside the
    captured tick: no host call an episode.  `state` and `draws` (one
    TickDraws [E_local, ...] a tick) replace them, for replaying another
    implementation's draws.  `mesh` is accepted for the JAX package's
    signature; the sweep needs no collective.  Returns this process's
    (final states, outputs), its own tensors; all_processes_value gathers
    them."""
    dev = m.device
    enc, ranges, angles = (
        torch.as_tensor(v, dtype=torch.float32, device=dev)
        for v in (local_encoders, local_scan_ranges, scan_angles))
    e_loc, t_n = enc.shape[0], ranges.shape[1]
    total = e_loc * process_count()
    start = process_index() * e_loc
    if state is None:
        whole = mcl.init_state(m, cfg, seed, batch=total)
        state = compiled.tree_map(
            lambda v: v if isinstance(v, torch.Generator)
            else v.narrow(0, start, e_loc).clone(), whole)
    if draws is not None:
        return mcl.run_episode(state, enc, ranges, angles, m, cfg,
                               draws=draws)
    xs = dict(encoders=enc, ranges=ranges,
              mask=torch.ones(ranges.shape, dtype=torch.bool, device=dev))
    consts = dict(angles=angles)
    carry = [state]

    def chunk(t0: int, n: int):
        part = compiled.tree_map(lambda v: v.narrow(1, t0, n), xs)
        graph = compiled.cached(None, _global_tick, carry[0], part, consts,
                                1, m=m, cfg=cfg, start=start, total=total)
        carry[0], ys = graph(carry[0], part, consts)
        return ys

    outs = compiled.run_chunked(chunk, t_n, 1)
    return compiled.detach_state(carry[0]), outs
