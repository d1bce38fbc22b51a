"""Multi-process dry run of the sharded filter on CPU processes.

The port's counterpart of the JAX package's
`__graft_entry__.dryrun_multichip(n)` (MULTICHIP_r05.json): n gloo ranks
on the CPU, each a process of this module, run three steps on tiny shapes
that still reach every code path, and rank 0 prints one "OK" line a step:

1. the default-config episode x particle step (make_sharded_step_batched)
   on a 2 x n/2 mesh (1 x n when n is odd or below 4), 64 particles a
   particle shard, two episodes an episode shard;
2. the production configuration (the ESS gate at 0.5, one round of
   refinement) through the same mesh;
3. particle-sharded SLAM, 32 particles over all n ranks, its ring
   exchange carrying (pose, score, map) rows (ESS threshold 1.1, so the
   resample runs).

Usage: python -m montecarlolocalisation_tpu_torch.tools.dryrun_multichip
[--devices N]   (default 4; exits non-zero if a rank fails)
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ANGLES = np.deg2rad(np.linspace(-118.0, 118.0, 8)).astype(np.float32)
SLAM_PARTICLES = 32


def run(n_devices: int, device: str = "cpu") -> list:
    """The three steps on this rank of an initialized n-rank world;
    returns the OK lines (every rank returns them, rank 0 prints)."""
    import torch.distributed as dist

    from ..config import (
        FilterConfig, MappingConfig, RefineConfig, ResampleConfig,
        SensorModelConfig, SLAMConfig,
    )
    from ..maps import from_map_file
    from ..presets import DEFAULT_MAP
    from ..models import sensor, slam
    from ..parallel import distributed as sd

    if dist.get_world_size() != n_devices:
        raise ValueError(f"the world has {dist.get_world_size()} ranks, "
                         f"not {n_devices}")
    if n_devices >= 4 and n_devices % 2 == 0:
        n_ep, n_part = 2, n_devices // 2
    else:
        n_ep, n_part = 1, n_devices
    mesh = sd.make_mesh(n_part, n_ep)
    maze = from_map_file(DEFAULT_MAP, device=device)
    cfg = FilterConfig(num_particles=64 * n_part,
                       sensor=SensorModelConfig(ray_mode="fixed"))
    n_episodes = 2 * n_ep
    e_loc = n_episodes // n_ep
    angles = torch.as_tensor(ANGLES, device=device)
    scan = sensor.Scan(
        angles=angles,
        ranges=torch.full((e_loc, len(ANGLES)), 0.7, device=device),
        mask=torch.ones(len(ANGLES), dtype=torch.bool, device=device))
    enc = torch.full((e_loc,), 0.5, device=device)
    state = sd.shard_state(sd.init_batched_state(0, maze, cfg, n_episodes),
                           mesh, episode_axis="episode")
    step = sd.make_sharded_step_batched(mesh, maze, cfg)
    state, _ = step(state, enc, enc, scan)
    whole = sd.gather_state(state, mesh, episode_axis="episode")
    if tuple(whole.particles.shape) != (n_episodes, cfg.num_particles, 3):
        raise AssertionError(f"state {tuple(whole.particles.shape)}")
    if not bool(torch.isfinite(whole.particles).all()):
        raise AssertionError("non-finite particles")
    lines = [f"dryrun_multichip OK: mesh=({n_ep}x{n_part}), "
             f"episodes={n_episodes}, particles={cfg.num_particles}"]

    cfg_prod = FilterConfig(
        num_particles=cfg.num_particles,
        sensor=SensorModelConfig(ray_mode="fixed"),
        refine=RefineConfig(iters=1),
        resample=ResampleConfig(ess_threshold=0.5))
    step_prod = sd.make_sharded_step_batched(mesh, maze, cfg_prod)
    state2, _ = step_prod(state, enc, enc, scan)
    whole = sd.gather_state(state2, mesh, episode_axis="episode")
    if not bool(torch.isfinite(whole.particles).all()):
        raise AssertionError("non-finite particles (production)")
    lines.append(f"dryrun_multichip OK (production: ess=0.5, refine=1): "
                 f"mesh=({n_ep}x{n_part})")

    slam_mesh = sd.make_mesh(n_devices)
    scfg = SLAMConfig(
        num_particles=SLAM_PARTICLES,
        mapping=MappingConfig(height=maze.height, width=maze.width,
                              resolution=float(maze.resolution),
                              origin_x=float(maze.origin_x),
                              origin_y=float(maze.origin_y)),
        sensor=SensorModelConfig(ray_mode="fixed"),
        keyframe_trans=0.10, keyframe_rot=0.35, ess_threshold=1.1)
    sstate = sd.shard_slam_state(
        slam.init_slam(3, (1.25, 1.25, 0.0), scfg, device=device),
        slam_mesh)
    sstep = sd.make_sharded_slam_step(slam_mesh, scfg)
    s2, info = sstep(sstate, 0.4, 0.42,
                     torch.full((len(ANGLES),), 0.6, device=device), angles,
                     torch.ones(len(ANGLES), device=device))
    whole = sd.gather_state(s2, slam_mesh)
    if tuple(whole.logodds.shape) != (SLAM_PARTICLES, maze.height,
                                      maze.width):
        raise AssertionError(f"maps {tuple(whole.logodds.shape)}")
    if not (bool(torch.isfinite(whole.poses).all())
            and bool(info["resampled"])):
        raise AssertionError("sharded SLAM: non-finite or not resampled")
    lines.append(f"dryrun_multichip OK (sharded SLAM: P={SLAM_PARTICLES} "
                 f"over {n_devices} shards, ring map exchange)")
    return lines


def _rank_main(rank: int, world: int, rdzv: str) -> None:
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{rdzv}",
                            rank=rank, world_size=world)
    try:
        lines = run(world, "cpu")
        if rank == 0:
            print("\n".join(lines), flush=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=4)
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--rdzv", default=None, help=argparse.SUPPRESS)
    a = p.parse_args(argv)
    if a.rank is not None:
        _rank_main(a.rank, a.devices, a.rdzv)
        return 0
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join(
                   [root] + [v for v in [os.environ.get("PYTHONPATH")] if v]))
    with tempfile.TemporaryDirectory() as tmp:
        rdzv = os.path.join(tmp, "rdzv")
        procs = [subprocess.Popen(
            [sys.executable, "-m", __spec__.name, "--devices",
             str(a.devices), "--rank", str(r), "--rdzv", rdzv], env=env)
            for r in range(a.devices)]
        try:
            rcs = [pr.wait(timeout=600) for pr in procs]
        finally:
            for pr in procs:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
    return max(abs(rc) for rc in rcs)


if __name__ == "__main__":
    sys.exit(main())
