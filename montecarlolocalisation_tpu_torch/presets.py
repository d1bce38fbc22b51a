"""World construction and the sweep preset (the JAX package's
presets.make_world and run_sweep, presets.py:46-72 and :151-172)."""
from __future__ import annotations

import dataclasses
import os.path as osp

import numpy as np
import torch

from .config import (
    FilterConfig, RefineConfig, ResampleConfig, SensorModelConfig,
)
from .maps import MazeMap, from_map_file

# The default maze ships with the JAX package; read by path, not imported.
DEFAULT_MAP = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "montecarlolocalisation_tpu", "maps",
                       "default_map.txt")


@dataclasses.dataclass
class World:
    maze: MazeMap
    walls: torch.Tensor
    cfg: FilterConfig
    angles: np.ndarray


def make_world(map_path: str = DEFAULT_MAP, num_particles: int = 1500,
               num_beams: int = 24, ray_mode: str = "fixed",
               resample_method: str = "multinomial",
               refine_iters: int = 0, ess_threshold=None,
               device="cuda") -> World:
    """World from a reference map.txt wall list: the maze on `device`, the
    filter config and an evenly spread beam table over +-118 degrees.
    refine_iters > 0 turns on gradient refinement (models/refine) and
    ess_threshold the ESS-gated resampling schedule
    (resample.ess_gated_resample); both are off by default, as in the JAX
    package's make_world (presets.py:46-72)."""
    maze = from_map_file(map_path, device=device)
    cfg = FilterConfig(num_particles=num_particles,
                       sensor=SensorModelConfig(ray_mode=ray_mode),
                       refine=RefineConfig(iters=refine_iters),
                       resample=ResampleConfig(method=resample_method,
                                               ess_threshold=ess_threshold))
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, num_beams)).astype(np.float32)
    return World(maze=maze, walls=maze.walls, cfg=cfg, angles=angles)


def run_sweep(world: World, batch: int = 64, num_ticks: int = 150,
              seed: int = 0, tick_chunk=None) -> dict:
    """Multi-episode localization sweep: `batch` wander episodes from
    (2.05, 2.05, 0), the filter over all of them as one batch, and the
    alias-aware convergence metrics of the final tick (floats).  The
    simulation and the filter draw from two seeds derived from `seed`;
    `tick_chunk` changes nothing (parallel.episodes.run_episode_batch)."""
    from .maps import symmetry
    from .parallel import episodes

    sim_seed, filter_seed = (int(v) for v in
                             np.random.SeedSequence(seed).generate_state(2))
    gen = torch.Generator(device=world.maze.device)
    gen.manual_seed(sim_seed)
    enc, scans, truth = episodes.simulate_episode_batch(
        gen, world.maze, world.cfg, world.angles, num_ticks, batch,
        start_pose=(2.05, 2.05, 0.0))
    final, _ = episodes.run_episode_batch(
        filter_seed, world.maze, world.cfg, enc, scans, world.angles,
        tick_chunk=tick_chunk)
    sym = symmetry.maze_symmetries(world.maze.walls.cpu().numpy(),
                                   float(world.maze.cell_meters))
    return episodes.sweep_rmse(final, truth, sym=sym)
