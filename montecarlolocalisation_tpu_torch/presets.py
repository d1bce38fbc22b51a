"""World construction and the presets of the JAX package's CLI
(presets.py:46-172): `localisation` (wander, then the filter), `planning`
(a BFS plan driven closed-loop), `challenge` (the gold/pickup TSP mission
driven closed-loop), `moving` (the wanderer alone) and `sweep` (a batch of
episodes)."""
from __future__ import annotations

import dataclasses
import os.path as osp

import numpy as np
import torch

from .config import (
    FilterConfig, RefineConfig, ResampleConfig, SensorModelConfig,
)
from .maps import MazeMap, from_map_file

# The port's copies of the JAX package's maze data (byte-equal; the gold
# and pickup files are the challenge preset's).
_MAPS = osp.join(osp.dirname(osp.abspath(__file__)), "maps")
DEFAULT_MAP = osp.join(_MAPS, "default_map.txt")
DEFAULT_GOLD = osp.join(_MAPS, "default_gold.txt")
DEFAULT_PICKUP = osp.join(_MAPS, "default_pickup.txt")


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
    """World from a map file on `device`: a reference map.txt wall list,
    or a ROS map_server YAML (+ PGM) through maps.pgm.from_pgm, whose cell
    layer is the synthesized wall tensor; the filter config and an evenly
    spread beam table over +-118 degrees.  refine_iters > 0 turns on
    gradient refinement (models/refine) and ess_threshold the ESS-gated
    resampling schedule (resample.ess_gated_resample); both are off by
    default, as in the JAX package's make_world (presets.py:46-72)."""
    if map_path.endswith((".yaml", ".yml")):
        from .maps.pgm import from_pgm

        maze = from_pgm(map_path, device=device)
    else:
        maze = from_map_file(map_path, device=device)
    cfg = FilterConfig(num_particles=num_particles,
                       sensor=SensorModelConfig(ray_mode=ray_mode),
                       refine=RefineConfig(iters=refine_iters),
                       resample=ResampleConfig(method=resample_method,
                                               ess_threshold=ess_threshold))
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, num_beams)).astype(np.float32)
    return World(maze=maze, walls=maze.walls, cfg=cfg, angles=angles)


def _seeds(seed: int):
    """The simulation's and the filter's seeds, derived from `seed`."""
    return (int(v) for v in np.random.SeedSequence(seed).generate_state(2))


def run_localisation(world: World, seed: int = 0, num_ticks: int = 200,
                     start=(2.05, 2.05, 0.0)):
    """Wander, then localize globally (presets.py:75-88 of the JAX
    package): returns (final state, outputs, true poses [T, 3])."""
    from .models import filter as mcl
    from .sim import robot

    sim_seed, filter_seed = _seeds(seed)
    gen = torch.Generator(device=world.maze.device)
    gen.manual_seed(sim_seed)
    enc, scans, truth = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, num_ticks,
        start_pose=start)
    state = mcl.init_state(world.maze, world.cfg, filter_seed)
    final, outs = mcl.run_episode(state, enc[0], scans[0], world.angles,
                                  world.maze, world.cfg)
    return final, outs, truth[0]


def _drive(world: World, cells, seed: int, num_ticks: int):
    """The closed loop along a cell path from its first cell's centre,
    heading 0.  The reference executor skips the first plan cell (the
    robot already stands there, moveToPosition_server.cpp:578); otherwise
    a cold-start robot must wander BACK to its origin before making
    progress.  Returns (final ClosedLoopState, outputs [T, ...])."""
    from .sim import closed_loop

    wps = closed_loop.mission_waypoints(cells)
    sx, sy = wps[0]
    drive_wps = wps[1:] if len(wps) > 1 else wps
    return closed_loop.run_closed_loop(
        world.maze, world.cfg, drive_wps, num_ticks, world.angles,
        start_pose=(float(sx), float(sy), 0.0), seed=seed)


def run_planning(world: World, start_cell=(2, 2), goal_cell=(4, 4),
                 seed: int = 0, num_ticks: int = 800):
    """BFS plan + closed-loop waypoint following under MCL
    (presets.py:89-106 of the JAX package): returns (path, final state,
    outputs)."""
    from .planning import bfs

    path = bfs.bfs_path(world.walls, start_cell, goal_cell)
    final, outs = _drive(world, path, seed, num_ticks)
    return path, final, outs


def run_challenge(world: World, start_cell=(5, 0),
                  gold_path: str = DEFAULT_GOLD,
                  pickup_path: str = DEFAULT_PICKUP,
                  seed: int = 0, num_ticks: int = 2000):
    """Gold/pickup TSP mission closed-loop (executeChallenge.cpp;
    presets.py:109-133 of the JAX package): returns (mission plan, final
    state, outputs), the last two None when there is nothing to drive."""
    from .planning import mission

    gold = mission.load_waypoints(gold_path)
    pickup = mission.load_waypoints(pickup_path)
    plan = mission.plan_mission(world.walls, start_cell, gold, pickup)
    if not plan.legs or not plan.legs[0].path:
        # Empty waypoint files or unreachable first goal: nothing to drive.
        return plan, None, None
    cells = [plan.legs[0].path[0]]
    for leg in plan.legs:
        cells.extend(leg.path[1:])
    final, outs = _drive(world, cells, seed, num_ticks)
    return plan, final, outs


def run_moving(world: World, seed: int = 0, num_ticks: int = 300,
               start=(2.05, 2.05, 0.0)) -> dict:
    """The wanderer alone, no filter (launch/moving.launch;
    presets.py:136-148 of the JAX package): ticks, the distance driven and
    the final pose."""
    from .sim import robot

    gen = torch.Generator(device=world.maze.device)
    gen.manual_seed(seed)
    _, _, truth = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, num_ticks,
        start_pose=start)
    tp = truth[0].cpu().numpy()
    dist = float(np.sum(np.hypot(np.diff(tp[:, 0]), np.diff(tp[:, 1]))))
    return dict(ticks=num_ticks, distance_m=round(dist, 3),
                final_pose=[round(float(v), 3) for v in tp[-1]])


def run_sweep(world: World, batch: int = 64, num_ticks: int = 150,
              seed: int = 0, tick_chunk=None) -> dict:
    """Multi-episode localization sweep: `batch` wander episodes from
    (2.05, 2.05, 0), the filter over all of them as one batch, and the
    alias-aware convergence metrics of the final tick (floats).  The
    simulation and the filter draw from two seeds derived from `seed`;
    `tick_chunk` changes nothing (parallel.episodes.run_episode_batch)."""
    from .maps import symmetry
    from .parallel import episodes

    sim_seed, filter_seed = _seeds(seed)
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
