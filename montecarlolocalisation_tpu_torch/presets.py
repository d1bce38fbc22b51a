"""World construction and the presets of the JAX package's CLI
(presets.py:46-606): `localisation` (wander, then the filter), `planning`
(a BFS plan driven closed-loop), `challenge` (the gold/pickup TSP mission
driven closed-loop), `moving` (the wanderer alone), `sweep` (a batch of
episodes), `mapping` (wanderers map the maze, then the filter localizes
on the learned map) and `slam` (RBPF SLAM from encoders and scans, then
relocalization, tracking and optionally the mission on the learned
map)."""
from __future__ import annotations

import dataclasses
import os.path as osp

import numpy as np
import torch

from .config import (
    FilterConfig, MappingConfig, RefineConfig, ResampleConfig, SLAMConfig,
    SensorModelConfig,
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


def _mapping_config(m: MazeMap) -> MappingConfig:
    """The mapper's grid: the maze's raster geometry."""
    return MappingConfig(height=m.height, width=m.width,
                         resolution=float(m.resolution),
                         origin_x=float(m.origin_x),
                         origin_y=float(m.origin_y))


def _gen(seed: int, device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return gen


def run_mapping(world: World, seed: int = 0, num_ticks: int = 600,
                robots: int = 8, relocalize: bool = True,
                pose_source: str = "true", slip_noise: float = 0.0,
                export=None) -> dict:
    """Explore, map, then localize on the learned map (presets.py:175-249
    of the JAX package): `robots` wanderers from spread-out starts map the
    maze from their true poses ("true") or dead-reckoned encoders
    ("odom", with `slip_noise`), their maps fuse by log-odds addition and
    snap onto the cell lattice (fit_walls), and fresh episodes sensing the
    true maze relocalize on the learned one.  Returns the wall metrics,
    the explored share and the reloc metrics; `export` writes the learned
    map as a map_server PGM + YAML."""
    from .models import mapping
    from .sim import robot

    if pose_source not in ("true", "odom"):
        raise ValueError(f"unknown pose_source {pose_source!r}")
    m = world.maze
    dev = m.device
    mc = _mapping_config(m)
    # Spread starts over the cell lattice (cell centres, row-major stride).
    cells = [(r, c) for r in range(m.n_rows) for c in range(m.n_cols)]
    stride = max(1, len(cells) // max(robots, 1))
    starts = [(c * m.cell_meters + m.cell_meters / 2 + 0.05,
               r * m.cell_meters + m.cell_meters / 2 + 0.05, 0.8 * i)
              for i, (r, c) in enumerate(cells[::stride][:robots])]
    lo = None
    for i, sp in enumerate(starts):
        sim_seed = int(np.random.SeedSequence((seed, i)).generate_state(1)[0])
        enc, scans, poses = robot.generate_wander_episode(
            _gen(sim_seed, dev), m, world.cfg, world.angles, num_ticks,
            start_pose=sp, slip_noise=slip_noise, explore=True)
        if pose_source == "odom":
            poses = mapping.dead_reckon_poses(enc[0], sp, world.cfg.motion)[
                None]
        ep = mapping.map_episode(poses, scans, world.angles, mc,
                                 world.cfg.sensor)[0]
        lo = ep if lo is None else lo + ep
    lo = lo.cpu().numpy()
    cell_px = int(round(m.cell_meters / m.resolution))
    learned_walls = mapping.fit_walls(lo, cell_px=cell_px)
    out = dict(robots=len(starts), ticks_per_robot=num_ticks,
               explored_frac=float(np.mean(np.abs(lo) > 0.5)),
               **mapping.wall_metrics(learned_walls, m.walls))
    if export:
        base = export[:-5] if export.endswith(".yaml") else export
        mapping.export_learned_map(lo, mc, base + ".pgm", base + ".yaml")
        out["exported"] = base + ".yaml"
    if relocalize:
        out.update(_relocalize_on(
            _maze_from_wall_tensor(learned_walls, dev), m, world,
            max(num_ticks, 200), seed + 1000,
            explored_px=np.abs(lo) > 0.5,
            known_maze=_maze_from_wall_tensor(mapping.fit_walls(
                lo, cell_px=cell_px, unexplored_is_wall=False), dev)))
    return out


def _maze_from_wall_tensor(learned_walls, device="cuda") -> MazeMap:
    """A fitted [R, C, 4] wall tensor -> a MazeMap (a clean lattice
    raster) on `device`."""
    from .maps import from_walls

    w = np.asarray(learned_walls, bool)
    lists = [[[e for e in range(4) if w[r, c, e]] for c in range(w.shape[1])]
             for r in range(w.shape[0])]
    return from_walls(lists, device=device)


def _coverage(truth: np.ndarray, m: MazeMap, explored_px) -> np.ndarray:
    """[E, T] bool: whether each true pose lies on an explored pixel."""
    ex = np.asarray(explored_px, bool)
    rows = np.clip((truth[..., 1] - float(m.origin_y)) / float(m.resolution),
                   0, ex.shape[0] - 1).astype(int)
    cols = np.clip((truth[..., 0] - float(m.origin_x)) / float(m.resolution),
                   0, ex.shape[1] - 1).astype(int)
    return ex[rows, cols]


def _relocalize_on(learned_maze: MazeMap, true_maze: MazeMap, world: World,
                   num_ticks: int, seed: int, batch: int = 8,
                   start_pose=(2.05, 2.05, 0.0), explored_px=None,
                   coverage_thresh: float = 0.8, known_maze=None,
                   replicas: int = 8) -> dict:
    """A sweep of fresh episodes that sense the true maze and localize
    globally on the learned one (presets.py:262-333 of the JAX package),
    `replicas` evidence-raced filters an episode
    (parallel/episodes.run_episode_replicas).  With `explored_px`, also
    the share among the episodes whose true path stayed on explored
    pixels for coverage_thresh of its ticks.  The metrics are computed on
    host copies after the run."""
    from .parallel import episodes

    sim_seed, filter_seed = _seeds(seed)
    enc, scans, truth = episodes.simulate_episode_batch(
        _gen(sim_seed, true_maze.device), true_maze, world.cfg, world.angles,
        num_ticks, batch, start_pose=start_pose)
    if replicas > 1:
        final, _, _ = episodes.run_episode_replicas(
            filter_seed, learned_maze, world.cfg, enc, scans, world.angles,
            replicas=replicas, known_map=known_maze)
    else:
        final, _ = episodes.run_episode_batch(
            filter_seed, learned_maze, world.cfg, enc, scans, world.angles,
            known_map=known_maze)
    best = final.best_pose.cpu().numpy()
    tpa = truth.cpu().numpy()                           # [E, T, 3]
    tp = tpa[:, -1, :]
    conf = best[:, 0] >= 0
    err = np.hypot(best[:, 0] - tp[:, 0], best[:, 1] - tp[:, 1])
    hit = conf & (err < 0.4)
    out = dict(
        reloc_converged_frac=float(np.mean(hit)),
        reloc_median_error_m=round(
            float(np.median(err[hit])) if hit.any() else float("nan"), 4))
    if explored_px is not None:
        covered = _coverage(tpa, true_maze, explored_px).mean(
            axis=1) >= coverage_thresh
        out.update(
            reloc_in_coverage_n=int(covered.sum()),
            reloc_in_coverage_frac=round(
                float(np.mean(hit[covered])) if covered.any()
                else float("nan"), 4))
    return out


def _track_on(learned_maze: MazeMap, true_maze: MazeMap, world: World,
              num_ticks: int, seed: int, batch: int = 8,
              start_pose=(1.25, 1.25, 0.0), known_maze=None,
              explored_px=None, coverage_thresh: float = 0.8) -> dict:
    """Pose tracking on a learned map from a known start
    (presets.py:336-420 of the JAX package): fresh wander episodes sense
    the true maze, each filter starts as a tight cloud at the start pose
    (init_tracking_state) on the learned map.  The share still within
    0.4 m at the end, the median final error and, with `explored_px`,
    the coverage-aware shares, the last scored at the end of each
    episode's first stretch on explored pixels."""
    from .models import filter as mcl
    from .parallel import episodes

    sim_seed, filter_seed = _seeds(seed)
    enc, scans, truth = episodes.simulate_episode_batch(
        _gen(sim_seed, true_maze.device), true_maze, world.cfg, world.angles,
        num_ticks, batch, start_pose=start_pose)
    state = mcl.init_tracking_state(learned_maze, world.cfg, start_pose,
                                    filter_seed, batch=batch)
    final, outs = mcl.run_episode(state, enc, scans, world.angles,
                                  learned_maze, world.cfg,
                                  known_map=known_maze)
    best = final.best_pose.cpu().numpy()
    tpa = truth.cpu().numpy()                           # [E, T, 3]
    tp = tpa[:, -1, :]
    err = np.hypot(best[:, 0] - tp[:, 0], best[:, 1] - tp[:, 1])
    ok = (best[:, 0] >= 0) & (err < 0.4)
    out = dict(track_on_learned_frac=float(np.mean(ok)),
               track_median_error_m=round(float(np.median(err)), 4))
    if explored_px is not None:
        in_cov = _coverage(tpa, true_maze, explored_px)   # [E, T]
        covered = in_cov.mean(axis=1) >= coverage_thresh
        out.update(
            track_in_coverage_n=int(covered.sum()),
            track_in_coverage_frac=round(
                float(np.mean(ok[covered])) if covered.any()
                else float("nan"), 4))
        # exact_pose[t] is published before tick t's update: the estimate
        # after tick t is exact_pose[t + 1], and the final best pose closes
        # the last slot.
        bp = outs.exact_pose.cpu().numpy()                # [E, T, 3]
        post = np.concatenate([bp[:, 1:], best[:, None, :]], axis=1)
        exits = ~in_cov
        t_edge = np.where(exits.any(axis=1),
                          np.maximum(np.argmax(exits, axis=1) - 1, 0),
                          in_cov.shape[1] - 1)
        has = in_cov[:, 0]
        be = post[np.arange(batch), t_edge]
        te = tpa[np.arange(batch), t_edge]
        err_e = np.hypot(be[:, 0] - te[:, 0], be[:, 1] - te[:, 1])
        ok_e = has & (be[:, 0] >= 0) & (err_e < 0.4)
        out["track_to_coverage_edge_frac"] = round(
            float(np.mean(ok_e[has])) if has.any() else float("nan"), 4)
    return out


def run_slam(world: World, seed: int = 0, num_ticks: int = 600,
             num_particles: int = 128, slip_noise: float = 0.03,
             relocalize: bool = True, mission: bool = False,
             mission_ticks: int = 2000, gold_path: str = DEFAULT_GOLD,
             pickup_path: str = DEFAULT_PICKUP, export=None,
             explore_mode: str = "wander", proposal_candidates: int = 1,
             keyframe=(0.15, 0.5), replicas: int = 4) -> dict:
    """The SLAM loop (presets.py:423-606 of the JAX package): a wander
    with wheel slip (the encoders lie) and RBPF SLAM over it (`replicas`
    evidence-raced replicas, models/slam.run_slam_replicas), or with
    explore_mode "frontier" or "hybrid" the closed-loop explorer of
    sim/frontier (phases of 120 ticks, `replicas` unused), then the best
    particle's map snapped onto the cell lattice, then relocalization and
    tracking sweeps on the learned map and, with `mission`, the gold /
    pickup TSP mission planned on the learned map and driven closed-loop
    while the LIDAR senses the true maze.  `keyframe` (trans, rot) gates
    the map updates; None updates every tick.  Every metric is computed
    on host copies after the runs."""
    from .models import mapping, slam
    from .sim import frontier, robot

    if explore_mode not in ("wander", "frontier", "hybrid"):
        raise ValueError(f"unknown explore_mode {explore_mode!r}")
    m = world.maze
    dev = m.device
    mc = _mapping_config(m)
    kf_t, kf_r = keyframe if keyframe is not None else (0.0, 0.0)
    scfg = SLAMConfig(num_particles=num_particles, mapping=mc,
                      sensor=world.cfg.sensor, motion=world.cfg.motion,
                      proposal_candidates=proposal_candidates,
                      keyframe_trans=kf_t, keyframe_rot=kf_r)
    start = (1.25, 1.25, 0.0)
    if explore_mode == "wander":
        sim_seed, slam_seed = _seeds(seed)
        enc, scans, truth = robot.generate_wander_episode(
            _gen(sim_seed, dev), m, world.cfg, world.angles, num_ticks,
            start_pose=start, slip_noise=slip_noise, explore=True)
        enc, scans = enc[0], scans[0]
        if replicas > 1:
            final, est, _ = slam.run_slam_replicas(
                slam_seed, enc, scans, world.angles, scfg, start,
                replicas=replicas)
        else:
            final, est = slam.run_slam_episode(slam_seed, enc, scans,
                                               world.angles, scfg, start)
        dr = mapping.dead_reckon_poses(enc, start, world.cfg.motion)
        tn, est, dr = (v.cpu().numpy() for v in (truth[0], est, dr))
    else:
        # Closed-loop exploration steered by the SLAM posterior
        # (sim/frontier), in phases of 120 ticks; it runs no dead
        # reckoning to compare with.
        phase_ticks = 120
        fst, finfo = frontier.run_frontier_slam(
            seed, m, scfg, world.angles, start_pose=start,
            phases=max(num_ticks // phase_ticks, 1),
            phase_ticks=phase_ticks, slip_noise=slip_noise,
            policy=explore_mode, static_map=True)
        final = fst.slam
        tn, est, dr = finfo["truth"], finfo["est"], None
        num_ticks = len(tn)
    lo = slam.best_map(final).cpu().numpy()
    tail = max(num_ticks // 4, 1)   # the final stretch's mean error
    slam_err = float(np.hypot(est[:, 0] - tn[:, 0],
                              est[:, 1] - tn[:, 1])[-tail:].mean())
    cell_px = int(round(m.cell_meters / m.resolution))
    learned_walls, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                            return_explored=True)
    truth_walls = m.walls.cpu().numpy()
    # Quality over the explored edges, apart from coverage.
    expl = mapping.wall_metrics(learned_walls, truth_walls, mask=seen)
    out = dict(particles=num_particles, ticks=num_ticks,
               slip_noise=slip_noise, explore_mode=explore_mode,
               slam_final_err_m=round(slam_err, 4),
               explored_edge_frac=round(float(np.mean(seen)), 4),
               **{k + "_explored": v for k, v in expl.items()},
               **mapping.wall_metrics(learned_walls, truth_walls))
    if dr is not None:
        out["dead_reckon_final_err_m"] = round(float(np.hypot(
            dr[:, 0] - tn[:, 0], dr[:, 1] - tn[:, 1])[-tail:].mean()), 4)
    if export:
        base = export[:-5] if export.endswith(".yaml") else export
        mapping.export_learned_map(lo, mc, base + ".pgm", base + ".yaml")
        out["exported"] = base + ".yaml"
    out.update(_on_learned_map(lo, world, num_ticks, seed, relocalize,
                               mission, mission_ticks, gold_path,
                               pickup_path, start))
    return out


def _on_learned_map(lo, world: World, num_ticks: int, seed: int,
                    relocalize: bool = True, mission: bool = False,
                    mission_ticks: int = 2000, gold_path: str = DEFAULT_GOLD,
                    pickup_path: str = DEFAULT_PICKUP,
                    start=(1.25, 1.25, 0.0)) -> dict:
    """run_slam's steps after mapping, on the learned log-odds `lo`
    [H, W] (host numpy) of a run of `num_ticks` ticks: the relocalization
    and tracking sweeps and, with `mission`, the mission, each sensing
    the true maze world.maze."""
    from .models import mapping

    m = world.maze
    dev = m.device
    cell_px = int(round(m.cell_meters / m.resolution))
    learned_walls = mapping.fit_walls(lo, cell_px=cell_px)
    learned_maze = _maze_from_wall_tensor(learned_walls, dev)
    # The conservative maze keeps hypotheses and routes out of unexplored
    # space; the known-walls-only fit lets the sensor model credit beams
    # that cross the exploration frontier (sensor.beam_weights_partial).
    known_maze = _maze_from_wall_tensor(mapping.fit_walls(
        lo, cell_px=cell_px, unexplored_is_wall=False), dev)
    out = {}
    if relocalize:
        ticks = min(max(num_ticks // 2, 150), 300)
        out.update(_relocalize_on(learned_maze, m, world, ticks, seed + 1000,
                                  start_pose=start,
                                  explored_px=np.abs(lo) > 0.5,
                                  known_maze=known_maze))
        out.update(_track_on(learned_maze, m, world, ticks, seed + 2000,
                             start_pose=start, known_maze=known_maze,
                             explored_px=np.abs(lo) > 0.5))
    if mission:
        out.update(_mission_on(learned_maze, learned_walls, world,
                               mission_ticks, seed + 2, gold_path,
                               pickup_path))
    return out


def _mission_on(learned_maze: MazeMap, learned_walls, world: World,
                num_ticks: int, seed: int, gold_path: str,
                pickup_path: str) -> dict:
    """The gold / pickup mission planned on the learned walls and driven
    closed-loop: the filter tracks on the learned maze from the plan's
    first cell (known_start) while the LIDAR senses the true maze."""
    from .planning import mission as mission_mod
    from .sim import closed_loop

    gold = mission_mod.load_waypoints(gold_path)
    pickup = mission_mod.load_waypoints(pickup_path)
    plan = mission_mod.plan_mission(np.asarray(learned_walls, np.uint8),
                                    (1, 1), gold, pickup)
    if not plan.legs or not plan.legs[0].path:
        return dict(mission_waypoints_reached=0, mission_waypoints_total=0,
                    mission_legs=[])
    cells = [plan.legs[0].path[0]]
    for leg in plan.legs:
        cells.extend(leg.path[1:])
    wps = closed_loop.mission_waypoints(cells)
    sx, sy = wps[0]
    drive_wps = wps[1:] if len(wps) > 1 else wps
    final, _ = closed_loop.run_closed_loop(
        learned_maze, world.cfg, drive_wps, num_ticks, world.angles,
        start_pose=(float(sx), float(sy), 0.0), known_start=True, seed=seed,
        sense_m=world.maze)
    return dict(mission_waypoints_reached=int(final.wp_idx),
                mission_waypoints_total=len(drive_wps),
                mission_legs=[list(leg.goal) for leg in plan.legs])


def run_calibrate(world: World, seed: int = 0, num_ticks: int = 200) -> dict:
    """Differentiable calibration (presets.py:609-640 of the JAX package):
    simulate a wander log with the true constants and 0.05 m range noise,
    fit (wheel_size, wheel_space) from guesses 15 % off (500 Adam epochs
    at 5e-3) and sigma from a guess 3 times off (400 at 5e-2), through
    models/calibrate; returns the true and fitted values and the motion
    fit's last loss, as floats."""
    from .models import calibrate
    from .sim import robot

    m = world.maze
    mcfg = world.cfg.motion
    start = (2.05, 2.05, 0.0)
    scan_noise = 0.05   # the log's true range noise, what the fit recovers
    enc, ranges, poses = robot.generate_wander_episode(
        _gen(seed, m.device), m, world.cfg, world.angles, num_ticks,
        start_pose=start, scan_noise=scan_noise)
    enc, ranges, poses = enc[0], ranges[0], poses[0]
    fit = calibrate.fit_motion_params(
        enc, poses, mcfg,
        init=dict(wheel_size=mcfg.wheel_size * 1.15,
                  wheel_space=mcfg.wheel_space * 0.85),
        steps=500, lr=5e-3, start_poses=start)
    sig = calibrate.fit_sensor_sigma(
        m, poses, ranges, world.angles, world.cfg.sensor,
        init_sigma=3.0 * scan_noise, steps=400, lr=5e-2)
    return dict(
        wheel_size_true=mcfg.wheel_size,
        wheel_size_fit=float(fit["wheel_size"]),
        wheel_space_true=mcfg.wheel_space,
        wheel_space_fit=float(fit["wheel_space"]),
        sigma_true=scan_noise,
        sigma_fit=float(sig["sigma"]),
        motion_loss=float(fit["loss"]),
    )
