"""SLAM quality sweep: the counterpart of the root tools/slam_sweep.py,
with its flags and output lines.

E wander episodes at each slip level, RBPF SLAM (models/slam) against
dead reckoning on the same encoder logs, and the map's quality at the
horizon.  Per (slip, config): the final-quarter mean position error of
each episode for SLAM and for dead reckoning, the episodes where SLAM
beats dead reckoning, and the explored-edge wall F1 of each episode's map
(--map-est: the best particle's, the weighted consensus, or one
re-rendered from the SLAM estimates).  The episodes run as one batch
(with --replicas K, one [E, K] state whose winner per episode has the
most log evidence) in CUDA graphs; --tick-chunk is accepted and changes
nothing.

  python -m montecarlolocalisation_tpu_torch.tools.slam_sweep \\
      --episodes 16 --ticks 1000 --particles 128 --slip 0.08 \\
      --keyframe-trans 0.15 --keyframe-rot 0.5 --replicas 4
"""
from __future__ import annotations

import argparse
import re
import time

import numpy as np
import torch

from . import sync, tool_device

START = (1.25, 1.25, 0.0)
WORLD = r"(rooms|maze)(\d+)x(\d+):(\d+)"     # --world STYLExRxC:SEED


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.slam_sweep")
    ap.add_argument("--episodes", type=int, default=16)
    ap.add_argument("--ticks", type=int, default=1000)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--particles", type=int, default=64)
    ap.add_argument("--slip", type=float, nargs="+", default=[0.03, 0.08])
    ap.add_argument("--candidates", type=int, default=1)
    ap.add_argument("--keyframe-trans", type=float, default=0.0)
    ap.add_argument("--keyframe-rot", type=float, default=0.0)
    ap.add_argument("--alpha-scale", type=float, default=None,
                    help="override SLAMConfig.alpha_scale")
    ap.add_argument("--l-free", type=float, default=None,
                    help="override MappingConfig.l_free (free-space carve "
                         "rate)")
    ap.add_argument("--clamp", type=float, default=None,
                    help="override MappingConfig.clamp (log-odds "
                         "saturation)")
    ap.add_argument("--closure", action="store_true",
                    help="consensus-anchored correlative correction on "
                         "keyframe ticks (models/slam.closure_correction)")
    ap.add_argument("--closure-margin", type=float, default=None)
    ap.add_argument("--closure-xy-range", type=float, default=None)
    ap.add_argument("--closure-theta-range", type=float, default=None)
    ap.add_argument("--offset-tol", type=int, default=None,
                    help="fit_walls offset_tol for the F1 scoring")
    ap.add_argument("--map-est", default="best",
                    choices=["best", "consensus", "rerender"],
                    help="map estimate scored by F1: the best particle's "
                         "grid, the importance-weighted mean grid, or a "
                         "map re-rendered from the SLAM estimates "
                         "(mapping.map_episode)")
    ap.add_argument("--ess-threshold", type=float, default=None,
                    help="override SLAMConfig.ess_threshold")
    ap.add_argument("--replicas", type=int, default=1,
                    help="K replicas per episode, the winner by "
                         "accumulated log evidence "
                         "(slam.run_slam_replicas)")
    ap.add_argument("--per-episode", action="store_true",
                    help="print per-episode (slam_err, dr_err, F1) rows")
    ap.add_argument("--tick-chunk", type=int, default=None,
                    help="accepted for the JAX tool's flags; changes "
                         "nothing")
    ap.add_argument("--world", default=None, metavar="STYLExRxC:SEED",
                    help="sweep a GENERATED world instead of the default "
                         "maze, e.g. 'rooms6x6:3' or 'maze10x10:7' "
                         "(maps/generator)")
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on")
    return ap


def sweep_world(args, dev):
    """(world, the maze swept): the default maze's world at --beams, and
    the generated --world on `dev` in its place where one is given."""
    from .. import presets
    from ..maps import from_walls, generator

    world = presets.make_world(num_beams=args.beams, device=dev)
    if not args.world:
        return world, world.maze
    mm = re.fullmatch(WORLD, args.world)
    gen = (generator.generate_rooms if mm.group(1) == "rooms"
           else generator.generate_maze)
    return world, from_walls(gen(int(mm.group(2)), int(mm.group(3)),
                                 seed=int(mm.group(4))), device=dev)


def slam_config(args, m, world):
    """The JAX tool's SLAMConfig from the flags, on the maze's grid."""
    from ..config import MappingConfig, SLAMConfig

    mkw = dict(height=m.height, width=m.width,
               resolution=float(m.resolution), origin_x=float(m.origin_x),
               origin_y=float(m.origin_y))
    if args.clamp is not None:
        mkw["clamp"] = args.clamp
    if args.l_free is not None:
        mkw["l_free"] = args.l_free
    kw = dict(num_particles=args.particles, mapping=MappingConfig(**mkw),
              sensor=world.cfg.sensor, motion=world.cfg.motion,
              proposal_candidates=args.candidates,
              keyframe_trans=args.keyframe_trans,
              keyframe_rot=args.keyframe_rot)
    if args.alpha_scale is not None:
        kw["alpha_scale"] = args.alpha_scale
    if args.ess_threshold is not None:
        kw["ess_threshold"] = args.ess_threshold
    if args.closure:
        kw["closure"] = True
        for name in ("closure_margin", "closure_xy_range",
                     "closure_theta_range"):
            v = getattr(args, name)
            if v is not None:
                kw[name] = v
    return SLAMConfig(**kw)


def episodes_at(slip: float, args, m, world):
    """The sweep's episodes at one slip level: episode ep wanders from
    START on the draws of a generator seeded seed0 + 7919 * ep + 13, as
    the JAX tool keys it; the episodes run as one batch (one robot's
    wander is launch-bound: 16 run one by one took 27 s of 1000 ticks on
    an H100).  Returns encoders [E, T, 2], scans [E, T, B], truth
    [E, T, 3] on the maze's device."""
    from ..models import compiled
    from ..sim import robot

    draws = []
    for ep in range(args.episodes):
        gen = torch.Generator(device=m.device)
        gen.manual_seed(args.seed0 + 7919 * ep + 13)
        draws.append(robot.draw_wander(gen, 1, args.ticks, len(world.angles),
                                       m.device, slip_noise=slip,
                                       explore=True))
    return robot.generate_wander_episode(
        None, m, world.cfg, world.angles, args.ticks, batch=args.episodes,
        start_pose=START, slip_noise=slip, explore=True,
        draws=compiled.tree_map(lambda *v: torch.cat(v), *draws))


def run_slam(args, cfg, world, enc, scans):
    """SLAM over the batch from one generator seeded seed0 + 100: (final
    state [E, ...], estimates [E, T, 3]); with --replicas the winners."""
    from ..models import slam

    seed = args.seed0 + 100
    if args.replicas > 1:
        final, est, _ = slam.run_slam_replicas(
            seed, enc, scans, world.angles, cfg, START,
            replicas=args.replicas, tick_chunk=args.tick_chunk)
        return final, est
    return slam.run_slam_episode(seed, enc, scans, world.angles, cfg, START)


def map_estimates(how: str, final, est, scans, world, mc) -> np.ndarray:
    """Each episode's map [E, H, W] on the host: the best-score
    particle's grid ("best"), the weight-averaged grid ("consensus",
    summed on the host as the JAX tool sums it), or the scans re-rendered
    from the estimates ("rerender")."""
    from ..models import mapping

    if how == "rerender":
        return mapping.map_episode(est, scans, world.angles, mc,
                                   world.cfg.sensor).cpu().numpy()
    lo = final.logodds.cpu().numpy()                  # [E, P, H, W]
    if how == "consensus":
        w = final.weights.cpu().numpy()
        return np.stack([np.einsum("p,phw->hw", w[ep], lo[ep])
                         for ep in range(lo.shape[0])])
    best = np.argmax(final.scores.cpu().numpy(), axis=-1)
    return lo[np.arange(lo.shape[0]), best]


def episode_scores(est, truth, encoders, maps, true_walls, motion_cfg,
                   cell_px: int, tail: int, offset_tol=None):
    """The JAX tool's per-episode scoring: the final `tail` ticks' mean
    position error of the SLAM estimates est [E, T, 3] and of dead
    reckoning from the encoders [E, T, 2] (mapping.dead_reckon_poses from
    START) against truth [E, T, 3], and the explored-edge F1 of each map
    [E, H, W] (fit_walls' seen mask) against the true walls.  Returns
    (slam_err [E], dr_err [E], f1 [E]) as numpy."""
    from ..models import mapping

    est = np.asarray(est)
    tr = np.asarray(truth)
    dr = mapping.dead_reckon_poses(
        torch.as_tensor(encoders, dtype=torch.float32), START,
        motion_cfg).cpu().numpy()
    slam_err = np.hypot(est[..., 0] - tr[..., 0],
                        est[..., 1] - tr[..., 1])[:, -tail:].mean(axis=1)
    dr_err = np.hypot(dr[..., 0] - tr[..., 0],
                      dr[..., 1] - tr[..., 1])[:, -tail:].mean(axis=1)
    fkw = {} if offset_tol is None else dict(offset_tol=offset_tol)
    f1s = []
    for lo in maps:
        walls, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                        return_explored=True, **fkw)
        f1s.append(mapping.wall_metrics(walls, true_walls, mask=seen)["f1"])
    return slam_err, dr_err, np.asarray(f1s)


def summary_line(slip: float, args, slam_err, dr_err, f1s, dt: float):
    """The JAX tool's line for one slip level."""
    beats = int((slam_err < dr_err).sum())
    return (f"slip={slip:.2f} world={args.world or 'default'} "
            f"K={args.candidates} reps={args.replicas} "
            f"closure={'on' if args.closure else 'off'} "
            f"kf=({args.keyframe_trans},{args.keyframe_rot}) "
            f"P={args.particles} T={args.ticks}: "
            f"slam {slam_err.mean():.3f}/{np.percentile(slam_err, 90):.3f}"
            f"/{slam_err.max():.3f} m | "
            f"dr {dr_err.mean():.3f}/{np.percentile(dr_err, 90):.3f}"
            f"/{dr_err.max():.3f} | beats {beats}/{args.episodes} | "
            f"F1 {np.mean(f1s):.3f} (min {np.min(f1s):.3f}) | "
            f"{dt:.1f}s")


def main(argv=None) -> None:
    ap = parser()
    args = ap.parse_args(argv)
    if args.world and not re.fullmatch(WORLD, args.world):
        ap.error("--world expects STYLExRxC:SEED, e.g. rooms6x6:3")
    dev = tool_device(args.device)
    world, m = sweep_world(args, dev)
    cfg = slam_config(args, m, world)
    cell_px = int(round(m.cell_meters / m.resolution))
    tail = max(args.ticks // 4, 1)
    true_walls = m.walls.cpu().numpy()
    for slip in args.slip:
        enc, scans, truth = episodes_at(slip, args, m, world)
        sync(dev)
        t0 = time.perf_counter()
        final, est = run_slam(args, cfg, world, enc, scans)
        sync(dev)
        dt = time.perf_counter() - t0
        maps = map_estimates(args.map_est, final, est, scans, world,
                             cfg.mapping)
        slam_err, dr_err, f1s = episode_scores(
            est.cpu().numpy(), truth.cpu().numpy(), enc, maps, true_walls,
            world.cfg.motion, cell_px, tail, args.offset_tol)
        if args.per_episode:
            for ep in range(args.episodes):
                print(f"  ep{ep:02d}: slam {slam_err[ep]:.3f} dr "
                      f"{dr_err[ep]:.3f} F1 {f1s[ep]:.3f}", flush=True)
        print(summary_line(slip, args, slam_err, dr_err, f1s, dt),
              flush=True)


if __name__ == "__main__":
    main()
