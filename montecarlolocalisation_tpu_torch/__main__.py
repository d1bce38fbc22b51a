"""CLI runner: `python -m montecarlolocalisation_tpu_torch <preset>`.

Presets of the JAX package's CLI (__main__.py), with its defaults: the
default maze (or `--map`, a map.txt wall list or a ROS map_server YAML),
1500 particles, 24 beams, the fixed march and multinomial resampling.

  localisation  the scripted wanderer for `--ticks` (200) ticks from
          (2.05, 2.05, 0), then the filter from a global cloud; prints the
          final confidence, the best and the true pose, the position
          error and the first songs.
  planning  a BFS plan from cell (2, 2) to (4, 4) driven closed-loop
          (sim/closed_loop) for `--ticks` (800) ticks from the first
          cell's centre; prints the plan, the waypoints reached of those
          driven and the final confidence.
  challenge  the gold/pickup TSP mission from cell (5, 0) driven
          closed-loop for `--ticks` (2000) ticks; prints the tour's gold
          cost, the legs' goals and the waypoints reached.
  moving  the wanderer alone for `--ticks` (300) ticks; prints the
          distance driven and the final pose.
  serve   JSONL sensor frames on stdin, one reply per line on stdout and a
          summary line on stderr at the end; `--robots R` > 1 serves a
          fleet of R filters in one batched tick (io/fleet.py), with
          `--pipeline` replies lag one tick; `--adapt [kld:]NMIN:NMAX`
          gives one filter an elastic particle budget (io/server.py).
  sweep   `--batch` wander episodes of `--ticks` ticks through the batched
          filter; prints one JSON line of the sweep's convergence metrics.
  mapping  `--robots` (8) wanderers map the maze for `--ticks` (600) ticks
          from their true poses (`--pose-source odom`: dead-reckoned, with
          `--slip`), the maps fuse, snap onto the cell lattice and a sweep
          relocalizes on the learned map; prints the wall metrics.
  calibrate  a `--ticks` (200) wander log with 0.05 m range noise; fits
          the wheel constants from guesses 15 % off and the sensor sigma
          from a guess 3 times off (models/calibrate); prints the true and
          fitted values.
  slam    RBPF SLAM (`--particles`, default 128, each with its own map) over
          a `--ticks` (1000) wander with `--slip` (0.03) wheel slip,
          `--slam-replicas` (4) evidence-raced replicas (or `--explore
          frontier|hybrid`, the closed-loop explorer), then
          relocalization and tracking on the learned map and, with
          `--mission`, the gold/pickup mission driven on it.

`serve --slam-serve` serves live SLAM instead (io/server.SLAMServer, or
io/fleet.SLAMFleetServer with `--robots R` > 1).

`--ess` and `--refine-iters` set the production schedule for both.  A
flag that would change nothing in the chosen mode is an error.  Both run
on `--device` (default cuda).
"""
from __future__ import annotations

import argparse
import json
import math
import sys

import numpy as np


def _dumps(obj) -> str:
    """json.dumps with non-finite floats as null (NaN means "no
    qualifying episode" in the sweep metrics and "not localized" in
    position_error_m)."""
    def clean(v):
        if isinstance(v, float) and not math.isfinite(v):
            return None
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        return v
    return json.dumps(clean(obj))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="montecarlolocalisation_tpu_torch")
    ap.add_argument("preset", choices=["localisation", "planning",
                                       "challenge", "moving", "serve",
                                       "sweep", "calibrate", "mapping",
                                       "slam"])
    ap.add_argument("--map", dest="map_path", default=None,
                    help="map file: a reference map.txt wall list, or a ROS "
                         "map_server YAML (+ PGM raster)")
    ap.add_argument("--particles", type=int, default=None,
                    help="particles (default 1500; slam: SLAM "
                         "particles, default 128, each with its own map; "
                         "serve --slam-serve runs 128 SLAM particles "
                         "whatever this says, as the JAX CLI does)")
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=None,
                    help="ticks per episode (default: localisation 200, "
                         "planning 800, challenge 2000, moving 300, sweep "
                         "150, calibrate 200, mapping 600, slam 1000)")
    ap.add_argument("--batch", type=int, default=64,
                    help="sweep: episodes in the batch")
    ap.add_argument("--tick-chunk", type=int, default=None,
                    help="sweep: accepted as in the JAX CLI; changes nothing")
    ap.add_argument("--robots", type=int, default=1,
                    help="serve: robots per batched fleet tick "
                         "(1 = one filter, io/server.py); mapping: the "
                         "wanderers (default 8)")
    ap.add_argument("--pipeline", action="store_true",
                    help="serve, fleet mode: replies lag one tick, and the "
                         "fetch of tick t-1 overlaps the card computing "
                         "tick t")
    ap.add_argument("--ess", type=float, default=None,
                    help="ESS-gated resampling threshold (e.g. 0.5): "
                         "resample only when ESS < ess * N (the production "
                         "SIR schedule; default: every tick, as the "
                         "reference)")
    ap.add_argument("--refine-iters", type=int, default=0,
                    help="gradient refinement rounds a tick (models/refine;"
                         " 0, the default, is the reference filter)")
    ap.add_argument("--adapt", default=None, metavar="[kld:]NMIN:NMAX",
                    help="serve, one robot: elastic particle budget; halve "
                         "the count every 20 confident ticks down to NMIN "
                         "and jump to NMAX when the filter goes lost. "
                         "'kld:NMIN:NMAX' sizes it by the KLD-sampling "
                         "bound instead (models/kld.py)")
    ap.add_argument("--pose-source", choices=["true", "odom"], default=None,
                    help="mapping: map from the true poses (default) or "
                         "from dead-reckoned encoders")
    ap.add_argument("--slip", type=float, default=None,
                    help="mapping and slam: per-tick multiplicative wheel "
                         "slip std the encoders do not see (default: "
                         "mapping 0, slam 0.03)")
    ap.add_argument("--export", default=None, metavar="PATH",
                    help="mapping and slam: write the learned map as a "
                         "map_server PGM + YAML (PATH.yaml then works with "
                         "--map)")
    ap.add_argument("--explore", default="wander",
                    choices=["wander", "frontier", "hybrid"],
                    help="slam: the explorer; 'wander' (the default) the "
                         "scripted freer-side wanderer, 'frontier' the "
                         "closed-loop explorer that targets the nearest "
                         "frontier on the robot's own map (sim/frontier), "
                         "'hybrid' wander phases, then frontier phases once "
                         "coverage growth decays")
    ap.add_argument("--slam-replicas", type=int, default=None,
                    help="slam and serve --slam-serve (one robot): "
                         "replicas an episode, the winner by accumulated "
                         "log evidence (default 4; 1 = one filter)")
    ap.add_argument("--slam-candidates", type=int, default=None,
                    help="slam: Monte-Carlo optimal-proposal candidates a "
                         "particle (default 1 = plain SIR)")
    ap.add_argument("--keyframe", default=None, metavar="TRANS:ROT",
                    help="slam: keyframe map-update gates in meters:radians "
                         "(default 0.15:0.5, swept at 8%% slip; '0:0' "
                         "updates every tick)")
    ap.add_argument("--mission", action="store_true",
                    help="slam: plan the gold/pickup mission on the learned "
                         "map and drive it closed-loop, sensing the true "
                         "maze")
    ap.add_argument("--slam-serve", action="store_true",
                    help="serve: live SLAM (io/server.SLAMServer; "
                         "io/fleet.SLAMFleetServer with --robots > 1) for "
                         "robots without a map; the 'export_map' command "
                         "writes the learned map")
    ap.add_argument("--device", default="cuda",
                    help="torch device the filter runs on")
    args = ap.parse_args(argv)
    slam = args.preset == "slam" or (args.preset == "serve"
                                     and args.slam_serve)
    # --particles counts SLAM particles for the slam preset only, as in
    # the JAX CLI (__main__.py:133 there): serve --slam-serve runs 128
    # whatever it says.
    slam_particles = args.particles if args.preset == "slam" else None
    if args.particles is None or args.preset == "slam":
        args.particles = 1500
    for name, presets_ in (("pose_source", ("mapping",)),
                           ("slip", ("mapping", "slam")),
                           ("export", ("mapping", "slam")),
                           ("slam_candidates", ("slam",)),
                           ("keyframe", ("slam",)),
                           ("mission", ("slam",)),
                           ("slam_serve", ("serve",))):
        if getattr(args, name) not in (None, False) \
                and args.preset not in presets_:
            ap.error(f"--{name.replace('_', '-')} applies to the "
                     f"{' and '.join(presets_)} preset")
    if args.explore != "wander":
        if args.preset != "slam":
            ap.error("--explore applies to the slam preset")
        if args.slam_replicas is not None:
            ap.error("--slam-replicas runs the wander explorer only")
    if args.slam_replicas is not None and not (
            args.preset == "slam" or (slam and args.robots == 1)):
        ap.error("--slam-replicas applies to the slam preset and to serve "
                 "--slam-serve with one robot")
    kf = None
    if args.keyframe is not None:
        try:
            kf = tuple(float(v) for v in args.keyframe.split(":"))
        except ValueError:
            kf = ()
        if len(kf) != 2 or min(kf) < 0:
            ap.error("--keyframe expects TRANS:ROT, e.g. 0.10:0.35")
    for name in ("particles", "beams", "batch", "robots", "slam_replicas",
                 "slam_candidates"):
        if getattr(args, name) is not None and getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    if slam_particles is not None and slam_particles < 1:
        ap.error("--particles must be >= 1")
    if args.ticks is not None and args.ticks < 1:
        ap.error("--ticks must be >= 1")
    if args.refine_iters < 0:
        ap.error("--refine-iters must be >= 0")
    if args.ess is not None and not 0.0 < args.ess <= 1.0:
        ap.error("--ess must be in (0, 1]")
    if args.pipeline and (args.preset != "serve" or args.robots == 1
                          or args.slam_serve):
        ap.error("--pipeline applies to the serve preset with --robots > 1")
    adapt, adapt_mode = None, "patience"
    if args.adapt is not None:
        if args.preset != "serve" or args.robots != 1 or args.slam_serve:
            ap.error("--adapt applies to the serve preset with one robot")
        spec = args.adapt
        if spec.startswith("kld:"):
            adapt_mode, spec = "kld", spec[len("kld:"):]
        try:
            lo, hi = (int(v) for v in spec.split(":"))
        except ValueError:
            ap.error("--adapt expects [kld:]NMIN:NMAX, e.g. kld:1024:65536")
        if not 1 <= lo <= hi:
            ap.error("--adapt needs 1 <= NMIN <= NMAX")
        adapt = (lo, hi)

    from . import presets

    world = presets.make_world(
        **({} if args.map_path is None else dict(map_path=args.map_path)),
        num_particles=args.particles, num_beams=args.beams,
        refine_iters=args.refine_iters, ess_threshold=args.ess,
        device=args.device)
    if args.preset == "localisation":
        final, outs, truth = presets.run_localisation(
            world, seed=args.seed, num_ticks=args.ticks or 200)
        best = final.best_pose.cpu().numpy()
        tp = truth[-1].cpu().numpy()
        err = (float(np.hypot(best[0] - tp[0], best[1] - tp[1]))
               if best[0] >= 0 else float("nan"))
        print(_dumps(dict(
            preset="localisation", confidence=float(final.confidence),
            best_pose=[round(float(v), 4) for v in best],
            true_pose=[round(float(v), 4) for v in tp],
            position_error_m=round(err, 4),
            songs=[int(s) for s in outs.song.cpu().numpy() if s != 0][:8])))
    elif args.preset == "planning":
        path, final, _ = presets.run_planning(
            world, seed=args.seed, num_ticks=args.ticks or 800)
        print(_dumps(dict(
            preset="planning", plan=[list(c) for c in path],
            waypoints_reached=int(final.wp_idx),
            waypoints_total=max(len(path) - 1, 1),  # start cell not driven
            final_confidence=float(final.filt.confidence))))
    elif args.preset == "challenge":
        plan, final, _ = presets.run_challenge(
            world, seed=args.seed, num_ticks=args.ticks or 2000)
        print(_dumps(dict(
            preset="challenge", tsp_gold_cost=plan.gold_cost,
            legs=[list(leg.goal) for leg in plan.legs],
            waypoints_reached=(int(final.wp_idx) if final is not None
                               else 0))))
    elif args.preset == "moving":
        out = presets.run_moving(world, seed=args.seed,
                                 num_ticks=args.ticks or 300)
        print(_dumps(dict(preset="moving", **out)))
    elif args.preset == "sweep":
        metrics = presets.run_sweep(world, batch=args.batch,
                                    num_ticks=args.ticks or 150,
                                    seed=args.seed,
                                    tick_chunk=args.tick_chunk)
        print(_dumps({k: round(float(v), 4) for k, v in metrics.items()}))
    elif args.preset == "calibrate":
        out = presets.run_calibrate(world, seed=args.seed,
                                    num_ticks=args.ticks or 200)
        print(_dumps(dict(preset="calibrate", **{
            k: round(float(v), 5) for k, v in out.items()})))
    elif args.preset == "mapping":
        out = presets.run_mapping(
            world, seed=args.seed, num_ticks=args.ticks or 600,
            robots=args.robots if args.robots > 1 else 8,
            pose_source=args.pose_source or "true",
            slip_noise=args.slip or 0.0, export=args.export)
        print(_dumps(dict(preset="mapping", **_rounded(out))))
    elif args.preset == "slam":
        out = presets.run_slam(
            world, seed=args.seed, num_ticks=args.ticks or 1000,
            num_particles=slam_particles or 128,
            slip_noise=0.03 if args.slip is None else args.slip,
            mission=args.mission, export=args.export,
            proposal_candidates=args.slam_candidates or 1,
            replicas=args.slam_replicas or 4,
            explore_mode=args.explore,
            **({} if kf is None else dict(keyframe=kf)))
        print(_dumps(dict(preset="slam", **_rounded(out))))
    elif args.slam_serve:
        _slam_serve(world, args, slam_particles or 128)
    elif args.robots > 1:
        from .io.fleet import MCLFleetServer

        fleet = MCLFleetServer(world.maze, world.cfg, world.angles,
                               n_robots=args.robots, seed=args.seed,
                               pipeline=args.pipeline)
        ticks = fleet.serve(sys.stdin)
        print(json.dumps(dict(
            preset="serve", robots=args.robots, ticks=ticks,
            final_confidence=[round(float(c), 4) for c in
                              fleet.state.confidence.cpu()])),
            file=sys.stderr)
    else:
        from .io.server import MCLServer

        server = MCLServer(world.maze, world.cfg, world.angles,
                           seed=args.seed, adapt=adapt,
                           adapt_mode=adapt_mode)
        ticks = server.serve(sys.stdin)
        print(json.dumps(dict(preset="serve", ticks=ticks,
                              final_confidence=round(
                                  float(server.state.confidence), 4))),
              file=sys.stderr)


def _rounded(out: dict) -> dict:
    return {k: (round(float(v), 4) if isinstance(v, float) else v)
            for k, v in out.items()}


def _slam_serve(world, args, particles: int) -> None:
    """serve --slam-serve: JSONL frames on stdin to live SLAM, all robots
    anchored at the default start (a shared world frame)."""
    from .config import SLAMConfig
    from .presets import _mapping_config

    m = world.maze
    scfg = SLAMConfig(num_particles=particles, mapping=_mapping_config(m),
                      sensor=world.cfg.sensor, motion=world.cfg.motion,
                      keyframe_trans=0.15, keyframe_rot=0.5)
    if args.robots > 1:
        from .io.fleet import SLAMFleetServer

        server = SLAMFleetServer(scfg, world.angles,
                                 [(1.25, 1.25, 0.0)] * args.robots,
                                 seed=args.seed, device=m.device)
    else:
        from .io.server import SLAMServer

        server = SLAMServer(scfg, world.angles, seed=args.seed,
                            replicas=args.slam_replicas or 4,
                            device=m.device)
    server.serve(sys.stdin)
    print(_dumps(dict(preset="serve", slam=True, robots=args.robots,
                      ticks=server.tick_count)), file=sys.stderr)


if __name__ == "__main__":
    main()
