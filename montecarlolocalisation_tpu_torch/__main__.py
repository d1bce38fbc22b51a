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
                                       "sweep"])
    ap.add_argument("--map", dest="map_path", default=None,
                    help="map file: a reference map.txt wall list, or a ROS "
                         "map_server YAML (+ PGM raster)")
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=None,
                    help="ticks per episode (default: localisation 200, "
                         "planning 800, challenge 2000, moving 300, sweep "
                         "150)")
    ap.add_argument("--batch", type=int, default=64,
                    help="sweep: episodes in the batch")
    ap.add_argument("--tick-chunk", type=int, default=None,
                    help="sweep: accepted as in the JAX CLI; changes nothing")
    ap.add_argument("--robots", type=int, default=1,
                    help="serve: robots per batched fleet tick "
                         "(1 = one filter, io/server.py)")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device the filter runs on")
    args = ap.parse_args(argv)
    for name in ("particles", "beams", "batch", "robots"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")
    if args.ticks is not None and args.ticks < 1:
        ap.error("--ticks must be >= 1")
    if args.refine_iters < 0:
        ap.error("--refine-iters must be >= 0")
    if args.ess is not None and not 0.0 < args.ess <= 1.0:
        ap.error("--ess must be in (0, 1]")
    if args.pipeline and (args.preset != "serve" or args.robots == 1):
        ap.error("--pipeline applies to the serve preset with --robots > 1")
    adapt, adapt_mode = None, "patience"
    if args.adapt is not None:
        if args.preset != "serve" or args.robots != 1:
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


if __name__ == "__main__":
    main()
