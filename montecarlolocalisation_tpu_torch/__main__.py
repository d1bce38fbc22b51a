"""CLI runner: `python -m montecarlolocalisation_tpu_torch <preset>`.

Presets of the JAX package's CLI (__main__.py), with its defaults: the
default maze, 1500 particles, 24 beams, the fixed march and multinomial
resampling.

  serve   JSONL sensor frames on stdin, one reply per line on stdout and a
          summary line on stderr at the end; `--robots R` > 1 serves a
          fleet of R filters in one batched tick (io/fleet.py), with
          `--pipeline` replies lag one tick.
  sweep   `--batch` wander episodes of `--ticks` ticks through the batched
          filter; prints one JSON line of the sweep's convergence metrics.

Both run on `--device` (default cuda).
"""
from __future__ import annotations

import argparse
import json
import math
import sys


def _dumps(obj) -> str:
    """json.dumps with non-finite floats as null (NaN means "no
    qualifying episode" in the sweep metrics)."""
    return json.dumps({k: (v if math.isfinite(v) else None)
                       for k, v in obj.items()})


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="montecarlolocalisation_tpu_torch")
    ap.add_argument("preset", choices=["serve", "sweep"])
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ticks", type=int, default=None,
                    help="sweep: ticks per episode (default 150)")
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
    ap.add_argument("--device", default="cuda",
                    help="torch device the filter runs on")
    args = ap.parse_args(argv)
    for name in ("particles", "beams", "batch", "robots"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")
    if args.ticks is not None and args.ticks < 1:
        ap.error("--ticks must be >= 1")

    from . import presets

    world = presets.make_world(num_particles=args.particles,
                               num_beams=args.beams, device=args.device)
    if args.preset == "sweep":
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
                           seed=args.seed)
        ticks = server.serve(sys.stdin)
        print(json.dumps(dict(preset="serve", ticks=ticks,
                              final_confidence=round(
                                  float(server.state.confidence), 4))),
              file=sys.stderr)


if __name__ == "__main__":
    main()
