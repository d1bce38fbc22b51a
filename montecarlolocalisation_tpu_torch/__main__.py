"""CLI runner: `python -m montecarlolocalisation_tpu_torch serve`.

The serve preset of the JAX package's CLI (__main__.py:289-306): JSONL
sensor frames on stdin, one pose reply per line on stdout, a summary line
on stderr at the end.  Same defaults: the default maze, 1500 particles,
24 beams, the fixed march and multinomial resampling.
"""
from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="montecarlolocalisation_tpu_torch")
    ap.add_argument("preset", choices=["serve"])
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the filter runs on")
    args = ap.parse_args(argv)
    for name in ("particles", "beams"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")

    from . import presets
    from .io.server import MCLServer

    world = presets.make_world(num_particles=args.particles,
                               num_beams=args.beams, device=args.device)
    server = MCLServer(world.maze, world.cfg, world.angles, seed=args.seed)
    ticks = server.serve(sys.stdin)
    print(json.dumps(dict(preset="serve", ticks=ticks,
                          final_confidence=round(
                              float(server.state.confidence), 4))),
          file=sys.stderr)


if __name__ == "__main__":
    main()
