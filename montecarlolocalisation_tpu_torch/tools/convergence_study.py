"""Convergence against particle count (BASELINE config 4): the
counterpart of the root tools/convergence_study.py, with its flags.

Sweeps --batch global-localization episodes x --ticks ticks on the default
maze for each --particles count through presets.run_sweep (the wander
simulation, then the batched filter in CUDA graphs), and prints one JSON
line a count: the JAX tool's keys, then `ms_per_tick` (the sweep's wall
time over its ticks) and `device`.  --refine-iters, --ess, --method and
--ray-mode set the filter as in the JAX tool; --tick-chunk is accepted and
changes nothing (the ticks run in graphs of a few ticks either way).

  python -m montecarlolocalisation_tpu_torch.tools.convergence_study \\
      --batch 32 --ticks 200 --particles 250 --refine-iters 2
"""
from __future__ import annotations

import argparse
import json
import time

from . import device_name, tool_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.convergence_study")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--particles", type=int, nargs="*",
                    default=[100, 250, 500, 1000, 2000, 4000])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--method", default="systematic",
                    choices=["systematic", "multinomial"])
    ap.add_argument("--tick-chunk", type=int, default=None,
                    help="accepted for the JAX tool's flags; changes "
                         "nothing")
    ap.add_argument("--refine-iters", type=int, default=0,
                    help="gradient-guided refinement rounds per tick "
                         "(models/refine), e.g. --particles 250 "
                         "--refine-iters 2 for the refinement table")
    ap.add_argument("--ray-mode", default="fixed",
                    choices=["fixed", "dda", "analytic"])
    ap.add_argument("--ess", type=float, default=None,
                    help="ESS-gated resampling threshold (e.g. 0.5); with "
                         "--refine-iters 2 the production schedule")
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on")
    return ap


def sweep_line(n: int, args: argparse.Namespace, metrics: dict,
               wall_s: float, device: str) -> dict:
    """One count's output line: the JAX tool's keys (metrics rounded to
    4 places, the wall time to 0.1 s), then ms_per_tick and the device."""
    return dict(
        particles=n, batch=args.batch, ticks=args.ticks,
        method=args.method, refine=args.refine_iters, ess=args.ess,
        wall_s=round(wall_s, 1),
        **{k: round(float(v), 4) for k, v in metrics.items()},
        ms_per_tick=round(1e3 * wall_s / args.ticks, 3), device=device)


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = tool_device(args.device)
    from .. import presets

    for n in args.particles:
        world = presets.make_world(num_particles=n, ray_mode=args.ray_mode,
                                   resample_method=args.method,
                                   refine_iters=args.refine_iters,
                                   ess_threshold=args.ess, device=dev)
        t0 = time.perf_counter()
        metrics = presets.run_sweep(world, batch=args.batch,
                                    num_ticks=args.ticks, seed=args.seed,
                                    tick_chunk=args.tick_chunk)
        line = sweep_line(n, args, metrics, time.perf_counter() - t0,
                          device_name(dev))
        print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
