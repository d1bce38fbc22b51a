"""Randomized-maps sweep tool (BASELINE config 4's maps axis): the
counterpart of the JAX package's tools/multimap_sweep.py, with its flags.

Generates --maps maps of --style, runs --episodes-per-map wander episodes
on each through the batched filter as one batch on the map stack (each
episode on its own map; on the card K1 batched reads each episode's
raster), and prints one JSON line of the sweep's metrics with the device.

  python -m montecarlolocalisation_tpu_torch.tools.multimap_sweep \\
      --maps 64 --episodes-per-map 2 --ticks 150 --style mixed
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.multimap_sweep")
    ap.add_argument("--maps", type=int, default=64)
    ap.add_argument("--episodes-per-map", type=int, default=2)
    ap.add_argument("--ticks", type=int, default=150)
    ap.add_argument("--particles", type=int, default=500)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--style", default="maze",
                    choices=["maze", "rooms", "mixed"])
    ap.add_argument("--extra-openings", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on")
    args = ap.parse_args(argv)

    from ..config import FilterConfig, SensorModelConfig
    from ..maps import generator
    from ..parallel import episodes

    dev = torch.device(args.device)
    cfg = FilterConfig(num_particles=args.particles,
                       sensor=SensorModelConfig())
    angles = np.deg2rad(np.linspace(-118.0, 118.0, args.beams)
                        ).astype(np.float32)
    maps = generator.generate_map_batch(
        args.maps, rows=args.rows, cols=args.cols, seed=args.seed,
        extra_openings=args.extra_openings, style=args.style, device=dev)
    t0 = time.perf_counter()
    final, outs, truth = episodes.run_multimap_sweep(
        args.seed, maps, cfg, angles, args.ticks,
        episodes_per_map=args.episodes_per_map,
        start_pose=(1.25, 1.25, 0.0))
    metrics = episodes.sweep_rmse(final, truth)
    wall = time.perf_counter() - t0
    metrics = {k: round(float(v), 4) for k, v in metrics.items()}
    metrics.update(maps=args.maps, episodes_per_map=args.episodes_per_map,
                   ticks=args.ticks, style=args.style,
                   wall_s=round(wall, 1),
                   device=(torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else str(dev)))
    print(json.dumps({k: (None if isinstance(v, float) and v != v else v)
                      for k, v in metrics.items()}))


if __name__ == "__main__":
    main()
