"""Fleet-mapping throughput: the counterpart of the root
tools/bench_mapping.py, with its flags and lines.

E robots' wander episodes fold into E occupancy grids as one batch
(models/mapping.map_episode over [E, T] in CUDA graphs).  Prints mapping
ticks/s, one tick being one scan's inverse-sensor-model update, the best
of --iters runs timed with CUDA events on the card (the host clock on the
CPU), the fetch of the maps included.  A third line gives the mapping
graphs' memory pool and the peak memory allocated during the runs.

  python -m montecarlolocalisation_tpu_torch.tools.bench_mapping \\
      --episodes 256 --ticks 600 --beams 34
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from . import sync, timed_s, tool_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.bench_mapping")
    ap.add_argument("--episodes", type=int, default=256)
    ap.add_argument("--ticks", type=int, default=600)
    ap.add_argument("--beams", type=int, default=34)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--map-px", type=int, nargs=2, default=None,
                    metavar=("H", "W"),
                    help="oversize the mapping grid (the maze sits in its "
                         "corner): the per-tick cost should stay about "
                         "flat in map area (mapping.update_map's window)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the mappers run on")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = tool_device(args.device)
    from ..config import FilterConfig, MappingConfig
    from ..maps import from_map_file
    from ..models import compiled, mapping
    from ..parallel import episodes
    from ..presets import DEFAULT_MAP

    m = from_map_file(DEFAULT_MAP, device=dev)
    cfg = FilterConfig(num_particles=64)
    angles = np.deg2rad(np.linspace(-118, 118, args.beams)).astype(np.float32)
    mc = (MappingConfig(height=args.map_px[0], width=args.map_px[1])
          if args.map_px else MappingConfig())

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    enc, scans, poses = episodes.simulate_episode_batch(
        gen, m, cfg, angles, args.ticks, args.episodes,
        start_pose=(2.05, 2.05, 0.0))
    sync(dev)
    t_sim = time.perf_counter() - t0

    def run():
        return mapping.map_episode(poses, scans, angles, mc,
                                   cfg.sensor).cpu()

    before = {id(g) for g in compiled.graphs.entries()}
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    lo, t_compile = timed_s(dev, run)
    best = min(timed_s(dev, run)[1] for _ in range(args.iters))
    ticks = args.episodes * args.ticks
    fused = mapping.fuse_maps(lo)
    print(f"sim {t_sim:.1f}s, compile+first {t_compile:.1f}s")
    print(f"{args.episodes} mappers x {args.ticks} ticks x {args.beams} "
          f"beams: {best:.3f}s -> {ticks / best:,.0f} mapping ticks/s "
          f"({ticks * mc.height * mc.width * args.beams / best:.3g} "
          f"pixel-beam evals/s); explored_frac="
          f"{float(torch.mean((torch.abs(fused) > 0.5).float())):.3f}")
    new = [g for g in compiled.graphs.entries() if id(g) not in before]
    pool = sum(g.pool_bytes for g in new)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else None)
    print(f"graphs built {len(new)}, pool "
          f"{pool / 2**20:.1f} MiB, max_memory_allocated "
          + (f"{peak / 2**20:.1f} MiB" if peak is not None else "n/a"),
          flush=True)


if __name__ == "__main__":
    main()
