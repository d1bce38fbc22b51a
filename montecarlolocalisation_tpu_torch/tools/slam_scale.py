"""SLAM scale table, per-tick cost and memory against (P, map size): the
counterpart of the root tools/slam_scale.py, with its flags and lines.

[P, H, W] dense per-particle maps grow with P x H x W; this measures where
the windowed update (the mapping window and slam.field_windows) holds the
tick's cost flat and what memory it takes.  Each (world, P) runs
--ticks-per-dispatch SLAM ticks a dispatch, one CUDA graph replay
(slam.run_slam_ticks), timed with CUDA events over --iters replays on the
card (the host clock on the CPU).  Where the JAX tool prints XLA's
compiled argument and temporary sizes, this prints
`max_memory_allocated_one_replay`: torch.cuda.max_memory_allocated after
reset_peak_memory_stats around one replay, less what the process had
allocated before the configuration was built (the graphs of earlier
configurations dropped first), and the graph's memory pool, which a
replay's temporaries use and the allocated count does not see ("n/a" on
the CPU).

  python -m montecarlolocalisation_tpu_torch.tools.slam_scale \\
      --particles 32 64 128 --worlds 6x6 12x10 16x12
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from . import sync, timed_s, tool_device

START = (1.25, 1.25, 0.0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.slam_scale")
    ap.add_argument("--particles", type=int, nargs="+",
                    default=[32, 64, 128])
    ap.add_argument("--worlds", nargs="+", default=["6x6", "12x10", "16x12"])
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--ticks-per-dispatch", type=int, default=8)
    ap.add_argument("--device", default="cuda",
                    help="torch device SLAM runs on")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = tool_device(args.device)
    from ..config import FilterConfig, MappingConfig, SLAMConfig
    from ..maps import from_walls, generator
    from ..models import compiled, slam
    from ..sim import robot

    fcfg = FilterConfig()
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, args.beams)).astype(np.float32)
    ja = torch.as_tensor(angles, device=dev)
    K = args.ticks_per_dispatch

    for world in args.worlds:
        r, c = (int(v) for v in world.split("x"))
        m = from_walls(generator.generate_maze(r, c, seed=3), device=dev)
        mc = MappingConfig(height=m.height, width=m.width,
                           resolution=float(m.resolution),
                           origin_x=float(m.origin_x),
                           origin_y=float(m.origin_y))
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        enc, scans, _ = robot.generate_wander_episode(
            gen, m, fcfg, angles, 64, start_pose=START, slip_noise=0.08,
            explore=True)
        enc, scans = enc[0, :K], scans[0, :K]
        mask = torch.ones_like(scans)
        for p in args.particles:
            cfg = SLAMConfig(num_particles=p, mapping=mc,
                             sensor=fcfg.sensor, motion=fcfg.motion,
                             keyframe_trans=0.10, keyframe_rot=0.35)
            # This configuration's memory alone: what it allocates above
            # the process's allocation before it, and its graph's pool.
            compiled.graphs.clear()
            base = 0
            if dev.type == "cuda":
                torch.cuda.empty_cache()
                base = torch.cuda.memory_allocated(dev)
            st = slam.init_slam(1, START, cfg, device=dev)

            def replay(state):
                return slam.run_slam_ticks(state, enc, scans, mask, ja,
                                           cfg)[0]

            cur = replay(st)             # builds and captures the graph
            sync(dev)
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
                cur = replay(cur)
                torch.cuda.synchronize(dev)
                peak = torch.cuda.max_memory_allocated(dev) - base
                pool = sum(g.pool_bytes for g in compiled.graphs.entries())
                mem = (f"max_memory_allocated_one_replay "
                       f"{peak / 2**20:.0f} MiB, graph pool "
                       f"{pool / 2**20:.0f} MiB")
            else:
                mem = "n/a"

            def run(cur=cur):
                for _ in range(args.iters):
                    cur = replay(cur)
                return cur

            _, secs = timed_s(dev, run)
            ms = secs / (args.iters * K) * 1e3
            win = slam.field_window_px(cfg)
            windowed = 2 * win <= min(m.height, m.width)
            print(f"world {world} ({m.height}x{m.width}px) P={p:4d}: "
                  f"{ms:7.2f} ms/tick | maps "
                  f"{p*m.height*m.width*4/2**20:6.1f} MiB | {mem} | "
                  f"field windowed={windowed} ({win}px)", flush=True)


if __name__ == "__main__":
    main()
