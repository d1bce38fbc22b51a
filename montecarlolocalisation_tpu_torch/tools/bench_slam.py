"""RBPF SLAM throughput (models/slam): the counterpart of the root
tools/bench_slam.py, with its flags and lines.

One SLAM tick is the motion proposal, each particle's likelihood field,
the bilinear endpoint and free-space weighting, the ESS-gated resample
that carries the maps, and the map update.  Prints SLAM ticks/s for each
particle count over one wander episode, then a fleet of --fleet robots'
episodes as one [E] state, optionally on an oversized grid (--map-px).
An episode runs as CUDA graph replays; the best of --iters episodes is
timed with CUDA events on the card (the host clock on the CPU), and
"compile+first" is the first episode, its graphs' capture included.

  python -m montecarlolocalisation_tpu_torch.tools.bench_slam \\
      --particles 32 64 128 --ticks 300
"""
from __future__ import annotations

import argparse

import torch

from . import timed_s, tool_device

START = (1.25, 1.25, 0.0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.bench_slam")
    ap.add_argument("--particles", type=int, nargs="+",
                    default=[32, 64, 128])
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--fleet", type=int, default=8,
                    help="SLAM robots for the fleet row (0 = skip)")
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--map-px", type=int, nargs=2, default=None,
                    metavar=("H", "W"))
    ap.add_argument("--device", default="cuda",
                    help="torch device SLAM runs on")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = tool_device(args.device)
    from .. import presets
    from ..config import MappingConfig, SLAMConfig
    from ..models import slam
    from ..sim import robot

    world = presets.make_world(num_beams=args.beams, device=dev)
    m = world.maze
    h, w = args.map_px if args.map_px else (m.height, m.width)
    mc = MappingConfig(height=h, width=w, resolution=float(m.resolution),
                       origin_x=float(m.origin_x),
                       origin_y=float(m.origin_y))
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    enc, scans, _ = robot.generate_wander_episode(
        gen, m, world.cfg, world.angles, args.ticks, start_pose=START,
        slip_noise=0.03, explore=True)

    def timed(fn):
        _, t_first = timed_s(dev, fn)
        best = min(timed_s(dev, fn)[1] for _ in range(args.iters))
        return t_first, best

    size = f"{mc.height}x{mc.width}px"
    for p in args.particles:
        cfg = SLAMConfig(num_particles=p, mapping=mc,
                         sensor=world.cfg.sensor, motion=world.cfg.motion)
        t_first, best = timed(lambda cfg=cfg: slam.run_slam_episode(
            1, enc[0], scans[0], world.angles, cfg, START))
        print(f"P={p:4d} {size} map: {args.ticks} ticks in {best:.3f}s "
              f"-> {args.ticks / best:,.0f} SLAM ticks/s "
              f"(compile+first {t_first:.1f}s)", flush=True)

    if args.fleet:
        cfg = SLAMConfig(num_particles=64, mapping=mc,
                         sensor=world.cfg.sensor, motion=world.cfg.motion)
        e_n = args.fleet
        enc_b = enc.expand(e_n, -1, -1)
        sc_b = scans.expand(e_n, -1, -1)
        t_first, best = timed(lambda: slam.run_slam_episode(
            0, enc_b, sc_b, world.angles, cfg, START))
        total = e_n * args.ticks
        print(f"fleet {e_n} x P=64 {size}: {total} robot-ticks in "
              f"{best:.3f}s -> {total / best:,.0f} SLAM robot-ticks/s "
              f"(compile+first {t_first:.1f}s)", flush=True)


if __name__ == "__main__":
    main()
