"""Fleet-serving throughput at the reference's per-robot config: the
counterpart of the root tools/bench_fleet.py, with its flags and keys.

Times MCLFleetServer's tick (the whole serving loop: one packed frame
upload, one batched tick as a CUDA graph replay, one reply fetch) at 1500
particles x 34 beams a robot for each fleet size.  A fleet is served at
10 Hz when a tick takes under 100 ms.  Each line adds `device_ms`, the
card's own time a tick (every kernel and copy the profiler sees; null on
the CPU), beside the host clock's `tick_ms`: the fleet's tick is bound by
the host.

  python -m montecarlolocalisation_tpu_torch.tools.bench_fleet \\
      [--robots 1 16 64 256] [--ticks 20] [--pipeline]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from . import device_name, tool_device


def bench_one(m, n_robots: int, particles: int, beams: int, ticks: int,
              pipeline: bool = False) -> dict:
    """One fleet size's line: MCLFleetServer on the map `m`, every robot
    fed the scan from (1.25, 1.25, 0) and encoders 0.1."""
    from ..config import FilterConfig, SensorModelConfig
    from ..io.fleet import MCLFleetServer
    from ..utils.profiling import device_ms
    from ..models import sensor

    cfg = FilterConfig(num_particles=particles, sensor=SensorModelConfig())
    angles = np.deg2rad(np.linspace(-118.0, 118.0, beams)).astype(np.float32)
    fleet = MCLFleetServer(m, cfg, angles, n_robots=n_robots, seed=0,
                           pipeline=pipeline)
    scan = sensor.simulate_scan(m, [1.25, 1.25, 0.0], angles, cfg.sensor)
    ranges = np.broadcast_to(scan.ranges.cpu().numpy(), (n_robots, beams))
    enc = np.full((n_robots,), 0.1, np.float32)

    fleet.tick(enc, enc, ranges)  # builds the kernels, captures the graph
    fleet.flush()
    t0 = time.perf_counter()
    for _ in range(ticks):
        fleet.tick(enc, enc, ranges)
    fleet.flush()  # pipelined mode: drain the last in-flight tick
    dt = (time.perf_counter() - t0) / ticks
    dev_ms = None
    if m.device.type == "cuda":
        def tick():
            fleet.tick(enc, enc, ranges)
            fleet.flush()

        dev_ms = round(device_ms(tick, reps=ticks), 4)
    return dict(
        robots=n_robots, particles=particles, beams=beams,
        pipeline=pipeline,
        tick_ms=round(dt * 1e3, 2),
        fleet_rate_hz=round(1.0 / dt, 1),
        robot_ticks_per_sec=round(n_robots / dt, 1),
        serves_10hz=bool(dt < 0.1),
        device_ms=dev_ms, device=device_name(m.device),
    )


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.bench_fleet")
    ap.add_argument("--robots", type=int, nargs="+",
                    default=[1, 16, 64, 256])
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--beams", type=int, default=34)
    ap.add_argument("--ticks", type=int, default=20)
    ap.add_argument("--pipeline", action="store_true",
                    help="double-buffered ticks (replies lag one tick; "
                         "fetch overlaps device compute)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the fleet runs on")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = tool_device(args.device)
    from ..maps import from_map_file
    from ..presets import DEFAULT_MAP

    m = from_map_file(DEFAULT_MAP, device=dev)
    for r in args.robots:
        print(json.dumps(bench_one(m, r, args.particles, args.beams,
                                   args.ticks, pipeline=args.pipeline)),
              flush=True)


if __name__ == "__main__":
    main()
