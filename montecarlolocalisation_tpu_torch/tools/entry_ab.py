"""Time the port's entry points at their chip sizes, on one GPU, for an A/B
of two checkouts of the port.

    python montecarlolocalisation_tpu_torch/tools/entry_ab.py [--root DIR]
        [--label NAME]

imports the package from DIR (default: the checkout this file lies in),
so that an earlier commit unpacked with `git archive` times its own code
in the same call; run them as parent, change, change, parent.  It prints
one JSON line a measurement, each with the label, the card's name and
power limit:

- `serve`: the 1M x 34 server (analytic casts, systematic resampling),
  the host ms of each of 20 ticks after 5 unmeasured ones, median and
  p90;
- `fleet`: 64 robots x 1500 x 34, synchronous and pipelined, the same;
- `sweep`: presets.run_sweep at 1024 x 500 x 24 x 300 ticks, the wall
  seconds of its second run.

Where the package has models/compiled, two more forms of the serve tick:
`eager`, the server whose graphs run their ticks as eager calls on their
buffers (no capture: the eager side of chip_smoke.py's A/B), and
`direct`, the server's tick function called on the device state, as the
server ticked before the compiled path (no buffers, no slab copies).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
START = (1.25, 1.25, 0.0)
FRAMES, WARM = 20, 5


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def frames(world, n: int, robots=None, seed: int = 0):
    """n frames of a straight drive from START: encoders and the scans
    simulated at the true poses, with 2 cm of noise drawn by numpy; a
    fleet's robots all drive it, each with its own noise."""
    import torch
    from montecarlolocalisation_tpu_torch.models import sensor

    rng = np.random.default_rng(seed)
    out = []
    for t in range(1, n + 1):
        pose = [START[0] + 0.01 * t, START[1], START[2]]
        r = sensor.simulate_scan(world.maze, torch.tensor(pose),
                                 world.angles, world.cfg.sensor
                                 ).ranges.cpu().numpy()
        shape = r.shape if robots is None else (robots,) + r.shape
        ranges = np.clip(r + rng.normal(0, 0.02, shape), 0.0, None)
        enc = 0.25 * t
        if robots is not None:
            enc = np.full(robots, enc, np.float32)
        out.append((enc, enc, ranges.astype(np.float32)))
    return out


def latencies(tick, fs) -> dict:
    """Host ms of each tick(*frame) after WARM unmeasured ones."""
    import torch

    for f in fs[:WARM]:
        tick(*f)
    torch.cuda.synchronize()
    ms = []
    for f in fs[WARM:]:
        t0 = time.perf_counter()
        tick(*f)
        ms.append(1e3 * (time.perf_counter() - t0))
    return dict(ms_median=float(np.median(ms)),
                ms_p90=float(np.percentile(ms, 90)))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(HERE)))
    p.add_argument("--label", default="change")
    args = p.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    from montecarlolocalisation_tpu_torch import presets
    from montecarlolocalisation_tpu_torch.io import server as srv
    from montecarlolocalisation_tpu_torch.io.fleet import MCLFleetServer
    try:
        from montecarlolocalisation_tpu_torch.models import compiled
    except ImportError:
        compiled = None

    if not torch.cuda.is_available():
        raise SystemExit("entry_ab.py times a CUDA card")
    head = dict(label=args.label, card=card(), root=args.root)

    def say(**fields):
        print(json.dumps(dict(head, **fields)), flush=True)

    dev = torch.device("cuda")
    big = presets.make_world(num_particles=1_048_576, num_beams=34,
                             ray_mode="analytic",
                             resample_method="systematic", device=dev)
    fs = frames(big, WARM + FRAMES, seed=1)
    server = srv.MCLServer(big.maze, big.cfg, big.angles, seed=0)
    say(what="serve", form="entry point", **latencies(server.tick, fs))
    del server
    if compiled is not None:
        capture = compiled.TickGraph._capture
        compiled.TickGraph._capture = lambda self: None
        try:
            server = srv.MCLServer(big.maze, big.cfg, big.angles, seed=0)
            say(what="serve", form="eager",
                **latencies(server.tick, fs))
        finally:
            compiled.TickGraph._capture = capture
        server = srv.MCLServer(big.maze, big.cfg, big.angles, seed=0)
        state = [server._state]

        def direct(left, right, ranges):
            frame = torch.as_tensor(np.concatenate(
                [np.float32([left, right]), ranges,
                 np.ones_like(ranges)]), device=dev)
            state[0], reply = srv._serve_tick(state[0], dict(frame=frame),
                                              None, **server._tick_args)
            reply.cpu()

        say(what="serve", form="direct", **latencies(direct, fs))
        del server, state
    del big
    torch.cuda.empty_cache()

    fleet = presets.make_world(num_particles=1500, num_beams=34,
                               device=dev)
    ffs = frames(fleet, WARM + FRAMES, robots=64, seed=2)
    for pipe in (False, True):
        f = MCLFleetServer(fleet.maze, fleet.cfg, fleet.angles, n_robots=64,
                           seed=0, pipeline=pipe)
        say(what="fleet", form="pipelined" if pipe else "synchronous",
            **latencies(f.tick, ffs))
        f.flush()

    sweep = presets.make_world(num_particles=500, num_beams=24, device=dev,
                               resample_method="systematic")
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        presets.run_sweep(sweep, batch=1024, num_ticks=300, seed=0)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    say(what="sweep", wall_s=walls[1], first_wall_s=walls[0])


if __name__ == "__main__":
    main()
