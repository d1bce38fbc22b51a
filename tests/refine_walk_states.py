"""The DDA walks' lane share on the states the benchmark cell
replay1024-production reaches (a script, not a test; it needs a CUDA card).

It makes the cell's logs from a run's seed as the benchmark's replay does
(mclbench's generator, logs1024x300-gated under production-500x24), runs
one sweep of the port's filter over them with the ticks eager, so that
models/refine.refine_particles sees each tick's particles, and on each
tick's refinement inputs counts the walks of the first round twice:
ops/refine.walk_stats (refine_grad_kernel's counting form) and
tests/refine_walk_mirror (the plain mirror of the same schedule).  It
prints one JSON line: the two counts over the sweep, their lane shares,
and the share tick by tick.

    python tests/refine_walk_states.py --seed 2147483653 --ticks 300
"""
from __future__ import annotations

import argparse
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CELL = "replay1024-production"


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=2147483653)
    ap.add_argument("--ticks", type=int, default=300)
    args = ap.parse_args(argv)
    sys.path[:0] = [ROOT, HERE]

    import torch

    import refine_walk_mirror as walk_mirror
    from mclbench import generator, harness
    from mclbench.drivers.replay import pass_seed
    from mclbench.program import PortWorld
    from mclbench.world import World
    from montecarlolocalisation_tpu_torch.models import compiled, refine
    from montecarlolocalisation_tpu_torch.ops import refine as kref
    from montecarlolocalisation_tpu_torch.parallel import episodes

    if not torch.cuda.is_available():
        raise SystemExit("refine_walk_states counts the kernel's walks on a "
                         "CUDA card")
    cell = harness.load_cell(ROOT, CELL)
    world = World(ROOT, cell.config, "cuda")
    traffic = cell.traffic
    s_traffic, s_filter, _ = generator.seeds(args.seed, 3)
    enc, ranges, _ = generator.logs(
        s_traffic, world.mz, world.angles, world.sensor, world.motion,
        int(traffic["episodes"]), args.ticks,
        generator.Wander(**traffic["wander"]))
    pw = PortWorld(world)

    ticks = []
    plain = refine.refine_particles

    def counted(m, particles, scan, cfg):
        if kref.kernels_take(m, particles, cfg):
            got = kref.walk_stats(m, particles, scan, cfg)
            p, ang, _, _ = kref.beam_inputs(particles, scan, cfg)
            want = walk_mirror.counts(
                walk_mirror.walks(m, p, ang, cfg.sensor)["steps"])
            ticks.append(dict(kernel={k: got[k] for k in want},
                              mirror=want))
        return plain(m, particles, scan, cfg)

    refine.refine_particles = counted
    compiled.TickGraph._capture = lambda self: None
    compiled.graphs = compiled.GraphCache()
    episodes.run_episode_batch(pass_seed(s_filter, 0), pw.m, pw.cfg, enc,
                               ranges, pw.angles_dev)
    torch.cuda.synchronize()

    def total(side):
        steps = sum(t[side]["steps"] for t in ticks)
        slots = sum(t[side]["slots"] for t in ticks)
        return dict(steps=steps, slots=slots, lane_share=steps / slots)

    out = dict(cell=CELL, seed=args.seed, ticks=len(ticks),
               device=torch.cuda.get_device_name(0),
               kernel=total("kernel"), mirror=total("mirror"),
               equal=all(t["kernel"] == t["mirror"] for t in ticks),
               share_by_tick=[round(t["kernel"]["steps"]
                                    / max(t["kernel"]["slots"], 1), 4)
                              for t in ticks])
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
