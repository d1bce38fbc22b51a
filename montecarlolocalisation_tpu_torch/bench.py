"""Benchmark of the port: particle-beam updates/s of the full filter tick on
one CUDA card.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
The metric and flags are those of the JAX package's root bench.py: the
complete tick (hysteresis, motion, beam weights, adaptive-injection
resampling, k-means confidence) at --particles x --beams, float32, by
default 1M x 34 with the closed-form caster and systematic resampling.
Ticks run one `mcl_step` call each, the serving form; the time is taken
with CUDA events after one warm-up tick that also builds the kernels.
vs_baseline is against the reference's implied ceiling, 1500 particles x
34 beams x 10 Hz on a Raspberry Pi 4 (BASELINE.md).

Usage: python -m montecarlolocalisation_tpu_torch.bench [--particles N]
       [--beams B] [--iters I] [--ray-mode M] [--resample R]
       [--beam-combine C]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import torch

BASELINE_UPDATES_PER_SEC = 1500 * 34 * 10.0


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def bench_full_step(num_particles: int, num_beams: int, iters: int,
                    ray_mode: str = "analytic",
                    resample_method: str = "systematic",
                    beam_combine: str = "sum") -> dict:
    if not torch.cuda.is_available():
        raise RuntimeError("the port's bench measures a CUDA card; "
                           "torch.cuda.is_available() is False")
    from . import presets
    from .models import filter as mcl
    from .models import sensor

    dev = torch.device("cuda")
    world = presets.make_world(num_particles=num_particles,
                               num_beams=num_beams, ray_mode=ray_mode,
                               resample_method=resample_method, device=dev)
    cfg = dataclasses.replace(world.cfg, sensor=dataclasses.replace(
        world.cfg.sensor, beam_combine=beam_combine))
    m = world.maze
    state = mcl.init_state(m, cfg, seed=0)
    scan = sensor.simulate_scan(m, [1.25, 1.25, 0.0], world.angles,
                                cfg.sensor)
    enc = torch.tensor(0.1, device=dev)

    state, _ = mcl.mcl_step(state, enc, enc, scan, m, cfg)   # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        state, _ = mcl.mcl_step(state, enc, enc, scan, m, cfg)
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    steps_per_sec = 1e3 / ms
    return dict(steps_per_sec=steps_per_sec,
                updates_per_sec=steps_per_sec * num_particles * num_beams,
                ms_per_step=ms, num_particles=num_particles,
                num_beams=num_beams,
                device=torch.cuda.get_device_name(0), card=card())


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="montecarlolocalisation_tpu_torch.bench")
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--beams", type=int, default=34)
    ap.add_argument("--iters", type=int, default=20,
                    help="timed ticks, one mcl_step call each")
    ap.add_argument("--ray-mode", default="analytic",
                    choices=["fixed", "dda", "analytic"])
    ap.add_argument("--resample", default="systematic",
                    choices=["systematic", "multinomial"])
    ap.add_argument("--beam-combine", default="sum", choices=["sum", "log"])
    args = ap.parse_args(argv)
    for name in ("particles", "beams", "iters"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")
    r = bench_full_step(args.particles, args.beams, args.iters,
                        ray_mode=args.ray_mode,
                        resample_method=args.resample,
                        beam_combine=args.beam_combine)
    print(json.dumps(dict(
        metric="particle_beam_updates_per_sec_full_mcl_step",
        value=r["updates_per_sec"], unit="updates/s",
        vs_baseline=r["updates_per_sec"] / BASELINE_UPDATES_PER_SEC,
        ms_per_step=r["ms_per_step"], particles=r["num_particles"],
        beams=r["num_beams"], device=r["device"], card=r["card"])))


if __name__ == "__main__":
    main()
