"""Benchmark of the port: particle-beam updates/s of the full filter tick on
one CUDA card.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
The metric and the flags below are those of the JAX package's root
bench.py (without its --verbose and stall-retry flags, which serve its
remote TPU runtime): the complete tick (hysteresis, motion, beam weights,
adaptive-injection resampling, k-means confidence) at --particles x
--beams, float32, by default 1M x 34 with the closed-form caster and
systematic resampling, every tick fed the same encoders and scan.

--scan-chunk K runs K full ticks a dispatch, as the JAX bench's lax.scan
does (bench.py:73-88): one replay of a CUDA graph of K mcl_step calls
(models/compiled), default 8; 1 is the serving form, one dispatch a tick.
--ess T is the ESS-gated resampling schedule at threshold T
(ResampleConfig.ess_threshold): the carried weights resample only when
the effective sample size falls below T x N; by default every tick
resamples, the reference schedule.  One warm-up dispatch builds the
kernels and captures the graph; then --iters dispatches are timed with
CUDA events, and the rate counts iters x K ticks.  vs_baseline is against
the reference's implied ceiling, 1500 particles x 34 beams x 10 Hz on a
Raspberry Pi 4 (BASELINE.md).

--device cpu runs the same ticks eagerly on the CPU, timed with the host
clock (the study tools' bench_matrix passes it through); its numbers are
the CPU's, never the card's.

Usage: python -m montecarlolocalisation_tpu_torch.bench [--particles N]
       [--beams B] [--iters I] [--ray-mode M] [--resample R]
       [--beam-combine C] [--scan-chunk K] [--ess T] [--device D]
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from .config import FilterConfig, ResampleConfig, SensorModelConfig

BASELINE_UPDATES_PER_SEC = 1500 * 34 * 10.0


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip()


def filter_config(args: argparse.Namespace) -> FilterConfig:
    """The filter the bench ticks: the JAX bench's FilterConfig
    (bench.py:60-65) from the parsed flags."""
    return FilterConfig(
        num_particles=args.particles,
        sensor=SensorModelConfig(ray_mode=args.ray_mode,
                                 beam_combine=args.beam_combine),
        resample=ResampleConfig(method=args.resample,
                                ess_threshold=args.ess))


def bench_full_step(cfg: FilterConfig, num_beams: int, iters: int,
                    scan_chunk: int = 8, device="cuda") -> dict:
    """Time `iters` dispatches of `scan_chunk` ticks of `cfg` at
    `num_beams` beams on `device` (module docstring): CUDA events on a
    card; on the CPU, where the ticks run eagerly, the host clock."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the port's bench measures a CUDA card; "
                           "torch.cuda.is_available() is False")
    from . import presets
    from .models import filter as mcl
    from .models import sensor

    world = presets.make_world(num_beams=num_beams, device=dev)
    m = world.maze
    state = mcl.init_state(m, cfg, seed=0)
    scan = sensor.simulate_scan(m, [1.25, 1.25, 0.0], world.angles,
                                cfg.sensor)
    enc = torch.full((scan_chunk, 2), 0.1, device=dev)
    ranges = scan.ranges.expand(scan_chunk, num_beams)
    mask = torch.ones((scan_chunk, num_beams), dtype=torch.bool, device=dev)

    def dispatch(st):
        return mcl.run_ticks(st, enc, ranges, mask, scan.angles, m, cfg)[0]

    state = dispatch(state)   # warm-up: builds the kernels and captures
    if dev.type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            state = dispatch(state)
        end.record()
        torch.cuda.synchronize()
        ms_dispatch = start.elapsed_time(end) / iters
    else:
        t0 = time.perf_counter()
        for _ in range(iters):
            state = dispatch(state)
        ms_dispatch = 1e3 * (time.perf_counter() - t0) / iters
    steps_per_sec = 1e3 * scan_chunk / ms_dispatch
    cuda = dev.type == "cuda"
    return dict(steps_per_sec=steps_per_sec,
                updates_per_sec=steps_per_sec * cfg.num_particles
                * num_beams,
                ms_per_step=ms_dispatch / scan_chunk,
                ms_per_dispatch=ms_dispatch,
                num_particles=cfg.num_particles, num_beams=num_beams,
                device=torch.cuda.get_device_name(dev) if cuda else str(dev),
                card=card() if cuda else None)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="montecarlolocalisation_tpu_torch.bench")
    ap.add_argument("--particles", type=int, default=1_000_000)
    ap.add_argument("--beams", type=int, default=34)
    ap.add_argument("--iters", type=int, default=20,
                    help="timed dispatches (each runs --scan-chunk ticks)")
    ap.add_argument("--ray-mode", default="analytic",
                    choices=["fixed", "dda", "analytic"])
    ap.add_argument("--resample", default="systematic",
                    choices=["systematic", "multinomial"])
    ap.add_argument("--beam-combine", default="sum", choices=["sum", "log"])
    ap.add_argument("--scan-chunk", type=int, default=8,
                    help="full ticks a dispatch, one CUDA graph replay "
                         "(the JAX bench's lax.scan); 1 = one dispatch a "
                         "tick, the online-serving form")
    ap.add_argument("--ess", type=float, default=None,
                    help="ESS-gated resampling threshold (e.g. 0.5): carry "
                         "the weights and resample only when ESS < ess * N "
                         "(the production schedule).  Default: resample "
                         "every tick, the reference schedule")
    ap.add_argument("--device", default="cuda",
                    help="torch device the bench runs on; the CPU runs the "
                         "ticks eagerly and times them with the host clock")
    args = ap.parse_args(argv)
    for name in ("particles", "beams", "iters", "scan_chunk"):
        if getattr(args, name) < 1:
            ap.error(f"--{name.replace('_', '-')} must be >= 1")
    return args


def main(argv=None) -> None:
    args = parse_args(argv)
    r = bench_full_step(filter_config(args), args.beams, args.iters,
                        scan_chunk=args.scan_chunk, device=args.device)
    print(json.dumps(dict(
        # A CPU run's rate is the CPU's: it never takes the card's name.
        metric="particle_beam_updates_per_sec_full_mcl_step"
        + ("" if r["card"] else "_cpu"),
        value=r["updates_per_sec"], unit="updates/s",
        vs_baseline=r["updates_per_sec"] / BASELINE_UPDATES_PER_SEC,
        ms_per_step=r["ms_per_step"], particles=r["num_particles"],
        beams=r["num_beams"], scan_chunk=args.scan_chunk, ess=args.ess,
        device=r["device"], card=r["card"])))


if __name__ == "__main__":
    main()
