"""Command-line tools of the port, run with `python -m`.

The study tools (convergence_study, reloc_sweep, slam_sweep,
coverage_bound, explore_sweep, bench_fleet, bench_slam, bench_mapping,
slam_scale, bench_matrix) are the counterparts of the root tools/ scripts
of the same names: the same flags, defaults and output lines, plus
`--device` (default cuda).  Each runs on the card unless `--device cpu` is
passed, and raises where there is none."""
from __future__ import annotations

import time

import torch


def tool_device(name: str) -> torch.device:
    """The torch device a tool runs on: `name`, which must be there; a
    CUDA device on a machine without a card raises (no CPU fallback)."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"--device {name}: this tool runs on a CUDA card and "
            f"torch.cuda.is_available() is False; pass --device cpu to run "
            f"it on the CPU")
    return dev


def device_name(dev: torch.device) -> str:
    """The card's name, or the torch device's for the CPU."""
    return (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))


def sync(dev: torch.device) -> None:
    """Wait for the work queued on `dev` (nothing to wait for on the
    CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_s(dev: torch.device, fn):
    """(fn(), seconds): CUDA events around the call on a card (its device
    timeline, the call's own host work included), the host clock on the
    CPU."""
    if dev.type != "cuda":
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / 1e3
