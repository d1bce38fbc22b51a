"""The benchmark's harness: one run of one cell.

A cell (BENCHMARK.json `workloads`) names a configuration and a traffic
mix.  The harness finds everything by name:

  * the configuration's file, as BENCHMARK.json `configs` gives it
    (mclbench/configs/<config>.json: the filter's or SLAM's settings, the
    beam table, the map);
  * the traffic mix, mclbench/traffic/<traffic>.json: its parameters and
    the driver that reads them (mclbench/drivers/<driver>.py: `fleet` for
    the open-loop fleet server, `replay` for log replays, `slam` for log
    replays through RBPF SLAM, `closed_loop` for filters driving their
    robots);
  * each per-layer metric, mclbench/metrics/<metric>.py: a reader of the
    traced run's device operations, spans and counts.

So a later change adds a configuration, a mix or a metric by adding
files and entries, and edits no file that is here.

A run: set-up (the program loads, the logs are made from the seed, the
cell's shapes warm up), the measured window of --seconds, then the check
of what the window produced against the plain reference
(mclbench/reference, mclbench/compare.py) and the result line.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time

_IMPORTED_AT = time.perf_counter()
# Top-level module names the process must not hold once the window has
# closed: JAX and the JAX package (the measured program is its port).
FORBIDDEN = ("jax", "jaxlib", "flax", "montecarlolocalisation_tpu")


def process_age() -> float:
    """Seconds since this process started (Linux /proc), or since this
    module was imported where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared as whole names."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list
    per_layer: list


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(root: str, workload: str) -> Cell:
    """The cell `workload` of the manifest at `root`, with its
    configuration, its traffic mix and the metrics it reports."""
    manifest = _read_json(os.path.join(root, "BENCHMARK.json"))
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json "
                       f"(has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in manifest["configs"]}[w["config"]]
    config = _read_json(os.path.join(root, conf["file"]))
    traffic = _read_json(os.path.join(root, "mclbench", "traffic",
                                      w["traffic"] + ".json"))
    e2e = [m for m in manifest["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(name=workload, chips=int(w["chips"]), config=config,
                traffic=traffic, end_to_end=e2e, per_layer=per_layer)


def metric_reader(root: str, name: str):
    """The module of a per-layer metric, mclbench/metrics/<name>.py; its
    read(reading) returns the number, or None where it finds nothing to
    read."""
    path = os.path.join(root, "mclbench", "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mclbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"mclbench.drivers.{name}")


def run_cell(root: str, workload: str, seed: int, seconds: float,
             trace: bool, device: str = "cuda", program=None,
             out=None, err=None) -> dict:
    """One run of a cell; prints the check lines on `err` and the result
    line on `out`, and returns the result.  `program` replaces the port's
    entry (the control, a fault); None runs the port."""
    import torch

    from . import compare
    from .world import World

    out = out or sys.stdout
    err = err or sys.stderr
    cell = load_cell(root, workload)
    world = World(root, cell.config, device)
    run = driver(cell.traffic["driver"]).run(world, cell.traffic, seed,
                                             seconds, trace, program)
    setup_s = process_age() - (time.perf_counter() - run.window_start)
    cuda = world.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(world.device) if cuda else 0
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the process holds {', '.join(found)} after the "
                         f"window: the benchmark measures the port alone")
    run.free()
    if run.reading is not None:
        run.reading.settle()
    numbers = compare.check(world, run.units)
    limits = cell.traffic["limits"]
    checks = {k: dict(value=numbers[k], limit=limits[k]) for k in limits}
    correct = run.failed == 0 and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    dev = dict(platform="gpu" if cuda else world.device.type,
               kind=(torch.cuda.get_device_name(world.device) if cuda
                     else "cpu"),
               count=1, memory_peak_bytes=int(peak))
    if trace:
        values = {}
        for m in cell.per_layer:
            v = metric_reader(root, m["name"]).read(run.reading)
            if v is not None:
                values[m["name"]] = dict(value=float(v), unit=m["unit"])
        dev.update(busy_s=run.reading.busy_s, window_s=run.reading.window_s)
    else:
        values = {m["name"]: dict(value=float(run.metrics[m["name"]]),
                                  unit=m["unit"])
                  for m in cell.end_to_end if m["name"] != "setup_s"}
        values["setup_s"] = dict(value=setup_s, unit="s")
    result = dict(correct=bool(correct), attempted=int(run.attempted),
                  failed=int(run.failed), metrics=values, device=dev)
    if trace:
        result["breakdown"] = run.reading.breakdown()
    result["diagnostics"] = dict(numbers, **{
        k: v for k, v in run.metrics.items()
        if k not in {m["name"] for m in cell.end_to_end}})
    result["checks"] = checks
    for k, c in checks.items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=err)
    print(f"check failed requests = {run.failed} of {run.attempted} "
          f"(limit 0)", file=err)
    print(json.dumps(result), file=out, flush=True)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="mclbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = load_cell(root, args.workload)
    # Build caches of libraries the port may use, at fixed paths in the
    # checkout (the port's own kernels build into its build/ directory).
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(root, "mclbench_cache", sub)
    import torch

    if not torch.cuda.is_available():
        print("mclbench: no CUDA device (torch.cuda.is_available() is "
              "False): the benchmark measures the port on a card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"mclbench: the cell asks for {cell.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    run_cell(root, args.workload, args.seed, args.seconds,
             bool(args.trace))
    return 0
