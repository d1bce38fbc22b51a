"""The benchmark matrix: the counterpart of the root tools/bench_matrix.py.

Runs the JAX tool's eight configurations (the reference's fixed march,
the exact analytic caster, 360 beams, 4M particles, the log combine,
multinomial resampling) through the port's bench
(`python -m montecarlolocalisation_tpu_torch.bench`), each in a process of
its own, prints each result line as it comes, then the table.  It writes
no file: the JAX tool rewrites BENCH_DETAILS.md, the TPU's record.

  python -m montecarlolocalisation_tpu_torch.tools.bench_matrix
"""
from __future__ import annotations

import argparse
import os.path as osp
import subprocess
import sys
import time

from . import tool_device

ROOT = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

CONFIGS = [
    ("reference semantics, 1M x 34 (headline)", ["--particles", "1000000", "--beams", "34", "--iters", "30"]),
    ("reference semantics, 1M x 12", ["--particles", "1000000", "--beams", "12", "--iters", "30"]),
    ("exact analytic ray cast, 1M x 34", ["--particles", "1000000", "--beams", "34", "--iters", "30", "--ray-mode", "analytic"]),
    ("scaling: 4M x 34", ["--particles", "4000000", "--beams", "34", "--iters", "10"]),
    ("full fidelity: 10k x 360 analytic", ["--particles", "10000", "--beams", "360", "--iters", "30", "--ray-mode", "analytic"]),
    ("reference-count replay: 1500 x 34", ["--particles", "1500", "--beams", "34", "--iters", "50"]),
    ("log-combine, 1M x 34", ["--particles", "1000000", "--beams", "34", "--iters", "30", "--beam-combine", "log"]),
    ("multinomial (parity path), 1M x 34", ["--particles", "1000000", "--beams", "34", "--iters", "10", "--resample", "multinomial"]),
]


def run_config(args: list, device: str, timeout: float = 1200):
    """One configuration through the port's bench in a process of its
    own: (its last output line, or FAILED with the end of its errors;
    seconds)."""
    t0 = time.time()
    out = subprocess.run(
        [sys.executable, "-m", "montecarlolocalisation_tpu_torch.bench",
         *args, "--device", device],
        capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    line = (out.stdout.strip().splitlines()[-1]
            if out.returncode == 0 and out.stdout.strip()
            else f"FAILED: {out.stderr[-200:]}")
    return line, round(time.time() - t0, 1)


def table(rows) -> str:
    """The JAX tool's markdown table of (name, args, line, wall) rows."""
    out = ["| Config | Args | Result | Wall (s, incl. compile) |",
           "|---|---|---|---|"]
    out += [f"| {name} | `{args}` | `{line}` | {wall} |"
            for name, args, line, wall in rows]
    return "\n".join(out)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.bench_matrix")
    ap.add_argument("--device", default="cuda",
                    help="torch device the bench runs on")
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    tool_device(args.device)
    rows = []
    for name, cargs in CONFIGS:
        line, wall = run_config(cargs, args.device)
        rows.append((name, " ".join(cargs), line, wall))
        print(f"{name}: {line}", flush=True)
    print(table(rows), flush=True)


if __name__ == "__main__":
    main()
