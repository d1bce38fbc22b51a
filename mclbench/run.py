"""Run one cell of the benchmark once and print its result line.

    python3 -m mclbench.run --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  See mclbench/README.md.
"""
from __future__ import annotations

import sys

from mclbench import harness

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:]))
