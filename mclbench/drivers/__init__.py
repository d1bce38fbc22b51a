"""The general drivers a traffic mix names: `fleet` (an open-loop fleet
server), `replay` (log replays through an episode entry), `slam` (log
replays through RBPF SLAM over episodes and replicas) and `closed_loop`
(filters driving their robots through a plan)."""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable


@dataclasses.dataclass
class Run:
    """What a driver hands the harness: the window's start (host clock),
    the end-to-end numbers, the requests attempted and failed, the check
    units (compare.Unit), the traced run's reading, and a function that
    frees the program's state before the reference runs."""

    window_start: float
    metrics: dict
    attempted: int
    failed: int
    units: list
    reading: object = None
    free: Callable[[], None] = lambda: None


def sleep_until(t: float) -> None:
    """Sleep, then spin, until the host clock reads t."""
    while True:
        left = t - time.perf_counter()
        if left <= 0:
            return
        if left > 0.002:
            time.sleep(left - 0.001)


def nearest_rank(values, q: float) -> float:
    """The q-quantile by nearest rank: the value with ceil(q * n) values at
    or below it."""
    v = sorted(values)
    return v[max(0, math.ceil(q * len(v)) - 1)]


def pick(seed_values, n: int, lo: int, hi: int) -> list:
    """n distinct integers in [lo, hi) from a seeded numpy generator."""
    import numpy as np

    rng = np.random.default_rng(seed_values)
    hi = max(hi, lo + 1)
    k = min(n, hi - lo)
    return sorted(int(v) for v in rng.choice(np.arange(lo, hi), k,
                                             replace=False))
