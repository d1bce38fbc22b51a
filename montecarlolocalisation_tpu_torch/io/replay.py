"""Raw-log replay preprocessing: LaserScan episodes -> fixed beam tables.

Torch-port counterpart of montecarlolocalisation_tpu/io/replay.py: the
reference's inline scan filtering (monte_carlo.cpp:254-278, :610-620, the
every-20th subsample :650) over a whole recorded episode at once.  It is
sensor.filter_scan vectorised over ticks in numpy (the JAX package loads
its C++ batch filter instead), and gives what both of the JAX package's
paths give.  The [T, B] tables and mask feed models/filter.run_episode.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..config import SensorModelConfig


def preprocess_episode(
    raw_ranges: np.ndarray,       # [T, R] raw radii (NaN/Inf allowed)
    angle_min: float,
    angle_increment: float,
    range_min: float,
    range_max: float,
    cfg: SensorModelConfig = SensorModelConfig(),
    pad_to: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """[T, R] raw log -> (angles [T, B], radii [T, B], mask [T, B]).

    Per tick, as sensor.filter_scan: non-finite beams become
    cfg.invalid_beam_range at their nominal angle, finite beams outside
    [range_min, range_max] are dropped (which shifts the later beams'
    places in the subsample), beams strictly inside +-angle_crop_deg are
    kept, then every beam_skip-th; the kept beams fill the first lanes of
    `pad_to` (default: every beam surviving, ceil(R / beam_skip))."""
    raw = np.asarray(raw_ranges, dtype=np.float32).astype(np.float64)
    t, n = raw.shape
    if pad_to is None:
        pad_to = (n + cfg.beam_skip - 1) // cfg.beam_skip
    angles = angle_min + np.arange(n) * angle_increment          # [R]
    deg = angles * 180.0 / np.pi
    crop = (deg > -cfg.angle_crop_deg) & (deg < cfg.angle_crop_deg)
    bad = ~np.isfinite(raw)
    with np.errstate(invalid="ignore"):
        in_range = (raw >= range_min) & (raw <= range_max)
    survive = (bad | in_range) & crop                            # [T, R]
    place = np.cumsum(survive, axis=1) - 1    # index among the survivors
    keep = survive & (place % cfg.beam_skip == 0)
    lane = place // cfg.beam_skip
    if keep.any() and lane[keep].max() >= pad_to:
        raise ValueError(f"pad_to={pad_to} < {int(lane[keep].max()) + 1} "
                         "beams")
    rows, cols = np.nonzero(keep)
    out_a = np.zeros((t, pad_to), dtype=np.float32)
    out_r = np.zeros((t, pad_to), dtype=np.float32)
    mask = np.zeros((t, pad_to), dtype=bool)
    radii = np.where(bad, cfg.invalid_beam_range, raw)
    out_a[rows, lane[rows, cols]] = angles[cols]
    out_r[rows, lane[rows, cols]] = radii[rows, cols]
    mask[rows, lane[rows, cols]] = True
    return out_a, out_r, mask
