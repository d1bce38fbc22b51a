"""io/replay.preprocess_episode against the JAX package's, on the raw
logs of tests/test_io_timed.py (NaN and Inf beams, a beam past
range_max, crop and skip), through both of its paths: the NumPy path
(sensor.filter_scan tick by tick) exactly, and the native C++ batch
filter within 1e-6 on the angles and radii (the JAX suite's own
tolerance between its two paths; the C++ filter adds angles in float32)
with the masks equal.  Then the shipped fixture
(montecarlolocalisation_tpu/data/replay_6x6.npz, read by path) replayed by
16 replicas for 60 ticks, and a raw log through the filter."""
import math
import os.path as osp

import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.io import replay as jreplay
from montecarlolocalisation_tpu_torch import interop, presets
from montecarlolocalisation_tpu_torch.config import (
    FilterConfig, SensorModelConfig,
)
from montecarlolocalisation_tpu_torch.io import replay as treplay
from montecarlolocalisation_tpu_torch.io.logs import EpisodeLog
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.parallel import episodes as tepisodes

torch.set_num_threads(1)

FIXTURE = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                   "montecarlolocalisation_tpu", "data", "replay_6x6.npz")
AM, INC = math.radians(-135), math.radians(0.352)


def _log(case):
    """The raw logs of test_io_timed.py: (raw [T, 726], range_min,
    range_max)."""
    if case == "faults":
        rng = np.random.default_rng(0)
        raw = rng.uniform(0.1, 4.0, (5, 726)).astype(np.float32)
        raw[0, 5] = np.nan
        raw[1, 7] = np.inf
        raw[2, 9] = 99.0
        raw[3, 100:140] = 0.05            # a run below range_min
        raw[4, 300] = -np.inf
        return raw, 0.1, 5.0
    rng = np.random.default_rng(1)
    return rng.uniform(0.2, 0.9, (4, 726)).astype(np.float32), 0.02, 5.6


@pytest.mark.parametrize("case", ["faults", "feeds_filter"])
@pytest.mark.parametrize("path", ["numpy", "native"])
def test_preprocess_equals_jax(monkeypatch, case, path):
    raw, lo, hi = _log(case)
    if path == "numpy":
        monkeypatch.setattr(jreplay, "load_native", lambda: None)
    else:
        assert jreplay.load_native() is not None
    want = jreplay.preprocess_episode(raw, AM, INC, lo, hi)
    got = treplay.preprocess_episode(raw, AM, INC, lo, hi)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
    np.testing.assert_array_equal(got[2], want[2])
    if path == "numpy":
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(got[0], want[0], atol=1e-6)
        np.testing.assert_allclose(got[1], want[1], atol=1e-6)


def test_preprocess_pad_and_config(monkeypatch):
    raw, lo, hi = _log("faults")
    monkeypatch.setattr(jreplay, "load_native", lambda: None)
    cfg = SensorModelConfig(beam_skip=7, angle_crop_deg=90.0,
                            invalid_beam_range=2.5)
    want = jreplay.preprocess_episode(raw, AM, INC, lo, hi, cfg, pad_to=80)
    got = treplay.preprocess_episode(raw, AM, INC, lo, hi,
                                     interop.config_from(cfg), pad_to=80)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError, match="pad_to"):
        treplay.preprocess_episode(raw, AM, INC, lo, hi, pad_to=3)


def test_raw_log_feeds_the_filter():
    raw, lo, hi = _log("feeds_filter")
    angles, radii, mask = treplay.preprocess_episode(raw, AM, INC, lo, hi)
    world = presets.make_world(num_particles=64, device="cpu")
    rng = np.random.default_rng(1)
    enc = np.cumsum(rng.uniform(0, 0.2, (4, 2)), axis=0).astype(np.float32)
    st = tfilter.init_state(world.maze, world.cfg, seed=0)
    final, outs = tfilter.run_episode(st, enc, radii, angles, world.maze,
                                      world.cfg, scan_mask=mask)
    assert torch.isfinite(final.particles).all()
    assert outs.confidence.shape == (4,)


def test_fixture_replay_by_replicas_stays_finite():
    log = EpisodeLog.load(FIXTURE)
    assert log.scan_ranges.shape == (240, 36)
    ticks, reps = 60, 16
    world = presets.make_world(device="cpu")
    cfg = FilterConfig(num_particles=128,
                       sensor=SensorModelConfig(ray_mode="dda"))
    final, outs, info = tepisodes.run_episode_replicas(
        2, world.maze, cfg, log.encoders[None, :ticks],
        log.scan_ranges[None, :ticks], log.scan_angles, replicas=reps)
    assert final.particles.shape == (1, 128, 3)
    assert info["log_evidence"].shape == (reps, 1)
    assert torch.isfinite(final.particles).all()
    assert torch.isfinite(outs.total_weight).all()
