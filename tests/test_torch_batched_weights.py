"""K1 batched and K4, the episode-batched beam weight kernels: their plain
versions (ops/weights.beam_weights_plain on [E, N, 3] and beamsub_plain)
against the JAX package's `beam_weights_pallas_batched` and
`beam_weights_pallas_beamsub` in interpret mode, at E = 3 episodes of
n in {200, 500, 600} particles (packed, packed, and unpacked with padding
in the TPU layout) x 12 beams, each episode with its own scan and a dead
mask lane.  The JAX row kernel runs its beam loop one beam at a time
(MCL_BEAM_UNROLL=1, the order the port sums in).

Tolerances are test_weights_pallas.py's: sum rtol 1e-5, log rtol 1e-4
(K1 batched: raw log-sums; K4: finished per episode, as its launcher
returns them), analytic > 99.9 % close (pixel-boundary ties shift a beam's
whole Gaussian)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import SensorModelConfig
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.ops.weights_pallas import (
    beam_weights_pallas_batched, beam_weights_pallas_beamsub,
)
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.ops import weights as tweights

from torch_parity import maps, t, uniform_particles

torch.set_num_threads(1)

E, BEAMS = 3, 12
TRUTH = [(1.25, 1.25, 0.0), (2.05, 3.3, 1.2), (3.7, 0.5, -2.0)]


def _fixture(n):
    jm, tm = maps()
    parts = np.stack([uniform_particles(jm, n, seed) for seed in range(E)])
    angles = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
    ranges = np.stack([np.asarray(jsensor.simulate_scan(
        jm, jnp.array(p), angles, SensorModelConfig()).ranges)
        for p in TRUTH])
    mask = np.ones((E, BEAMS), bool)
    mask[np.arange(E), [1, 5, 11]] = False
    tscan = tsensor.make_scan(angles, ranges, mask)
    return jm, tm, parts, angles, ranges, mask, tscan


def _check(got, want, cfg):
    rtol = 1e-4 if cfg.beam_combine == "log" else 1e-5
    close = np.isclose(got, want, rtol=rtol, atol=1e-6)
    if cfg.ray_mode == "analytic":
        assert close.mean() > 0.999
    else:
        assert close.all(), np.abs(got - want).max()


CASES = [(n, mode, comb) for n in (200, 500, 600)
         for mode in ("fixed", "analytic") for comb in ("sum", "log")]


@pytest.mark.parametrize("n,ray_mode,combine", CASES)
def test_k1_batched_plain_matches_jax_kernel(n, ray_mode, combine,
                                             monkeypatch):
    monkeypatch.setenv("MCL_BEAM_UNROLL", "1")
    jm, tm, parts, angles, ranges, mask, tscan = _fixture(n)
    jcfg = SensorModelConfig(ray_mode=ray_mode, beam_combine=combine)
    want = np.asarray(beam_weights_pallas_batched(
        jm, jnp.asarray(parts), angles, ranges, mask.astype(np.float32),
        jcfg, interpret=True))
    cfg = interop.config_from(jcfg)
    got = tweights.beam_weights_batched(tm, t(parts), tscan, cfg).numpy()
    assert got.shape == (E, n)
    _check(got, want, cfg)
    if combine == "sum":
        assert (got > 0).mean() > 0.3


@pytest.mark.parametrize("n,ray_mode,combine", CASES)
def test_k4_plain_matches_jax_kernel(n, ray_mode, combine):
    jm, tm, parts, angles, ranges, mask, tscan = _fixture(n)
    jcfg = SensorModelConfig(ray_mode=ray_mode, beam_combine=combine,
                             log_temperature=2.0)
    want = np.asarray(beam_weights_pallas_beamsub(
        jm, jnp.asarray(parts), angles, ranges, mask.astype(np.float32),
        jcfg, interpret=True))
    cfg = interop.config_from(jcfg)
    got = tweights.beam_weights_beamsub(tm, t(parts), tscan, cfg).numpy()
    assert got.shape == (E, n)
    _check(got, want, cfg)


@pytest.mark.parametrize("combine", ["sum", "log"])
def test_batched_plain_equals_each_episode_and_the_dense_path(combine):
    # The batched plain version is the single-filter one on each episode,
    # bit for bit; the dispatch on CPU tensors launches nothing and gives
    # the dense path's weights (log mode finished per episode).
    _, tm, parts, _, _, _, tscan = _fixture(256)
    cfg = interop.config_from(SensorModelConfig(beam_combine=combine))
    before = (tweights.beam_weights_batched_cuda.launches,
              tweights.beamsub_cuda.launches)
    got = tweights.beam_weights_batched(tm, t(parts), tscan, cfg)
    for e in range(E):
        one = tsensor.Scan(tscan.angles, tscan.ranges[e], tscan.mask[e])
        assert torch.equal(got[e], tweights.beam_weights(tm, t(parts[e]),
                                                         one, cfg))
    full = tsensor.beam_weights(tm, t(parts), tscan, cfg)
    dense = tsensor.beam_weights_dense(tm, t(parts), tscan, cfg)
    assert torch.equal(full, dense)
    if combine == "log":
        assert torch.equal(full, tsensor.finish_log_weights(
            tm, cfg, t(parts), got))
        assert torch.allclose(full.amax(-1), torch.ones(E))
    sub = tweights.beam_weights_beamsub(tm, t(parts), tscan, cfg)
    np.testing.assert_allclose(sub.numpy(), full.numpy(),
                               rtol=1e-4 if combine == "log" else 1e-5,
                               atol=1e-6)
    assert (tweights.beam_weights_batched_cuda.launches,
            tweights.beamsub_cuda.launches) == before
