"""models/diagnostics.py against the JAX package's, on the inputs of
tests/test_diagnostics.py and on random ones: the weighted-mean pose and
the density and max-weight ratios within float32 rounding (atol 1e-5),
the max-weight particle and the Bresenham line of sight exactly."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.models import diagnostics as jdiag
from montecarlolocalisation_tpu_torch.models import diagnostics as tdiag

from torch_parity import maps, t

torch.set_num_threads(1)


def _clouds():
    key = jax.random.PRNGKey(0)
    tight = 0.05 * jax.random.normal(key, (800, 2)) + 2.0
    diffuse = jax.random.uniform(key, (800, 2), minval=0.0, maxval=4.8)
    rng = np.random.default_rng(3)
    rand = rng.uniform(0, 4.8, (1500, 3)).astype(np.float32)
    return [np.concatenate([np.asarray(c), np.zeros((800, 1), np.float32)],
                           axis=-1) for c in (tight, diffuse)] + [rand]


def test_weighted_mean_pose():
    cases = [(np.float32([[1.0, 2.0, 0.0], [3.0, 4.0, np.pi / 2]]),
              np.float32([1.0, 3.0]))]
    rng = np.random.default_rng(1)
    cases.append((rng.uniform(-3, 3, (257, 3)).astype(np.float32),
                  rng.uniform(0, 1, 257).astype(np.float32)))
    cases.append((cases[-1][0], np.zeros(257, np.float32)))
    for parts, w in cases:
        got = tdiag.weighted_mean_pose(t(parts), t(w)).numpy()
        want = np.asarray(jdiag.weighted_mean_pose(jnp.asarray(parts),
                                                   jnp.asarray(w)))
        np.testing.assert_allclose(got, want, atol=1e-5)
    got = tdiag.weighted_mean_pose(t(cases[0][0]), t(cases[0][1])).numpy()
    assert got[:2] == pytest.approx([2.5, 3.5])


@pytest.mark.parametrize("block", [1024, 100])
def test_pairwise_density_ratio(block):
    tight, diffuse, rand = _clouds()
    for parts in (tight, diffuse, rand):
        got = float(tdiag.pairwise_density_ratio(t(parts), block=block))
        want = float(jdiag.pairwise_density_ratio(jnp.asarray(parts),
                                                  block=block))
        assert got == pytest.approx(want, abs=1e-5)
    assert float(tdiag.pairwise_density_ratio(t(tight))) > 0.9
    assert float(tdiag.pairwise_density_ratio(t(diffuse))) < 0.3


def test_max_weight_confidence():
    parts = np.concatenate([np.full((90, 3), 1.0), np.full((10, 3), 4.0)]
                           ).astype(np.float32)
    w = np.zeros(100, np.float32)
    w[95] = 5.0
    rng = np.random.default_rng(2)
    rparts = rng.uniform(0, 4.8, (700, 3)).astype(np.float32)
    rw = rng.uniform(0, 1, 700).astype(np.float32)
    for p, ww in ((parts, w), (rparts, rw)):
        ratio, best = tdiag.max_weight_confidence(t(p), t(ww))
        jr, jb = jdiag.max_weight_confidence(jnp.asarray(p), jnp.asarray(ww))
        assert float(ratio) == pytest.approx(float(jr), abs=1e-6)
        np.testing.assert_array_equal(best.numpy(), np.asarray(jb))
    assert float(tdiag.max_weight_confidence(t(parts), t(w))[0]) == \
        pytest.approx(0.1)


def test_bresenham_line_of_sight():
    jm, tm = maps()
    cases = [(1.85, 2.05, 2.25, 2.05), (0.45, 0.45, -0.2, 0.45),
             (1.25, 1.25, 2.05, 1.25)]
    for case in cases:
        assert bool(tdiag.bresenham_path_valid(tm, *case)) == bool(
            jdiag.bresenham_path_valid(jm, *case))
    assert [bool(tdiag.bresenham_path_valid(tm, *c)) for c in cases] == [
        True, False, False]
    rng = np.random.default_rng(4)
    ends = rng.uniform(-0.3, 5.2, (4, 512)).astype(np.float32)
    got = tdiag.bresenham_path_valid(tm, *(t(e) for e in ends))
    want = jdiag.bresenham_path_valid(jm, *(jnp.asarray(e) for e in ends))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    short = tdiag.bresenham_path_valid(tm, t(ends[0]), t(ends[1]),
                                       t(ends[2]), t(ends[3]), max_steps=8)
    np.testing.assert_array_equal(short.numpy(), np.asarray(
        jdiag.bresenham_path_valid(jm, *(jnp.asarray(e) for e in ends),
                                   max_steps=8)))
