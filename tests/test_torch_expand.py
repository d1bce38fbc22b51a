"""K2's plain version (ops/expand) vs the JAX package's Pallas expansion
`systematic_expand(..., interpret=True)` and its XLA path, given the cdf
and u0 JAX computed: bit-exact (it is a copy)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.models.resample import (
    offspring_counts as j_offspring_counts, systematic_indices,
)
from montecarlolocalisation_tpu.ops.expand_pallas import systematic_expand
from montecarlolocalisation_tpu_torch.models import resample as tresample
from montecarlolocalisation_tpu_torch.ops import expand as texpand

from torch_parity import t

torch.set_num_threads(1)


def _case(n, skew, seed, d=3):
    rng = np.random.default_rng(seed)
    w = rng.uniform(size=n) ** skew if skew else np.ones(n)
    cdf = np.asarray(jnp.cumsum(jnp.asarray(w / w.sum(), jnp.float32)))
    parts = rng.normal(size=(n, d)).astype(np.float32)
    return parts, cdf


@pytest.mark.parametrize("n,skew,seed,u0", [
    (2048, 0, 0, 0.625),
    (4096, 12, 2, 0.1),     # heavy skew: long repeats + long skips
    (1500, 4, 3, 0.9),      # not a multiple of 256
    (257, 2, 4, 0.5),
    (1, 0, 5, 0.3),
    (1000, 1, 6, 0.99),
])
def test_expand_matches_jax_bit_exact(n, skew, seed, u0):
    parts, cdf = _case(n, skew, seed)
    u0 = np.float32(u0)
    want_kernel = np.asarray(systematic_expand(
        jnp.asarray(parts), jnp.asarray(cdf), u0, interpret=True))
    want_xla = np.asarray(jnp.asarray(parts)[systematic_indices(
        jnp.asarray(cdf), u0)])
    got = texpand.systematic_expand(t(parts), t(cdf), t(u0)).numpy()
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(
        tresample.systematic_indices(t(cdf), t(u0)).numpy(),
        np.asarray(systematic_indices(jnp.asarray(cdf), u0)))


def test_short_cdf_copies_last_source_like_xla_path():
    # A cdf summing a few ulps short of 1 leaves the last outputs without
    # an interval; the scatter+cummax path gives them the last source with
    # offspring.
    n = 64
    cdf = np.linspace(1.0 / n, 1.0, n).astype(np.float32) * np.float32(0.97)
    parts = np.arange(3 * n, dtype=np.float32).reshape(n, 3)
    u0 = np.float32(0.5)
    want = np.asarray(jnp.asarray(parts)[systematic_indices(
        jnp.asarray(cdf), u0)])
    got = texpand.systematic_expand(t(parts), t(cdf), t(u0)).numpy()
    np.testing.assert_array_equal(got, want)


def test_offspring_counts_match_monotone_and_total():
    _, cdf = _case(4096, 6, 7)
    u0 = np.float32(0.25)
    c = texpand.offspring_counts(t(cdf), t(u0)).numpy()
    np.testing.assert_array_equal(
        c, np.asarray(j_offspring_counts(jnp.asarray(cdf), u0)))
    assert (np.diff(c) >= 0).all()
    assert c[-1] == 4096


def test_one_particle_takes_all():
    n = 2048
    w = np.zeros(n, np.float32)
    w[777] = 1.0
    parts = np.stack([np.arange(n, dtype=np.float32)] * 3, -1)
    got = texpand.systematic_expand(t(parts), t(np.cumsum(w)), t(0.5))
    assert bool((got == 777.0).all())


def _batch(n_ep, n, seed):
    cases = [_case(n, 1 + e % 7, seed + e) for e in range(n_ep)]
    parts = np.stack([c[0] for c in cases])
    cdf = np.stack([c[1] for c in cases])
    u0 = np.random.default_rng(seed).uniform(size=n_ep).astype(np.float32)
    return parts, cdf, u0


@pytest.mark.parametrize("n_ep,n", [(5, 500), (3, 1500), (4, 1)])
def test_batched_expansion_equals_each_episode_bit_exact(n_ep, n):
    parts, cdf, u0 = _batch(n_ep, n, 30)
    got = texpand.systematic_expand(t(parts), t(cdf), t(u0))
    assert got.shape == (n_ep, n, 3)
    before = texpand.systematic_expand_batched_cuda.launches
    for e in range(n_ep):
        assert torch.equal(got[e], texpand.systematic_expand(
            t(parts[e]), t(cdf[e]), t(u0[e])))
    assert texpand.systematic_expand_batched_cuda.launches == before


def test_batched_expansion_matches_jax_onehot_bit_exact():
    # The JAX package's batched systematic expansion under vmap
    # (resample.py:284 _expand_onehot_batched) and its per-episode XLA path.
    from montecarlolocalisation_tpu.models.resample import (
        _expand_onehot_batched,
    )

    parts, cdf, u0 = _batch(6, 500, 40)
    want = np.asarray(_expand_onehot_batched(jnp.asarray(parts),
                                             jnp.asarray(cdf),
                                             jnp.asarray(u0)))
    got = texpand.systematic_expand(t(parts), t(cdf), t(u0)).numpy()
    np.testing.assert_array_equal(got, want)
    for e in range(6):
        np.testing.assert_array_equal(got[e], np.asarray(
            jnp.asarray(parts[e])[systematic_indices(jnp.asarray(cdf[e]),
                                                     u0[e])]))
