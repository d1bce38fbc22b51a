"""K2's plain version (ops/expand) vs the JAX package's Pallas expansion
`systematic_expand(..., interpret=True)` and its XLA path, given the cdf
and u0 JAX computed: bit-exact (it is a copy).  The plain version takes
the cdf and u0, as K2 does, and computes the offspring counts and their
cummax guard itself."""
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


# -- the cdf's hard cases, each against both JAX paths ----------------------

def _count(x, n, u0):
    """The offspring count of cdf values x (float32), as both packages
    compute it."""
    x = np.asarray(x, np.float32)
    v = np.floor(np.float32(n) * x - np.float32(u0)).astype(np.int64) + 1
    return np.clip(v, 0, n)


def _count_edge(x, n, u0):
    """The smallest float32 y <= x with x's count: the float at which the
    count steps up (x >= 0, a scalar)."""
    want = _count(x, n, u0)
    lo, hi = 0, int(np.float32(x).view(np.int32))
    while lo < hi:
        mid = (lo + hi) // 2
        if _count(np.int32(mid).view(np.float32), n, u0) == want:
            hi = mid
        else:
            lo = mid + 1
    return np.int32(lo).view(np.float32)


def _glitch(cdf, u0, rng, every=100):
    """A cdf one ulp non-monotone at about one position in `every`: where
    the count steps up at i, cdf[i] is moved down to the float where it
    steps, and cdf[i + 1] to one ulp below that, so count(i + 1) <
    count(i) until the cummax guard lifts it."""
    cdf = cdf.copy()
    n = cdf.shape[-1]
    for i in sorted(rng.choice(n - 1, max(1, n // every), replace=False)):
        c = _count(cdf[max(i - 1, 0): i + 1], n, u0)
        if c[-1] < 1 or (i > 0 and c[0] >= c[-1]) or (
                i > 0 and cdf[i - 1] > cdf[i]):
            continue
        edge = _count_edge(cdf[i], n, u0)
        cdf[i] = edge
        cdf[i + 1] = np.nextafter(edge, np.float32(0))
    return cdf


def _cdf_case(kind, n, u0, rng):
    """One of the hard cases: a cdf [n] for offset u0."""
    if kind == "glitched":
        cdf = _glitch(_case(n, 2, int(rng.integers(1 << 30)))[1], u0, rng)
        assert (np.diff(_count(cdf, n, u0)) < 0).any()
        return cdf
    if kind == "overshoot":
        # A few ulps past 1 on the last sources: their counts clip to n.
        cdf = _case(n, 1, int(rng.integers(1 << 30)))[1].copy()
        tail = min(n, 8)
        cdf[-tail:] = np.float32(1.0) + np.arange(
            1, tail + 1, dtype=np.float32) * np.float32(2 ** -23)
        return cdf
    if kind == "on_integers":
        # n a power of two: n * cdf - u0 is an exact integer everywhere, so
        # every threshold (k + u0)/n ties with a cdf value.
        m = np.sort(rng.integers(0, n, n))
        m[-1] = n - 1
        return ((m + np.float32(u0)) / np.float32(n)).astype(np.float32)
    if kind == "one_source":
        cdf = np.zeros(n, np.float32)
        cdf[n // 3:] = 1.0
        return cdf
    if kind == "zero_run":
        w = rng.uniform(size=n)
        w[n // 5: 4 * n // 5] = 0.0       # 60 % of the sources in one run
        return np.cumsum(w / w.sum()).astype(np.float32)
    raise ValueError(kind)


@pytest.mark.parametrize("kind,n,u0", [
    ("glitched", 2048, 0.5),
    ("glitched", 1500, 0.99999994),
    ("overshoot", 1000, 0.5),
    ("overshoot", 2048, 0.0),
    ("on_integers", 1024, 0.0),
    ("on_integers", 2048, 0.5),
    ("on_integers", 256, 0.25),
    ("one_source", 1500, 0.5),
    ("one_source", 999, 0.0),
    ("zero_run", 2000, 0.3),
    ("zero_run", 4096, 0.99999994),
])
def test_hard_cdfs_match_jax_bit_exact(kind, n, u0):
    rng = np.random.default_rng(n + int(1e6 * u0))
    u0 = np.float32(u0)
    cdf = _cdf_case(kind, n, u0, rng)
    parts = np.stack([np.arange(n, dtype=np.float32),
                      rng.normal(size=n).astype(np.float32),
                      rng.normal(size=n).astype(np.float32)], -1)
    want_kernel = np.asarray(systematic_expand(
        jnp.asarray(parts), jnp.asarray(cdf), u0, interpret=True))
    idx = np.asarray(systematic_indices(jnp.asarray(cdf), u0))
    got = texpand.systematic_expand(t(parts), t(cdf), t(u0)).numpy()
    np.testing.assert_array_equal(got, parts[idx])
    np.testing.assert_array_equal(got, want_kernel)
    np.testing.assert_array_equal(
        texpand.offspring_counts(t(cdf), t(u0)).numpy(),
        np.asarray(j_offspring_counts(jnp.asarray(cdf), u0)))
    if kind == "one_source":
        # Source n // 3 owns every output; at u0 = 0 output 0 draws
        # lower_bound(cdf, 0) = 0.
        owner = np.full(n, n // 3)
        owner[0] = 0 if u0 == 0 else n // 3
        np.testing.assert_array_equal(got[:, 0], owner)


def test_batch_of_glitched_episodes_equals_each_alone():
    # Each episode carries its own glitches and offset.
    n_ep, n = 6, 1024
    rng = np.random.default_rng(50)
    u0 = rng.uniform(size=n_ep).astype(np.float32)
    u0[0] = 0.0
    cdf = np.stack([_glitch(_case(n, e % 4, 60 + e)[1], u0[e], rng, 50)
                    for e in range(n_ep)])
    parts = rng.normal(size=(n_ep, n, 3)).astype(np.float32)
    got = texpand.systematic_expand(t(parts), t(cdf), t(u0)).numpy()
    for e in range(n_ep):
        alone = texpand.systematic_expand(t(parts[e]), t(cdf[e]),
                                          t(u0[e])).numpy()
        np.testing.assert_array_equal(got[e], alone)
        np.testing.assert_array_equal(got[e], parts[e][np.asarray(
            systematic_indices(jnp.asarray(cdf[e]), u0[e]))])


@pytest.mark.parametrize("n,episodes,one_block,tiles", [
    (1, 1, True, 0),
    (500, 1024, True, 0),
    (texpand.SMALL_N, 1, True, 0),
    (texpand.SMALL_N + 1, 63, False, 3),
    (texpand.SMALL_N + 1, 64, False, 3),
    (texpand.SMALL_N, 1024, True, 0),
    (16_384, 1, False, 4),
    (16_385, 1024, False, 5),
    (1_048_576, 1, False, 256),
    (4_194_304, 1, False, 1024),
    (4_194_305, 2, False, 1025),
    (65_536, 8, False, 16),
])
def test_launch_plan(n, episodes, one_block, tiles):
    # One block an episode up to SMALL_N sources whatever the batch; past
    # it, scratch for the counts and one maximum each SCAN_CHUNK sources
    # (the most tiles the kernel can choose).
    plan = texpand.launch_plan(n, episodes)
    assert plan.one_block == one_block
    assert plan.device_launches == (1 if one_block else 2)
    assert plan.scratch_ints == (0 if one_block
                                 else episodes * (n + tiles))


@pytest.mark.parametrize("lead,n", [((), 1000), ((4,), 1000), ((4,), 9000)])
def test_strided_cdf_and_scalar_u0_equal_contiguous(lead, n):
    # The dispatcher takes a cdf that is a view with a stride and a scalar
    # u0 that it broadcasts to the batch.
    rng = np.random.default_rng(70 + n)
    cdf = np.stack([_case(n, 4, 80 + e)[1]
                    for e in range(int(np.prod(lead)))]).reshape(*lead, n)
    wide = np.stack([cdf, np.zeros_like(cdf)], -1)
    parts = rng.normal(size=(*lead, n, 3)).astype(np.float32)
    strided = t(wide)[..., 0]
    assert not strided.is_contiguous()
    got = texpand.systematic_expand(t(parts), strided, torch.tensor(0.5))
    want = texpand.systematic_expand(t(parts), t(cdf),
                                     torch.full(lead, 0.5))
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    for e in range(int(np.prod(lead))):
        np.testing.assert_array_equal(
            got.reshape(-1, n, 3)[e].numpy(),
            parts.reshape(-1, n, 3)[e][np.asarray(systematic_indices(
                jnp.asarray(cdf.reshape(-1, n)[e]), np.float32(0.5)))])
