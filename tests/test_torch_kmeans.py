"""K3's plain version (ops/kmeans) vs the JAX package: its dense path
`_kmeans_dense` (the rule, early-exit latch included) and its Pallas kernel
`kmeans_pallas(..., interpret=True)` on clouds where the latch cannot
matter.  Same centers0/reseed; centers within 1e-4 and > 99.9 % of
assignments equal (partial sums reassociate, so boundary particles may
flip)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import ClusterConfig
from montecarlolocalisation_tpu.models import cluster as jcluster
from montecarlolocalisation_tpu.ops.kmeans_pallas import kmeans_pallas
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.models import cluster as tcluster
from montecarlolocalisation_tpu_torch.ops import kmeans as tkmeans

from torch_parity import jax_kmeans_indices, t

torch.set_num_threads(1)


def _mixture(seed, n=6000):
    """Three well-separated blobs + uniform background."""
    rng = np.random.default_rng(seed)
    blobs = [c + 0.15 * rng.normal(size=(n // 3, 2))
             for c in ([1.0, 1.0], [4.0, 1.5], [2.5, 4.0])]
    bg = rng.uniform(size=(n - 3 * (n // 3), 2)) * 5.0
    return np.concatenate(blobs + [bg]).astype(np.float32)


def _inputs(seed, xy):
    cfg = ClusterConfig()
    init, reseed = jax_kmeans_indices(jax.random.PRNGKey(seed), xy.shape[0],
                                      cfg)
    return cfg, xy[init], xy[reseed]


def _close(c_got, a_got, c_want, a_want):
    np.testing.assert_allclose(c_got, c_want, rtol=1e-4, atol=1e-4)
    assert (a_got == a_want).mean() > 0.999


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [6000, 5001])
def test_plain_matches_dense(seed, n):
    xy = _mixture(seed + 10, n)
    cfg, c0, rs = _inputs(seed, xy)
    cw, aw = jax.jit(lambda a, b, c: jcluster._kmeans_dense(a, b, c, cfg))(
        xy, c0, rs)
    cg, ag = tkmeans.kmeans(t(xy), t(c0), t(rs))
    assert ag.dtype == torch.int32
    _close(cg.numpy(), ag.numpy(), np.asarray(cw), np.asarray(aw))


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_matches_pallas_kernel(seed):
    xy = _mixture(seed + 20)
    cfg, c0, rs = _inputs(seed, xy)
    cw, aw = kmeans_pallas(jnp.asarray(xy), jnp.asarray(c0), jnp.asarray(rs),
                           cfg.max_iters, interpret=True)
    cg, ag = tkmeans.kmeans_plain(t(xy), t(c0), t(rs))
    _close(cg.numpy(), ag.numpy(), np.asarray(cw), np.asarray(aw))


def test_latch_freezes_like_dense():
    # Converges in a few iterations: the latch stops updates after that.
    xy = _mixture(4, 3000)
    cfg, c0, rs = _inputs(4, xy)
    cw, aw = jax.jit(lambda a, b, c: jcluster._kmeans_dense(a, b, c, cfg))(
        xy, c0, rs)
    cg, ag = tkmeans.kmeans_plain(t(xy), t(c0), t(rs))
    _close(cg.numpy(), ag.numpy(), np.asarray(cw), np.asarray(aw))


def test_empty_cluster_reseeds():
    # Two centers far from the data: every particle joins the third, the
    # assignments change, and the two empty clusters must take reseed
    # candidates, not NaN.
    xy = _mixture(5)
    cfg = ClusterConfig()
    c0 = np.float32([[100.0, 100.0], [100.0, 100.0], [1.0, 1.0]])
    rs = np.broadcast_to(xy[:3][None], (cfg.max_iters, 3, 2)).copy()
    cw, aw = jax.jit(lambda a, b, c: jcluster._kmeans_dense(a, b, c, cfg))(
        xy, c0, rs)
    cg, ag = tkmeans.kmeans_plain(t(xy), t(c0), t(rs))
    assert np.isfinite(cg.numpy()).all() and (cg.numpy() < 10.0).all()
    _close(cg.numpy(), ag.numpy(), np.asarray(cw), np.asarray(aw))


def test_cluster_confidence_matches():
    xy = _mixture(6, 4000)
    rng = np.random.default_rng(6)
    parts = np.concatenate([xy, rng.uniform(-3, 3, (4000, 1))], 1).astype(
        np.float32)
    w = np.full(4000, 1.0 / 4000, np.float32)
    cfg = ClusterConfig()
    key = jax.random.PRNGKey(8)
    init, reseed = jax_kmeans_indices(key, 4000, cfg)
    for thr in (0.1, 0.9):
        jr, jp = jax.jit(lambda p: jcluster.cluster_confidence(
            key, p, w, jnp.float32(thr), cfg))(parts)
        tr, tp = tcluster.cluster_confidence(
            t(parts), t(w), t(thr), config_from(cfg), t(init, torch.int64),
            t(reseed, torch.int64))
        np.testing.assert_allclose(float(tr), float(jr), atol=1e-3)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-3)


def _episodes(n_ep, n, seed):
    xys = [_mixture(seed + e, n) + np.float32(0.3 * e) for e in range(n_ep)]
    ins = [_inputs(seed + e, xy) for e, xy in enumerate(xys)]
    return (ins[0][0], np.stack(xys), np.stack([i[1] for i in ins]),
            np.stack([i[2] for i in ins]))


def test_batched_plain_equals_each_episode_bit_exact():
    # Each episode keeps its own early-exit latch: the batch is its
    # episodes run one by one.
    _, xy, c0, rs = _episodes(4, 1500, 50)
    cg, ag = tkmeans.kmeans(t(xy), t(c0), t(rs))
    assert cg.shape == (4, 3, 2) and ag.shape == (4, 1500)
    for e in range(4):
        ce, ae = tkmeans.kmeans(t(xy[e]), t(c0[e]), t(rs[e]))
        assert torch.equal(cg[e], ce) and torch.equal(ag[e], ae)


def test_batched_plain_matches_jax_vmapped_dense():
    cfg, xy, c0, rs = _episodes(5, 2000, 60)
    cw, aw = jax.jit(jax.vmap(
        lambda a, b, c: jcluster._kmeans_dense(a, b, c, cfg)))(xy, c0, rs)
    cg, ag = tkmeans.kmeans_plain(t(xy), t(c0), t(rs))
    _close(cg.numpy(), ag.numpy(), np.asarray(cw), np.asarray(aw))


def test_batched_cluster_confidence_matches_jax_vmapped():
    cfg, xy, _, _ = _episodes(3, 1200, 70)
    rng = np.random.default_rng(7)
    parts = np.concatenate([xy, rng.uniform(-3, 3, (3, 1200, 1))],
                           -1).astype(np.float32)
    w = np.full((3, 1200), 1.0 / 1200, np.float32)
    thr = np.float32([0.1, 0.9, 0.3])
    keys = jax.random.split(jax.random.PRNGKey(9), 3)
    jr, jp = jax.jit(jax.vmap(lambda k, p, ww, th: jcluster.cluster_confidence(
        k, p, ww, th, cfg)))(keys, parts, w, thr)
    idx = [jax_kmeans_indices(k, 1200, cfg) for k in keys]
    tr, tp = tcluster.cluster_confidence(
        t(parts), t(w), t(thr), config_from(cfg),
        t(np.stack([i[0] for i in idx]), torch.int64),
        t(np.stack([i[1] for i in idx]), torch.int64))
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), atol=1e-3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), atol=1e-3)


@pytest.mark.parametrize("n", [1, 255, 500, 1024, 1025, 1_048_576])
def test_launch_plan_chunks_cover_n_exactly(n):
    plan = tkmeans.launch_plan(n)
    chunks = [plan.chunk(c) for c in range(plan.n_chunks)]
    assert chunks[0][0] == 0 and chunks[-1][1] == n
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert all(0 < stop - start <= tkmeans.CHUNK for start, stop in chunks)
    groups = [plan.group_chunks(g) for g in range(plan.n_groups)]
    assert groups[0][0] == 0 and groups[-1][1] == plan.n_chunks
    assert all(a[1] == b[0] for a, b in zip(groups, groups[1:]))
    assert all(0 < stop - start <= tkmeans.GROUP_CHUNKS
               for start, stop in groups)


@pytest.mark.parametrize("n", [1, 500, 1500, 16_384, 16_385, 65_536,
                               1_048_576])
def test_launch_plan_chunking_depends_on_n_alone(n):
    # The summation order is the chunking, so a batch of episodes sums
    # each episode as K3 sums it alone.
    one = tkmeans.launch_plan(n, 1)
    for episodes in (2, 64, 1024):
        many = tkmeans.launch_plan(n, episodes)
        assert (many.n_chunks, many.n_groups, many.one_block,
                many.threads) == (one.n_chunks, one.n_groups, one.one_block,
                                  one.threads)
        assert [many.chunk(c) for c in range(many.n_chunks)] == \
            [one.chunk(c) for c in range(one.n_chunks)]


@pytest.mark.parametrize("n,one_block", [
    (1, True), (500, True), (tkmeans.BLOCK_MAX_N, True),
    (tkmeans.BLOCK_MAX_N + 1, False), (1_048_576, False)])
def test_launch_plan_splits_at_the_one_block_limit(n, one_block):
    plan = tkmeans.launch_plan(n)
    assert plan.one_block is one_block
    if one_block:
        # One warp a chunk, up to 8, and at most 2 groups: 12 bytes a point
        # of xy and assignments in shared memory, 192 KB at the limit.
        assert plan.threads == 32 * min(8, plan.n_chunks)
        assert plan.n_groups <= 2 and 12 * n <= 192 * 1024
    else:
        assert plan.threads == tkmeans.GRID_THREADS
        assert plan.n_groups == -(-n // tkmeans.GROUP)


@pytest.mark.parametrize("n", [1, 255])
def test_plain_matches_dense_at_small_n(n):
    xy = _mixture(30 + n, n)
    cfg, c0, rs = _inputs(n, xy)
    cw, aw = jax.jit(lambda a, b, c: jcluster._kmeans_dense(a, b, c, cfg))(
        xy, c0, rs)
    cg, ag = tkmeans.kmeans_plain(t(xy), t(c0), t(rs))
    _close(cg.numpy(), ag.numpy(), np.asarray(cw), np.asarray(aw))


def test_plain_takes_the_strided_view_of_the_particles():
    # The filter passes particles[..., :2]; the kernel reads it through its
    # strides, and the plain version gives the same as on a copy.
    rng = np.random.default_rng(40)
    parts = t(np.concatenate([_mixture(40, 900), rng.normal(size=(900, 1))],
                             1))
    xy = parts[:, :2]
    assert xy.stride() == (3, 1)
    c0, rs = xy[:3].clone(), xy[3:63].reshape(20, 3, 2).clone()
    cg, ag = tkmeans.kmeans(xy, c0, rs)
    cc, ac = tkmeans.kmeans(xy.contiguous(), c0, rs)
    assert torch.equal(cg, cc) and torch.equal(ag, ac)
