"""K1 batched and K4, the episode-batched beam weight kernels: their plain
versions (ops/weights.beam_weights_plain on [E, N, 3] and beamsub_plain)
against the JAX package's `beam_weights_pallas_batched` and
`beam_weights_pallas_beamsub` in interpret mode, at E = 3 episodes of
n in {200, 500, 600} particles (packed, packed, and unpacked with padding
in the TPU layout) x 12 beams, each episode with its own scan and a dead
mask lane; K4 also at 5 beams (dead lanes), 8 (one full group) and 34 (the
fleet's and the bench's), at n in {200, 600}.  The JAX row kernel runs its
beam loop one beam at a time (MCL_BEAM_UNROLL=1, the order the port sums
in).

Tolerances are test_weights_pallas.py's: sum rtol 1e-5, log rtol 1e-4
(K1 batched: raw log-sums; K4: finished per episode, as its launcher
returns them), analytic > 99.9 % close (pixel-boundary ties shift a beam's
whole Gaussian).

K4's CUDA kernel holds a particle's eight lane sums on T of 1, 2, 4 or 8
threads (ops/weights.beamsub_plan); a numpy restatement of its sums with
each T equals beamsub_plain bit for bit, and folding two lanes into one
sum would not.  The plan's own rules are checked at the card's SM counts
given as arguments."""
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


def _fixture(n, nb=BEAMS):
    jm, tm = maps()
    parts = np.stack([uniform_particles(jm, n, seed) for seed in range(E)])
    angles = np.deg2rad(np.linspace(-118, 118, nb)).astype(np.float32)
    ranges = np.stack([np.asarray(jsensor.simulate_scan(
        jm, jnp.array(p), angles, SensorModelConfig()).ranges)
        for p in TRUTH])
    mask = np.ones((E, nb), bool)
    mask[np.arange(E), [1 % nb, 5 % nb, 11 % nb]] = False
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


K4_CASES = [(*c, BEAMS) for c in CASES] + [
    (n, mode, comb, nb) for nb in (5, 8, 34) for n in (200, 600)
    for mode in ("fixed", "analytic") for comb in ("sum", "log")]


@pytest.mark.parametrize(
    "n,ray_mode,combine,beams", K4_CASES,
    ids=["-".join(map(str, c[:3])) + ("" if c[3] == BEAMS else f"-b{c[3]}")
         for c in K4_CASES])
def test_k4_plain_matches_jax_kernel(n, ray_mode, combine, beams):
    jm, tm, parts, angles, ranges, mask, tscan = _fixture(n, beams)
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


def _k4_sums(terms, threads, merged=False):
    """K4's sums [..., N] of masked beam terms [..., N, B] as its kernel
    makes them with `threads` threads a particle: thread r keeps the lane
    sums r, r + threads, ... apart, each adding its beams (lane s: beams s,
    s + 8, ...) in order from 0, and the eight lane sums are then added in
    lane order from 0.  merged=True folds a thread's lanes into one sum in
    beam order instead, then adds the threads' sums in thread order."""
    nb = terms.shape[-1]
    zero = np.zeros(terms.shape[:-1], np.float32)
    held = {}
    for r in range(threads):
        if merged:
            acc = zero
            for b in range(r, nb, threads):
                acc = acc + terms[..., b]
            held[r] = acc
            continue
        for lane in range(r, 8, threads):
            acc = zero
            for b in range(lane, nb, 8):
                acc = acc + terms[..., b]
            held[lane] = acc
    prob = zero
    for k in sorted(held):
        prob = prob + held[k]
    return prob


@pytest.mark.parametrize("threads", [1, 2, 4, 8])
@pytest.mark.parametrize("beams", [5, 8, 12, 34])
def test_k4_lane_sums_on_any_thread_count_equal_beamsub_plain(threads,
                                                              beams):
    _, tm, parts, _, _, _, tscan = _fixture(256, beams)
    for combine in ("sum", "log"):
        cfg = interop.config_from(SensorModelConfig(beam_combine=combine))
        terms = tweights._beam_terms(tm, t(parts), tscan, cfg).numpy()
        got = tweights._gate(tm, cfg, t(parts),
                             torch.from_numpy(_k4_sums(terms, threads)))
        assert torch.equal(got, tweights.beamsub_plain(tm, t(parts), tscan,
                                                       cfg))


@pytest.mark.parametrize("threads", [1, 2, 4])
def test_k4_merged_lane_sums_change_the_bits(threads):
    # Folding lanes r and r + T into one register sums the same terms in
    # another order; on some particle the result differs from K4's.
    _, tm, parts, _, _, _, tscan = _fixture(256, 34)
    cfg = interop.config_from(SensorModelConfig())
    terms = tweights._beam_terms(tm, t(parts), tscan, cfg).numpy()
    separate = _k4_sums(terms, threads)
    merged = _k4_sums(terms, threads, merged=True)
    assert (merged != separate).any()


SMS = [132, 114, 16]   # H100 SXM, H100 PCIe, a small card


@pytest.mark.parametrize("sms", SMS)
def test_beamsub_plan_takes_every_t_and_never_more_as_the_batch_grows(
        sms):
    taken = set()
    for nb in (1, 5, 8, 24, 34):
        last = 8
        for e, n in sorted(((e, n) for e in (1, 2, 64, 1024)
                            for n in (1, 7, 127, 500, 768, 1500, 2000,
                                      8192)), key=lambda s: s[0] * s[1]):
            plan = tweights.beamsub_plan(e, n, nb, sms)
            threads = plan.threads * plan.per_block
            assert plan.threads in (1, 2, 4, 8) and 8 % plan.threads == 0
            assert plan.threads <= max(nb, 1) and plan.threads <= last
            assert threads % 32 == 0 and threads <= tweights.BLOCK
            last = plan.threads
            taken.add(plan.threads)
    assert taken == {1, 2, 4, 8}


@pytest.mark.parametrize("shape", [(1, 1, 5), (3, 127, 24), (64, 500, 24),
                                   (64, 768, 24), (5, 1500, 34),
                                   (1024, 127, 24), (7, 2000, 1)])
def test_beamsub_plan_items_cover_every_particle_once(shape):
    e, n, nb = shape
    plan = tweights.beamsub_plan(e, n, nb, 132)
    seen = np.zeros((e, n), np.int64)
    for f in range(plan.items):
        ep, start, stop = plan.item(f)
        assert 0 < stop - start <= plan.per_block
        seen[ep, start:stop] += 1
    assert (seen == 1).all()
    # Items come in episode order: a block's next item is in its episode
    # or a later one.
    assert [plan.item(f)[0] for f in range(plan.items)] == sorted(
        plan.item(f)[0] for f in range(plan.items))


def test_beamsub_plan_at_the_measured_shapes():
    # The thresholds PERF.md's K4 times were taken at (132 SMs).
    want = {(1, 1500, 24): 8, (64, 127, 24): 8, (64, 500, 24): 4,
            (1, 1500, 5): 4, (64, 768, 24): 2, (64, 1500, 34): 1,
            (64, 2000, 24): 1, (1024, 768, 24): 1}
    got = {s: tweights.beamsub_plan(*s, 132).threads for s in want}
    assert got == want
