"""models/resample: the ESS gate, the elastic resize and the explored-cell
draw of the port against the JAX package, with the draws JAX made.

Tolerances: where the gate skips, the particles bit-exact; where the
pass runs, every row within atol 1e-6 of JAX's (the same source rows, as
the uniform cloud's rows lie far further apart: XLA contracts the
jitter's multiply-add inside lax.cond into one rounding, and its atan2
differs from torch's in the last bit of the wrapped heading); carried
weights rtol 1e-6 (the normalizing sums add in another order); a batch
equal to its episodes one by one, bit for bit; resize_particles
index-exact (the rows carry their index); the explored cells exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig, InitConfig, ResampleConfig,
)
from montecarlolocalisation_tpu.models import resample as jres
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.models import resample as tres

from torch_parity import jax_resample_draws, maps, stack, t, uniform_particles

torch.set_num_threads(1)

N = 256


def _cfg(method="systematic", tau=0.5):
    return FilterConfig(num_particles=N, resample=ResampleConfig(
        method=method, ess_threshold=tau))


def _likelihood(rng, kind):
    if kind == "skewed":      # ESS far below N / 2: the pass fires
        return (rng.random(N) ** 12).astype(np.float32)
    return (0.9 + 0.1 * rng.random(N)).astype(np.float32)   # near uniform


def _masked_draws(key, jm, cfg, mask):
    """jax_resample_draws with the fresh particles drawn over `mask`."""
    d = jax_resample_draws(key, jm, N, cfg)
    k_fresh = jax.random.split(key, 6)[5]
    fresh = jres.sample_uniform_particles(k_fresh, jm, N, cfg.init,
                                          cell_mask=mask)
    return tres.ResampleDraws(jitter=d.jitter, fresh=t(fresh), u=d.u,
                              u0=d.u0, inject_r=d.inject_r)


@pytest.mark.parametrize("method", ["systematic", "multinomial"])
@pytest.mark.parametrize("kind,lost,inj,fires", [
    ("flat", False, (0.5, 0.5), False),      # ESS high, no injection: skip
    ("skewed", False, (0.01, 0.01), True),   # ESS low: the pass
    ("flat", True, (50.0, 1.0), True),       # kidnap detector asks: the pass
])
def test_ess_gated_resample_matches_jax(method, kind, lost, inj, fires):
    jm, tm = maps()
    cfg = _cfg(method)
    rng = np.random.default_rng(3)
    parts = uniform_particles(jm, N, 4)
    lik = _likelihood(rng, kind)
    carried = (0.5 + rng.random(N)).astype(np.float32)
    key = jax.random.PRNGKey(9)
    jinj = jres.InjectionState(jnp.float32(inj[0]), jnp.float32(inj[1]))
    jp, jw, jnew_inj, jinfo = jax.jit(
        lambda p, l, c: jres.ess_gated_resample(
            key, p, l, c, jinj, jnp.bool_(lost), jm, cfg))(parts, lik,
                                                           carried)
    draws = jax_resample_draws(key, jm, N, cfg)
    tp, tw, tinj, tinfo = tres.ess_gated_resample(
        t(parts), t(lik), t(carried),
        tres.InjectionState(t(inj[0]), t(inj[1])), torch.tensor(lost), tm,
        config_from(cfg), draws)
    assert bool(tinfo["resampled"]) == fires
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6)
    assert int(tinfo["n_injected"]) == int(jinfo["n_injected"])
    assert (int(tinfo["n_injected"]) > 0) == (fires and lost)
    for f in ("w_slow", "w_fast"):
        np.testing.assert_allclose(float(getattr(tinj, f)),
                                   float(getattr(jnew_inj, f)), rtol=1e-6)
    np.testing.assert_allclose(float(tinfo["p_inject"]),
                               float(jinfo["p_inject"]), rtol=1e-6)
    if not fires:
        np.testing.assert_array_equal(tp.numpy(), parts)


def test_ess_gate_clamps_the_averages_rates_as_jax():
    """Under the gate conf_alpha_fast = 2.0 is clamped to 1 (the JAX
    package's _regime); without the gate the reference's 2.0 stays."""
    jm, tm = maps()
    lik = np.full(N, 0.2, np.float32)
    for tau in (None, 0.5):
        cfg = _cfg(tau=tau)
        jinj, jp, _, _ = jres.update_injection(
            jnp.asarray(lik), jres.InjectionState(jnp.float32(1.0),
                                                  jnp.float32(1.0)),
            jnp.bool_(False), cfg)
        tinj, tp, _, _ = tres.update_injection(
            t(lik), tres.InjectionState(t(1.0), t(1.0)), torch.tensor(False),
            config_from(cfg))
        np.testing.assert_allclose(float(tinj.w_fast), float(jinj.w_fast),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(tp), float(jp), rtol=1e-6)


def test_ess_gate_batch_equals_its_episodes():
    jm, tm = maps()
    cfg = config_from(_cfg())
    rng = np.random.default_rng(5)
    kinds = ["flat", "skewed", "flat", "skewed"]
    lost = [False, False, True, True]
    parts = np.stack([uniform_particles(jm, N, 10 + e) for e in range(4)])
    lik = np.stack([_likelihood(rng, k) for k in kinds])
    carried = (0.5 + rng.random((4, N))).astype(np.float32)
    inj = tres.InjectionState(t([0.5, 0.5, 50.0, 50.0]),
                              t([0.5, 0.5, 1.0, 1.0]))
    draws = [jax_resample_draws(jax.random.PRNGKey(20 + e), jm, N, _cfg())
             for e in range(4)]
    bp, bw, binj, binfo = tres.ess_gated_resample(
        t(parts), t(lik), t(carried), inj, torch.tensor(lost), tm, cfg,
        stack(draws))
    assert binfo["resampled"].tolist() == [False, True, True, True]
    for e in range(4):
        p, w, i, info = tres.ess_gated_resample(
            t(parts[e]), t(lik[e]), t(carried[e]),
            tres.InjectionState(inj.w_slow[e], inj.w_fast[e]),
            torch.tensor(lost[e]), tm, cfg, draws[e])
        assert torch.equal(bp[e], p) and torch.equal(bw[e], w)
        assert torch.equal(binj.w_fast[e], i.w_fast)
        assert int(binfo["n_injected"][e]) == int(info["n_injected"])


@pytest.mark.parametrize("n_new,weights", [
    (64, "random"), (1000, "random"), (N, "random"), (100, "zero"),
    (700, "one_source"),
])
def test_resize_particles_matches_jax_index_for_index(n_new, weights):
    rng = np.random.default_rng(n_new)
    parts = np.zeros((N, 3), np.float32)
    parts[:, 0] = np.arange(N)          # each row carries its index
    parts[:, 1:] = rng.random((N, 2))
    w = {"random": rng.random(N) ** 3, "zero": np.zeros(N),
         "one_source": np.eye(N)[17]}[weights].astype(np.float32)
    key = jax.random.PRNGKey(n_new)
    jp, jw = jres.resize_particles(key, jnp.asarray(parts), jnp.asarray(w),
                                   n_new)
    u0 = t(jax.random.uniform(key, ()))
    tp, tw = tres.resize_particles(t(parts), t(w), n_new, u0)
    assert tp.shape == (n_new, 3)
    np.testing.assert_array_equal(tp[:, 0].numpy().astype(int),
                                  np.asarray(jp)[:, 0].astype(int))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-7)
    # A batch resizes each episode as alone.
    bp, _ = tres.resize_particles(t(np.stack([parts, parts[::-1]])),
                                  t(np.stack([w, w[::-1]])), n_new,
                                  torch.stack([u0, u0]))
    assert torch.equal(bp[0], tp)


def test_masked_cells_and_explored_injection_match_jax():
    jm, tm = maps()
    rng = np.random.default_rng(1)
    mask = rng.random((tm.n_rows, tm.n_cols)) < 0.4
    u = rng.random(4096).astype(np.float32)
    jr, jc = jres._masked_cells(jnp.asarray(u), jnp.asarray(mask))
    tr, tc = tres.masked_cells(t(u), torch.as_tensor(mask))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert mask[tr.numpy(), tc.numpy()].all()
    # An all-False mask falls back to every cell.
    none = np.zeros_like(mask)
    jr, jc = jres._masked_cells(jnp.asarray(u), jnp.asarray(none))
    tr, tc = tres.masked_cells(t(u), torch.as_tensor(none))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    # The port's own draw lands in the mask's cells.
    gen = torch.Generator()
    gen.manual_seed(0)
    fresh = tres.sample_uniform_particles(gen, tm, 2000, InitConfig(),
                                          cell_mask=torch.as_tensor(mask))
    col = ((fresh[:, 0] - 0.05) / tm.cell_meters).floor().long()
    row = ((fresh[:, 1] - 0.05) / tm.cell_meters).floor().long()
    assert mask[row.numpy(), col.numpy()].all()
    # The gated pass injects from the given draws, which JAX drew on the
    # mask: the same particles.
    cfg = _cfg()
    key = jax.random.PRNGKey(4)
    parts = uniform_particles(jm, N, 2)
    lik = np.full(N, 0.05, np.float32)
    jinj = jres.InjectionState(jnp.float32(50.0), jnp.float32(1.0))
    jp, _, _, jinfo = jres.ess_gated_resample(
        key, jnp.asarray(parts), jnp.asarray(lik), jnp.ones(N), jinj,
        jnp.bool_(True), jm, cfg, cell_mask=jnp.asarray(mask))
    tp, _, _, tinfo = tres.ess_gated_resample(
        t(parts), t(lik), torch.ones(N),
        tres.InjectionState(t(50.0), t(1.0)), torch.tensor(True), tm,
        config_from(cfg), _masked_draws(key, jm, cfg, jnp.asarray(mask)))
    assert int(tinfo["n_injected"]) == int(jinfo["n_injected"]) > 0
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)
