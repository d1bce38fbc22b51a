"""Port resampling (models/resample) vs montecarlolocalisation_tpu, with
the draws JAX made.  Every particle row must agree within 1e-5 except
where a cumsum ulp moves a draw across a CDF boundary (allowed for at most
0.1 % of rows)."""
import dataclasses

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

from torch_parity import jax_resample_draws, maps, t, uniform_particles

torch.set_num_threads(1)


def _inj_pair(w_slow, w_fast):
    return (jres.InjectionState(jnp.float32(w_slow), jnp.float32(w_fast)),
            tres.InjectionState(t(w_slow), t(w_fast)))


@pytest.mark.parametrize("lost", [True, False])
@pytest.mark.parametrize("inj", [(0.0, 0.0), (2.0, 1.0), (0.5, 3.0)])
def test_update_injection(lost, inj):
    cfg = FilterConfig()
    w = np.random.default_rng(0).uniform(0, 3, 1000).astype(np.float32)
    ji, ti = _inj_pair(*inj)
    jn, jp, ja, jt = jax.jit(lambda w: jres.update_injection(
        w, ji, jnp.bool_(lost), cfg))(w)
    tn, tp, ta, tt = tres.update_injection(t(w), ti, t(lost, torch.bool),
                                           config_from(cfg))
    for a, b in ((tn.w_slow, jn.w_slow), (tn.w_fast, jn.w_fast), (tp, jp),
                 (ta, ja), (tt, jt)):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-5, atol=1e-7)


def _run(cfg, n, lost, inj, seed):
    jm, tm = maps()
    parts = uniform_particles(jm, n, seed)
    w = (np.random.default_rng(seed).uniform(size=n) ** 4).astype(np.float32)
    w[::7] = 0.0
    key = jax.random.PRNGKey(seed + 100)
    ji, ti = _inj_pair(*inj)
    jp, jw, jinj, jinfo = jax.jit(lambda p, w: jres.resample(
        key, p, w, ji, jnp.bool_(lost), jm, cfg))(parts, w)
    draws = jax_resample_draws(key, jm, n, cfg)
    tp, tw, tinj, tinfo = tres.resample(t(parts), t(w), ti,
                                        t(lost, torch.bool), tm,
                                        config_from(cfg), draws)
    rows = np.all(np.abs(tp.numpy() - np.asarray(jp)) <= 1e-5, axis=1)
    assert rows.mean() >= 0.999, rows.mean()
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw))
    assert int(tinfo["n_injected"]) == int(jinfo["n_injected"])
    np.testing.assert_allclose(float(tinfo["p_inject"]),
                               float(jinfo["p_inject"]), rtol=1e-5)
    np.testing.assert_allclose(float(tinj.w_fast), float(jinj.w_fast),
                               rtol=1e-5)
    return tp.numpy(), int(tinfo["n_injected"])


@pytest.mark.parametrize("method", ["multinomial", "systematic"])
@pytest.mark.parametrize("lost", [True, False])
def test_resample_matches_with_jax_draws(method, lost):
    cfg = FilterConfig(resample=ResampleConfig(method=method),
                       init=InitConfig(sampler="reference"))
    _, n_inj = _run(cfg, 2048, lost, (2.0, 0.2), seed=1)
    # The cap: lost 200, confident 50 (monte_carlo.cpp:474,479).
    assert n_inj == (200 if lost else 50)


@pytest.mark.parametrize("method", ["multinomial", "systematic"])
def test_resample_without_injection(method):
    cfg = FilterConfig(resample=ResampleConfig(method=method))
    out, n_inj = _run(cfg, 1500, True, (0.0, 0.0), seed=2)
    assert n_inj == 0
    assert np.isfinite(out).all()
    assert (np.abs(out[:, 2]) <= np.pi).all()     # atan2 re-wrap


def test_sorted_multinomial_means_exact():
    # "sorted" is the JAX package's TPU-only form of the same multiset; the
    # port runs the exact draw for it.
    cfg = FilterConfig(resample=ResampleConfig(multinomial_impl="sorted"))
    exact = dataclasses.replace(cfg, resample=ResampleConfig(
        multinomial_impl="exact"))
    jm, tm = maps()
    n = 512
    parts = t(uniform_particles(jm, n, 3))
    w = t(np.random.default_rng(3).uniform(size=n))
    draws = jax_resample_draws(jax.random.PRNGKey(3), jm, n, cfg)
    inj = tres.InjectionState.zero()
    a = tres.resample(parts, w, inj, t(True, torch.bool), tm,
                      config_from(cfg), draws)
    b = tres.resample(parts, w, inj, t(True, torch.bool), tm,
                      config_from(exact), draws)
    torch.testing.assert_close(a[0], b[0], rtol=0, atol=0)


def test_all_zero_weights_draw_uniformly():
    jm, tm = maps()
    n = 1024
    cfg = FilterConfig(resample=ResampleConfig(method="systematic"))
    parts = t(uniform_particles(jm, n, 4))
    draws = jax_resample_draws(jax.random.PRNGKey(4), jm, n, cfg)
    out, w, _, info = tres.resample(parts, torch.zeros(n),
                                    tres.InjectionState.zero(),
                                    t(False, torch.bool), tm,
                                    config_from(cfg), draws)
    assert torch.isfinite(out).all() and int(info["n_injected"]) == 0
    assert float(w.sum()) == pytest.approx(1.0, rel=1e-5)
