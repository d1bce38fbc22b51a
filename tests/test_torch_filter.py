"""The slice end to end: the port's mcl_step vs the JAX package's, tick by
tick from the same state (moved across with interop) and with the draws
JAX made, at 2048 particles x 12 beams.

Tolerances: >= 99.9 % of particle rows within atol 1e-5 (a cumsum ulp can
move a rare draw across a CDF boundary); confidence within 1e-3; best pose
within 1e-3 m; song, wanderer command and n_injected equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig, ResampleConfig, SensorModelConfig,
)
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.models import resample as jres
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import sensor as tsensor

from torch_parity import jax_tick_draws, maps

torch.set_num_threads(1)

N, BEAMS, TICKS = 2048, 12, 3


def _cfg(ray_mode, method):
    return FilterConfig(num_particles=N,
                        sensor=SensorModelConfig(ray_mode=ray_mode),
                        resample=ResampleConfig(method=method))


@pytest.mark.parametrize("ray_mode,method,lost", [
    ("fixed", "multinomial", True),       # goes lost, then recovers
    ("analytic", "systematic", False),    # tracks
])
def test_ticks_match_jax(ray_mode, method, lost):
    # A cloud around the robot (a uniform cloud's confidence moves by
    # 1/N with every particle a k-means center shift carries across the
    # 0.4 m radius), with the kidnap detector firing so injection runs.
    # One draw moved across a CDF boundary moves the best pose by its
    # displacement / cluster size; the seed here moves none that far.
    jm, tm = maps()
    cfg = _cfg(ray_mode, method)
    angles = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
    state = jfilter.init_tracking_state(jax.random.PRNGKey(0), jm, cfg,
                                        (1.2, 2.05, 0.0), sigma_xy=0.1,
                                        sigma_theta=0.1)
    state = dataclasses.replace(state, inj=jres.InjectionState(
        jnp.float32(50.0), jnp.float32(1.0)))
    if lost:
        state = dataclasses.replace(state, confidence=jnp.float32(0.0))
    step = jax.jit(lambda s, el, er, r: jfilter.mcl_step(
        s, el, er, jsensor.make_scan(angles, r), jm, cfg))
    injected = 0
    for tick in range(TICKS):
        pose = jnp.array([1.2 + 0.05 * tick, 2.05, 0.0])
        ranges = np.asarray(jsensor.simulate_scan(jm, pose, angles,
                                                  cfg.sensor).ranges)
        enc = (np.float32(0.8 * (tick + 1)), np.float32(0.8 * (tick + 1)))
        draws = jax_tick_draws(state.key, jm, N, cfg)
        tstate = interop.state_from_numpy(state)
        new, out = step(state, *enc, ranges)
        tnew, tout = tfilter.mcl_step(tstate, *enc,
                                      tsensor.make_scan(angles, ranges),
                                      tm, config_from(cfg), draws=draws)
        rows = np.all(np.abs(tnew.particles.numpy()
                             - np.asarray(new.particles)) <= 1e-5, axis=1)
        assert rows.mean() >= 0.999, (tick, rows.mean())
        np.testing.assert_allclose(float(tout.confidence),
                                   float(out.confidence), atol=1e-3)
        np.testing.assert_allclose(tnew.best_pose.numpy(),
                                   np.asarray(new.best_pose), atol=1e-3)
        for f in ("song", "wanderer_cmd", "n_injected"):
            assert int(getattr(tout, f)) == int(getattr(out, f)), f
        np.testing.assert_array_equal(tout.cell_pose.numpy(),
                                      np.asarray(out.cell_pose))
        np.testing.assert_allclose(float(tout.total_weight),
                                   float(out.total_weight), rtol=1e-4)
        assert bool(tnew.was_lost) == bool(new.was_lost)
        injected += int(out.n_injected)
        state = new
    assert injected > 0


def test_run_episode_shapes_and_per_tick_angles():
    _, tm = maps()
    cfg = config_from(_cfg("fixed", "multinomial"))
    t_ticks = 4
    angles = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
    enc = np.cumsum(np.full((t_ticks, 2), 0.1, np.float32), axis=0)
    ranges = np.stack([tsensor.simulate_scan(
        tm, [1.25, 1.25, 0.1 * k], angles, cfg.sensor).ranges.numpy()
        for k in range(t_ticks)])
    for ang in (angles, np.broadcast_to(angles, (t_ticks, BEAMS)).copy()):
        state = tfilter.init_state(tm, dataclasses.replace(
            cfg, num_particles=256), seed=1)
        final, outs = tfilter.run_episode(state, enc, ranges, ang, tm,
                                          dataclasses.replace(
                                              cfg, num_particles=256))
        assert final.particles.shape == (256, 3)
        assert outs.exact_pose.shape == (t_ticks, 3)
        assert outs.cell_pose.shape == (t_ticks, 3)
        assert outs.cell_pose.dtype == torch.int32
        assert outs.song.shape == (t_ticks,)
        assert torch.isfinite(final.particles).all()
        assert float(outs.total_weight[0]) > 0


def test_init_state_and_unported_options_raise():
    # ESS gating and refinement are ported now: a tick runs with both.
    # What still raises is an option neither package knows.
    _, tm = maps()
    cfg = config_from(_cfg("fixed", "multinomial"))
    s = tfilter.init_state(tm, cfg, seed=3)
    assert s.particles.shape == (N, 3) and bool(s.was_lost) is False
    assert s.best_pose.tolist() == [-1.0, -1.0, -1.0]
    scan = tsensor.make_scan(np.zeros(BEAMS, np.float32),
                             np.ones(BEAMS, np.float32))
    ess = dataclasses.replace(
        cfg, resample=config_from(ResampleConfig(ess_threshold=0.5)),
        refine=dataclasses.replace(cfg.refine, iters=1))
    new, out = tfilter.mcl_step(s, 0.0, 0.0, scan, tm, ess)
    assert new.particles.shape == (N, 3)
    assert torch.isfinite(new.weights).all()
    bogus = dataclasses.replace(cfg, resample=dataclasses.replace(
        cfg.resample, method="stratified"))
    with pytest.raises(ValueError):
        tfilter.mcl_step(s, 0.0, 0.0, scan, tm, bogus)
