"""The partial-map and production-schedule filter against the JAX package:
sensor.filter_scan, sensor.beam_weights_partial, the known-map startup
states, and one mcl_step with the ESS gate, refinement and a known map.

The partial map: the default maze as the `known` fit, and the same maze
with a few cells closed on all four sides as the conservative one (their
edges unexplored), so the conservative walls contain the known ones.

Tolerances: filter_scan exact; beam_weights_partial rtol 1e-5 (sum) and
1e-4 (log), flat and interval credit; init_tracking_state exact given the
normals; mcl_step, with the closed-form caster, >= 99.9 % of particle
rows within atol 1e-5 (the tick test's tolerance: a summation ulp can move
a rare draw across a CDF boundary or flip a refinement step), weights
rtol 1e-5, confidence and best pose within 1e-3, song, wanderer and
n_injected equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig, InitConfig, RefineConfig, ResampleConfig,
    SensorModelConfig,
)
from montecarlolocalisation_tpu.maps import from_walls as jfrom_walls
from montecarlolocalisation_tpu.maps import maze as jmaze
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.models import resample as jres
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.maps import from_walls as tfrom_walls
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import sensor as tsensor

from torch_parity import MAP_PATH, jax_tick_draws, t

torch.set_num_threads(1)

N, BEAMS = 1024, 24
CLOSED = ((0, 3), (1, 3), (2, 0), (4, 4))     # unexplored cells


def partial_maps():
    """((JAX conservative, JAX known), (port conservative, port known))."""
    walls = jmaze.load_map_file(MAP_PATH)
    cons = [[list(c) for c in row] for row in walls]
    for r, c in CLOSED:
        cons[r][c] = [0, 1, 2, 3]
    return ((jfrom_walls(cons), jfrom_walls(walls)),
            (tfrom_walls(cons, device="cpu"),
             tfrom_walls(walls, device="cpu")))


def _scan_inputs(jm, seed, n=N):
    rng = np.random.default_rng(seed)
    parts = np.stack([rng.uniform(0.1, 3.9, n), rng.uniform(0.1, 3.9, n),
                      rng.uniform(-np.pi, np.pi, n)], -1).astype(np.float32)
    angles = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
    ranges = rng.uniform(0.05, 1.0, BEAMS).astype(np.float32)
    ranges[::5] = 1.0                 # max-range returns: the p_rand term
    mask = rng.random(BEAMS) > 0.1
    return parts, angles, ranges, mask


def test_filter_scan_matches_jax_exactly():
    rng = np.random.default_rng(0)
    for k in range(6):
        raw = rng.uniform(0.0, 1.3, 726)
        raw[rng.random(726) < 0.05] = np.nan
        raw[rng.random(726) < 0.02] = np.inf
        args = (raw, -2.35619 + 0.01 * k, 0.00613, 0.02, 1.0)
        for pad in (None, 40):
            cfg = SensorModelConfig(beam_skip=20 - k)
            want = jsensor.filter_scan(*args, cfg=cfg, pad_to=pad)
            got = tsensor.filter_scan(*args, cfg=config_from(cfg), pad_to=pad)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype
                np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tsensor.filter_scan(np.ones(726), -2.3, 0.006, 0.0, 2.0, pad_to=3)


@pytest.mark.parametrize("credit", ["interval", "flat"])
@pytest.mark.parametrize("ray_mode", ["fixed", "dda"])
@pytest.mark.parametrize("combine", ["sum", "log"])
def test_beam_weights_partial_matches_jax(credit, ray_mode, combine):
    (jm, jk), (tm, tk) = partial_maps()
    cfg = SensorModelConfig(ray_mode=ray_mode, beam_combine=combine,
                            unknown_credit_mode=credit, lookup_mode="gather")
    parts, angles, ranges, mask = _scan_inputs(jm, 1)
    want = np.asarray(jax.jit(lambda p: jsensor.beam_weights_partial(
        jm, jk, p, jsensor.make_scan(angles, ranges, mask), cfg))(
        jnp.asarray(parts)))
    got = tsensor.beam_weights_partial(
        tm, tk, t(parts), tsensor.make_scan(angles, ranges, mask),
        config_from(cfg)).numpy()
    rtol = 1e-4 if combine == "log" else 1e-5
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6)
    # The frontier credit really changes scores against the plain model.
    plain = tsensor.beam_weights_dense(
        tm, t(parts), tsensor.make_scan(angles, ranges, mask),
        config_from(cfg)).numpy()
    scale = np.maximum(np.abs(got), np.abs(plain))
    assert np.mean(np.abs(got - plain) > 1e-3 * scale) > 0.05


def test_beam_weights_partial_batch_equals_its_episodes():
    (jm, _), (tm, tk) = partial_maps()
    cfg = config_from(SensorModelConfig(ray_mode="fixed"))
    ins = [_scan_inputs(jm, 5 + e, 256) for e in range(3)]
    parts = t(np.stack([i[0] for i in ins]))
    scan = tsensor.make_scan(ins[0][1], np.stack([i[2] for i in ins]),
                             np.stack([i[3] for i in ins]))
    got = tsensor.beam_weights_partial(tm, tk, parts, scan, cfg)
    for e in range(3):
        one = tsensor.beam_weights_partial(
            tm, tk, parts[e], tsensor.make_scan(ins[e][1], ins[e][2],
                                                ins[e][3]), cfg)
        assert torch.equal(got[e], one)


def _cell_of(parts, m):
    col = torch.floor((parts[..., 0] - 0.05) / m.cell_meters).long()
    row = torch.floor((parts[..., 1] - 0.05) / m.cell_meters).long()
    return row, col


@pytest.mark.parametrize("cells,restricted", [
    ("explored", True), ("init-only", True), ("uniform", False)])
def test_init_state_on_a_known_map_draws_explored_cells(cells, restricted):
    _, (tm, tk) = partial_maps()
    cfg = config_from(FilterConfig(num_particles=4000,
                                   init=InitConfig(partial_map_cells=cells)))
    st = tfilter.init_state(tm, cfg, seed=1, known_map=tk)
    row, col = _cell_of(st.particles, tm)
    closed = torch.zeros(tm.n_rows, tm.n_cols, dtype=torch.bool)
    for r, c in CLOSED:
        closed[r, c] = True
    assert bool(closed[row, col].any()) != restricted
    # Without a known map the draw is the reference's, whatever the knob.
    plain = tfilter.init_state(tm, cfg, seed=1)
    assert bool(closed[_cell_of(plain.particles, tm)].any())
    # Fresh injection draws follow "explored" only.
    mask = tfilter.injection_cells(tm, cfg, tk)
    assert (mask is not None) == (cells == "explored")


def test_init_tracking_state_matches_jax_given_its_normals():
    (jm, _), (tm, _) = partial_maps()
    cfg = FilterConfig(num_particles=N)
    pose = (1.2, 2.05, 0.4)
    js = jfilter.init_tracking_state(jax.random.PRNGKey(3), jm, cfg, pose,
                                     sigma_xy=0.1, sigma_theta=0.2)
    st = jfilter.init_state(jax.random.PRNGKey(3), jm, cfg)
    normals = np.stack([np.asarray(jax.random.normal(k, (N,)))
                        for k in jax.random.split(st.key, 3)])
    ts = tfilter.init_tracking_state(tm, config_from(cfg), pose,
                                     sigma_xy=0.1, sigma_theta=0.2,
                                     normals=t(normals))
    np.testing.assert_array_equal(ts.particles.numpy(),
                                  np.asarray(js.particles))
    for f in ("confidence", "cluster_threshold", "confident_threshold",
              "best_pose"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    # A batch of tracked filters from the port's own generator.
    b = tfilter.init_tracking_state(tm, config_from(cfg), [pose] * 2,
                                    batch=2)
    assert b.particles.shape == (2, N, 3) and b.best_pose.shape == (2, 3)
    assert float((b.particles[..., 0] - pose[0]).abs().mean()) < 0.1


def _masked_tick_draws(key, jm, cfg, mask):
    """jax_tick_draws with the fresh particles drawn over `mask`, as JAX's
    mcl_step draws them under partial_map_cells="explored"."""
    d = jax_tick_draws(key, jm, N, cfg)
    k_resample = jax.random.split(key, 4)[2]
    k_fresh = jax.random.split(k_resample, 6)[5]
    fresh = jres.sample_uniform_particles(k_fresh, jm, N, cfg.init,
                                          cell_mask=mask)
    return dataclasses.replace(d, resample=dataclasses.replace(
        d.resample, fresh=t(fresh)))


@pytest.mark.parametrize("lost", [False, True])
def test_mcl_step_with_ess_refine_and_known_map_matches_jax(lost):
    (jm, jk), (tm, tk) = partial_maps()
    # The closed-form caster: the fixed march is piecewise constant, and
    # its refinement ties are held apart in test_torch_refine.py.
    cfg = FilterConfig(
        num_particles=N, sensor=SensorModelConfig(ray_mode="analytic"),
        resample=ResampleConfig(method="systematic", ess_threshold=0.5),
        refine=RefineConfig(iters=2),
        init=InitConfig(partial_map_cells="explored"))
    angles = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
    spread = 0.1 if lost else 0.02
    state = jfilter.init_tracking_state(jax.random.PRNGKey(0), jm, cfg,
                                        (1.2, 2.05, 0.0), sigma_xy=spread,
                                        sigma_theta=spread)
    rng = np.random.default_rng(2)
    state = dataclasses.replace(
        state, weights=jnp.asarray(0.9 + 0.2 * rng.random(N), jnp.float32),
        inj=jres.InjectionState(jnp.float32(50.0 if lost else 0.01),
                                jnp.float32(1.0 if lost else 0.01)),
        confidence=jnp.float32(0.0 if lost else 1.0))
    step = jax.jit(lambda s, el, er, r: jfilter.mcl_step(
        s, el, er, jsensor.make_scan(angles, r), jm, cfg, known_map=jk))
    mask = ~jnp.all(jm.walls, axis=-1)
    skipped = []
    for tick in range(2):
        pose = jnp.array([1.2 + 0.05 * tick, 2.05, 0.0])
        ranges = np.asarray(jsensor.simulate_scan(jk, pose, angles,
                                                  cfg.sensor).ranges)
        enc = (np.float32(0.8 * (tick + 1)), np.float32(0.8 * (tick + 1)))
        draws = _masked_tick_draws(state.key, jm, cfg, mask)
        tstate = interop.state_from_numpy(state)
        new, out = step(state, *enc, ranges)
        tnew, tout = tfilter.mcl_step(tstate, *enc,
                                      tsensor.make_scan(angles, ranges),
                                      tm, config_from(cfg), draws=draws,
                                      known_map=tk)
        rows = np.all(np.abs(tnew.particles.numpy()
                             - np.asarray(new.particles)) <= 1e-5, axis=1)
        assert rows.mean() >= 0.999, (tick, rows.mean())
        np.testing.assert_allclose(tnew.weights.numpy(),
                                   np.asarray(new.weights), rtol=1e-5,
                                   atol=1e-9)
        np.testing.assert_allclose(float(tout.confidence),
                                   float(out.confidence), atol=1e-3)
        np.testing.assert_allclose(tnew.best_pose.numpy(),
                                   np.asarray(new.best_pose), atol=1e-3)
        for f in ("song", "wanderer_cmd", "n_injected"):
            assert int(getattr(tout, f)) == int(getattr(out, f)), f
        w = np.asarray(new.weights)
        skipped.append((bool(np.any(w != w[0])), int(out.n_injected)))
        state = new
    # Tracking, the tight cloud keeps the ESS high: the gate skips its
    # first tick and carries the weights.  Lost, the detector fires the
    # pass, which injects.
    assert skipped[0][0] != lost
    assert (skipped[0][1] > 0) == lost
