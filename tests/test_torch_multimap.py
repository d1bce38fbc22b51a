"""The tick on a map stack, and the randomized-maps sweep.

- A batched tick on a 2-map stack (E = 4 episodes, 2 a map, N = 128)
  equals each episode's single-map tick on its own map, bit for bit on the
  CPU, for both ray modes, both resampling methods and both combines.
- One tick against the JAX package's vmap(mcl_step) over the repeated
  stack maps_b, with JAX's own draws: >= 99.9 % of particle rows within
  1e-5 (the one-tick tolerance) under the fixed march.  Under vmap the
  JAX maps are traced, so its analytic mode computes DDA
  (models/raycast.py:193-205); the port's analytic cast is held to that
  DDA at the caster tolerance (atol 1e-4, > 99.9 % exact).
- The wanderer on a stack equals each robot's wander on its own map, and
  run_multimap_sweep runs at 2 maps x 2 episodes x 15 ticks
  (test_generator.py:47-57); then the map stack's own rules: lookups read each episode's map,
  an index outside the stack or a stack with one filter [N, 3] raises.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig, MotionModelConfig, ResampleConfig, SensorModelConfig,
)
from montecarlolocalisation_tpu.maps import generator as jgen
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.maps import generator as tgen
from montecarlolocalisation_tpu_torch.maps import grid as tgrid
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import resample as tresample
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.ops import weights as tweights
from montecarlolocalisation_tpu_torch.parallel import episodes as tepisodes
from montecarlolocalisation_tpu_torch.sim import robot as trobot

from torch_parity import episode, jax_episode_draws

torch.set_num_threads(1)

E, PER_MAP, N, BEAMS = 4, 2, 128, 12
ANGLES = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
TRUTH = np.float32([[1.25, 1.25, 0.0], [2.05, 3.3, 1.2], [3.7, 0.5, -2.0],
                    [0.45, 2.9, 0.4]])


def _stack():
    """(JAX stacked MazeMap of 2 mixed maps, the port's stack of them
    repeated 2 episodes a map)."""
    jm = jgen.generate_map_batch(2, seed=5, style="mixed")
    return jm, tgrid.repeat_maps(interop.maze_from_numpy(jm), PER_MAP)


def _cfg(ray_mode="fixed", method="multinomial", combine="sum",
         shared=True):
    return FilterConfig(
        num_particles=N,
        sensor=SensorModelConfig(ray_mode=ray_mode, beam_combine=combine),
        motion=MotionModelConfig(shared_noise=shared),
        resample=ResampleConfig(method=method))


@pytest.mark.parametrize("ray_mode,method,combine,shared", [
    ("fixed", "multinomial", "sum", True),
    ("analytic", "systematic", "sum", False),
    ("fixed", "systematic", "log", True),
    ("dda", "multinomial", "sum", True),
])
def test_stack_tick_equals_single_map_ticks_bit_for_bit(ray_mode, method,
                                                        combine, shared):
    _, tm = _stack()
    cfg = interop.config_from(_cfg(ray_mode, method, combine, shared))
    state = tfilter.init_state(tm, cfg, seed=2, batch=E)
    state = dataclasses.replace(state, inj=tresample.InjectionState(
        torch.full((E,), 50.0), torch.ones(E)))
    singles = [episode(state, e) for e in range(E)]
    own = [tm.map_at(int(tm.episode_maps[e])) for e in range(E)]
    gen = torch.Generator()
    gen.manual_seed(3)
    truth = torch.as_tensor(TRUTH)
    for tick in range(2):
        scan = tsensor.simulate_scan(tm, truth, ANGLES, cfg.sensor, gen=gen)
        draws = tfilter.draw_tick(gen, tm, N, cfg, (E,))
        enc = (torch.full((E,), 0.3 * (tick + 1)),
               torch.full((E,), 0.28 * (tick + 1)))
        state, out = tfilter.mcl_step(state, *enc, scan, tm, cfg,
                                      draws=draws)
        for e in range(E):
            clean = tsensor.simulate_scan(own[e], truth[e], ANGLES,
                                          cfg.sensor)
            noisy = tsensor.simulate_scan(tm, truth, ANGLES, cfg.sensor)
            assert torch.equal(clean.ranges, noisy.ranges[e])
            one = tsensor.Scan(scan.angles, scan.ranges[e], scan.mask[e])
            singles[e], o = tfilter.mcl_step(
                singles[e], enc[0][e], enc[1][e], one, own[e], cfg,
                draws=episode(draws, e))
            assert torch.equal(singles[e].particles, state.particles[e])
            assert torch.equal(singles[e].best_pose, state.best_pose[e])
            for f in dataclasses.fields(o):
                assert torch.equal(getattr(o, f.name),
                                   getattr(out, f.name)[e]), f.name
    assert int(out.n_injected.sum()) > 0


def _jax_tick(jmb, jcfg, states, ranges):
    def one(st, el, er, rng, m):
        sc = jsensor.Scan(angles=jnp.asarray(ANGLES), ranges=rng,
                          mask=jnp.ones((BEAMS,), bool))
        return jfilter.mcl_step(st, el, er, sc, m, jcfg)

    return jax.jit(jax.vmap(one))(states, jnp.full((E,), 0.3),
                                  jnp.full((E,), 0.28), ranges, jmb)


@pytest.mark.parametrize("ray_mode,method", [("fixed", "multinomial"),
                                             ("fixed", "systematic"),
                                             ("analytic", "systematic")])
def test_stack_tick_matches_jax_vmap_over_maps(ray_mode, method):
    jm, tm = _stack()
    jcfg = _cfg(ray_mode, method)
    jmb = jax.tree_util.tree_map(lambda x: jnp.repeat(x, PER_MAP, axis=0),
                                 jm)
    keys = jax.random.split(jax.random.PRNGKey(7), E)
    states = jax.jit(jax.vmap(
        lambda k, m: jfilter.init_state(k, m, jcfg)))(keys, jmb)
    scan = jax.vmap(lambda p, m: jsensor.simulate_scan(
        m, p, ANGLES, jcfg.sensor))(jnp.asarray(TRUTH), jmb)
    ranges = np.asarray(scan.ranges)
    jnext, jout = _jax_tick(jmb, jcfg, states, ranges)
    one_map = jax.tree_util.tree_map(lambda x: x[0], jm)
    draws = jax_episode_draws(states, one_map, N, jcfg, 1)[0]
    cfg = interop.config_from(jcfg)
    tstate = interop.state_from_numpy(states)
    tscan = tsensor.make_scan(ANGLES, ranges)
    nxt, out = tfilter.mcl_step(tstate, torch.full((E,), 0.3),
                                torch.full((E,), 0.28), tscan, tm, cfg,
                                draws=draws)
    rows = np.all(np.abs(nxt.particles.numpy()
                         - np.asarray(jnext.particles)) <= 1e-5, axis=-1)
    assert rows.mean() >= 0.999, rows.mean()
    np.testing.assert_allclose(out.total_weight.numpy(),
                               np.asarray(jout.total_weight), rtol=1e-5)
    np.testing.assert_array_equal(out.n_injected.numpy(),
                                  np.asarray(jout.n_injected))
    if ray_mode == "analytic":
        # The port's analytic cast against JAX's DDA on traced maps.
        parts = np.asarray(states.particles)
        want = np.asarray(jax.vmap(lambda p, m: jsensor.expected_ranges(
            m, p, jnp.asarray(ANGLES), jcfg.sensor))(parts, jmb))
        got = tsensor.expected_ranges(tm, torch.tensor(parts),
                                      torch.as_tensor(ANGLES),
                                      cfg.sensor).numpy()
        exact = np.abs(got - want) <= 1e-4
        assert exact.mean() > 0.999, exact.mean()


def test_run_multimap_sweep_runs():
    maps = tgen.generate_map_batch(2, rows=4, cols=4, seed=0, device="cpu")
    cfg = interop.config_from(FilterConfig(
        num_particles=N, sensor=SensorModelConfig(ray_mode="fixed")))
    angles = np.deg2rad(np.linspace(-118, 118, 8)).astype(np.float32)
    final, outs, poses = tepisodes.run_multimap_sweep(
        0, maps, cfg, angles, num_ticks=15, episodes_per_map=2,
        start_pose=(0.45, 0.45, 0.0))
    assert final.particles.shape == (4, N, 3)
    assert outs.confidence.shape == (4, 15)
    assert poses.shape == (4, 15, 3)
    assert torch.isfinite(final.particles).all()
    # Episodes 0, 1 wander map 0 and 2, 3 map 1: the same start and
    # script, so the truth differs only where the maps do.
    assert torch.equal(poses[0], poses[1]) and torch.equal(poses[2],
                                                           poses[3])
    metrics = tepisodes.sweep_rmse(final, poses)
    assert 0.0 <= metrics["converged_frac"] <= 1.0
    with pytest.raises(ValueError, match="map stack"):
        tepisodes.run_multimap_sweep(0, maps.map_at(0), cfg, angles, 2)


def test_stack_lookups_read_each_episodes_map():
    occ = np.zeros((3, 4, 5), bool)
    occ[0, 1, 2] = occ[1, 2, 3] = occ[2, 3, 4] = True
    table = torch.as_tensor(occ)
    mx = torch.tensor([[2, 3, 4], [2, 3, 4]])
    my = torch.tensor([[1, 2, 3], [1, 2, 3]])
    got = tgrid.lookup(table, mx, my, torch.tensor([2, 1], dtype=torch.int32))
    assert got.tolist() == [[False, False, True], [False, True, False]]
    off = tgrid.lookup(table, torch.tensor([[-1], [5]]),
                       torch.tensor([[1], [0]]), torch.tensor([0, 0]))
    assert not off.any()
    with pytest.raises(ValueError, match="episodes"):
        tgrid.lookup(table, mx[:1], my[:1], torch.tensor([0, 1]))


def test_stack_rules():
    _, tm = _stack()
    assert tm.maps == 2 and tm.episode_maps.tolist() == [0, 0, 1, 1]
    with pytest.raises(ValueError, match="outside"):
        tgrid.select_maps(tm, [0, 2])
    with pytest.raises(ValueError, match="geometry"):
        tgrid.stack_maps([tm.map_at(0), tgen.generate_map_batch(
            1, rows=4, cols=4, device="cpu").map_at(0)])
    cfg = interop.config_from(SensorModelConfig())
    scan = tsensor.make_scan(ANGLES, np.full(BEAMS, 0.5, np.float32))
    with pytest.raises(ValueError, match="map stack"):
        tsensor.beam_weights(tm, torch.zeros(N, 3), scan, cfg)
    # A stack's weights through the wrapper equal each episode on its map.
    parts = torch.as_tensor(TRUTH)[:, None, :].expand(E, N, 3).contiguous()
    bscan = tsensor.make_scan(ANGLES, np.full((E, BEAMS), 0.5, np.float32))
    got = tweights.beam_weights_batched(tm, parts, bscan, cfg)
    for e in range(E):
        want = tweights.beam_weights_plain(
            tm.map_at(int(tm.episode_maps[e])), parts[e],
            tsensor.Scan(bscan.angles, bscan.ranges[e], bscan.mask[e]), cfg)
        assert torch.equal(got[e], want)


def test_wander_on_a_stack_wanders_each_robot_in_its_own_map():
    """generate_wander_episode on a stack equals each robot's wander on its
    own map with the same draws, the explorer's probe rays included."""
    _, tm = _stack()
    cfg = interop.config_from(_cfg())
    gen = torch.Generator()
    gen.manual_seed(9)
    draws = trobot.draw_wander(gen, E, 40, BEAMS, "cpu", explore=True)
    got = trobot.generate_wander_episode(None, tm, cfg, ANGLES, 40, batch=E,
                                         start_pose=(1.25, 1.25, 0.0),
                                         explore=True, draws=draws)
    for e in range(E):
        one = trobot.WanderDraws(
            scan=tsensor.ScanDraws(noise=draws.scan.noise[e:e + 1]),
            tie=draws.tie[e:e + 1], dur=draws.dur[e:e + 1])
        want = trobot.generate_wander_episode(
            None, tm.map_at(int(tm.episode_maps[e])), cfg, ANGLES, 40,
            start_pose=(1.25, 1.25, 0.0), explore=True, draws=one)
        for g, w in zip(got, want):
            assert torch.equal(g[e], w[0])
    assert not torch.equal(got[2][0], got[2][2])   # the maps differ
