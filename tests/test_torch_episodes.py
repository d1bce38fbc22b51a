"""The slice as a whole: the episode-batched filter.

- One `mcl_step` on [E, N, 3] equals E single-filter `mcl_step`s with the
  same draws, bit for bit on the CPU.
- `run_episode_batch` against the JAX package's (vmap of init + scan),
  from the JAX initial states (moved across with interop) and with the
  draws JAX made, at E = 4 episodes x 256 particles x 12 beams x 3 ticks.
  Tolerances are the PR 1 tick's: >= 99.9 % of particle rows within 1e-5
  (a cumsum ulp can move a rare draw across a CDF boundary); confidence
  and best pose within 1e-3; song, wanderer command and n_injected equal.
- `sweep_rmse` (with the maze's symmetry group) on the same final states
  and truth matches JAX's within 1e-5, and `run_episode_replicas` picks the
  same winners from the same total_weight arrays.
"""
import collections
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig, MotionModelConfig, ResampleConfig, SensorModelConfig,
)
from montecarlolocalisation_tpu.maps import symmetry as jsym
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.parallel import episodes as jepisodes
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.maps import symmetry as tsym
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import resample as tresample
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.parallel import episodes as tepisodes

from torch_parity import episode, jax_episode_draws, maps, t

torch.set_num_threads(1)

E, N, BEAMS, TICKS = 4, 256, 12, 3
ANGLES = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)


def _cfg(ray_mode="fixed", method="multinomial", combine="sum",
         shared=True):
    return FilterConfig(
        num_particles=N,
        sensor=SensorModelConfig(ray_mode=ray_mode, beam_combine=combine),
        motion=MotionModelConfig(shared_noise=shared),
        resample=ResampleConfig(method=method))


def _episodes(jm, cfg, seed=0):
    enc, ranges, poses = jepisodes.simulate_episode_batch(
        jax.random.PRNGKey(seed), jm, cfg, ANGLES, TICKS, E,
        start_pose=(2.05, 2.05, 0.0))
    return np.asarray(enc), np.asarray(ranges), np.asarray(poses)


@pytest.mark.parametrize("ray_mode,method,combine,shared", [
    ("fixed", "multinomial", "sum", True),
    ("analytic", "systematic", "sum", False),
    ("fixed", "systematic", "log", True),
])
def test_batched_tick_equals_single_ticks_bit_for_bit(ray_mode, method,
                                                      combine, shared):
    _, tm = maps()
    cfg = interop.config_from(_cfg(ray_mode, method, combine, shared))
    state = tfilter.init_state(tm, cfg, seed=2, batch=E)
    # The kidnap detector armed, so injection runs in the batch.
    state = dataclasses.replace(state, inj=tresample.InjectionState(
        torch.full((E,), 50.0), torch.ones(E)))
    singles = [episode(state, e) for e in range(E)]
    gen = torch.Generator()
    gen.manual_seed(3)
    truth = torch.tensor([[1.25, 1.25, 0.0], [2.05, 3.3, 1.2],
                          [3.7, 0.5, -2.0], [0.45, 2.9, 0.4]])
    for tick in range(TICKS):
        scan = tsensor.simulate_scan(tm, truth, ANGLES, cfg.sensor, gen=gen)
        draws = tfilter.draw_tick(gen, tm, N, cfg, (E,))
        enc = torch.full((E,), 0.3 * (tick + 1)), torch.full(
            (E,), 0.28 * (tick + 1))
        state, out = tfilter.mcl_step(state, *enc, scan, tm, cfg,
                                      draws=draws)
        for e in range(E):
            one = tsensor.Scan(scan.angles, scan.ranges[e], scan.mask[e])
            singles[e], o = tfilter.mcl_step(
                singles[e], enc[0][e], enc[1][e], one, tm, cfg,
                draws=episode(draws, e))
            assert torch.equal(singles[e].particles, state.particles[e])
            assert torch.equal(singles[e].best_pose, state.best_pose[e])
            for f in dataclasses.fields(o):
                assert torch.equal(getattr(o, f.name),
                                   getattr(out, f.name)[e]), f.name
    assert int(out.n_injected.sum()) > 0


@pytest.mark.parametrize("ray_mode,method", [("fixed", "multinomial"),
                                             ("analytic", "systematic")])
def test_run_episode_batch_matches_jax(ray_mode, method):
    jm, tm = maps()
    jcfg = _cfg(ray_mode, method)
    enc, ranges, _ = _episodes(jm, jcfg)
    key = jax.random.PRNGKey(5)
    jfinal, jouts = jepisodes.run_episode_batch(key, jm, jcfg, enc, ranges,
                                                ANGLES)
    # JAX's initial states and the draws of every tick, per episode.
    states0 = jax.vmap(lambda k: jfilter.init_state(k, jm, jcfg))(
        jax.random.split(key, E))
    draws = jax_episode_draws(states0, jm, N, jcfg, TICKS)
    final, outs = tepisodes.run_episode_batch(
        0, tm, interop.config_from(jcfg), enc, ranges, ANGLES,
        state=interop.state_from_numpy(states0), draws=draws)
    assert final.particles.shape == (E, N, 3)
    assert outs.confidence.shape == (E, TICKS)
    for tick in range(TICKS):
        for f in ("song", "wanderer_cmd", "n_injected"):
            np.testing.assert_array_equal(
                getattr(outs, f)[:, tick].numpy(),
                np.asarray(getattr(jouts, f))[:, tick], err_msg=f)
        np.testing.assert_allclose(outs.confidence[:, tick].numpy(),
                                   np.asarray(jouts.confidence)[:, tick],
                                   atol=1e-3)
        np.testing.assert_allclose(outs.exact_pose[:, tick].numpy(),
                                   np.asarray(jouts.exact_pose)[:, tick],
                                   atol=1e-3)
        np.testing.assert_allclose(outs.total_weight[:, tick].numpy(),
                                   np.asarray(jouts.total_weight)[:, tick],
                                   rtol=1e-4)
    rows = np.all(np.abs(final.particles.numpy()
                         - np.asarray(jfinal.particles)) <= 1e-5, axis=-1)
    assert rows.mean() >= 0.999, rows.mean()
    np.testing.assert_allclose(final.best_pose.numpy(),
                               np.asarray(jfinal.best_pose), atol=1e-3)


def test_run_episode_batch_seeded_and_tick_chunk_changes_nothing():
    jm, tm = maps()
    cfg = interop.config_from(_cfg())
    enc, ranges, _ = _episodes(jm, _cfg(), seed=1)
    a, oa = tepisodes.run_episode_batch(7, tm, cfg, enc, ranges, ANGLES)
    b, ob = tepisodes.run_episode_batch(7, tm, cfg, enc, ranges, ANGLES,
                                        tick_chunk=1)
    assert torch.equal(a.particles, b.particles)
    assert torch.equal(oa.confidence, ob.confidence)
    assert torch.isfinite(a.particles).all()
    with pytest.raises(ValueError):
        tepisodes.run_episode_batch(7, tm, cfg, enc, ranges, ANGLES,
                                    tick_chunk=0)


def test_sweep_rmse_matches_jax():
    jm, tm = maps()
    rng = np.random.default_rng(11)
    n_ep = 24
    truth = rng.uniform(0.3, 4.5, (n_ep, 5, 3)).astype(np.float32)
    truth[..., 2] = rng.uniform(-3, 3, (n_ep, 5))
    best = truth[:, -1] + rng.normal(0, 0.2, (n_ep, 3)).astype(np.float32)
    best[::4] = -1.0                                   # unconverged
    parts = (best[:, None, :] + rng.normal(0, 0.3, (n_ep, 64, 3))).astype(
        np.float32)
    weights = rng.uniform(0.1, 1.0, (n_ep, 64)).astype(np.float32)
    jstate = collections.namedtuple("S", "best_pose particles weights")(
        jnp.asarray(best), jnp.asarray(parts), jnp.asarray(weights))
    tstate = collections.namedtuple("S", "best_pose particles weights")(
        t(best), t(parts), t(weights))
    walls = np.asarray(jm.walls)
    jg = jsym.maze_symmetries(walls, float(jm.cell_meters))
    tg = tsym.maze_symmetries(walls, float(tm.cell_meters))
    want = jepisodes.sweep_rmse(jstate, truth, sym=jg)
    got = tepisodes.sweep_rmse(tstate, truth, sym=tg)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], float(want[k]), atol=1e-5,
                                   err_msg=k)


def test_replicas_pick_the_same_winners_as_jax(monkeypatch):
    # The same per-replica total_weight arrays through both selections:
    # JAX's host loop (run_episode_batch patched to hand them out) and the
    # port's replica-major batch.
    rng = np.random.default_rng(12)
    reps, n_ep = 3, 5
    tw = rng.uniform(0.0, 2.0, (reps, n_ep, TICKS)).astype(np.float32)
    tw[1, 2] = 0.0                                    # log floor 1e-30
    Out = collections.namedtuple("Out", "total_weight")
    calls = iter(range(reps))

    def fake(*args, **kw):
        r = next(calls)
        return {"replica": jnp.full((n_ep,), r)}, Out(jnp.asarray(tw[r]))

    monkeypatch.setattr(jepisodes, "run_episode_batch", fake)
    _, _, jinfo = jepisodes.run_episode_replicas(
        jax.random.PRNGKey(0), None, None, np.zeros((n_ep, TICKS, 2)),
        np.zeros((n_ep, TICKS, BEAMS)), ANGLES, replicas=reps)

    _, tm = maps()
    cfg = interop.config_from(_cfg())
    final = tfilter.init_state(tm, cfg, seed=0, batch=reps * n_ep)
    rows = torch.arange(reps * n_ep, dtype=torch.float32)
    final = dataclasses.replace(final, confidence=rows)
    outs = tfilter.MCLOutput(**{
        f.name: torch.zeros((reps * n_ep, TICKS))
        for f in dataclasses.fields(tfilter.MCLOutput)})
    outs = dataclasses.replace(outs, total_weight=t(tw.reshape(-1, TICKS)))
    win, wout, info = tepisodes.pick_replicas(final, outs, reps)
    np.testing.assert_array_equal(info["chosen"], jinfo["chosen"])
    np.testing.assert_allclose(info["log_evidence"], jinfo["log_evidence"])
    np.testing.assert_array_equal(
        win.confidence.numpy(), jinfo["chosen"] * n_ep + np.arange(n_ep))
    np.testing.assert_array_equal(
        wout.total_weight.numpy(), tw[jinfo["chosen"], np.arange(n_ep)])
    assert win.particles.shape == (n_ep, N, 3)


def test_run_episode_replicas_runs_one_batch():
    jm, tm = maps()
    cfg = interop.config_from(_cfg())
    enc, ranges, _ = _episodes(jm, _cfg(), seed=2)
    final, outs, info = tepisodes.run_episode_replicas(
        3, tm, cfg, enc, ranges, ANGLES, replicas=2)
    assert final.particles.shape == (E, N, 3)
    assert outs.total_weight.shape == (E, TICKS)
    assert info["log_evidence"].shape == (2, E)
    assert info["chosen"].shape == (E,)


def test_sweep_cli_prints_the_jax_presets_metrics():
    import json
    import os.path as osp
    import subprocess
    import sys

    root = osp.dirname(osp.dirname(osp.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, "-m", "montecarlolocalisation_tpu_torch", "sweep",
         "--batch", "4", "--ticks", "4", "--particles", "64", "--device",
         "cpu"], cwd=root, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    got = json.loads(r.stdout.strip().splitlines()[-1])
    jm, _ = maps()
    walls = np.asarray(jm.walls)
    truth = np.zeros((2, 1, 3), np.float32)
    want = jepisodes.sweep_rmse(
        collections.namedtuple("S", "best_pose particles weights")(
            jnp.full((2, 3), -1.0), jnp.zeros((2, 4, 3)), jnp.ones((2, 4))),
        truth, sym=jsym.maze_symmetries(walls, 0.8))
    assert set(got) == set(want)
    assert 0.0 <= got["converged_frac"] <= 1.0
