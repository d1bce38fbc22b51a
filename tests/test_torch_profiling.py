"""The port's profiling harness (utils/profiling) against the JAX
package's, and the JAX package's public names in io, maps, utils and
planning.

- _knockout_step with skip=() equals the port's mcl_step bit for bit (the
  same draws, from the state's generator or given), at the default
  configuration and with the analytic caster and systematic resampling.
- _knockout_step against JAX's on JAX's draws, for the full step and each
  stage knocked out: >= 99.9 % of the particle rows within 1e-5 (the
  one-tick tolerance).
- stage_knockout_times returns JAX's keys, all finite, on the CPU's
  TickGraphs; time_fn; trace writes a non-empty Chrome trace;
  utils exports profiling as JAX's utils does.
- io.save_pytree / load_pytree (round trip, like JAX's on the same tree),
  maps.grid.get_cell, utils.angles.yaw_to_quaternion_z,
  planning.bfs.bfs_path_py and planning.tsp.held_karp_py against their
  JAX twins.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (FilterConfig, ResampleConfig,
                                               SensorModelConfig)
from montecarlolocalisation_tpu.io import logs as jlogs
from montecarlolocalisation_tpu.maps import grid as jgrid
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.models import resample as jres
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.planning import bfs as jbfs
from montecarlolocalisation_tpu.planning import tsp as jtsp
from montecarlolocalisation_tpu.utils import angles as jangles
from montecarlolocalisation_tpu.utils import profiling as jprof
from montecarlolocalisation_tpu_torch import interop, io as tio
from montecarlolocalisation_tpu_torch import utils as tutils
from montecarlolocalisation_tpu_torch.maps import grid as tgrid
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.planning import bfs as tbfs
from montecarlolocalisation_tpu_torch.planning import tsp as ttsp
from montecarlolocalisation_tpu_torch.utils import angles as tangles
from montecarlolocalisation_tpu_torch.utils import profiling as tprof

from torch_parity import jax_tick_draws, maps

torch.set_num_threads(1)

N, BEAMS = 1024, 12
ANGLES = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
CONFIGS = dict(
    default=FilterConfig(num_particles=N),
    analytic=FilterConfig(num_particles=N,
                          sensor=SensorModelConfig(ray_mode="analytic"),
                          resample=ResampleConfig(method="systematic")))
SKIPS = [(), ("motion",), ("weights",), ("resample",), ("cluster",)]


def _jax_state(jm, cfg, lost=False):
    """A tracking cloud near (1.2, 2.05) and its scan (JAX arrays)."""
    st = jfilter.init_tracking_state(jax.random.PRNGKey(3), jm, cfg,
                                     (1.2, 2.05, 0.0), sigma_xy=0.1,
                                     sigma_theta=0.1)
    st = dataclasses.replace(st, inj=jres.InjectionState(
        jnp.float32(50.0), jnp.float32(1.0)))
    if lost:
        st = dataclasses.replace(st, confidence=jnp.float32(0.0))
    ranges = np.asarray(jsensor.simulate_scan(
        jm, jnp.array([1.25, 2.05, 0.0]), ANGLES, cfg.sensor).ranges)
    return st, ranges


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_knockout_full_step_equals_mcl_step(name):
    jm, tm = maps()
    cfg = CONFIGS[name]
    tcfg = interop.config_from(cfg)
    jst, ranges = _jax_state(jm, cfg)
    scan = tsensor.make_scan(ANGLES, ranges)
    enc = torch.tensor(0.1)
    # Drawn from the state's generator: two states from one seed.
    a, b = (interop.state_from_numpy(jst) for _ in range(2))
    want, _ = tfilter.mcl_step(a, enc, enc, scan, tm, tcfg)
    got = tprof._knockout_step(tm, tcfg, scan, b, enc, ())
    for f in dataclasses.fields(want):
        if f.name == "gen":
            assert torch.equal(got.gen.get_state(), want.gen.get_state())
            continue
        w, g = getattr(want, f.name), getattr(got, f.name)
        if dataclasses.is_dataclass(w):
            for sub in dataclasses.fields(w):
                assert torch.equal(getattr(g, sub.name),
                                   getattr(w, sub.name)), (f.name, sub.name)
        else:
            assert torch.equal(g, w), f.name
    # And on given draws.
    draws = jax_tick_draws(jst.key, jm, N, cfg)
    st = interop.state_from_numpy(jst)
    want, _ = tfilter.mcl_step(st, enc, enc, scan, tm, tcfg, draws=draws)
    got = tprof._knockout_step(tm, tcfg, scan, st, enc, (), draws)
    assert torch.equal(got.particles, want.particles)
    assert torch.equal(got.best_pose, want.best_pose)
    assert torch.equal(got.confidence, want.confidence)


@pytest.mark.parametrize("skip", SKIPS, ids=lambda s: "-".join(s) or "full")
def test_knockout_step_matches_jax(skip):
    jm, tm = maps()
    cfg = CONFIGS["default"]
    tcfg = interop.config_from(cfg)
    jst, ranges = _jax_state(jm, cfg, lost=True)
    enc = jnp.float32(0.1)
    want = jax.jit(lambda s: jprof._knockout_step(
        jm, cfg, jsensor.make_scan(ANGLES, ranges), s, enc, skip))(jst)
    got = tprof._knockout_step(
        tm, tcfg, tsensor.make_scan(ANGLES, ranges),
        interop.state_from_numpy(jst), torch.tensor(0.1), skip,
        jax_tick_draws(jst.key, jm, N, cfg))
    rows = np.all(np.abs(got.particles.numpy()
                         - np.asarray(want.particles)) <= 1e-5, axis=1)
    assert rows.mean() >= 0.999
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(want.weights),
                               rtol=1e-4, atol=1e-12)
    np.testing.assert_allclose(float(got.confidence),
                               float(want.confidence), atol=1e-3)
    np.testing.assert_allclose(got.best_pose.numpy(),
                               np.asarray(want.best_pose), atol=1e-3)
    assert bool(got.was_lost) == bool(want.was_lost)
    for f in ("x", "y", "theta"):
        np.testing.assert_allclose(float(getattr(got.odom, f)),
                                   float(getattr(want.odom, f)), atol=1e-6)


def _timing_inputs():
    jm, tm = maps()
    cfg = FilterConfig(num_particles=256)
    jst, ranges = _jax_state(jm, cfg)
    return (tm, interop.config_from(cfg), tsensor.make_scan(ANGLES, ranges),
            interop.state_from_numpy(jst))


def test_stage_knockout_times_returns_the_jax_keys():
    tm, tcfg, scan, st = _timing_inputs()
    before = st.particles.clone()
    out = tprof.stage_knockout_times(tm, tcfg, scan, st, iters=2)
    assert list(out) == ["full", "marginal_motion", "marginal_weights",
                         "marginal_resample", "marginal_cluster"]
    assert all(np.isfinite(v) for v in out.values())
    assert out["full"] > 0.0
    # The caller's state is left as it was.
    assert torch.equal(st.particles, before)


def test_time_fn_and_trace(tmp_path):
    calls = []
    assert tprof.time_fn(lambda x: calls.append(x), 3, iters=4,
                         warmup=2) >= 0.0
    assert calls == [3] * 6
    logdir = str(tmp_path / "trace")
    with tprof.trace(logdir):
        torch.ones(64).cumsum(0)
    path = os.path.join(logdir, "trace.json")
    assert os.path.getsize(path) > 0
    assert tutils.__all__ == ["angles", "songs", "profiling", "viz"]
    assert tutils.profiling is tprof


# ----------------------------------------------------------------------
# The JAX package's public names.
# ----------------------------------------------------------------------

def test_save_and_load_pytree_round_trip(tmp_path):
    jm, tm = maps()
    cfg = FilterConfig(num_particles=64)
    jst, _ = _jax_state(jm, cfg)
    st = interop.state_from_numpy(jst)
    tio.save_pytree(str(tmp_path / "port.npz"), st)
    like = interop.state_from_numpy(jax.device_get(
        jfilter.init_state(jax.random.PRNGKey(9), jm, cfg)))
    back = tio.load_pytree(str(tmp_path / "port.npz"), like)
    jlogs.save_pytree(str(tmp_path / "jax.npz"), jst)
    jback = jlogs.load_pytree(str(tmp_path / "jax.npz"), jst)
    assert torch.equal(back.particles, st.particles)
    np.testing.assert_array_equal(back.particles.numpy(),
                                  np.asarray(jback.particles))
    np.testing.assert_array_equal(back.best_pose.numpy(),
                                  np.asarray(jback.best_pose))
    assert torch.equal(back.gen.get_state(), st.gen.get_state())
    assert tio.EpisodeLog is tio.logs.EpisodeLog
    assert tio.__all__ == ["logs", "replay", "EpisodeLog", "save_pytree",
                           "load_pytree"]


def test_get_cell_matches_jax():
    jm, tm = maps()
    rng = np.random.RandomState(0)
    mx = rng.randint(-5, jm.width + 5, 200).astype(np.int32)
    my = rng.randint(-5, jm.height + 5, 200).astype(np.int32)
    want = np.asarray(jgrid.get_cell(jm, jnp.asarray(mx), jnp.asarray(my)))
    got = tgrid.get_cell(tm, torch.as_tensor(mx), torch.as_tensor(my))
    np.testing.assert_array_equal(got.numpy(), want)


def test_yaw_to_quaternion_z_matches_jax():
    theta = np.linspace(-7, 7, 101).astype(np.float32)
    want = np.asarray(jangles.yaw_to_quaternion_z(jnp.asarray(theta)))
    got = tangles.yaw_to_quaternion_z(torch.as_tensor(theta))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-7, rtol=0)
    # A Python float stays a float, in double precision: MCLServer's reply.
    assert tangles.yaw_to_quaternion_z(1.0) == np.sin(0.5)


def test_planner_aliases_match_jax():
    jm, _ = maps()
    walls = np.asarray(jm.walls)
    assert tbfs.bfs_path_py is tbfs.bfs_path
    assert ttsp.held_karp_py is ttsp.held_karp
    for goal in ((5, 5), (0, 5), (3, 2)):
        assert tbfs.bfs_path_py(walls, (0, 0), goal) == [
            tuple(c) for c in jbfs.bfs_path_py(walls, (0, 0), goal)]
    rng = np.random.RandomState(1)
    d = rng.randint(1, 20, (6, 6))
    d = d + d.T
    np.fill_diagonal(d, 0)
    assert ttsp.held_karp_py(d) == jtsp.held_karp_py(d)
