"""The port's differentiable calibration (models/calibrate) against the
JAX package's.

- integrate_odometry on JAX's 200-tick wander log within 1e-4 m and rad
  (200 ticks of float32 accumulation in two orders), and the JAX suite's
  dead-reckoning check (tests/test_calibrate.py: exact against the
  simulator to 1e-3 m) on the port.
- fit_motion_params (500 Adam epochs from guesses 15 % off) and
  fit_sensor_sigma (400 from a guess 2 times off) against JAX's on the
  same logs within 1e-3 relative, and the JAX suite's recoveries on the
  port: the wheel constants within 2 % and 5 %, sigma within 15 %; an
  episode batch against JAX's vmap.
- The gradient flows through a tensor wheel_space; the CPU runs its
  epochs eagerly, one call of the epoch graph each (its `replays`, its
  `cuda` False); the `calibrate` CLI prints the JAX preset's keys.
"""
import functools
import json
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu import presets as jpresets
from montecarlolocalisation_tpu.config import FilterConfig, SensorModelConfig
from montecarlolocalisation_tpu.models import calibrate as jcal
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.sim import robot as jrobot
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.models import calibrate as tcal
from montecarlolocalisation_tpu_torch.models import compiled

from torch_parity import maps

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
START = (2.05, 2.05, 0.0)
CFG = FilterConfig(num_particles=8,
                   sensor=SensorModelConfig(lookup_mode="gather"))
TCFG = interop.config_from(CFG)
INIT = dict(wheel_size=CFG.motion.wheel_size * 1.15,
            wheel_space=CFG.motion.wheel_space * 0.85)


@functools.lru_cache(maxsize=None)
def _log(ticks=200, seed=0):
    """The JAX simulator's wander (encoders [T, 2], poses [T, 3])."""
    jm, _ = maps()
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    enc, _, poses = jrobot.generate_wander_episode(
        jax.random.PRNGKey(seed), jm, CFG, angles, ticks, start_pose=START)
    return np.asarray(enc), np.asarray(poses)


def _wrap(a):
    return np.arctan2(np.sin(a), np.cos(a))


def test_integrate_odometry_matches_jax():
    enc, _ = _log()
    want = np.asarray(jcal.integrate_odometry(enc, START, CFG.motion))
    got = tcal.integrate_odometry(enc, START, TCFG.motion,
                                  device="cpu").numpy()
    assert got.shape == want.shape == (200, 3)
    np.testing.assert_allclose(got[:, :2], want[:, :2], atol=1e-4, rtol=0)
    assert np.abs(_wrap(got[:, 2] - want[:, 2])).max() <= 1e-4


def test_integrate_odometry_matches_sim():
    # The JAX suite's check: noise-free encoders and the same kinematics,
    # so dead reckoning follows the simulator's truth.
    enc, poses = _log(120)
    pred = tcal.integrate_odometry(torch.tensor(enc), START, TCFG.motion)
    err = np.hypot(*(pred.numpy()[:, :2] - poses[:, :2]).T)
    assert err.max() < 1e-3, err.max()


def test_gradient_flows_through_a_tensor_wheel_space():
    enc, poses = _log(60)
    wsp = torch.tensor(0.25, requires_grad=True)
    ws = torch.tensor(0.06, requires_grad=True)
    pred = tcal.integrate_odometry(enc, START, TCFG.motion, ws, wsp,
                                   device="cpu")
    loss = tcal._pose_loss(pred, torch.tensor(poses))
    loss.backward()
    assert float(wsp.grad) != 0.0 and float(ws.grad) != 0.0
    # The float path is the filter's: a float wheel_space gives the same
    # poses as the config's.
    same = tcal.integrate_odometry(enc, START, TCFG.motion, None,
                                   TCFG.motion.wheel_space, device="cpu")
    assert torch.equal(same, tcal.integrate_odometry(
        enc, START, TCFG.motion, device="cpu"))


def _epochs_run(fit):
    """fit() and the epochs it ran by the epoch graphs' own count:
    replayed (CUDA graphs) and eager (the CPU's TickGraph)."""
    before = {g: g.replays for g in compiled.graphs.entries()}
    out = fit()
    ran = dict(replayed=0, eager=0)
    for g in compiled.graphs.entries():
        if g.step is tcal._epoch:
            ran["replayed" if g.cuda else "eager"] += (
                g.replays - before.get(g, 0))
    return out, ran


@functools.lru_cache(maxsize=None)
def _motion_fits():
    enc, poses = _log()
    kw = dict(init=INIT, steps=500, lr=5e-3, start_poses=START)
    want = jcal.fit_motion_params(enc, poses, CFG.motion, **kw)
    got, ran = _epochs_run(lambda: tcal.fit_motion_params(
        enc, poses, TCFG.motion, device="cpu", **kw))
    return ({k: float(v) for k, v in want.items()},
            {k: float(v) for k, v in got.items()}, ran)


def test_fit_motion_params_matches_jax():
    want, got, ran = _motion_fits()
    assert set(got) == set(want) == {"wheel_size", "wheel_space", "loss"}
    for key in ("wheel_size", "wheel_space"):
        assert abs(got[key] - want[key]) <= 1e-3 * abs(want[key]), key
    assert got["loss"] == pytest.approx(want["loss"], rel=0.05, abs=1e-7)
    # On the CPU the epochs run eagerly, one call of the epoch each.
    assert ran == dict(replayed=0, eager=500)


def test_fit_motion_params_recovers_truth():
    _, got, _ = _motion_fits()
    ws, wsp = got["wheel_size"], got["wheel_space"]
    assert abs(ws - CFG.motion.wheel_size) / CFG.motion.wheel_size < 0.02
    assert abs(wsp - CFG.motion.wheel_space) / CFG.motion.wheel_space < 0.05


def test_fit_motion_params_batch_matches_jax_vmap():
    encs, poses = zip(*(_log(60, seed) for seed in (1, 2)))
    enc, truth = np.stack(encs), np.stack(poses)
    starts = np.array([START, START], np.float32)
    kw = dict(init=INIT, steps=40, lr=5e-3, start_poses=starts)
    want = jcal.fit_motion_params(enc, truth, CFG.motion, **kw)
    got = tcal.fit_motion_params(torch.as_tensor(enc),
                                 torch.as_tensor(truth), TCFG.motion, **kw)
    for key in ("wheel_size", "wheel_space"):
        assert abs(float(got[key]) - float(want[key])) <= 1e-3 * abs(
            float(want[key])), key


@functools.lru_cache(maxsize=None)
def _sigma_fits():
    jm, tm = maps()
    true_sigma = 0.07
    angles = np.deg2rad(np.linspace(-118, 118, 48)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(4), 40)
    poses = jnp.tile(jnp.array([2.05, 2.05, 0.4]), (40, 1))
    scans = jnp.stack([
        jsensor.simulate_scan(jm, poses[i], angles, CFG.sensor, key=keys[i],
                              noise_sigma=true_sigma).ranges
        for i in range(40)])
    kw = dict(init_sigma=2.0 * true_sigma, steps=400, lr=5e-2)
    want = jcal.fit_sensor_sigma(jm, poses, scans, angles, CFG.sensor, **kw)
    got = tcal.fit_sensor_sigma(tm, np.asarray(poses), np.asarray(scans),
                                angles, TCFG.sensor, **kw)
    return ({k: float(v) for k, v in want.items()},
            {k: float(v) for k, v in got.items()}, true_sigma)


def test_fit_sensor_sigma_matches_jax():
    want, got, _ = _sigma_fits()
    assert set(got) == set(want) == {"sigma", "loss"}
    assert abs(got["sigma"] - want["sigma"]) <= 1e-3 * want["sigma"]
    assert abs(got["loss"] - want["loss"]) <= 1e-3 * abs(want["loss"])


def test_fit_sensor_sigma_recovers_truth():
    _, got, true_sigma = _sigma_fits()
    assert abs(got["sigma"] - true_sigma) / true_sigma < 0.15
    assert np.isfinite(got["loss"])


def test_calibrate_cli_prints_the_jax_keys():
    r = subprocess.run(
        [sys.executable, "-m", "montecarlolocalisation_tpu_torch",
         "calibrate", "--ticks", "30", "--device", "cpu"], cwd=ROOT,
        capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr
    line = json.loads(r.stdout.strip().splitlines()[-1])
    jworld = jpresets.make_world(num_particles=8)
    want = jpresets.run_calibrate(jworld, seed=0, num_ticks=30)
    assert list(line) == ["preset"] + list(want)
    assert line["preset"] == "calibrate"
    assert all(isinstance(line[k], float) and np.isfinite(line[k])
               for k in want)
    assert line["wheel_size_true"] == round(CFG.motion.wheel_size, 5)
    assert line["sigma_true"] == 0.05
