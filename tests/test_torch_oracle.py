"""Oracle parity for the port: the six checks of tests/test_parity.py run
against the port's modules, with the C++-faithful NumPy oracle
(tests/oracle.py) as the reference and test_parity's own tolerances:
beam weights rtol/atol 2e-3 with the zero pattern exact, the march > 97 %
within 1e-5 (a float32 step can flip a boundary sample, never by more than
one step), validity > 99.5 %, the odometry decomposition within 1e-5, the
Gaussian against the lookup table within 5e-5, and a whole filter's
seed-averaged posterior statistics over 24 ticks (cloud mean, spread,
injection volume and phase, confidence)."""
import jax
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import FilterConfig as JFilterConfig
from montecarlolocalisation_tpu.config import ResampleConfig as JResample
from montecarlolocalisation_tpu.config import SensorModelConfig as JSensor
from montecarlolocalisation_tpu.sim import robot as jrobot
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.config import (
    MotionModelConfig, SensorModelConfig,
)
from montecarlolocalisation_tpu_torch.maps.grid import is_valid_pos
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import motion as tmotion
from montecarlolocalisation_tpu_torch.models import resample as tresample
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.models.raycast import raycast

from oracle import GaussianLUT, Oracle, OracleFilter, diff_drive_decompose
from torch_parity import maps, t

torch.set_num_threads(1)

ANGLES = np.deg2rad(np.linspace(-115, 115, 16)).astype(np.float32)


@pytest.fixture(scope="module")
def setup():
    jm, tm = maps()
    cfg = SensorModelConfig(ray_mode="fixed", lookup_mode="gather")
    return jm, tm, Oracle(tm.occ.numpy()), cfg


def test_beam_weights_match_oracle(setup):
    _, tm, oracle, cfg = setup
    gen = torch.Generator()
    gen.manual_seed(3)
    parts = tresample.sample_uniform_particles(gen, tm, 256)
    scan = tsensor.simulate_scan(tm, torch.tensor([2.05, 2.05, 0.4]),
                                 ANGLES, cfg)
    got = tsensor.beam_weights(tm, parts, scan, cfg).numpy()
    want = oracle.compute_weights(parts.numpy().astype(np.float64), ANGLES,
                                  scan.ranges.numpy())
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    np.testing.assert_array_equal(got == 0.0, want == 0.0)


def test_raycast_matches_oracle(setup):
    _, tm, oracle, cfg = setup
    rng = np.random.default_rng(1)
    xs = rng.uniform(0.2, 4.6, 128)
    ys = rng.uniform(0.2, 4.6, 128)
    ths = rng.uniform(-np.pi, np.pi, 128)
    got = raycast(tm, t(xs), t(ys), t(ths), cfg).numpy()
    want = np.array([oracle.raycast(x, y, th)
                     for x, y, th in zip(xs, ys, ths)])
    agree = np.isclose(got, want, atol=1e-5)
    assert agree.mean() > 0.97
    if (~agree).any():
        assert np.abs(got[~agree] - want[~agree]).max() <= 0.1 + 1e-6


def test_validity_matches_oracle(setup):
    _, tm, oracle, _ = setup
    rng = np.random.default_rng(2)
    xs = rng.uniform(-0.2, 5.1, 512)
    ys = rng.uniform(-0.2, 5.1, 512)
    got = is_valid_pos(tm, t(xs), t(ys)).numpy()
    want = np.array([oracle.is_valid_pos(x, y) for x, y in zip(xs, ys)])
    assert (got == want).mean() > 0.995


def test_motion_decomposition_matches_oracle():
    cfg = MotionModelConfig()
    st = tmotion.OdometryState.zero()
    for enc in ((3.0, 5.0), (10.0, 4.0), (-2.0, 2.0), (7.7, 7.7)):
        new, rot1, trans, rot2 = tmotion.diff_drive_update(
            st, torch.tensor(enc[0]), torch.tensor(enc[1]), cfg)
        (ox, oy, oth), orot1, otrans, orot2 = diff_drive_decompose(
            (0.0, 0.0, 0.0), (0.0, 0.0), enc)
        for got, want in ((new.x, ox), (new.y, oy), (new.theta, oth),
                          (rot1, orot1), (trans, otrans), (rot2, orot2)):
            assert float(got) == pytest.approx(want, abs=1e-5)


def test_gauss_exact_vs_lut_error_bound():
    lut = GaussianLUT()
    diffs = np.linspace(0, 1.1, 2003)
    exact = tsensor.gauss_pdf(t(diffs), SensorModelConfig()).numpy()
    table = np.array([lut.get(d) for d in diffs])
    np.testing.assert_allclose(exact, table, atol=5e-5)


def test_episode_posterior_statistics_match_oracle(setup):
    """The oracle as a whole filter (OracleFilter, the executeParticleFilter
    tick loop) and the port's mcl_step on the same inputs from a tracking
    start; per-draw streams cannot match, so the seed-averaged per-tick
    statistics are compared, as test_parity does for the JAX filter."""
    jm, tm, oracle, _ = setup
    n, ticks, seeds = 384, 24, 6
    start = (1.25, 1.25, 0.0)
    jcfg = JFilterConfig(
        num_particles=n,
        sensor=JSensor(ray_mode="fixed", lookup_mode="gather"),
        resample=JResample(method="multinomial", multinomial_impl="exact"))
    cfg = interop.config_from(jcfg)
    enc, scans, _ = jrobot.generate_wander_episode(
        jax.random.PRNGKey(5), jm, jcfg, ANGLES, ticks, start_pose=start)
    enc, scans = np.asarray(enc), np.asarray(scans)

    def run_port(seed):
        state = tfilter.init_tracking_state(tm, cfg, start, seed=seed)
        mean, spread, conf, ninj = [], [], [], []
        for k in range(ticks):
            sc = tsensor.make_scan(ANGLES, scans[k])
            state, out = tfilter.mcl_step(state, t(enc[k, 0]), t(enc[k, 1]),
                                          sc, tm, cfg)
            xy = state.particles[:, :2].numpy()
            mean.append(xy.mean(axis=0))
            spread.append(float(np.sqrt(
                ((xy - xy.mean(axis=0)) ** 2).sum(axis=1).mean())))
            conf.append(float(state.confidence))
            ninj.append(int(out.n_injected))
        return tuple(map(np.asarray, (mean, spread, conf, ninj)))

    def run_oracle(seed):
        of = OracleFilter(oracle, n, seed=seed, start_pose=start)
        recs = [of.tick(float(enc[k, 0]), float(enc[k, 1]), ANGLES,
                        scans[k]) for k in range(ticks)]
        return tuple(np.asarray([r[f] for r in recs])
                     for f in ("mean", "spread", "confidence", "n_injected"))

    p = [run_port(100 + s) for s in range(seeds)]
    o = [run_oracle(200 + s) for s in range(seeds)]
    pm, ps, pc, pi = (np.mean([r[k] for r in p], axis=0) for k in range(4))
    om, os_, oc, oi = (np.mean([r[k] for r in o], axis=0) for k in range(4))
    d = np.hypot(pm[:, 0] - om[:, 0], pm[:, 1] - om[:, 1])
    assert d.mean() < 0.2, f"ens cloud-mean gap {d.mean():.3f} m"
    rs = ps[3:].mean() / os_[3:].mean()
    assert 0.6 < rs < 1.5, f"ens spread ratio {rs:.2f}"
    assert pi.sum() > 0 and oi.sum() > 0, "oscillator quirk missing"
    rel = abs(pi.sum() - oi.sum()) / max(oi.sum(), 1.0)
    assert rel < 0.5, f"total injected {pi.sum():.0f} vs {oi.sum():.0f}"
    pb, ob = pi > 0.5, oi > 0.5
    overlap = (pb & ob).sum() / max((pb | ob).sum(), 1)
    assert overlap >= 0.6, f"injection-phase overlap {overlap:.2f}"
    assert abs(pc.mean() - oc.mean()) < 0.12, \
        f"confidence {pc.mean():.2f} vs {oc.mean():.2f}"
