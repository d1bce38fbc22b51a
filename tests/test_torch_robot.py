"""sim/robot: the port's wander simulator against the JAX package's
`generate_wander_episode`, with the random numbers JAX drew for each tick
handed to the port (scan noise, dropout and outliers, wheel slip, the
explore turn).  Encoders and poses within 1e-5, ranges within 1e-4."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import FilterConfig
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.sim import robot as jrobot
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.sim import robot as trobot

from torch_parity import maps, t

torch.set_num_threads(1)

TICKS, BEAMS = 40, 12
ANGLES = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)


def jax_wander_draws(key, cfg, turn_ticks=10):
    """The draws of robot.py's tick keys (robot.py:154-171, and
    sensor.py:465-478 for each tick's scan), as a batch of one."""
    noise, drop, out, outv, slip, tie, dur = ([] for _ in range(7))
    for tk in jax.random.split(key, TICKS):
        k_noise, k_drop, k_out, k_outv = jax.random.split(tk, 4)
        noise.append(jax.random.normal(k_noise, (BEAMS,)))
        drop.append(jax.random.uniform(k_drop, (BEAMS,)))
        out.append(jax.random.uniform(k_out, (BEAMS,)))
        outv.append(jax.random.uniform(k_outv, (BEAMS,),
                                       maxval=cfg.sensor.max_range)
                    / cfg.sensor.max_range)
        slip.append(jax.random.normal(jax.random.fold_in(tk, 1), (2,)))
        tie.append(jax.random.normal(jax.random.fold_in(tk, 2)))
        dur.append(jax.random.randint(jax.random.fold_in(tk, 3), (),
                                      max(turn_ticks // 2, 1),
                                      2 * turn_ticks + 1))

    def b(xs, dtype=torch.float32):
        return t(np.stack([np.asarray(x) for x in xs])[None], dtype)

    return trobot.WanderDraws(
        scan=tsensor.ScanDraws(noise=b(noise), drop=b(drop), out=b(out),
                               outv=b(outv)),
        slip=b(slip), tie=b(tie), dur=b(dur, torch.int64))


@pytest.mark.parametrize("stressor", [
    dict(),
    dict(kidnap_tick=12),
    dict(slip_noise=0.1),
    dict(moving_obstacle=(2.05, 2.05, 0.5, 0.15, 0.3)),
    dict(explore=True),
    dict(scan_noise=0.02, dropout_p=0.2, outlier_p=0.2),
])
def test_wander_matches_jax(stressor):
    jm, tm = maps()
    jcfg = FilterConfig()
    kw = dict(dict(scan_noise=0.0), **stressor)
    key = jax.random.PRNGKey(4)
    enc, ranges, poses = jrobot.generate_wander_episode(
        key, jm, jcfg, ANGLES, TICKS, start_pose=(2.05, 2.05, 0.0), **kw)
    tenc, tranges, tposes = trobot.generate_wander_episode(
        None, tm, interop.config_from(jcfg), ANGLES, TICKS,
        start_pose=(2.05, 2.05, 0.0), draws=jax_wander_draws(key, jcfg),
        **kw)
    assert tenc.shape == (1, TICKS, 2) and tranges.shape == (1, TICKS, BEAMS)
    np.testing.assert_allclose(tenc[0].numpy(), np.asarray(enc), atol=1e-5)
    np.testing.assert_allclose(tposes[0].numpy(), np.asarray(poses),
                               atol=1e-5)
    np.testing.assert_allclose(tranges[0].numpy(), np.asarray(ranges),
                               atol=1e-4)
    # The walk turns at walls at least once.
    assert np.ptp(np.asarray(poses)[:, 2]) > 0.5


def test_batch_of_robots_and_generator_draws():
    _, tm = maps()
    cfg = interop.config_from(FilterConfig())
    gen = torch.Generator()
    gen.manual_seed(0)
    enc, ranges, poses = trobot.generate_wander_episode(
        gen, tm, cfg, ANGLES, 10, batch=5, slip_noise=0.05, outlier_p=0.1)
    assert enc.shape == (5, 10, 2) and poses.shape == (5, 10, 3)
    assert ranges.shape == (5, 10, BEAMS)
    assert torch.isfinite(ranges).all()
    # Slip differs per robot, so the truths drift apart; the commanded
    # encoders do not see it.
    assert poses[:, -1, 0].unique().numel() > 1
    assert enc[:, -1].unique(dim=0).shape[0] == 1


def test_simulate_scan_stressors_match_jax():
    jm, tm = maps()
    cfg = FilterConfig().sensor
    pose = np.float32([1.25, 1.25, 0.3])
    key = jax.random.PRNGKey(9)
    obstacle = (1.6, 1.25, 0.1)
    want = jsensor.simulate_scan(jm, jnp.asarray(pose), ANGLES, cfg, key=key,
                                 noise_sigma=0.02, dropout_p=0.3,
                                 outlier_p=0.3, obstacle=obstacle)
    k_noise, k_drop, k_out, k_outv = jax.random.split(key, 4)
    draws = tsensor.ScanDraws(
        noise=t(jax.random.normal(k_noise, (BEAMS,))),
        drop=t(jax.random.uniform(k_drop, (BEAMS,))),
        out=t(jax.random.uniform(k_out, (BEAMS,))),
        outv=t(jax.random.uniform(k_outv, (BEAMS,))))
    got = tsensor.simulate_scan(tm, pose, ANGLES, interop.config_from(cfg),
                                noise_sigma=0.02, dropout_p=0.3,
                                outlier_p=0.3, obstacle=obstacle,
                                draws=draws)
    np.testing.assert_allclose(got.ranges.numpy(), np.asarray(want.ranges),
                               atol=1e-4)
    assert (got.ranges.numpy() == cfg.invalid_beam_range).any()
