"""K1's plain version (ops/weights.beam_weights_plain, and the dense path
of models/sensor.beam_weights) vs the JAX package: its Pallas kernel
`beam_weights_pallas(..., interpret=True)` and its dense path, with two dead
mask lanes.  Tolerances are test_weights_pallas.py's: sum rtol 1e-5, log
rtol 1e-4, analytic > 99.9 % close (pixel-boundary ties shift a beam's
whole Gaussian)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import SensorModelConfig
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.ops.weights_pallas import beam_weights_pallas
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.ops import weights as tweights

from torch_parity import maps, t, uniform_particles

torch.set_num_threads(1)


def _fixture(n, beams=8, seed=0):
    jm, tm = maps()
    parts = uniform_particles(jm, n, seed)
    angles = np.deg2rad(np.linspace(-118, 118, beams)).astype(np.float32)
    scan = jsensor.simulate_scan(jm, jnp.array([1.25, 1.25, 0.0]), angles,
                                 SensorModelConfig())
    jscan = jsensor.Scan(angles=jnp.pad(scan.angles, (0, 2)),
                         ranges=jnp.pad(scan.ranges, (0, 2)),
                         mask=jnp.pad(jnp.ones(beams, bool), (0, 2)))
    tscan = tsensor.make_scan(np.asarray(jscan.angles),
                              np.asarray(jscan.ranges),
                              np.asarray(jscan.mask))
    return jm, tm, parts, jscan, tscan


def _check(got, want, cfg):
    rtol = 1e-4 if cfg.beam_combine == "log" else 1e-5
    close = np.isclose(got, want, rtol=rtol, atol=1e-6)
    if cfg.ray_mode == "analytic":
        assert close.mean() > 0.999
    else:
        assert close.all(), np.abs(got - want).max()


@pytest.mark.parametrize("n", [500, 1024])
@pytest.mark.parametrize("combine", ["sum", "log"])
@pytest.mark.parametrize("ray_mode", ["fixed", "analytic"])
def test_plain_matches_jax_kernel_and_dense(ray_mode, combine, n):
    jm, tm, parts, jscan, tscan = _fixture(n)
    cfg = SensorModelConfig(ray_mode=ray_mode, beam_combine=combine,
                            log_temperature=2.0)
    raw = beam_weights_pallas(jm, jnp.asarray(parts), jscan, cfg,
                              interpret=True)
    if combine == "log":
        raw = jsensor.finish_log_weights(jm, cfg, jnp.asarray(parts), raw)
    dense = jax.jit(lambda p: jsensor._beam_weights_dense(
        jm, p, jscan, cfg, 0.1, "gather"))(parts)
    tcfg = config_from(cfg)
    plain = tweights.beam_weights_plain(tm, t(parts), tscan, tcfg)
    if combine == "log":
        plain = tsensor.finish_log_weights(tm, tcfg, t(parts), plain)
    got = tsensor.beam_weights(tm, t(parts), tscan, tcfg).numpy()
    np.testing.assert_array_equal(plain.numpy(), got)
    _check(got, np.asarray(raw), cfg)
    _check(got, np.asarray(dense), cfg)
    assert (got > 0).mean() > 0.3


@pytest.mark.parametrize("quantize", [False, True])
def test_quantized_march_matches(quantize):
    jm, tm, parts, jscan, tscan = _fixture(700, beams=12, seed=3)
    cfg = SensorModelConfig(quantize_ray_deg=quantize)
    want = jax.jit(lambda p: jsensor.beam_weights(jm, p, jscan, cfg))(parts)
    got = tsensor.beam_weights(tm, t(parts), tscan,
                               config_from(cfg)).numpy()
    _check(got, np.asarray(want), cfg)


def test_wrapper_takes_plain_version_on_cpu():
    _, tm, parts, _, tscan = _fixture(64)
    cfg = config_from(SensorModelConfig())
    before = tweights.beam_weights_cuda.launches
    out = tweights.beam_weights(tm, t(parts), tscan, cfg)
    assert out.shape == (64,) and out.device.type == "cpu"
    assert tweights.beam_weights_cuda.launches == before
