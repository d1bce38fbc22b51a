"""Port motion model vs montecarlolocalisation_tpu/models/motion.py, with
the normals JAX drew.  rtol 1e-6: the same float32 operations, except that
XLA on the CPU may fuse a multiply-add and its sin/cos/atan2 can differ
from torch's in the last bit."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import MotionModelConfig
from montecarlolocalisation_tpu.models import motion as jmotion
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.models import motion as tmotion

from torch_parity import t

torch.set_num_threads(1)


def _odom_pair(x, y, th, el, er):
    j = jmotion.OdometryState(*(jnp.float32(v) for v in (x, y, th, el, er)))
    o = tmotion.OdometryState(*(t(v) for v in (x, y, th, el, er)))
    return j, o


@pytest.mark.parametrize("enc", [(0.3, 0.3), (0.5, -0.2), (-1.0, 0.7),
                                 (0.0, 0.0)])
def test_diff_drive_update(enc):
    cfg = MotionModelConfig()
    j, o = _odom_pair(1.2, 2.1, 0.4, 0.1, -0.05)
    jn, *jr = jax.jit(lambda s, a, b: jmotion.diff_drive_update(s, a, b, cfg))(
        j, jnp.float32(enc[0]), jnp.float32(enc[1]))
    tn, *tr = tmotion.diff_drive_update(o, enc[0], enc[1], config_from(cfg))
    for f in ("x", "y", "theta", "encoder_left", "encoder_right"):
        np.testing.assert_allclose(float(getattr(tn, f)),
                                   float(getattr(jn, f)), rtol=1e-6,
                                   atol=1e-7)
    np.testing.assert_allclose([float(v) for v in tr],
                               [float(v) for v in jr], rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shared", [True, False])
def test_motion_update_with_jax_normals(shared):
    cfg = dataclasses.replace(MotionModelConfig(), shared_noise=shared)
    n = 512
    rng = np.random.default_rng(3)
    parts = np.stack([rng.uniform(0.2, 4.6, n), rng.uniform(0.2, 4.6, n),
                      rng.uniform(-3.1, 3.1, n)], -1).astype(np.float32)
    key = jax.random.PRNGKey(11)
    j, o = _odom_pair(1.0, 1.0, 0.2, 0.0, 0.0)
    jn, jp = jax.jit(lambda k, s, p: jmotion.motion_update(
        k, p, s, jnp.float32(0.4), jnp.float32(0.25), cfg))(key, j, parts)
    shape = () if shared else (n,)
    normals = np.stack([np.asarray(jax.random.normal(k, shape))
                        for k in jax.random.split(key, 3)])
    tn, tp = tmotion.motion_update(t(parts), o, 0.4, 0.25, config_from(cfg),
                                   t(normals))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=1e-6,
                               atol=2e-6)
    np.testing.assert_allclose(float(tn.theta), float(jn.theta), rtol=1e-6)


def test_propagation_does_not_rewrap_theta():
    p = t([[1.0, 1.0, 3.1]])
    out = tmotion.propagate_particles(p, t(0.1), t(0.0), t(0.1))
    assert float(out[0, 2]) > np.pi
