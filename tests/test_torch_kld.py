"""models/kld: the port's KLD-sampling statistic against the JAX package's.

Tolerances: bin ids and occupied-bin counts exact (on the full cloud and
on strided subsamples, tight and global clouds); the Wilson-Hilferty
target rtol 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import KLDConfig
from montecarlolocalisation_tpu.models import kld as jkld
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.models import kld as tkld

from torch_parity import maps, t, uniform_particles

torch.set_num_threads(1)


def _clouds(jm):
    rng = np.random.default_rng(0)
    tight = (np.float32([1.25, 2.05, 0.3])
             + rng.normal(0, [0.05, 0.05, 0.05], (3000, 3))).astype(
        np.float32)
    two = np.concatenate([tight, tight[:1000] + np.float32([1.6, 0, 2.0])])
    outside = rng.uniform(-1.0, 5.0, (2000, 3)).astype(np.float32)
    return dict(global_=uniform_particles(jm, 20000, 1), tight=tight,
                two_modes=two, outside=outside)


@pytest.mark.parametrize("kind", ["global_", "tight", "two_modes",
                                  "outside"])
@pytest.mark.parametrize("cfg", [KLDConfig(), KLDConfig(subsample=1000),
                                 KLDConfig(epsilon=0.01, bin_xy=0.25,
                                           bin_theta=0.2)])
def test_occupied_bins_and_target_match_jax(kind, cfg):
    jm, tm = maps()
    parts = _clouds(jm)[kind]
    tcfg = config_from(cfg)
    np.testing.assert_array_equal(
        tkld.bin_ids(t(parts), tm, tcfg).numpy(),
        np.asarray(jkld.bin_ids(jnp.asarray(parts), jm, cfg)))
    k = tkld.occupied_bin_count(t(parts), tm, tcfg)
    jk = jkld.occupied_bin_count(jnp.asarray(parts), jm, cfg)
    assert k.dtype == torch.int32 and int(k) == int(jk)
    np.testing.assert_allclose(float(tkld.particle_target(t(parts), tm,
                                                          tcfg)),
                               float(jkld.particle_target(
                                   jnp.asarray(parts), jm, cfg)), rtol=1e-6)


def test_kld_target_formula_and_batch():
    cfg = KLDConfig()
    ks = np.array([0, 1, 2, 3, 10, 100, 1000, 20000], np.int32)
    np.testing.assert_allclose(
        tkld.kld_target(torch.as_tensor(ks), config_from(cfg)).numpy(),
        np.asarray(jax_targets(ks, cfg)), rtol=1e-6)
    jm, tm = maps()
    c = _clouds(jm)
    batch = t(np.stack([c["tight"][:2000], c["global_"][:2000]]))
    got = tkld.particle_target(batch, tm, config_from(cfg))
    for e in range(2):
        assert float(got[e]) == float(tkld.particle_target(
            batch[e], tm, config_from(cfg)))
    assert float(got[0]) < float(got[1])      # spread needs more particles


def jax_targets(ks, cfg):
    return [jkld.kld_target(jnp.int32(k), cfg) for k in ks]
