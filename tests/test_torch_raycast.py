"""Port ray casters (models/raycast, ops/analytic) vs the JAX package.

Fixed march and DDA: equal to 1e-6 (same float32 operations; only the
last bit of sin/cos can differ between XLA and torch, which moves a sample
across a pixel edge in ~1e-6 of rays, none at these sizes).  Analytic:
> 99.9 % within atol 1e-4, the tolerance test_analytic holds the JAX caster
to against DDA (the rest are pixel-boundary ties).
"""
import jax
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import SensorModelConfig
from montecarlolocalisation_tpu.maps import from_walls
from montecarlolocalisation_tpu.maps.generator import generate_maze
from montecarlolocalisation_tpu.models import raycast as jraycast
from montecarlolocalisation_tpu.ops.analytic import AnalyticCasterCache
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.models import raycast as traycast
from montecarlolocalisation_tpu_torch.ops import analytic as tanalytic

from torch_parity import maps, t

torch.set_num_threads(1)


def _rays(n, seed, lo=0.0, hi=4.9):
    rng = np.random.default_rng(seed)
    return (rng.uniform(lo, hi, n).astype(np.float32),
            rng.uniform(lo, hi, n).astype(np.float32),
            rng.uniform(-np.pi, np.pi, n).astype(np.float32))


def _both(jm, tm, cfg, ox, oy, ang):
    want = jax.jit(lambda a, b, c: jraycast.raycast(jm, a, b, c, cfg))(
        ox, oy, ang)
    got = traycast.raycast(tm, t(ox), t(oy), t(ang), interop.config_from(cfg))
    return got.numpy(), np.asarray(want)


def _random_maze(seed):
    jm = from_walls(generate_maze(5, 7, seed=seed, extra_openings=4))
    return jm, interop.maze_from_numpy(jm)


@pytest.mark.parametrize("mode,quantize", [("fixed", False), ("fixed", True),
                                           ("dda", False)])
@pytest.mark.parametrize("world", ["default", "random"])
def test_march_and_dda_match(mode, quantize, world):
    jm, tm = maps() if world == "default" else _random_maze(3)
    cfg = SensorModelConfig(ray_mode=mode, quantize_ray_deg=quantize)
    got, want = _both(jm, tm, cfg, *_rays(20000, 1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert (got < cfg.max_range).mean() > 0.3


@pytest.mark.parametrize("world", ["default", "random"])
def test_analytic_matches(world):
    jm, tm = maps() if world == "default" else _random_maze(5)
    assert tm.gridline
    cfg = SensorModelConfig(ray_mode="analytic")
    got, want = _both(jm, tm, cfg, *_rays(20000, 2))
    close = np.isclose(got, want, rtol=0, atol=1e-4)
    assert close.mean() > 0.999


@pytest.mark.parametrize("mode", ["fixed", "dda", "analytic"])
def test_out_of_map_origins(mode):
    jm, tm = maps()
    cfg = SensorModelConfig(ray_mode=mode)
    ox, oy, ang = _rays(4000, 4, lo=-1.0, hi=6.0)
    got, want = _both(jm, tm, cfg, ox, oy, ang)
    close = np.isclose(got, want, rtol=0, atol=1e-4)
    assert close.mean() > 0.999
    off = (ox < -0.1) | (oy < -0.1) | (ox > 5.0) | (oy > 5.0)
    assert off.sum() > 100
    np.testing.assert_array_equal(got[off], cfg.max_range)


def test_analytic_axis_parallel_rays():
    jm, tm = maps()
    cast = AnalyticCasterCache.get(jm)
    rng = np.random.default_rng(6)
    n = 2000
    ox = rng.uniform(0.0, 4.9, n).astype(np.float32)
    oy = rng.uniform(0.0, 4.9, n).astype(np.float32)
    # Exactly on a gridline too: origins inside wall slabs.
    ox[:200] = np.float32(0.8)
    oy[200:400] = np.float32(1.6)
    for dx, dy in [(1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)]:
        dxa = np.full(n, dx, np.float32)
        dya = np.full(n, dy, np.float32)
        want = np.asarray(jax.jit(lambda a, b, c, d: cast.cast_dir(
            a, b, c, d, 1.0))(ox, oy, dxa, dya))
        got = tanalytic.cast_dir(tm, t(ox), t(oy), t(dxa), t(dya),
                                 1.0).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_analytic_falls_back_to_dda_off_gridlines():
    occ = np.zeros((17, 17), bool)
    occ[5, 3:9] = True                      # off the 8-px gridlines
    from montecarlolocalisation_tpu.maps.grid import from_raster

    jm = from_raster(occ)
    tm = interop.maze_from_numpy(jm)
    assert not tm.gridline
    cfg = SensorModelConfig(ray_mode="analytic")
    got, want = _both(jm, tm, cfg, *_rays(3000, 7, hi=1.7))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    dda = traycast.raycast(tm, *(t(a) for a in _rays(3000, 7, hi=1.7)),
                           interop.config_from(
                               SensorModelConfig(ray_mode="dda")))
    np.testing.assert_array_equal(got, dda.numpy())
