"""Port maps (montecarlolocalisation_tpu_torch/maps) vs the JAX package."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.maps import grid as jgrid
from montecarlolocalisation_tpu_torch.maps import grid as tgrid
from montecarlolocalisation_tpu_torch.maps import raster as traster

from torch_parity import MAP_PATH, maps, t

torch.set_num_threads(1)


@pytest.mark.parametrize("field", ["occ", "occ_dilated", "walls",
                                   "row_lengths"])
def test_map_fields_bit_exact(field):
    jm = jgrid.from_map_file(MAP_PATH)
    tm = tgrid.from_map_file(MAP_PATH, device="cpu")
    np.testing.assert_array_equal(getattr(tm, field).numpy(),
                                  np.asarray(getattr(jm, field)))
    assert tm.gridline
    assert (tm.height, tm.width, tm.extent_x) == (jm.height, jm.width,
                                                  jm.extent_x)


def test_ragged_rows_rasterize_like_jax():
    from montecarlolocalisation_tpu.maps import raster as jraster

    walls = [[[1, 2], [1], [1, 0]], [[2, 3], [3, 0]]]
    np.testing.assert_array_equal(traster.rasterize_walls(walls),
                                  jraster.rasterize_walls_py(walls))


def test_world_to_map_truncates_toward_zero():
    jm, tm = maps()
    wx = np.float32([-0.15, -0.05, -0.0, 0.05, 0.25, 4.85, 4.95, 2.3])
    wy = np.float32([0.3, -0.09, 1.0, -0.11, 4.89, 0.0, 1.0, 2.3])
    jx, jy, jinb = jax.jit(lambda a, b: jgrid.world_to_map(jm, a, b))(wx, wy)
    tx, ty, tinb = tgrid.world_to_map(tm, t(wx), t(wy))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(tinb.numpy(), np.asarray(jinb))
    # The (-res, 0) quirk: pixel 0, in bounds.
    assert tx[1] == 0 and bool(tinb[1])


def test_is_valid_pos_matches():
    jm, tm = maps()
    rng = np.random.default_rng(0)
    pts = rng.uniform(-0.3, 5.2, size=(4000, 2)).astype(np.float32)
    want = jax.jit(lambda p: jgrid.is_valid_pos(jm, p[:, 0], p[:, 1]))(pts)
    got = tgrid.is_valid_pos(tm, t(pts[:, 0]), t(pts[:, 1]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.1 < got.float().mean() < 0.9


def test_world_to_cell_and_center():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-0.5, 5.0, size=(1000, 2)).astype(np.float32)
    jr, jc = jax.jit(lambda p: jgrid.world_to_cell(p[:, 0], p[:, 1]))(pts)
    tr, tc = tgrid.world_to_cell(t(pts[:, 0]), t(pts[:, 1]))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    x, y = tgrid.cell_center(t([2.0]), t([3.0]))
    jx, jy = jgrid.cell_center(jnp.float32(2.0), jnp.float32(3.0))
    assert float(x[0]) == float(jx) and float(y[0]) == float(jy)
