"""maps/symmetry: the port's group and alias metrics against the JAX
package's, on the default maze and on wall layouts with the full D4 group
(square) and its rectangle subgroup.  Alias metrics within 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.maps import symmetry as jsym
from montecarlolocalisation_tpu_torch.maps import symmetry as tsym

from torch_parity import maps, t

torch.set_num_threads(1)


def _box(rows, cols):
    """A maze of only its outer walls: RIGHT=0, TOP=1, LEFT=2, BOTTOM=3."""
    w = np.zeros((rows, cols, 4), bool)
    w[:, -1, 0] = w[0, :, 1] = w[:, 0, 2] = w[-1, :, 3] = True
    return w


def _walls(name):
    if name == "default":
        return np.asarray(maps()[0].walls)
    return _box(*{"square": (4, 4), "rect": (3, 5)}[name])


@pytest.mark.parametrize("name,size", [("default", None), ("square", 8),
                                       ("rect", 4)])
def test_maze_symmetries_give_the_same_group(name, size):
    walls = _walls(name)
    want = jsym.maze_symmetries(walls, 0.8)
    got = tsym.maze_symmetries(walls, 0.8)
    assert got.names == want.names
    if size is not None:
        assert got.size == size
    for f in ("M", "t", "s", "dth"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))


def test_alias_metrics_match_jax():
    walls = _walls("square")
    jg, tg = jsym.maze_symmetries(walls, 0.8), tsym.maze_symmetries(walls,
                                                                    0.8)
    rng = np.random.default_rng(3)
    truth = np.concatenate([rng.uniform(0.2, 3.0, (6, 2)),
                            rng.uniform(-3, 3, (6, 1))], -1).astype(
        np.float32)
    best = (truth + rng.normal(0, 0.3, truth.shape)).astype(np.float32)
    best[2] = np.asarray(jg.apply(jnp.asarray(truth[2])))[3] + 0.01
    np.testing.assert_allclose(tg.apply(t(truth)).numpy(),
                               np.asarray(jg.apply(jnp.asarray(truth))),
                               atol=1e-5)
    want = jsym.alias_errors(best, truth, jg)
    got = tsym.alias_errors(t(best), t(truth), tg)
    np.testing.assert_array_equal(got["alias_idx"].numpy(),
                                  np.asarray(want["alias_idx"]))
    for k in ("err_xy", "err_theta"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5)
    parts = (truth[:, None] + rng.normal(0, 0.5, (6, 200, 3))).astype(
        np.float32)
    w = rng.uniform(0.1, 1.0, (6, 200)).astype(np.float32)
    want = jsym.mixture_tracking(parts, w, truth, jg, stray_radius=0.4)
    got = tsym.mixture_tracking(t(parts), t(w), t(truth), tg,
                                stray_radius=0.4)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
