"""maps/generator.py against the JAX package's: the same wall lists for
seeds 0 to 7, the three styles and extra_openings 0 and 3, and a map stack
whose every map is `from_walls` of its wall list and equals the JAX
package's stacked MazeMap array for array."""
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.maps import generator as jgen
from montecarlolocalisation_tpu_torch.maps import generator as tgen
from montecarlolocalisation_tpu_torch.maps import grid as tgrid

torch.set_num_threads(1)


def _jax_walls(i, seed, extra, style):
    """Map i of the JAX package's generate_map_batch (generator.py:152)."""
    if style == "rooms" or (style == "mixed" and i % 2 == 1):
        return jgen.generate_rooms(6, 6, seed + i)
    return jgen.generate_maze(6, 6, seed + i, extra)


@pytest.mark.parametrize("seed", range(8))
@pytest.mark.parametrize("style", ["maze", "rooms", "mixed"])
@pytest.mark.parametrize("extra", [0, 3])
def test_wall_lists_equal_jax(seed, style, extra):
    for i in range(2):
        assert tgen.map_walls(i, 6, 6, seed, extra, style) == _jax_walls(
            i, seed, extra, style)
    if style == "maze":
        assert tgen.generate_maze(6, 6, seed, extra) == jgen.generate_maze(
            6, 6, seed, extra)
    if style == "rooms":
        assert tgen.generate_rooms(4, 7, seed, min_room=1) == \
            jgen.generate_rooms(4, 7, seed, min_room=1)


@pytest.mark.parametrize("style", ["maze", "rooms", "mixed"])
def test_stack_equals_from_walls_and_jax(style):
    stack = tgen.generate_map_batch(4, rows=4, cols=5, seed=3,
                                    extra_openings=2, style=style,
                                    device="cpu")
    want = jgen.generate_map_batch(4, rows=4, cols=5, seed=3,
                                   extra_openings=2, style=style)
    assert stack.is_stack and stack.maps == 4 and stack.gridline
    assert (stack.height, stack.width, stack.n_rows, stack.n_cols) == (
        33, 41, 4, 5)
    for name in ("occ", "occ_dilated", "walls", "row_lengths"):
        np.testing.assert_array_equal(getattr(stack, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for i in range(4):
        one = tgrid.from_walls(tgen.map_walls(i, 4, 5, 3, 2, style),
                               device="cpu")
        got = stack.map_at(i)
        for name in ("occ", "occ_dilated", "walls", "row_lengths"):
            assert torch.equal(getattr(got, name), getattr(one, name))
        assert got.gridline == one.gridline and not got.is_stack


def test_unknown_style_raises():
    with pytest.raises(ValueError):
        tgen.generate_map_batch(1, style="corridor", device="cpu")
