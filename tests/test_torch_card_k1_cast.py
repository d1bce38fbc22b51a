"""The analytic K1's cast scheduled by ray, on a CUDA card (marked `card`:
skips without one).

K1, K1 batched and its map-stack form against beam_weights_plain bit for
bit, in sum and log mode, with and without quantize_ray_deg, on the hard
cases of k1_cast_mirror.CASES (origins near gridlines, rays along them,
origins on wall pixels and off the map, bands across a 32-bit word, the
241-px maze in the device-memory raster form, a 4 m range, 360 beams), at
a particle count that is no multiple of a block or a warp; K1 batched
against K1 episode by episode; and ops/weights.cast_stats' tallies against
the mirror's.  The suite's conftest imports JAX, which a card's host may
lack, so run this file alone there:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_card_k1_cast.py
"""
import pytest
import torch

import k1_cast_mirror as mirror

pytestmark = pytest.mark.card

N = 1000        # no multiple of a block (256 threads) or a warp (32)
EPISODES = 4


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the analytic K1 runs on the card")
    return torch.device("cuda")


def _episode(scan, e):
    from montecarlolocalisation_tpu_torch.models import sensor

    return sensor.Scan(scan.angles, scan.ranges[e], scan.mask[e])


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("combine", ["sum", "log"])
@pytest.mark.parametrize("kind", list(mirror.CASES))
def test_analytic_kernels_equal_the_plain_version(card, kind, combine,
                                                  quantize):
    from montecarlolocalisation_tpu_torch.maps import grid
    from montecarlolocalisation_tpu_torch.ops import weights

    m, parts, scan, cfg = mirror.case(kind, N, card, seed=1,
                                      combine=combine, quantize=quantize)
    assert weights.raster_form(m, cfg) == (
        "device" if kind == "maze241" else "shared")
    want = weights.beam_weights_plain(m, parts, scan, cfg)
    assert torch.equal(weights.beam_weights_cuda(m, parts, scan, cfg), want)

    m, parts, scan, cfg = mirror.case(kind, N, card, seed=2,
                                      combine=combine, quantize=quantize,
                                      episodes=EPISODES)
    got = weights.beam_weights_batched_cuda(m, parts, scan, cfg)
    assert torch.equal(got, weights.beam_weights_plain(m, parts, scan, cfg))
    for e in range(EPISODES):
        assert torch.equal(got[e], weights.beam_weights_cuda(
            m, parts[e], _episode(scan, e), cfg)), e

    cells = (m.width - 1) // 8
    other = mirror.random_maze(cells, seed=cells + 100, device=card)
    index = torch.arange(EPISODES) % 2
    stack = grid.select_maps(grid.stack_maps([m, other]), index)
    got = weights.beam_weights_stack_cuda(stack, parts, scan, cfg)
    assert torch.equal(got, weights.beam_weights_plain(stack, parts, scan,
                                                       cfg))
    for e in range(EPISODES):
        one = (m, other)[int(index[e])]
        assert torch.equal(got[e], weights.beam_weights_cuda(
            one, parts[e], _episode(scan, e), cfg)), e


@pytest.mark.parametrize("kind", list(mirror.CASES))
def test_cast_stats_equal_the_mirror(card, kind):
    from montecarlolocalisation_tpu_torch.ops import weights
    from montecarlolocalisation_tpu_torch.utils import profiling

    keys = ("lockstep_slabs", "queued_slabs", "deferred", "rounds")
    m, parts, scan, cfg = mirror.case(kind, N, card, seed=3)
    before = profiling.recorded()[1].get("k1.cast_slabs", 0)
    got = weights.cast_stats(m, parts, scan, cfg)
    want = mirror.schedule(m, parts, scan, cfg)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["slabs"] == got["lockstep_slabs"] + got["queued_slabs"]
    assert got["beams"] == N * len(scan.angles)
    assert profiling.recorded()[1]["k1.cast_slabs"] == before + got["slabs"]

    m, parts, scan, cfg = mirror.case(kind, N, card, seed=4,
                                      episodes=EPISODES)
    got = weights.cast_stats(m, parts, scan, cfg)
    want = mirror.schedule(m, parts, scan, cfg)
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
