"""K1's plain version (ops/weights.beam_weights_plain, and the dense path
of models/sensor.beam_weights) vs the JAX package: its Pallas kernel
`beam_weights_pallas(..., interpret=True)` and its dense path, with two dead
mask lanes.  Tolerances are test_weights_pallas.py's: sum rtol 1e-5, log
rtol 1e-4, analytic > 99.9 % close (pixel-boundary ties shift a beam's
whole Gaussian).  Two kinds of input pin the cases on which the kernel's
bit-word slab search and its parallel-ray branch part from a pixel loop:
rays parallel to the gridlines, and a maze whose gridlines are longer than
one 32-bit word."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    WALL_LEFT, WALL_TOP, SensorModelConfig,
)
from montecarlolocalisation_tpu.maps import from_walls
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.ops.weights_pallas import beam_weights_pallas
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.maps import grid as tgrid
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.ops import analytic, build
from montecarlolocalisation_tpu_torch.ops import weights as tweights

import k1_cast_mirror as mirror
from torch_parity import maps, t, uniform_particles

torch.set_num_threads(1)


def _fixture(n, beams=8, seed=0, angles=None, pair=None):
    """(JAX map, port map, particles [n, 3], JAX scan, port scan) with two
    dead lanes padded on; the default maze unless `pair` is given."""
    jm, tm = pair or maps()
    parts = uniform_particles(jm, n, seed).copy()
    if angles is None:
        angles = np.deg2rad(np.linspace(-118, 118, beams)).astype(np.float32)
    beams = len(angles)
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


def _jax_both(jm, parts, jscan, cfg):
    """The JAX kernel (interpret mode, log mode finished) and dense path."""
    raw = beam_weights_pallas(jm, jnp.asarray(parts), jscan, cfg,
                              interpret=True)
    if cfg.beam_combine == "log":
        raw = jsensor.finish_log_weights(jm, cfg, jnp.asarray(parts), raw)
    dense = jax.jit(lambda p: jsensor._beam_weights_dense(
        jm, p, jscan, cfg, 0.1, "gather"))(parts)
    return np.asarray(raw), np.asarray(dense)


def _plain(tm, parts, tscan, cfg):
    tcfg = config_from(cfg)
    out = tweights.beam_weights_plain(tm, t(parts), tscan, tcfg)
    if cfg.beam_combine == "log":
        out = tsensor.finish_log_weights(tm, tcfg, t(parts), out)
    return out.numpy()


@pytest.mark.parametrize("n", [500, 1024])
@pytest.mark.parametrize("combine", ["sum", "log"])
@pytest.mark.parametrize("ray_mode", ["fixed", "analytic"])
def test_plain_matches_jax_kernel_and_dense(ray_mode, combine, n):
    jm, tm, parts, jscan, tscan = _fixture(n)
    cfg = SensorModelConfig(ray_mode=ray_mode, beam_combine=combine,
                            log_temperature=2.0)
    plain = _plain(tm, parts, tscan, cfg)
    got = tsensor.beam_weights(tm, t(parts), tscan,
                               config_from(cfg)).numpy()
    np.testing.assert_array_equal(plain, got)
    for want in _jax_both(jm, parts, jscan, cfg):
        _check(got, want, cfg)
    assert (got > 0).mean() > 0.3


# Beams at 0, +-pi/2 and pi, and particles facing 0, pi/2, pi and -pi/2 in
# turn: some rays run exactly along a gridline axis (the caster's |du| <
# eps branch) and others nearly so, where a slab band is longest.
PARALLEL_BEAMS = np.float32([0.0, math.pi / 2, -math.pi / 2, math.pi, 0.3,
                             -1.2])
HEADINGS = np.float32([0.0, math.pi / 2, math.pi, -math.pi / 2])


@pytest.mark.parametrize("combine", ["sum", "log"])
@pytest.mark.parametrize("ray_mode", ["fixed", "analytic"])
def test_plain_matches_jax_on_rays_parallel_to_the_gridlines(ray_mode,
                                                              combine):
    jm, tm, parts, jscan, tscan = _fixture(256, seed=5,
                                           angles=PARALLEL_BEAMS)
    parts[:, 2] = HEADINGS[np.arange(256) % 4]
    cfg = SensorModelConfig(ray_mode=ray_mode, beam_combine=combine,
                            log_temperature=2.0)
    got = _plain(tm, parts, tscan, cfg)
    for want in _jax_both(jm, parts, jscan, cfg):
        _check(got, want, cfg)


def _random_maze(cells, seed):
    """A random maze of cells x cells; its gridlines are 8 * cells + 1 px
    long, past one 32-bit word."""
    rng = np.random.default_rng(seed)
    walls = [[[w for w in (WALL_TOP, WALL_LEFT) if rng.random() < 0.4]
              for _ in range(cells)] for _ in range(cells)]
    jm = from_walls(walls)
    return jm, interop.maze_from_numpy(jm)


@pytest.mark.parametrize("combine", ["sum", "log"])
def test_plain_matches_jax_on_gridlines_longer_than_a_word(combine):
    pair = _random_maze(9, seed=3)
    assert pair[1].height == pair[1].width == 73
    jm, tm, parts, jscan, tscan = _fixture(400, beams=12, seed=6, pair=pair)
    cfg = SensorModelConfig(ray_mode="analytic", beam_combine=combine,
                            log_temperature=2.0)
    got = _plain(tm, parts, tscan, cfg)
    for want in _jax_both(jm, parts, jscan, cfg):
        _check(got, want, cfg)
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


def _square_maze(cells):
    """An open square maze of `cells` x `cells` cells, 8 * cells + 1 px a
    side, on the CPU."""
    from montecarlolocalisation_tpu_torch.maps import from_walls as tfw

    walls = [[[WALL_TOP] if r == 0 else [] for _ in range(cells)]
             for r in range(cells)]
    return tfw(walls, device="cpu")


@pytest.mark.parametrize("cells,fixed_form,analytic_form", [
    (6, "shared", "shared"),          # the default maze's size, 49 px
    (12, "device", "shared"),         # 97 px: 1552 bytes of march words
    (30, "device", "device"),         # 241 px: 1984 bytes of gridlines
    (170, "device", "device"),        # 1361 px: past shared memory
    (340, "device", "device"),        # 2721 px: the gridlines too
])
def test_raster_form_past_shared_memory(cells, fixed_form, analytic_form):
    """F1: every raster takes a kernel.  ops/weights keeps a raster of at
    most SHARED_RASTER_BYTES of bit words in each block's shared memory
    and any larger one, up to rasters no block's shared memory holds, in a
    device buffer of the same words; the config check no longer refuses a
    raster for its size."""
    m = _square_maze(cells)
    for mode, want in (("fixed", fixed_form), ("analytic", analytic_form)):
        cfg = config_from(SensorModelConfig(ray_mode=mode))
        words = -(-m.width // 32) * m.height if mode == "fixed" else \
            2 * (cells + 1) * -(-m.width // 32)
        assert tweights.raster_words(m, cfg) == words
        assert tweights.raster_form(m, cfg) == want
        assert (want == "shared") == (4 * words
                                      <= tweights.SHARED_RASTER_BYTES)
        for nb in (12, 34):
            fits = tweights.smem_bytes(m, cfg, nb) <= tweights.SMEM_MAX
            assert fits == (cells < 170 or (mode == "analytic"
                                            and cells < 340))
            tweights._check_config(m, cfg, nb)


def test_wrapper_takes_plain_version_on_a_raster_past_shared_memory():
    m = _square_maze(170)
    cfg = config_from(SensorModelConfig(ray_mode="fixed"))
    gen = torch.Generator()
    gen.manual_seed(0)
    parts = torch.rand(64, 3, generator=gen) * torch.tensor([130.0, 130.0,
                                                             6.0])
    scan = tsensor.make_scan(np.zeros(12, np.float32),
                             np.full(12, 0.5, np.float32))
    got = tweights.beam_weights(m, parts, scan, cfg)
    assert torch.equal(got, tweights.beam_weights_plain(m, parts, scan, cfg))
    assert torch.equal(got, tsensor.beam_weights(m, parts, scan, cfg))


def _stack_of(m, maps):
    return tgrid.stack_maps([m] * maps)


@pytest.mark.parametrize("cells,form", [(6, "shared"), (30, "device")])
def test_map_stack_scratch_holds_every_maps_words(cells, form):
    """K1 batched's map-stack form: the raster form is chosen per map by
    the single map's rule, and the device form's scratch holds every
    map's words, map m's at m * raster_words."""
    one = _square_maze(cells)
    stack = _stack_of(one, 3)
    cfg = config_from(SensorModelConfig(ray_mode="fixed"))
    assert tweights.raster_words(stack, cfg) == tweights.raster_words(
        one, cfg)
    assert tweights.raster_form(stack, cfg) == tweights.raster_form(
        one, cfg) == form
    buf = tweights._raster_buffer(stack, cfg)
    if form == "shared":
        assert buf is None
    else:
        assert buf.shape == (3 * tweights.raster_words(one, cfg),)
    forced = tweights._raster_buffer(stack, cfg, form="device")
    assert forced.shape == (3 * tweights.raster_words(one, cfg),)


def test_map_stack_index_across_the_chunk_boundary():
    """The plain version the map-stack form is held to, at E = 65,543
    episodes (past one launch's 65,535 along grid y) with the map index
    changing across the boundary: the episodes around it equal a
    single-map call on their own map."""
    base = maps()[1]
    walls = [[[WALL_TOP] if (r + c) % 3 else [WALL_LEFT]
              for c in range(6)] for r in range(6)]
    other = interop.maze_from_numpy(from_walls(walls))
    stack = tgrid.stack_maps([base, other, base])
    n_ep = build.GRID_Y_MAX + 8
    index = (torch.arange(n_ep) // 7) % 3
    stack = tgrid.select_maps(stack, index)
    gen = torch.Generator()
    gen.manual_seed(4)
    parts = torch.rand(n_ep, 1, 3, generator=gen) * torch.tensor(
        [4.8, 4.8, 6.28])
    angles = np.float32([0.3, -1.2])
    scan = tsensor.make_scan(angles, torch.rand(n_ep, 2, generator=gen))
    for mode in ("fixed", "analytic"):
        cfg = config_from(SensorModelConfig(ray_mode=mode))
        got = tweights.beam_weights_batched(stack, parts, scan, cfg)
        assert got.shape == (n_ep, 1)
        edge = range(build.GRID_Y_MAX - 8, n_ep)
        assert len({int(index[e]) for e in edge}) == 3
        for e in edge:
            one = stack.map_at(int(index[e]))
            want = tweights.beam_weights_plain(
                one, parts[e], tsensor.Scan(scan.angles, scan.ranges[e],
                                            scan.mask[e]), cfg)
            assert torch.equal(got[e], want), e


# The analytic K1's cast schedule (csrc/weights.cu beam_weights_cast_kernel)
# through its plain mirror (k1_cast_mirror), on the card test's hard cases.

@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kind", list(mirror.CASES))
def test_cast_schedule_skips_only_slabs_that_cannot_lower_the_distance(
        kind, quantize):
    """Every slab the schedule never evaluates leaves the beam's distance
    as it is: behind the origin and past the last line it has no hit in
    the plain cast (its ok is false), and elsewhere no hit earlier than the
    least the schedule found; and the schedule's distances are the ones
    beam_weights_plain computes its likelihoods from, bit for bit."""
    m, parts, scan, cfg = mirror.case(kind, 300, "cpu", seed=4,
                                      quantize=quantize)
    s = mirror.schedule(m, parts, scan, cfg)
    n_cand = s["hit"].shape[-1]
    cand = torch.arange(n_cand)
    inb = s["inb"][..., None, None].expand(s["hit"].shape)
    skipped = ~s["evaluated"] & inb
    behind = cand < s["first"][..., None]
    assert (s["hit"][skipped & behind] == analytic.INF).all()
    assert (s["hit"][skipped] >= s["px"][..., None, None].expand(
        s["hit"].shape)[skipped]).all()
    assert (s["evaluated"].sum((-1, -2)) >= 2)[s["inb"][..., 0]].all()
    want = tsensor.expected_ranges(m, parts, scan.angles, cfg)
    assert torch.equal(s["dist"][0], want)
    assert s["lockstep_slabs"] == 2 * int(s["inb"].sum()) * len(scan.angles)
    assert s["queued_slabs"] == int(s["items"].sum())


def test_cast_schedule_constants_match_the_kernel():
    """The mirror's chunks and the wrapper's shared-memory count read the
    kernel's constants (csrc/weights.cu): CAST_CHUNK beams a chunk, a
    warp's queue of CAST_QUEUE pairs, a word each."""
    import os
    import re

    with open(os.path.join(build.CSRC, "weights.cu")) as f:
        src = f.read()
    const = lambda name: int(re.search(
        rf"constexpr int {name} = (\d+);", src).group(1))
    assert const("kChunk") == tweights.CAST_CHUNK
    assert const("kQueue") == tweights.CAST_QUEUE
    shared = re.search(r"struct CastShared \{(.*?)\};", src, re.S).group(1)
    assert shared.split() == [
        "float", "dist[kChunk][kThreads];", "float", "gx[kThreads],",
        "gy[kThreads];", "int", "queue[kWarps][kQueue];"]
    assert tweights.CAST_WORDS == (tweights.CAST_CHUNK + 2) * 256 \
        + 8 * tweights.CAST_QUEUE
    assert mirror.chunks(34) == [(0, 17), (17, 34)]
    assert mirror.chunks(16) == [(0, 16)]


def _c_fields(src: str, head: str) -> dict:
    """{"float": n, "int": n}: the fields of the C struct `head { ... };`
    in src, by type."""
    import re

    body = re.search(re.escape(head) + r" \{(.*?)\};", src, re.S).group(1)
    count = {"float": 0, "int": 0}
    for kind, names in re.findall(r"(float|int) ([^;]*);", body):
        count[kind] += len(names.split(","))
    return count


@pytest.mark.parametrize("family", ["weights", "refine"])
def test_params_follow_the_c_structs(family):
    """Both families' host parameters begin with sensor_prefix, which fills
    csrc/sensor_model.cuh's SensorParams field for field, and add as many
    floats and ints as the family's own Params declares after it."""
    import os

    from montecarlolocalisation_tpu_torch.config import FilterConfig
    from montecarlolocalisation_tpu_torch.ops import refine as trefine

    def read(name):
        with open(os.path.join(build.CSRC, name)) as f:
            return f.read()

    m, cfg = maps()[1], FilterConfig()
    fp0, ip0 = tweights.sensor_prefix(m, cfg.sensor)
    assert _c_fields(read("sensor_model.cuh"), "struct SensorParams") == {
        "float": len(fp0), "int": len(ip0)}
    fp, ip = (tweights._params(m, cfg.sensor) if family == "weights"
              else trefine._params(m, cfg, 24, 1000))
    assert list(fp)[:len(fp0)] == list(build.floats(fp0))
    assert list(ip)[:len(ip0)] == ip0
    own = _c_fields(read(family + ".cu"), "struct Params : SensorParams")
    assert own == {"float": len(fp) - len(fp0), "int": len(ip) - len(ip0)}
    assert min(own.values()) > 0


def test_cast_stats_needs_the_analytic_cast_on_the_card():
    """cast_stats counts the analytic kernel's schedule: fixed mode has no
    slabs, and on the CPU there is no kernel to count (the mirror is)."""
    import dataclasses

    m, parts, scan, cfg = mirror.case("uniform", 64, "cpu")
    with pytest.raises(ValueError, match="analytic"):
        tweights.cast_stats(m, parts, scan,
                            dataclasses.replace(cfg, ray_mode="fixed"))
    with pytest.raises(ValueError, match="CUDA"):
        tweights.cast_stats(m, parts, scan, cfg)
