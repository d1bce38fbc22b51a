"""The port's occupancy mapper (models/mapping) against the JAX package's.

- update_map on a single beam's geometry, on masked and sentinel beams,
  dense on the default maze and windowed on a generated 12 x 10-cell maze
  (97 x 81 px, past twice sensor_window_px), under jit: at least 99.9 %
  of the pixels within 1e-5, and a pixel that differs does so by whole
  hits and crossings (l_occ, l_free; two at most, for a pixel on the
  threshold of two beams): XLA may contract dxp * cb + dyp * sb into a
  fused multiply-add, torch does not.
- Leading dims [E, P] against vmap(vmap(update_map)).
- The hit and free counts summed over chunks of beams equal the one-shot
  sum bit for bit.
- The keyframe gate: update_map(..., paint=m) equals torch.where(m,
  update_map(...), logodds) bit for bit on [E, K, P] maps, dense and
  windowed, the gate all open, all closed, mixed by filter and by map;
  paint=None equals the plain form and an all-open gate; on the CPU the
  kernel (ops/ism) never runs.
- map_episode over 30 ticks and dead_reckon_poses within 1e-5.
- fit_walls, wall_metrics and to_trinary equal on JAX's log-odds, and
  export_learned_map writes byte-equal files.
"""
import math
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import FilterConfig, MappingConfig
from montecarlolocalisation_tpu.maps import from_map_file, from_walls
from montecarlolocalisation_tpu.maps import generator
from montecarlolocalisation_tpu.models import mapping as jmapping
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.sim import robot as jrobot
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.models import mapping as tmapping
from montecarlolocalisation_tpu_torch.ops import ism as tism
from montecarlolocalisation_tpu_torch.utils import profiling

torch.set_num_threads(1)

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation_tpu",
                    "maps", "default_map.txt")
SENSOR = FilterConfig().sensor
TSENSOR = interop.config_from(SENSOR)


def _mc(m):
    return MappingConfig(height=m.height, width=m.width,
                         resolution=float(m.resolution),
                         origin_x=float(m.origin_x),
                         origin_y=float(m.origin_y))


def _maze():
    return from_map_file(MAP_PATH)


def _big():
    return from_walls(generator.generate_maze(12, 10, seed=3))


def _t(a, dtype=torch.float32):
    return torch.as_tensor(np.array(a), dtype=dtype)


def _jax_update(lo, pose, ranges, angles, mask, mc):
    return np.asarray(jax.jit(
        lambda l, p, r, a, k: jmapping.update_map(l, p, r, a, k, mc, SENSOR))(
            lo, pose, ranges, angles, mask))


def assert_map_close(got, want, mc):
    """>= 99.9 % of the pixels within 1e-5; each other pixel off by a
    whole number of hits and crossings, at most two in all (a pixel on a
    threshold of two beams, as on the axis-aligned beams)."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    diff = got - np.asarray(want)
    assert np.mean(np.abs(diff) <= 1e-5) >= 0.999
    steps = [a * mc.l_occ + b * mc.l_free for a in range(-2, 3)
             for b in range(-2, 3) if 0 < abs(a) + abs(b) <= 2]
    for d in diff[np.abs(diff) > 1e-5]:
        assert min(abs(d - s) for s in steps) <= 1e-5, d


def _case(name):
    """(mapping config, log-odds, pose, ranges, angles, mask) as numpy."""
    rng = np.random.RandomState(7)
    if name == "single_beam":
        m = _maze()
        mc = _mc(m)
        pose = np.array([1.25, 1.25, 0.0], np.float32)
        angles = np.array([0.0, math.pi / 2, -math.pi / 2, math.pi],
                          np.float32)
        ranges = np.asarray(jsensor.simulate_scan(
            m, jnp.asarray(pose), jnp.asarray(angles), SENSOR).ranges)
        return (mc, np.zeros((mc.height, mc.width), np.float32), pose,
                ranges, angles, np.ones(4, np.float32))
    if name in ("masked", "sentinel", "no_return"):
        mc = _mc(_maze())
        ranges = dict(masked=[0.5, 0.6], sentinel=[1.05, 1.05],
                      no_return=[SENSOR.max_range] * 2)[name]
        mask = np.zeros(2) if name == "masked" else np.ones(2)
        return (mc, np.zeros((mc.height, mc.width), np.float32),
                np.array([1.25, 1.25, 0.5], np.float32),
                np.array(ranges, np.float32), np.array([0.0, 0.7], np.float32),
                mask.astype(np.float32))
    m = _maze() if name == "dense" else _big()
    mc = _mc(m)
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    lo = rng.uniform(-3, 3, (mc.height, mc.width)).astype(np.float32)
    w_m, h_m = mc.width * mc.resolution, mc.height * mc.resolution
    pose = np.array({"dense": (1.9, 2.3, 0.7),
                     "windowed": (w_m / 2, h_m / 2, -2.0),
                     "border": (w_m - 0.05, h_m - 0.05, 2.8),
                     "outside": (-0.4, h_m / 2, 0.0)}[name], np.float32)
    ranges = rng.uniform(0.1, 1.2, 24).astype(np.float32)
    mask = np.ones(24, np.float32)
    mask[2] = 0.0
    return mc, lo, pose, ranges, angles, mask


CASES = ["single_beam", "masked", "sentinel", "no_return", "dense",
         "windowed", "border", "outside"]


@pytest.mark.parametrize("name", CASES)
def test_update_map_matches_jax(name):
    mc, lo, pose, ranges, angles, mask = _case(name)
    tmc = interop.config_from(mc)
    want = _jax_update(lo, pose, ranges, angles, mask, mc)
    got = tmapping.update_map(_t(lo), _t(pose), _t(ranges), _t(angles),
                              _t(mask), tmc, TSENSOR)
    assert_map_close(got, want, mc)
    if name in ("windowed", "border", "outside"):
        assert 2 * tmapping.sensor_window_px(tmc) <= min(mc.height,
                                                         mc.width)
    if name in ("masked", "sentinel"):
        assert not got.any()
    if name == "no_return":
        assert float(got.min()) < 0 and float(got.max()) == 0.0


@pytest.mark.parametrize("which", ["dense", "windowed"])
def test_leading_dims_match_vmap(which):
    """Maps [E, P, H, W] with poses [E, P, 3] and one scan per episode
    [E, 1, B]: JAX's vmap(vmap(update_map))."""
    m = _maze() if which == "dense" else _big()
    mc = _mc(m)
    rng = np.random.RandomState(3)
    e, p, b = 2, 3, 16
    lo = rng.uniform(-2, 2, (e, p, mc.height, mc.width)).astype(np.float32)
    poses = np.stack([
        rng.uniform(0.3, mc.width * mc.resolution - 0.3, (e, p)),
        rng.uniform(0.3, mc.height * mc.resolution - 0.3, (e, p)),
        rng.uniform(-np.pi, np.pi, (e, p))], -1).astype(np.float32)
    angles = np.deg2rad(np.linspace(-118, 118, b)).astype(np.float32)
    ranges = rng.uniform(0.1, 1.1, (e, b)).astype(np.float32)
    mask = (rng.uniform(size=(e, b)) > 0.1).astype(np.float32)
    want = jax.jit(jax.vmap(jax.vmap(
        lambda l, q, r, k: jmapping.update_map(l, q, r, angles, k, mc,
                                               SENSOR),
        in_axes=(0, 0, None, None))))(lo, poses, ranges, mask)
    got = tmapping.update_map(_t(lo), _t(poses), _t(ranges)[:, None],
                              _t(angles), _t(mask)[:, None],
                              interop.config_from(mc), TSENSOR)
    assert got.shape == lo.shape
    assert_map_close(got, want, mc)


@pytest.mark.parametrize("which", ["dense", "windowed"])
@pytest.mark.parametrize("chunk", [1, 5])
def test_beam_chunks_equal_one_shot_bit_for_bit(which, chunk):
    mc, lo, pose, ranges, angles, mask = _case(which)
    tmc = interop.config_from(mc)
    lo = np.broadcast_to(lo, (4,) + lo.shape).copy()
    poses = pose + np.array([[0, 0, 0], [0.1, 0, 0.3], [0, -0.2, 1.0],
                             [0.3, 0.3, -2.0]], np.float32)
    args = (_t(lo), _t(poses), _t(ranges), _t(angles), _t(mask), tmc,
            TSENSOR)
    one_shot = tmapping.update_map_plain(*args, beam_chunk=len(ranges))
    chunked = tmapping.update_map_plain(*args, beam_chunk=chunk)
    default = tmapping.update_map(*args)
    assert torch.equal(chunked, one_shot)
    assert torch.equal(default, one_shot)


def _filters_case(which):
    """Maps [E, K, P, H, W] with poses [E, K, P, 3] and one scan a filter
    [E, K, 1, B] (as slam_step passes them), as torch tensors, and the
    port's mapping config."""
    m = _maze() if which == "dense" else _big()
    mc = _mc(m)
    rng = np.random.RandomState(11)
    e, k, p, b = 2, 2, 3, 24
    lo = rng.uniform(-8, 8, (e, k, p, mc.height, mc.width)).astype(np.float32)
    lo[..., 0, 0] = 8.0
    lo[..., 1, 1] = -0.0
    poses = np.stack([
        rng.uniform(-0.2, mc.width * mc.resolution + 0.2, (e, k, p)),
        rng.uniform(-0.2, mc.height * mc.resolution + 0.2, (e, k, p)),
        rng.uniform(-np.pi, np.pi, (e, k, p))], -1).astype(np.float32)
    angles = np.deg2rad(np.linspace(-118, 118, b)).astype(np.float32)
    ranges = rng.uniform(0.05, 1.1, (e, k, 1, b)).astype(np.float32)
    ranges[..., 3] = SENSOR.max_range
    ranges[..., 5] = 1.05
    mask = (rng.uniform(size=(e, k, 1, b)) > 0.15).astype(np.float32)
    return (interop.config_from(mc), _t(lo), _t(poses), _t(ranges),
            _t(angles), _t(mask))


def _ism_counts():
    return (profiling.recorder.counters.get("ism.calls", 0),
            profiling.recorder.counters.get("ism.maps", 0),
            tism.ism_update_cuda.launches)


@pytest.mark.parametrize("which", ["dense", "windowed"])
@pytest.mark.parametrize("gate", ["open", "closed", "by_filter", "by_map"])
def test_paint_equals_where_bit_for_bit(which, gate):
    tmc, lo, poses, ranges, angles, mask = _filters_case(which)
    lead = lo.shape[:-2]
    rng = np.random.RandomState(5)
    paint = torch.as_tensor({
        "open": np.ones(lead[:2] + (1,), bool),
        "closed": np.zeros(lead[:2] + (1,), bool),
        "by_filter": np.array([[True, False], [False, True]])[..., None],
        "by_map": rng.uniform(size=lead) > 0.5}[gate])
    before, counts = lo.clone(), _ism_counts()
    args = (lo, poses, ranges, angles, mask, tmc, TSENSOR)
    got = tmapping.update_map(*args, paint=paint)
    want = torch.where(paint[..., None, None], tmapping.update_map(*args),
                       lo)
    assert got.shape == lo.shape
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert torch.equal(tmapping.update_map_plain(*args, paint=paint), got)
    if gate == "closed":
        assert torch.equal(got.view(torch.int32), lo.view(torch.int32))
    else:
        assert not torch.equal(got, lo)
    assert torch.equal(lo.view(torch.int32), before.view(torch.int32))
    assert _ism_counts() == counts


@pytest.mark.parametrize("which", ["dense", "windowed"])
def test_paint_none_is_every_map(which):
    tmc, lo, poses, ranges, angles, mask = _filters_case(which)
    counts = _ism_counts()
    args = (lo, poses, ranges, angles, mask, tmc, TSENSOR)
    got = tmapping.update_map(*args)
    assert torch.equal(got.view(torch.int32),
                       tmapping.update_map_plain(*args).view(torch.int32))
    every = torch.ones(lo.shape[:-2], dtype=torch.bool)
    assert torch.equal(got.view(torch.int32), tmapping.update_map(
        *args, paint=every).view(torch.int32))
    assert not tism.kernel_takes(lo, poses, poses[..., 2:])
    assert _ism_counts() == counts


def _episode(ticks=30, slip=0.05):
    m = _maze()
    cfg = FilterConfig(num_particles=64)
    angles = np.deg2rad(np.linspace(-118, 118, 16)).astype(np.float32)
    enc, scans, poses = jrobot.generate_wander_episode(
        jax.random.PRNGKey(0), m, cfg, angles, ticks,
        start_pose=(1.25, 1.25, 0.0), slip_noise=slip, explore=True)
    return m, cfg, angles, np.asarray(enc), np.asarray(scans), \
        np.asarray(poses)


def test_map_episode_and_dead_reckoning_match_jax():
    m, cfg, angles, enc, scans, poses = _episode()
    mc = _mc(m)
    tmc = interop.config_from(mc)
    want = np.asarray(jax.jit(lambda p, s: jmapping.map_episode(
        p, s, angles, mc, cfg.sensor))(poses, scans))
    got = tmapping.map_episode(_t(poses), _t(scans), angles, tmc, TSENSOR)
    assert_map_close(got, want, mc)
    # Two robots: the leading dim is vmap, and fusion adds.
    both = tmapping.map_episode(_t(np.stack([poses, poses[::-1]])),
                                _t(np.stack([scans, scans[::-1]])), angles,
                                tmc, TSENSOR)
    assert torch.equal(both[0], got)
    fused = tmapping.fuse_maps(both)
    assert torch.equal(fused, both[0] + both[1])
    dr_want = np.asarray(jax.jit(lambda e: jmapping.dead_reckon_poses(
        e, (1.25, 1.25, 0.0), cfg.motion))(enc))
    dr = tmapping.dead_reckon_poses(_t(enc), (1.25, 1.25, 0.0),
                                    interop.config_from(cfg.motion))
    np.testing.assert_allclose(dr.numpy(), dr_want, atol=1e-5, rtol=0)
    dr2 = tmapping.dead_reckon_poses(_t(np.stack([enc, enc])),
                                     (1.25, 1.25, 0.0),
                                     interop.config_from(cfg.motion))
    assert torch.equal(dr2[1], dr)


def test_host_fits_and_export_equal_jax(tmp_path):
    m, cfg, angles, enc, scans, poses = _episode(ticks=150, slip=0.0)
    mc = _mc(m)
    lo = np.array(jmapping.map_episode(poses, scans, angles, mc,
                                       cfg.sensor))
    walls = np.array(m.walls)
    for kw in (dict(), dict(unexplored_is_wall=False), dict(offset_tol=0),
               dict(cell_px=8, return_explored=True)):
        want = jmapping.fit_walls(lo, **kw)
        got = tmapping.fit_walls(torch.as_tensor(lo), **kw)
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            np.testing.assert_array_equal(g, w)
    learned, seen = jmapping.fit_walls(lo, return_explored=True)
    assert tmapping.wall_metrics(learned, torch.as_tensor(walls),
                                 mask=seen) == \
        jmapping.wall_metrics(learned, walls, mask=seen)
    assert tmapping.wall_metrics(learned, walls) == \
        jmapping.wall_metrics(learned, walls)
    np.testing.assert_array_equal(tmapping.to_trinary(torch.as_tensor(lo)),
                                  jmapping.to_trinary(lo))
    assert torch.equal(tmapping.to_occupancy(torch.as_tensor(lo)),
                       torch.as_tensor(lo > 0.0))
    jmapping.export_learned_map(lo, mc, str(tmp_path / "j.pgm"),
                                str(tmp_path / "j.yaml"))
    tmapping.export_learned_map(torch.as_tensor(lo),
                                interop.config_from(mc),
                                str(tmp_path / "t.pgm"),
                                str(tmp_path / "t.yaml"))
    assert (tmp_path / "t.pgm").read_bytes() == \
        (tmp_path / "j.pgm").read_bytes()
    assert (tmp_path / "t.yaml").read_text().replace("t.pgm", "j.pgm") == \
        (tmp_path / "j.yaml").read_text()
