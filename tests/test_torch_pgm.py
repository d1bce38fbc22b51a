"""maps/pgm.py and the rest of maps/grid.py (from_raster,
synthesize_walls, is_valid_pos_stencil) against the JAX package: the
cases of tests/test_pgm.py, with the port's outputs equal to JAX's (the
images, occupancy, rasters, wall tensors and written files exactly; the
beam weights on imported rasters at the weights' rtol 1e-5)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig, WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP,
)
from montecarlolocalisation_tpu.maps import from_map_file as jfrom_map_file
from montecarlolocalisation_tpu.maps import from_pgm as jfrom_pgm
from montecarlolocalisation_tpu.maps import from_raster as jfrom_raster
from montecarlolocalisation_tpu.maps import grid as jgrid
from montecarlolocalisation_tpu.maps import pgm as jpgm
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu_torch import interop, presets
from montecarlolocalisation_tpu_torch.maps import grid as tgrid
from montecarlolocalisation_tpu_torch.maps import pgm as tpgm
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import sensor as tsensor

torch.set_num_threads(1)


def _same_map(got, want):
    for name in ("occ", "occ_dilated", "walls", "row_lengths"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    for name in ("resolution", "origin_x", "origin_y", "cell_meters",
                 "n_rows", "n_cols"):
        assert getattr(got, name) == getattr(want, name), name


def _write(tmp_path, text, name="t.pgm"):
    path = str(tmp_path / name)
    with open(path, "w") as f:
        f.write(text)
    return path


def test_pgm_p5_roundtrip(tmp_path):
    img = (np.arange(35, dtype=np.uint8) * 7).reshape(5, 7)
    ours, theirs = str(tmp_path / "a.pgm"), str(tmp_path / "b.pgm")
    tpgm.save_pgm(ours, img)
    jpgm.save_pgm(theirs, img)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    np.testing.assert_array_equal(tpgm.load_pgm(ours), img)


@pytest.mark.parametrize("text", [
    "P2\n# a comment\n3 2\n# another\n255\n0 128 255\n10 20 30\n",
    "P2\n2 1\n100\n0 100\n",
    "P2\n2 2\n65535\n0 65535\n32768 100\n",
])
def test_pgm_ascii_comments_and_maxval(tmp_path, text):
    path = _write(tmp_path, text)
    np.testing.assert_array_equal(tpgm.load_pgm(path), jpgm.load_pgm(path))


def test_pgm_16_bit_binary(tmp_path):
    path = str(tmp_path / "t.pgm")
    raw = np.array([[0, 1000], [40000, 65535]], dtype=">u2")
    with open(path, "wb") as f:
        f.write(b"P5\n2 2\n65535\n" + raw.tobytes())
    np.testing.assert_array_equal(tpgm.load_pgm(path), jpgm.load_pgm(path))


def test_pgm_bad_files_raise(tmp_path):
    for text in ("P3\n1 1\n255\n0\n", "P2\n2 2\n255\n1 2 3\n", "P2\n2"):
        path = _write(tmp_path, text)
        with pytest.raises(ValueError):
            jpgm.load_pgm(path)
        with pytest.raises(ValueError):
            tpgm.load_pgm(path)


def test_yaml_parser_minimal(tmp_path):
    path = _write(tmp_path, "image: maze.pgm   # the raster\n"
                  "resolution: 0.05\norigin: [-1.0, 2.5, 0.0]\nnegate: 1\n"
                  "occupied_thresh: 0.65\nfree_thresh: 0.196\n", "m.yaml")
    doc = tpgm.parse_map_yaml(path)
    assert doc == jpgm.parse_map_yaml(path)
    assert doc["image"] == "maze.pgm" and doc["origin"] == [-1.0, 2.5, 0.0]


@pytest.mark.parametrize("negate", [False, True])
def test_occupancy_trinary_semantics(negate):
    img = np.arange(256, dtype=np.uint8).reshape(16, 16)
    got = tpgm.occupancy_from_image(img, negate=negate)
    np.testing.assert_array_equal(got, jpgm.occupancy_from_image(
        img, negate=negate))
    np.testing.assert_array_equal(
        tpgm.occupancy_from_image(np.array([[254, 0, 205]], np.uint8),
                                  negate=negate),
        [[100, 0, 100]] if negate else [[0, 100, -1]])


def test_to_pgm_image_and_export_raster(tmp_path):
    occ = np.array([[1, 0, -1], [0, 100, 0]], dtype=np.int8)
    np.testing.assert_array_equal(tpgm.to_pgm_image(occ),
                                  jpgm.to_pgm_image(occ))
    for mod, name in ((tpgm, "t"), (jpgm, "j")):
        mod.export_raster(occ, 0.05, -1.5, 2.0, str(tmp_path / f"{name}.pgm"),
                          str(tmp_path / f"{name}.yaml"))
    assert (open(tmp_path / "t.pgm", "rb").read()
            == open(tmp_path / "j.pgm", "rb").read())
    assert (open(tmp_path / "t.yaml").read().replace("t.pgm", "j.pgm")
            == open(tmp_path / "j.yaml").read())


def test_vertical_flip_convention(tmp_path):
    img = np.full((4, 3), 254, dtype=np.uint8)
    img[0, 1] = 0
    tpgm.save_pgm(str(tmp_path / "m.pgm"), img)
    path = _write(tmp_path, "image: m.pgm\nresolution: 0.1\n"
                  "origin: [0, 0, 0]\n", "m.yaml")
    m = tpgm.from_pgm(path, unknown="free", device="cpu")
    _same_map(m, jfrom_pgm(path, unknown="free"))
    assert m.occ[3, 1] and int(m.occ.sum()) == 1


def test_unknown_modes(tmp_path):
    tpgm.save_pgm(str(tmp_path / "m.pgm"),
                  np.array([[254, 205, 0]], dtype=np.uint8))
    path = _write(tmp_path, "image: m.pgm\nresolution: 0.1\n", "m.yaml")
    for unknown in ("occupied", "free"):
        _same_map(tpgm.from_pgm(path, unknown=unknown, device="cpu"),
                  jfrom_pgm(path, unknown=unknown))
    with pytest.raises(ValueError):
        tpgm.from_pgm(path, unknown="maybe", device="cpu")


def test_keep_origin(tmp_path):
    tpgm.save_pgm(str(tmp_path / "m.pgm"), np.full((9, 9), 254, np.uint8))
    path = _write(tmp_path, "image: m.pgm\nresolution: 0.1\n"
                  "origin: [-2.0, 3.0, 0.0]\n", "m.yaml")
    for keep in (False, True):
        m = tpgm.from_pgm(path, keep_origin=keep, device="cpu")
        _same_map(m, jfrom_pgm(path, keep_origin=keep))
    wx = torch.tensor([-1.9, 0.1])
    wy = torch.tensor([3.1, 0.1])
    assert tgrid.is_inside_map(m, wx, wy).tolist() == [True, False]
    rot = _write(tmp_path, "image: m.pgm\nresolution: 0.1\n"
                 "origin: [0.0, 0.0, 0.5]\n", "r.yaml")
    with pytest.raises(ValueError, match="rotated"):
        tpgm.from_pgm(rot, keep_origin=True, device="cpu")


def test_synthesize_walls_open_bands_and_blob():
    occ = np.zeros((9, 9), dtype=bool)
    occ[0, :] = True
    t = tgrid.synthesize_walls(occ, 8)
    np.testing.assert_array_equal(t, jgrid.synthesize_walls(occ, 8))
    assert t[0, 0, WALL_TOP] and not (t[0, 0, WALL_LEFT]
                                      or t[0, 0, WALL_RIGHT]
                                      or t[0, 0, WALL_BOTTOM])
    blob = np.zeros((17, 17), dtype=bool)
    blob[3:6, 3:6] = True
    t = tgrid.synthesize_walls(blob, 8)
    np.testing.assert_array_equal(t, jgrid.synthesize_walls(blob, 8))
    assert t[0, 0].all() and not t[1, 1].any()


@pytest.mark.parametrize("seed,shape,cell_px", [
    (0, (25, 25), 8), (1, (30, 17), 8), (2, (41, 41), 16), (3, (5, 6), 8)])
def test_from_raster_and_synthesized_walls_equal_jax(seed, shape, cell_px):
    rng = np.random.default_rng(seed)
    occ = rng.random(shape) < 0.15
    np.testing.assert_array_equal(tgrid.synthesize_walls(occ, cell_px),
                                  jgrid.synthesize_walls(occ, cell_px))
    res = 0.8 / cell_px
    _same_map(tgrid.from_raster(occ, res, 0.5, -0.25, device="cpu"),
              jfrom_raster(occ, res, 0.5, -0.25))


def test_roundtrip_maze_and_files_equal_jax(tmp_path):
    src = presets.make_world(device="cpu").maze
    jsrc = jfrom_map_file(presets.DEFAULT_MAP)
    tpgm.export_map(src, str(tmp_path / "t.pgm"), str(tmp_path / "t.yaml"))
    jpgm.export_map(jsrc, str(tmp_path / "j.pgm"), str(tmp_path / "j.yaml"))
    assert (open(tmp_path / "t.pgm", "rb").read()
            == open(tmp_path / "j.pgm", "rb").read())
    imp = tpgm.from_pgm(str(tmp_path / "t.yaml"), device="cpu")
    _same_map(imp, jfrom_pgm(str(tmp_path / "j.yaml")))
    assert torch.equal(imp.occ, src.occ) and imp.gridline
    world = presets.make_world(str(tmp_path / "t.yaml"), device="cpu")
    assert torch.equal(world.maze.occ, src.occ)
    assert torch.equal(world.walls, imp.walls)


@pytest.mark.parametrize("offset", [0.1, 0.13])
def test_is_valid_pos_stencil_equals_jax(offset):
    jm = jfrom_map_file(presets.DEFAULT_MAP)
    tm = interop.maze_from_numpy(jm)
    rng = np.random.default_rng(2)
    xs = rng.uniform(-0.2, 5.1, 2048).astype(np.float32)
    ys = rng.uniform(-0.2, 5.1, 2048).astype(np.float32)
    want = np.asarray(jgrid.is_valid_pos_stencil(jm, xs, ys, offset))
    got = tgrid.is_valid_pos_stencil(tm, torch.as_tensor(xs),
                                     torch.as_tensor(ys), offset)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tgrid.is_valid_pos(tm, torch.as_tensor(xs), torch.as_tensor(ys),
                           offset).numpy(),
        np.asarray(jgrid.is_valid_pos(jm, xs, ys, offset)))


def test_imported_map_weights_equal_jax_and_localize(tmp_path):
    src = presets.make_world(device="cpu").maze
    tpgm.export_map(src, str(tmp_path / "m.pgm"), str(tmp_path / "m.yaml"))
    imp = tpgm.from_pgm(str(tmp_path / "m.yaml"), device="cpu")
    jimp = jfrom_pgm(str(tmp_path / "m.yaml"))
    cfg = FilterConfig(num_particles=512)
    tcfg = interop.config_from(cfg)
    angles = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
    truth = np.float32([1.25, 1.25, 0.5])
    jscan = jsensor.simulate_scan(jimp, jnp.asarray(truth), angles,
                                  cfg.sensor)
    scan = tsensor.simulate_scan(imp, torch.as_tensor(truth), angles,
                                 tcfg.sensor)
    np.testing.assert_array_equal(scan.ranges.numpy(),
                                  np.asarray(jscan.ranges))
    near = (truth + 0.05 * np.random.default_rng(0).standard_normal(
        (512, 3))).astype(np.float32)
    np.testing.assert_allclose(
        tsensor.beam_weights(imp, torch.as_tensor(near), scan,
                             tcfg.sensor).numpy(),
        np.asarray(jsensor.beam_weights(jimp, jnp.asarray(near), jscan,
                                        cfg.sensor)), rtol=1e-5, atol=1e-6)
    state = tfilter.init_state(imp, tcfg, seed=1)
    state = dataclasses.replace(state, particles=torch.as_tensor(near))
    for _ in range(5):
        state, out = tfilter.mcl_step(state, torch.tensor(0.0),
                                      torch.tensor(0.0), scan, imp, tcfg)
    best = out.exact_pose.numpy()
    assert np.hypot(best[0] - 1.25, best[1] - 1.25) < 0.3


@pytest.mark.parametrize("ray_mode", ["fixed", "analytic"])
def test_nongridline_raster_takes_the_dense_path(ray_mode):
    occ = np.zeros((25, 25), dtype=bool)
    occ[:, 0] = occ[:, -1] = occ[0, :] = occ[-1, :] = True
    occ[12, 5:20] = True
    m = tgrid.from_raster(occ, resolution=0.1, device="cpu")
    jm = jfrom_raster(occ, resolution=0.1)
    assert not m.gridline
    cfg = FilterConfig(num_particles=64).sensor
    cfg = type(cfg)(ray_mode=ray_mode)
    tcfg = interop.config_from(cfg)
    angles = np.deg2rad(np.linspace(-90, 90, 8)).astype(np.float32)
    pose = np.float32([1.2, 0.6, 1.57])
    jscan = jsensor.simulate_scan(jm, jnp.asarray(pose), angles, cfg)
    scan = tsensor.simulate_scan(m, torch.as_tensor(pose), angles, tcfg)
    np.testing.assert_allclose(scan.ranges.numpy(), np.asarray(jscan.ranges),
                               atol=1e-5)
    rng = np.random.default_rng(1)
    parts = (pose + rng.normal(0, 0.3, (64, 3))).astype(np.float32)
    got = tsensor.beam_weights(m, torch.as_tensor(parts), scan, tcfg)
    want = np.asarray(jsensor.beam_weights(jm, jnp.asarray(parts), jscan,
                                           cfg))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)
    assert np.isfinite(got.numpy()).all() and float(got.max()) > 0.0
    if ray_mode == "analytic":
        dda = interop.config_from(type(cfg)(ray_mode="dda"))
        p = torch.as_tensor(parts)
        assert torch.equal(
            tsensor.expected_ranges(m, p, scan.angles, tcfg),
            tsensor.expected_ranges(m, p, scan.angles, dda))
