"""The benchmark's frozen copies held to the originals once, at a small
size: the maze raster, the wander and its scans, the casters, the bounds'
counts and the reference tick.  Only these tests import the originals."""
from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest
import torch

from mclbench import bounds, generator
from mclbench.reference import caster, maze
from mclbench.reference import filter as ref

from . import tiny

MAP = os.path.join(tiny.BENCH, "data", "default_map.txt")


def _filter(name="ref-1500x34") -> dict:
    with open(os.path.join(tiny.BENCH, "configs", name + ".json")) as f:
        return json.load(f)["filter"]


@pytest.fixture(scope="module")
def port():
    from montecarlolocalisation_tpu_torch import config, maps
    from montecarlolocalisation_tpu_torch.models import filter as mcl
    from montecarlolocalisation_tpu_torch.models import raycast
    from montecarlolocalisation_tpu_torch.sim import robot

    return dict(config=config, maps=maps, mcl=mcl, raycast=raycast,
                robot=robot, m=maps.from_map_file(MAP, device="cpu"))


def _rays(n, seed=0):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand(n, generator=g) * 4.9, torch.rand(n, generator=g) * 4.9,
            (torch.rand(n, generator=g) * 2 - 1) * np.pi)


def test_the_raster_is_the_ports(port):
    mz = maze.load(MAP)
    assert torch.equal(mz.occ, port["m"].occ)
    assert torch.equal(mz.occ_dilated, port["m"].occ_dilated)
    assert (mz.n_rows, mz.n_cols) == (port["m"].n_rows, port["m"].n_cols)


@pytest.mark.parametrize("mode", ["fixed", "analytic"])
def test_the_casters_are_the_ports(port, mode):
    mz = maze.load(MAP)
    sensor = dict(_filter()["sensor"], ray_mode=mode)
    cfg = port["config"].SensorModelConfig(ray_mode=mode)
    ox, oy, a = _rays(4000)
    assert torch.equal(caster.cast(mz, ox, oy, a, sensor),
                       port["raycast"].raycast(port["m"], ox, oy, a, cfg))


def test_the_wall_rectangles_cast_as_the_slabs():
    mz = maze.load(MAP)
    sensor = _filter()["sensor"]
    ox, oy, a = _rays(20000, seed=1)
    walls = generator.Walls(mz)
    d = torch.abs(walls.cast(ox, oy, a, sensor)
                  - caster.slabs(mz, ox, oy, a, sensor["max_range"]))
    assert float((d > 1e-5).float().mean()) <= 1e-3


def test_the_wander_is_the_ports(port):
    mz = maze.load(MAP)
    f = _filter()
    sensor = dict(f["sensor"], ray_mode="analytic")
    angles = torch.from_numpy(np.deg2rad(np.linspace(-118, 118, 7)).astype(
        np.float32))
    e, t = 3, 40
    gen = torch.Generator().manual_seed(3)
    d = generator.draws(gen, e, t, 7, 10, "cpu")
    start = torch.tensor([[1.25, 1.25, 0.0]] * e)
    w = generator.Wander()
    mine = generator.wander(mz, angles, sensor, f["motion"], start, d, w)
    rb = port["robot"]
    from montecarlolocalisation_tpu_torch.models import sensor as psensor

    cfg = port["config"].FilterConfig(
        sensor=port["config"].SensorModelConfig(ray_mode="analytic"))
    draws = rb.WanderDraws(scan=psensor.ScanDraws(noise=d["noise"]),
                           tie=d["tie"], dur=d["dur"])
    theirs = rb.generate_wander_episode(
        None, port["m"], cfg, angles, t, batch=e, start_pose=(1.25, 1.25, 0),
        scan_noise=w.scan_noise, explore=True, draws=draws)
    for a, b in zip(mine, theirs):
        assert torch.allclose(a, b, atol=1e-5), float((a - b).abs().max())


def test_the_counts_are_the_yardstick_of_chip_smoke(port):
    sys.path.insert(0, tiny.ROOT)
    import chip_smoke

    mz = maze.load(MAP)
    g = torch.Generator().manual_seed(5)
    parts = torch.stack([torch.rand(300, generator=g) * 4.9,
                         torch.rand(300, generator=g) * 4.9,
                         (torch.rand(300, generator=g) * 2 - 1) * np.pi], -1)
    angles = torch.from_numpy(np.deg2rad(np.linspace(-118, 118, 9)).astype(
        np.float32))
    sensor = _filter()["sensor"]
    cfg = port["config"].SensorModelConfig()
    assert bounds.march_samples(mz, parts, angles, sensor) == \
        chip_smoke.march_samples(port["m"], parts, angles, cfg)
    assert bounds.k1_bound(mz, parts, angles, sensor) == \
        chip_smoke.k1_bound(port["m"], parts, angles, cfg)
    # chip_smoke's slab count takes its first candidate once a particle,
    # not once a beam: with one beam the two agree.
    acfg = port["config"].SensorModelConfig(ray_mode="analytic")
    one = angles[4:5]
    assert bounds.slab_candidates(mz, parts, one, dict(
        sensor, ray_mode="analytic")) == chip_smoke.slab_candidates(
            port["m"], parts, one, acfg)
    xy = parts[None, :, :2].contiguous()
    c0 = xy[:, :3]
    rs = xy[:, torch.randint(0, 300, (20 * 3,), generator=g)].reshape(
        1, 20, 3, 2)
    assert bounds.kmeans_iterations(xy, c0, rs) == \
        chip_smoke.kmeans_iterations(xy, c0, rs)
    assert bounds.k3_bound(xy, c0, rs) == chip_smoke.k3_bound(xy, c0, rs)


@pytest.mark.parametrize("name", ["ref-1500x34", "global-1m-analytic"])
def test_the_reference_tick_is_the_ports(port, name):
    """Eight ticks of a batch from the same seed: the same particles, bit
    for bit, and the same answers, on the CPU (the port's plain
    versions)."""
    from mclbench.program import filter_config

    f = dict(_filter(name), num_particles=96)
    cfg = filter_config(f)
    mz = maze.load(MAP)
    angles = ref.beam_table(dict(count=9, min_deg=-118, max_deg=118))
    enc, ranges, _ = generator.logs(11, mz, angles, f["sensor"], f["motion"],
                                    2, 8)
    st = port["mcl"].init_state(port["m"], cfg, 7, batch=2)
    st, outs = port["mcl"].run_episode(st, enc, ranges, angles, port["m"],
                                       cfg)
    rst, gen = ref.init(mz, f, 7, 2)
    mask = torch.ones(ranges.shape, dtype=torch.bool)
    rst, routs = ref.run(rst, gen, enc, ranges, mask, angles, mz, f)
    assert torch.equal(rst.particles, st.particles)
    assert torch.equal(gen.get_state(), st.gen.get_state())
    for t, o in enumerate(routs):
        assert torch.equal(o.exact_pose, outs.exact_pose[:, t])
        assert torch.equal(o.confidence, outs.confidence[:, t])
        assert torch.equal(o.song, outs.song[:, t])
