"""control/align and sim/align_sim against the JAX package's.

- RANSAC given the pair indices JAX drew (ransac_extract splits its key a
  round, _fit_candidates splits that in two, align.py:53-67): the same
  lines within 1e-5 (coefficients and end inliers) and equal inlier
  masks, on full-circle scans of a closed cell and on noisy walls with
  clutter; the generator-drawn form finds the same walls.
- The geometry (angles, feet, distances, intersections, sides, corners)
  and align_plan on the same lines: equal exactly.
- full_circle_scan equal, and run_align with injected draws (run_align
  splits its key an explore tick) ending within 1e-4 of JAX's robot with
  the same plan, from the JAX suite's starts; its exploration path too.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    AlignConfig as JAlignConfig, FilterConfig as JFilterConfig,
    SensorModelConfig as JSensorModelConfig,
)
from montecarlolocalisation_tpu.control import align as jalign
from montecarlolocalisation_tpu.maps import from_walls as jfrom_walls
from montecarlolocalisation_tpu.sim import align_sim as jsim
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.config import AlignConfig
from montecarlolocalisation_tpu_torch.control import align as talign
from montecarlolocalisation_tpu_torch.maps import from_walls
from montecarlolocalisation_tpu_torch.sim import align_sim as tsim

from torch_parity import maps

torch.set_num_threads(1)

JCFG = JFilterConfig(sensor=JSensorModelConfig(ray_mode="dda"))
TCFG = interop.config_from(JCFG)
ACFG = JAlignConfig()
BOX = [[[0, 1, 2, 3]]]


def jax_pairs(key, n_points, cfg=ACFG):
    """The pair indices ransac_extract(key, ...) draws, one (i1, i2) a
    round."""
    rounds = []
    for _ in range(cfg.max_lines):
        key, sub = jax.random.split(key)
        k1, k2 = jax.random.split(sub)
        rounds.append(tuple(
            torch.as_tensor(np.array(jax.random.randint(
                k, (cfg.max_iterations,), 0, n_points)), dtype=torch.int64)
            for k in (k1, k2)))
    return rounds


class JaxExploreDraws:
    """run_align's draws, explore tick by explore tick, as JAX splits its
    key (align_sim.py:86-88)."""

    def __init__(self, key, n_points):
        self.key, self.n, self.done = key, n_points, []

    def __getitem__(self, tick):
        while len(self.done) <= tick:
            self.key, sub = jax.random.split(self.key)
            self.done.append(jax_pairs(sub, self.n))
        return self.done[tick]


def assert_lines_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose([g.a, g.b, g.c], [w.a, w.b, w.c],
                                   rtol=0, atol=1e-5)
        np.testing.assert_allclose(g.first_inlier + g.last_inlier,
                                   w.first_inlier + w.last_inlier, rtol=0,
                                   atol=1e-5)
        np.testing.assert_array_equal(g.inlier_mask, w.inlier_mask)
        assert g.num_inliers == w.num_inliers


def assert_plans_close(got, want):
    """The same actions; values (degrees or meters from lines within
    1e-5) within 1e-3."""
    assert [(a.kind, a.speed) for a in got] == [(a.kind, a.speed)
                                                for a in want]
    np.testing.assert_allclose([a.value for a in got],
                               [a.value for a in want], rtol=0, atol=1e-3)


def _clutter(seed):
    """Two noisy walls at right angles and uniform clutter."""
    rng = np.random.default_rng(seed)
    t1 = rng.uniform(-1, 1, 120)
    t2 = rng.uniform(-1, 1, 90)
    px = np.concatenate([t1, 0.6 + 0.01 * rng.standard_normal(90),
                         rng.uniform(-1, 1, 40)])
    py = np.concatenate([-0.4 + 0.01 * rng.standard_normal(120), t2,
                         rng.uniform(-1, 1, 40)])
    mask = rng.uniform(size=px.size) > 0.05
    return px.astype(np.float32), py.astype(np.float32), mask


def _scan(pose):
    return jsim.full_circle_scan(jfrom_walls(BOX), jnp.asarray(pose), JCFG)


INPUTS = {"box_a": lambda: _scan((0.3, 0.55, 0.3)),
          "box_b": lambda: _scan((0.6, 0.3, -1.0)),
          "clutter_0": lambda: _clutter(0), "clutter_1": lambda: _clutter(1)}


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_ransac_with_jax_pairs(name):
    px, py, mask = INPUTS[name]()
    key = jax.random.PRNGKey(3)
    want = jalign.ransac_extract(key, jnp.asarray(px), jnp.asarray(py), mask,
                                 ACFG)
    got = talign.ransac_extract(torch.as_tensor(px), torch.as_tensor(py),
                                mask, AlignConfig(),
                                pairs=jax_pairs(key, len(px)))
    assert len(want) == 2
    assert_lines_equal(got, want)
    # Drawn from a torch generator: the same two walls, up to sign.
    gen = torch.Generator()
    gen.manual_seed(0)
    drawn = talign.ransac_extract(px, py, torch.as_tensor(mask),
                                  AlignConfig(), gen=gen)
    assert len(drawn) == 2
    for d in drawn:
        assert min(abs(abs(d.a * w.a + d.b * w.b) - 1) for w in want) < 0.05


def _line(j) -> talign.Line:
    return talign.Line(**{f.name: getattr(j, f.name)
                          for f in dataclasses.fields(talign.Line)})


@pytest.mark.parametrize("name", sorted(INPUTS))
def test_geometry_and_plan_equal_jax(name):
    px, py, mask = INPUTS[name]()
    jl = jalign.ransac_extract(jax.random.PRNGKey(4), jnp.asarray(px),
                               jnp.asarray(py), mask, ACFG)
    tl = [_line(j) for j in jl]
    x_axis = jalign.Line(a=1.0, b=0.0, c=0.0, inlier_mask=np.zeros(0, bool),
                         first_inlier=(0, 0), last_inlier=(0, 0))
    for (j1, t1) in zip(jl, tl):
        assert talign.perpendicular_foot(t1) == jalign.perpendicular_foot(j1)
        assert talign.distance_to_line(t1) == jalign.distance_to_line(j1)
        assert talign.classify_wall_side(t1) == jalign.classify_wall_side(j1)
        assert talign.line_angle_deg(t1, _line(x_axis)) == \
            jalign.line_angle_deg(j1, x_axis)
        fw, jfw = talign.face_wall_action(t1), jalign.face_wall_action(j1)
        assert (fw is None) == (jfw is None)
        if fw is not None:
            assert dataclasses.asdict(fw) == dataclasses.asdict(jfw)
    pairs = [(0, 1), (1, 0)]
    for i, k in pairs:
        assert talign.intersect_lines(tl[i], tl[k]) == \
            jalign.intersect_lines(jl[i], jl[k])
        assert talign.is_corner(tl[i], tl[k]) == jalign.is_corner(jl[i],
                                                                  jl[k])
        assert talign.line_angle_deg(tl[i], tl[k]) == \
            jalign.line_angle_deg(jl[i], jl[k])
        got = talign.align_plan(tl[i], tl[k], AlignConfig())
        want = jalign.align_plan(jl[i], jl[k], ACFG)
        assert [dataclasses.asdict(a) for a in got] == \
            [dataclasses.asdict(a) for a in want]
    assert talign.intersect_lines(tl[0], tl[0]) is None


def test_polar_to_cartesian_and_full_circle_scan():
    rng = np.random.default_rng(9)
    r = rng.uniform(0, 3, 50).astype(np.float32)
    a = rng.uniform(-np.pi, np.pi, 50).astype(np.float32)
    got = talign.polar_to_cartesian(r, a)
    want = jalign.polar_to_cartesian(r, a)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)
    tbox = from_walls(BOX, device="cpu")
    for pose in [(0.3, 0.55, 0.3), (0.45, 0.45, 2.0)]:
        got = tsim.full_circle_scan(tbox, torch.tensor(pose), TCFG)
        want = jsim.full_circle_scan(jfrom_walls(BOX), jnp.asarray(pose),
                                     JCFG)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


@pytest.mark.parametrize("start", [(0.3, 0.55, 0.3), (0.6, 0.3, -1.0),
                                   (0.45, 0.45, 2.0)])
def test_run_align_with_jax_draws(start):
    key = jax.random.PRNGKey(0)
    jrb, jplan = jsim.run_align(key, jfrom_walls(BOX), JCFG, start)
    trb, tplan = tsim.run_align(from_walls(BOX, device="cpu"), TCFG, start,
                                draws=JaxExploreDraws(key, 360))
    assert_plans_close(tplan, jplan)
    np.testing.assert_allclose(
        [float(trb.x), float(trb.y), float(trb.theta)],
        [float(jrb.x), float(jrb.y), float(jrb.theta)], rtol=0, atol=1e-4)
    # The JAX suite's check: roughly centred, the two-wall plan.
    assert len(tplan) == 4 and abs(abs(tplan[2].value) - 90.0) < 1e-6
    assert np.hypot(float(trb.x) - 0.45, float(trb.y) - 0.45) < 0.30


def test_run_align_explores_in_the_maze():
    # From the default maze's open corridor fewer than two walls lock at
    # first: the robot explores before the plan (align_server.cpp:779-793).
    jm, tm = maps()
    start = (2.0, 2.0, 0.0)
    key = jax.random.PRNGKey(1)
    jrb, jplan = jsim.run_align(key, jm, JCFG, start, max_explore_ticks=40)
    draws = JaxExploreDraws(key, 360)
    trb, tplan = tsim.run_align(tm, TCFG, start, max_explore_ticks=40,
                                draws=draws)
    assert_plans_close(tplan, jplan)
    np.testing.assert_allclose(
        [float(trb.x), float(trb.y), float(trb.theta)],
        [float(jrb.x), float(jrb.y), float(jrb.theta)], rtol=0, atol=1e-4)
    assert len(draws.done) > 1        # explore ticks ran
