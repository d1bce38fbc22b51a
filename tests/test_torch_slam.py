"""The port's RBPF SLAM (models/slam) against the JAX package's.

- _blur_matrix and hit_field within 1e-6; _bilinear (a four-tap gather)
  against JAX's tent einsum within 1e-6: points off the pixel-centre
  hull, on the last pixel, on integer coordinates and in windows.
- field_windows equal; scan_log_likelihood and scan_loglik_multi within
  rtol 1e-5, dense and windowed (a 12 x 10-cell maze, 97 x 81 px).
- closure_correction on the JAX suite's known-offset case
  (tests/test_slam.py:510): the same offset (to 1e-8: XLA folds the
  candidate grid's linspace with its own rounding) and gain within 1e-4.
- slam_step teacher-forced for 20 ticks from JAX's state with JAX's draws
  (tests/torch_parity.jax_slam_draws), P = 16, 24 beams, under the
  default config, K = 3 candidates, keyframes, the closure and 2 rounds
  of refinement: >= 99.9 % of the pose rows within 1e-5, >= 99.9 % of
  the map pixels within 1e-5, weights within rtol 1e-4 (the log-weights
  carry a float32 sum over 24 x 7 terms, which JAX orders otherwise),
  log_evidence within 1e-4, resampled and mapped exact, closure_delta
  within 1e-8.
- run_slam_episode on JAX's draws against JAX's lax.scan; a [3] batch
  equal bit for bit to its episodes run one by one; run_slam_replicas
  taking the argmax of the evidence; the TickGraph on the CPU equal to
  eager ticks bit for bit; best_map and best_pose as JAX picks them.
"""
import functools
import os.path as osp

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (FilterConfig, MappingConfig,
                                               SLAMConfig)
from montecarlolocalisation_tpu.maps import from_map_file, from_walls
from montecarlolocalisation_tpu.maps import generator
from montecarlolocalisation_tpu.models import mapping as jmapping
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.models import slam as jslam
from montecarlolocalisation_tpu.sim import robot as jrobot
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.models import compiled
from montecarlolocalisation_tpu_torch.models import slam as tslam

from torch_parity import jax_slam_draws, t

torch.set_num_threads(1)

MAP_PATH = osp.join(osp.dirname(__file__), "..", "montecarlolocalisation_tpu",
                    "maps", "default_map.txt")
ANGLES = np.deg2rad(np.linspace(-118, 118, 24)).astype(np.float32)
START = (1.25, 1.25, 0.0)
TICKS = 20


def _cfg(m, **kw):
    fc = FilterConfig()
    mc = MappingConfig(height=m.height, width=m.width,
                       resolution=float(m.resolution),
                       origin_x=float(m.origin_x), origin_y=float(m.origin_y))
    return SLAMConfig(**dict(dict(num_particles=16, mapping=mc,
                                  sensor=fc.sensor, motion=fc.motion), **kw))


@functools.lru_cache(maxsize=None)
def _maze():
    return from_map_file(MAP_PATH)


@functools.lru_cache(maxsize=None)
def _big():
    return from_walls(generator.generate_maze(12, 10, seed=3))


@functools.lru_cache(maxsize=None)
def _episode(ticks=TICKS, seed=0):
    """A wander with 5 % wheel slip on the default maze: (encoders [T, 2],
    ranges [T, 24]) as numpy."""
    enc, scans, _ = jrobot.generate_wander_episode(
        jax.random.PRNGKey(seed), _maze(), FilterConfig(), ANGLES, ticks,
        start_pose=START, slip_noise=0.05, explore=True)
    return np.asarray(enc), np.asarray(scans)


def test_blur_matrix_and_hit_field_match_jax():
    cfg = _cfg(_maze())
    np.testing.assert_allclose(
        tslam._blur_matrix(49, 1.0, 4).numpy(),
        np.asarray(jslam._blur_matrix(49, 1.0, 4)), atol=1e-6, rtol=0)
    rng = np.random.RandomState(0)
    for shape in ((3, 49, 49), (2, 3, 39, 39)):
        lo = rng.uniform(-4, 4, shape).astype(np.float32)
        lo[..., 10:14, :] = 8.0                  # walls: a saturated field
        fn = functools.partial(jslam.hit_field, cfg=cfg)
        want = jax.jit(fn if len(shape) == 3 else jax.vmap(fn))(lo)
        got = tslam.hit_field(t(lo), interop.config_from(cfg))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-6,
                                       rtol=0)


def _points(kind, mcfg, rng, p=3, s=40):
    """World points [P, S] of a kind, and the offsets for a window."""
    w_m, h_m = mcfg.width * mcfg.resolution, mcfg.height * mcfg.resolution
    ex = rng.uniform(0.0, w_m, (p, s))
    ey = rng.uniform(0.0, h_m, (p, s))
    res = mcfg.resolution
    if kind == "off_hull":
        ex[:, ::3] = rng.uniform(-0.5, 0.04, (p, len(ex[0, ::3])))
        ey[:, 1::3] = rng.uniform(h_m - 0.04, h_m + 0.5,
                                  (p, len(ey[0, 1::3])))
    elif kind == "last_pixel":
        ex[:, ::2] = mcfg.origin_x + (mcfg.width - 0.5) * res
        ey[:, 1::2] = mcfg.origin_y + (mcfg.height - 0.5) * res
    elif kind == "integer":
        ex = mcfg.origin_x + (rng.randint(0, mcfg.width, (p, s)) + 0.5) * res
        ey = mcfg.origin_y + (rng.randint(0, mcfg.height, (p, s)) + 0.5) * res
    return ex.astype(np.float32), ey.astype(np.float32)


@pytest.mark.parametrize("kind", ["inside", "off_hull", "last_pixel",
                                  "integer", "windowed"])
def test_bilinear_gather_matches_tent_einsum(kind):
    m = _big() if kind == "windowed" else _maze()
    mcfg = _cfg(m).mapping
    rng = np.random.RandomState(1)
    ex, ey = _points(kind, mcfg, rng)
    if kind == "integer":
        # The fixture's premise: most points sit on a pixel centre.
        u = (ex - mcfg.origin_x) * np.float32(1 / mcfg.resolution) - 0.5
        assert np.mean(u == np.round(u)) >= 0.5
    offsets = None
    if kind == "windowed":
        r0 = np.array([0, 20, 42], np.int32)
        c0 = np.array([58, 10, 0], np.int32)
        field = rng.uniform(0, 1, (3, 39, 39)).astype(np.float32)
        # Points inside each window and a few past it.
        ex = (mcfg.origin_x + (c0[:, None] + rng.uniform(-2, 40, (3, 40)))
              * mcfg.resolution).astype(np.float32)
        ey = (mcfg.origin_y + (r0[:, None] + rng.uniform(-2, 40, (3, 40)))
              * mcfg.resolution).astype(np.float32)
        offsets = (r0, c0)
    else:
        field = rng.uniform(0, 1, (3, mcfg.height, mcfg.width)).astype(
            np.float32)
    want = jax.jit(lambda f, x, y: jslam._bilinear(
        f, x, y, mcfg, None if offsets is None else tuple(
            jnp.asarray(o) for o in offsets)))(field, ex, ey)
    got = tslam._bilinear(
        t(field), t(ex), t(ey), interop.config_from(mcfg),
        None if offsets is None else tuple(t(o, torch.int64)
                                           for o in offsets))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=0)
    if kind == "off_hull":
        assert (got.numpy() == 0).sum() >= ex.size // 3


def _random_maps(cfg, rng, p):
    mc = cfg.mapping
    lo = rng.uniform(-3, 3, (p, mc.height, mc.width)).astype(np.float32)
    lo[:, ::8, :] = 6.0
    return lo


@pytest.mark.parametrize("which", ["dense", "windowed"])
def test_field_windows_and_likelihoods_match_jax(which):
    m = _maze() if which == "dense" else _big()
    cfg = _cfg(m, num_particles=4)
    tcfg = interop.config_from(cfg)
    rng = np.random.RandomState(2)
    lo = _random_maps(cfg, rng, 4)
    w_m = cfg.mapping.width * cfg.mapping.resolution
    h_m = cfg.mapping.height * cfg.mapping.resolution
    poses = np.stack([rng.uniform(0.3, w_m - 0.3, 4),
                      rng.uniform(0.3, h_m - 0.3, 4),
                      rng.uniform(-3, 3, 4)], -1).astype(np.float32)
    ranges = rng.uniform(0.1, 1.1, 24).astype(np.float32)
    ranges[3] = cfg.sensor.max_range
    mask = np.ones(24, np.float32)
    mask[5] = 0.0
    jwin, joff = jax.jit(lambda l, p: jslam.field_windows(l, p, cfg))(
        lo, poses)
    twin, toff = tslam.field_windows(t(lo), t(poses), tcfg)
    np.testing.assert_array_equal(twin.numpy(), np.asarray(jwin))
    assert (toff is None) == (joff is None) == (which == "dense")
    if joff is not None:
        for a, b in zip(toff, joff):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cand = (poses[:, None, :] + rng.normal(0, 0.03, (4, 3, 3))).astype(
        np.float32)

    def jax_ll(w, o, p, c):
        f = jslam.hit_field(w, cfg)
        return (jslam.scan_log_likelihood(f, p, ranges, ANGLES, mask, cfg,
                                          o),
                jslam.scan_loglik_multi(f, c, ranges, ANGLES, mask, cfg, o))

    want1, want3 = jax.jit(jax_ll)(jwin, joff, poses, cand)
    field = tslam.hit_field(twin, tcfg)
    got1 = tslam.scan_log_likelihood(field, t(poses), t(ranges), t(ANGLES),
                                     t(mask), tcfg, toff)
    got3 = tslam.scan_loglik_multi(field, t(cand), t(ranges), t(ANGLES),
                                   t(mask), tcfg, toff)
    np.testing.assert_allclose(got1.numpy(), np.asarray(want1), rtol=1e-5)
    np.testing.assert_allclose(got3.numpy(), np.asarray(want3), rtol=1e-5)


def _painted(m, cfg, pose, angles):
    """The JAX suite's _painted_state (tests/test_slam.py:487-507): maps
    [4, H, W] painted from around `pose` with the true maze's scans, and
    the scan at `pose`."""
    tp = np.asarray(pose, np.float32)
    lo = jnp.zeros((cfg.mapping.height, cfg.mapping.width), jnp.float32)
    for ddx, ddy in ((0.0, 0.0), (-0.2, 0.0), (0.2, 0.0), (0.0, -0.2),
                     (0.0, 0.2)):
        p = jnp.asarray([tp[0] + ddx, tp[1] + ddy, tp[2]], jnp.float32)
        s = jsensor.simulate_scan(m, p, angles, cfg.sensor)
        for _ in range(2):
            lo = jmapping.update_map(lo, p, s.ranges, angles, s.mask,
                                     cfg.mapping, cfg.sensor)
    sc = jsensor.simulate_scan(m, jnp.asarray(tp), angles, cfg.sensor)
    return sc, np.broadcast_to(np.asarray(lo), (4,) + lo.shape)


@pytest.mark.parametrize("case", ["translation", "rotation", "flat"])
def test_closure_correction_matches_jax(case):
    m = _maze()
    cfg = _cfg(m, num_particles=4, closure=True,
               **(dict(closure_margin=0.5) if case == "rotation" else {}))
    angles = np.deg2rad(np.linspace(-118, 118, 64)).astype(np.float32)
    pose, drift = dict(translation=((1.25, 1.25, 0.0), (0.10, -0.05, 0.0)),
                       rotation=((2.05, 2.05, 0.7), (0.0, 0.0, 0.08)),
                       flat=((1.25, 1.25, 0.0), (0.0, 0.0, 0.0)))[case]
    sc, lo = _painted(m, cfg, pose, jnp.asarray(angles))
    ranges, mask = np.asarray(sc.ranges), np.asarray(sc.mask, np.float32)
    if case == "flat":
        lo = np.zeros_like(lo)
    w = np.full(4, 0.25, np.float32)
    mean = (np.asarray(pose) + np.asarray(drift)).astype(np.float32)
    jd, jg = jax.jit(lambda l: jslam.closure_correction(
        l, w, mean, ranges, angles, mask, cfg))(lo)
    td, tg = tslam.closure_correction(t(lo), t(w), t(mean), t(ranges),
                                      t(angles), t(mask),
                                      interop.config_from(cfg))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=1e-8,
                               rtol=0)
    np.testing.assert_allclose(float(tg), float(jg), atol=1e-4, rtol=0)
    if case == "translation":
        assert float(tg) >= cfg.closure_margin
        assert np.all(np.abs(td.numpy()[:2] + np.asarray(drift)[:2])
                      <= 0.051)
    if case == "flat":
        assert not td.any()


CONFIGS = dict(
    default={},
    candidates=dict(proposal_candidates=3),
    keyframes=dict(keyframe_trans=0.15, keyframe_rot=0.5),
    closure=dict(keyframe_trans=0.05, keyframe_rot=0.2, closure=True,
                 closure_margin=0.5, closure_min_beams=4),
    refine=dict(refine_iters=2),
)


def _port_state(st):
    return interop.slam_state_from_numpy(jax.device_get(st))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_teacher_forced_slam_step_matches_jax(name):
    cfg = _cfg(_maze(), **CONFIGS[name])
    tcfg = interop.config_from(cfg)
    enc, scans = _episode()
    mask = np.ones(24, np.float32)
    step = jax.jit(lambda s, e, r: jslam.slam_step(
        s, e[0], e[1], r, ANGLES, mask, cfg))
    st = jslam.init_slam(jax.random.PRNGKey(1), START, cfg)
    rows, pixels, flags = [], [], []
    for k in range(TICKS):
        draws, _ = jax_slam_draws(st.key, cfg)
        got, ginfo = tslam.slam_step(
            _port_state(st), float(enc[k, 0]), float(enc[k, 1]),
            t(scans[k]), t(ANGLES), t(mask), tcfg, draws=draws)
        st, info = step(st, enc[k], scans[k])
        rows.append(np.max(np.abs(got.poses.numpy() - np.asarray(st.poses)),
                           axis=-1) <= 1e-5)
        pixels.append(np.abs(got.logodds.numpy() - np.asarray(st.logodds))
                      <= 1e-5)
        np.testing.assert_allclose(got.weights.numpy(),
                                   np.asarray(st.weights), rtol=1e-4)
        assert abs(float(got.log_evidence) - float(st.log_evidence)) <= 1e-4
        for key in ("resampled", "mapped"):
            assert bool(ginfo[key]) == bool(info[key]), (k, key)
        np.testing.assert_allclose(ginfo["closure_delta"].numpy(),
                                   np.asarray(info["closure_delta"]),
                                   atol=1e-8, rtol=0)
        np.testing.assert_allclose(ginfo["pose"].numpy(),
                                   np.asarray(info["pose"]), atol=1e-5,
                                   rtol=0)
        assert int(got.closure_cool) == int(st.closure_cool)
        flags.append((bool(info["resampled"]), bool(info["mapped"]),
                      bool(np.any(np.asarray(info["closure_delta"])))))
    assert np.mean(rows) >= 0.999
    assert np.mean(pixels) >= 0.999
    # The ticks took each branch the config allows.
    resampled, mapped, fired = (any(f[i] for f in flags) for i in range(3))
    assert resampled and mapped
    if name == "keyframes":
        assert not all(f[1] for f in flags)


def _jax_episode(cfg, ticks=TICKS):
    enc, scans = _episode(ticks)
    final, poses = jax.jit(lambda k: jslam.run_slam_episode(
        k, enc, scans, ANGLES, cfg, START))(jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(1)
    draws = []
    for _ in range(ticks):
        d, key = jax_slam_draws(key, cfg)
        draws.append(d)
    return enc, scans, final, np.asarray(poses), draws


def test_run_slam_episode_on_jax_draws_matches_jax():
    cfg = _cfg(_maze(), keyframe_trans=0.15, keyframe_rot=0.5)
    enc, scans, jfinal, jposes, draws = _jax_episode(cfg)
    final, poses = tslam.run_slam_episode(
        1, t(enc), t(scans), ANGLES, interop.config_from(cfg), START,
        draws=draws)
    assert poses.shape == (TICKS, 3)
    np.testing.assert_allclose(poses.numpy(), jposes, atol=1e-4, rtol=0)
    np.testing.assert_allclose(final.poses.numpy(),
                               np.asarray(jfinal.poses), atol=1e-4, rtol=0)
    diff = np.abs(final.logodds.numpy() - np.asarray(jfinal.logodds))
    assert np.mean(diff <= 1e-5) >= 0.999
    assert abs(float(final.log_evidence) - float(jfinal.log_evidence)) \
        <= 1e-3
    np.testing.assert_allclose(tslam.best_pose(final).numpy(),
                               np.asarray(jslam.best_pose(jfinal)),
                               atol=1e-4, rtol=0)
    assert np.mean(np.abs(tslam.best_map(final).numpy()
                          - np.asarray(jslam.best_map(jfinal))) <= 1e-5) \
        >= 0.999


def _port_draws(cfg, batch, ticks, seed):
    gen = torch.Generator()
    gen.manual_seed(seed)
    return [tslam.draw_slam(gen, cfg, batch, "cpu") for _ in range(ticks)]


def test_batch_equals_its_episodes_bit_for_bit():
    """A [3] state on three episodes (each its own encoders, scans, start
    and draws) equals each episode run alone."""
    cfg = interop.config_from(_cfg(_maze(), num_particles=32,
                                   proposal_candidates=2,
                                   keyframe_trans=0.1, closure=True,
                                   closure_margin=0.5, closure_min_beams=4))
    eps = [_episode(12, seed) for seed in range(3)]
    starts = np.array([START, (1.2, 1.3, 0.1), (1.3, 1.2, -0.1)],
                      np.float32)
    draws = [_port_draws(cfg, (), 12, s) for s in range(3)]
    singles = [tslam.run_slam_episode(
        0, t(e), t(s), ANGLES, cfg, starts[i], draws=draws[i])
        for i, (e, s) in enumerate(eps)]
    batched = [tslam.SLAMDraws(
        normals=torch.stack([d[k].normals for d in draws]),
        gumbel=torch.stack([d[k].gumbel for d in draws]),
        u0=torch.stack([d[k].u0 for d in draws])) for k in range(12)]
    final, poses = tslam.run_slam_episode(
        0, t(np.stack([e for e, _ in eps])),
        t(np.stack([s for _, s in eps])), ANGLES, cfg, starts,
        draws=batched)
    for i, (sfinal, sposes) in enumerate(singles):
        assert torch.equal(poses[i], sposes)
        for f in ("poses", "logodds", "weights", "scores", "kf_pose",
                  "closure_cool", "log_evidence"):
            assert torch.equal(getattr(final, f)[i], getattr(sfinal, f)), f


def test_run_slam_replicas_takes_the_argmax_of_the_evidence():
    cfg = interop.config_from(_cfg(_maze(), num_particles=16))
    enc, scans = _episode(12)
    win, poses, info = tslam.run_slam_replicas(
        5, t(enc), t(scans), ANGLES, cfg, START, replicas=3)
    every, all_poses = tslam.run_slam_episode(
        5, t(enc), t(scans), ANGLES, cfg, START, batch=(3,))
    assert torch.equal(info["log_evidence"], every.log_evidence)
    best = int(torch.argmax(every.log_evidence))
    assert int(info["chosen"]) == best
    assert torch.equal(poses, all_poses[best])
    assert torch.equal(win.logodds, every.logodds[best])
    assert win.poses.shape == (16, 3) and poses.shape == (12, 3)
    # Two episodes of three replicas each: the argmax runs per episode.
    win2, poses2, info2 = tslam.run_slam_replicas(
        5, t(np.stack([enc, enc])), t(np.stack([scans, scans])), ANGLES,
        cfg, START, replicas=3, tick_chunk=4)
    assert info2["log_evidence"].shape == (2, 3)
    assert torch.equal(info2["chosen"],
                       torch.argmax(info2["log_evidence"], dim=-1))
    assert poses2.shape == (2, 12, 3) and win2.logodds.shape == (2, 16, 49,
                                                                 49)
    with pytest.raises(ValueError):
        tslam.run_slam_replicas(5, t(enc), t(scans), ANGLES, cfg, START,
                                tick_chunk=0)


@pytest.mark.parametrize("k", [3, 8])
def test_tick_graph_on_the_cpu_equals_eager_ticks(monkeypatch, k):
    """run_slam_episode (TickGraphs of k ticks, their buffers and copies,
    the ticks called eagerly on the CPU) against slam_step called tick by
    tick from the same generator state: bit for bit."""
    monkeypatch.setattr(compiled, "TICKS_PER_GRAPH", k)
    compiled.graphs.clear()
    cfg = interop.config_from(_cfg(_maze(), keyframe_trans=0.15,
                                   keyframe_rot=0.5, proposal_candidates=2))
    enc, scans = _episode(10)
    final, poses = tslam.run_slam_episode(3, t(enc), t(scans), ANGLES, cfg,
                                          START, batch=(2,))
    st = tslam.init_slam(3, START, cfg, (2,), "cpu")
    want = []
    for i in range(10):
        st, info = tslam.slam_step(st, float(enc[i, 0]), float(enc[i, 1]),
                                   t(scans[i]), t(ANGLES), torch.ones(24),
                                   cfg)
        want.append(info["pose"])
    assert torch.equal(poses, torch.stack(want, dim=1))
    for f in ("poses", "logodds", "weights", "scores", "log_evidence"):
        assert torch.equal(getattr(final, f), getattr(st, f)), f
    assert torch.equal(final.gen.get_state(), st.gen.get_state())
    compiled.graphs.clear()
