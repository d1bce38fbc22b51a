"""The port's frontier exploration (sim/frontier) against the JAX
package's.

- frontier_cells and plan_to_nearest_frontier exactly equal to JAX's on
  random seen-edge masks and wall graphs, without and with a numpy
  Generator of the same seed.
- _explore_tick teacher-forced for 8 ticks on JAX's draws (its phase
  key's scan noise and slip, its SLAM key's draws), the state carried
  across by interop.explore_state_from_numpy every tick, and explore_phase
  over the same 8 ticks from one carried state (graphs of 3 ticks), in
  three styles: the freer side with two waypoints (an arrival), the
  novelty bias with one (the spin), and wall following with none.  The
  control fields (wp_idx, turn_left, turn_sign) equal, the true pose
  within 1e-5, the SLAM fields at test_torch_slam.py's slam_step
  tolerances (>= 99.9 % of the pose rows and map pixels within 1e-5,
  weights rtol 1e-4, the estimate within 1e-5).
- The JAX suite's mechanics (tests/test_frontier.py) on the port: the
  phase runs and the SLAM map gains evidence, the policies' coverage never
  decreases, the wall follower turns away from its wall.
- run_frontier_slam's host loop teacher-forced on JAX's phases, handed
  JAX's host seed: the same waypoint slabs every phase and the same
  coverage, for the frontier and hybrid policies.
- run_slam(explore_mode="frontier" / "hybrid") returns the JAX preset's
  keys, in order; the CLI's `slam --explore frontier` prints the JAX
  CLI's.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu import presets as jpresets
from montecarlolocalisation_tpu.config import (FilterConfig, MappingConfig,
                                               SLAMConfig)
from montecarlolocalisation_tpu.models import slam as jslam
from montecarlolocalisation_tpu.sim import frontier as jfr
from montecarlolocalisation_tpu_torch import __main__ as tmain
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch import presets as tpresets
from montecarlolocalisation_tpu_torch.models import compiled
from montecarlolocalisation_tpu_torch.models import mapping as tmapping
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.sim import frontier as tfr
from montecarlolocalisation_tpu_torch.sim import robot as trobot

from torch_parity import jax_slam_draws, maps, t

torch.set_num_threads(1)

B = 12
ANGLES = np.deg2rad(np.linspace(-118, 118, B)).astype(np.float32)
START = (1.25, 1.25, 0.0)
TICKS = 8
# (knobs, waypoints, n_wp) of each style: an arrival at the first of two
# waypoints, the spin after the only one, no waypoint at all.
STYLES = dict(
    freer=({}, [[1.3, 1.25], [2.0, 2.0]], 2),
    novelty=(dict(novelty_bias=1.0), [[1.25, 1.25]], 1),
    wallfollow=(dict(wander_style="wallfollow"), [], 0),
)
TICK_ARGS = (0.03, 0.02, 8.0, 5.0, 0.25, 0.25, 0.1)


def _scfg(m, particles=16):
    fc = FilterConfig()
    mc = MappingConfig(height=m.height, width=m.width,
                       resolution=float(m.resolution),
                       origin_x=float(m.origin_x),
                       origin_y=float(m.origin_y))
    return SLAMConfig(num_particles=particles, mapping=mc, sensor=fc.sensor,
                      motion=fc.motion)


def _slots(wps, slots=4):
    pad = np.zeros((slots, 2), np.float32)
    pad[:len(wps)] = np.reshape(wps, (-1, 2))
    return pad


# ----------------------------------------------------------------------
# The host planner.
# ----------------------------------------------------------------------

def test_frontier_cells_and_planning():
    """The JAX suite's planner check, on the port."""
    seen = np.ones((3, 3, 4), bool)
    assert tfr.frontier_cells(seen) == []
    seen[1, 2, 0] = False
    seen[2, 0, 3] = False
    cells = tfr.frontier_cells(seen)
    assert set(cells) == {(1, 2), (2, 0)}
    walls = np.zeros((3, 3, 4), bool)
    path = tfr.plan_to_nearest_frontier(walls, seen, (0, 0))
    assert path and path[0] == (0, 0) and tuple(path[-1]) in set(cells)
    seen2 = np.ones((3, 3, 4), bool)
    seen2[0, 0, 1] = False
    assert tfr.plan_to_nearest_frontier(walls, seen2, (0, 0)) == []
    p2 = tfr.plan_to_nearest_frontier(walls, seen, (0, 0),
                                      np.random.default_rng(0))
    assert p2 and tuple(p2[-1]) in set(cells)


@pytest.mark.parametrize("seed", range(4))
def test_frontier_planning_matches_jax(seed):
    rng = np.random.RandomState(seed)
    jrng, trng = (np.random.default_rng(seed) for _ in range(2))
    for _ in range(8):
        rows, cols = rng.randint(3, 8, 2)
        seen = rng.rand(rows, cols, 4) > rng.uniform(0.2, 0.9)
        walls = rng.rand(rows, cols, 4) > 0.6
        cur = (int(rng.randint(rows)), int(rng.randint(cols)))
        assert tfr.frontier_cells(seen) == jfr.frontier_cells(seen)
        for k in (1, 3):
            want = jfr.plan_to_nearest_frontier(walls, seen, cur, None, k)
            got = tfr.plan_to_nearest_frontier(walls, seen, cur, None, k)
            assert [tuple(c) for c in got] == [tuple(c) for c in want]
            want = jfr.plan_to_nearest_frontier(walls, seen, cur, jrng, k)
            got = tfr.plan_to_nearest_frontier(walls, seen, cur, trng, k)
            assert [tuple(c) for c in got] == [tuple(c) for c in want]


# ----------------------------------------------------------------------
# The explore tick and phase on JAX's draws.
# ----------------------------------------------------------------------

def _draws(tick_keys, slam_key, cfg):
    """The port's ExploreDraws of JAX's ticks: scan noise from each tick
    key's first split (sensor.py:465-467), slip from its fold_in 1
    (frontier.py:204-205), the SLAM draws down the SLAM key's chain."""
    out = []
    for k in tick_keys:
        noise = jax.random.normal(jax.random.split(k, 4)[0], (B,))
        slip = jax.random.normal(jax.random.fold_in(k, 1), (2,))
        sd, slam_key = jax_slam_draws(slam_key, cfg)
        out.append(tfr.ExploreDraws(scan=tsensor.ScanDraws(noise=t(noise)),
                                    slam=sd, slip=t(slip)))
    return out


def _port(st):
    return interop.explore_state_from_numpy(jax.device_get(st))


class _Close:
    """Accumulates the comparisons of port and JAX states."""

    def __init__(self):
        self.rows, self.pixels = [], []

    def states(self, got, want):
        assert int(got.wp_idx) == int(want.wp_idx)
        assert int(got.turn_left) == int(want.turn_left)
        assert float(got.turn_sign) == float(want.turn_sign)
        np.testing.assert_allclose(got.robot.pose.numpy(),
                                   np.asarray(want.robot.pose), atol=1e-5,
                                   rtol=0)
        for f in ("encoder_left", "encoder_right"):
            np.testing.assert_allclose(float(getattr(got.robot, f)),
                                       float(getattr(want.robot, f)),
                                       rtol=1e-6)
        np.testing.assert_allclose(got.est.numpy(), np.asarray(want.est),
                                   atol=1e-5, rtol=0)
        gs, ws = got.slam, want.slam
        self.rows.append(np.max(np.abs(gs.poses.numpy()
                                       - np.asarray(ws.poses)), -1) <= 1e-5)
        self.pixels.append(np.abs(gs.logodds.numpy()
                                  - np.asarray(ws.logodds)) <= 1e-5)
        np.testing.assert_allclose(gs.weights.numpy(),
                                   np.asarray(ws.weights), rtol=1e-4)

    def shares(self):
        assert np.mean(self.rows) >= 0.999
        assert np.mean(self.pixels) >= 0.999


@functools.lru_cache(maxsize=None)
def _setup():
    jm, tm = maps()
    cfg = _scfg(jm)
    return jm, tm, cfg, interop.config_from(cfg)


@pytest.mark.parametrize("style", sorted(STYLES))
def test_explore_tick_teacher_forced_matches_jax(style):
    jm, tm, cfg, tcfg = _setup()
    kw, wps, n_wp = STYLES[style]
    slots = _slots(wps)
    step = jax.jit(lambda s, k: jfr._explore_tick(
        s, k, jnp.asarray(slots), jnp.int32(n_wp), jm, cfg,
        jnp.asarray(ANGLES), *TICK_ARGS, **kw))
    st = jfr.init_explore(jax.random.PRNGKey(0), START, cfg)
    keys = jax.random.split(jax.random.PRNGKey(1), TICKS)
    close, wp_seen = _Close(), set()
    for k in range(TICKS):
        (d,) = _draws(keys[k:k + 1], st.slam.key, cfg)
        got, (tp, ep) = tfr._explore_tick(
            _port(st), t(slots), torch.tensor(n_wp, dtype=torch.int32), tm,
            tcfg, ANGLES, *TICK_ARGS, draws=d, **kw)
        st, (jtp, jep) = step(st, keys[k])
        close.states(got, st)
        np.testing.assert_allclose(tp.numpy(), np.asarray(jtp), atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(ep.numpy(), np.asarray(jep), atol=1e-5,
                                   rtol=0)
        wp_seen.add(int(st.wp_idx))
    close.shares()
    # The ticks took the branch each style is there for.
    assert max(wp_seen) == min(n_wp, 1)


@pytest.mark.parametrize("style", sorted(STYLES))
def test_explore_phase_teacher_forced_matches_jax(style, monkeypatch):
    monkeypatch.setattr(compiled, "TICKS_PER_GRAPH", 3)
    jm, tm, cfg, tcfg = _setup()
    kw, wps, n_wp = STYLES[style]
    slots = _slots(wps)
    st = jfr.init_explore(jax.random.PRNGKey(0), START, cfg)
    phase_key = jax.random.PRNGKey(2)
    draws = _draws(jax.random.split(phase_key, TICKS), st.slam.key, cfg)
    got, (tp, ep) = tfr.explore_phase(
        _port(st), slots, n_wp, tm, tcfg, ANGLES, TICKS, slip_noise=0.03,
        draws=draws, **kw)
    want, (jtp, jep) = jax.jit(lambda s, k: jfr.explore_phase(
        s, k, jnp.asarray(slots), jnp.int32(n_wp), jm, cfg,
        jnp.asarray(ANGLES), TICKS, slip_noise=0.03, **kw))(st, phase_key)
    close = _Close()
    close.states(got, want)
    close.shares()
    assert tp.shape == ep.shape == (TICKS, 3)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jtp), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(ep.numpy(), np.asarray(jep), atol=1e-5,
                               rtol=0)


def test_explore_phase_graphs_equal_eager_ticks(monkeypatch):
    """The phase through the graphs (3 ticks each on the CPU's
    TickGraph) equals the same ticks called one by one, bit for bit,
    drawing from the state's generators."""
    monkeypatch.setattr(compiled, "TICKS_PER_GRAPH", 3)
    _, tm, _, tcfg = _setup()
    slots = _slots([[2.0, 1.2], [2.0, 2.0]])
    st = tfr.init_explore(5, START, tcfg, device="cpu")
    got, (tp, _) = tfr.explore_phase(st, slots, 2, tm, tcfg, ANGLES, 7)
    ref = tfr.init_explore(5, START, tcfg, device="cpu")
    poses = []
    for _ in range(7):
        ref, (p, _) = tfr._explore_tick(
            ref, t(slots), torch.tensor(2, dtype=torch.int32), tm, tcfg,
            ANGLES, *TICK_ARGS)
        poses.append(p)
    assert torch.equal(tp, torch.stack(poses))
    assert torch.equal(got.slam.logodds, ref.slam.logodds)
    assert torch.equal(got.gen.get_state(), ref.gen.get_state())
    assert torch.equal(got.slam.gen.get_state(), ref.slam.gen.get_state())


# ----------------------------------------------------------------------
# The host loop on JAX's phases.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("policy,seed,ticks", [("frontier", 3, 40),
                                               ("hybrid", 1, 24)])
def test_run_frontier_slam_teacher_forced_plans_match_jax(policy, seed, ticks,
                                                          monkeypatch):
    """The loop between the phases (coverage, the policy and stall rules,
    the conservative plan then the optimistic one, the draw among the
    nearest frontiers, the 3-waypoint cap, the padded slab) on JAX's
    phases.  JAX's run records each phase's slab, n_wp, and the best map
    and estimate after it; the port's run, handed the host seed that JAX
    draws from its key, reads those maps and estimates in place of its
    own phases and must plan the same slabs and report the same
    coverage.  One of the next four host seeds plans other slabs: the
    draws among the nearest frontiers took part."""
    jm, tm, cfg, tcfg = _setup()
    phases = 5
    rec = []
    phase_jit = jfr._phase_jit

    def recording_jit(*args):
        fn = phase_jit(*args)

        def run(st, k, wps, n_wp, m, ang):
            out = fn(st, k, wps, n_wp, m, ang)
            rec.append(dict(pad=np.asarray(wps), n_wp=int(n_wp),
                            lo=np.asarray(jslam.best_map(out[0].slam)),
                            est=np.asarray(out[0].est)))
            return out
        return run

    monkeypatch.setattr(jfr, "_phase_jit", recording_jit)
    _, want = jfr.run_frontier_slam(seed, jm, cfg, ANGLES, phases=phases,
                                    phase_ticks=ticks, policy=policy)
    k_init = jax.random.split(jax.random.PRNGKey(seed))[0]
    host_seed = int(np.asarray(jax.random.key_data(k_init))[-1])
    maps_read = [np.asarray(jslam.best_map(
        jfr.init_explore(k_init, START, cfg).slam))]
    slabs = []

    def teacher_phase(state, pad, n_wp, m_true, scfg, angles, num_ticks,
                      **kw):
        r = rec[len(slabs)]
        slabs.append((np.asarray(pad).copy(), int(n_wp)))
        maps_read.append(r["lo"])
        poses = torch.zeros(num_ticks, 3)
        return (dataclasses.replace(state, est=torch.tensor(r["est"])),
                (poses, poses))

    def teacher_coverage(state, cell_px):
        lo = maps_read[-1]
        walls, seen = tmapping.fit_walls(lo, cell_px=cell_px,
                                         return_explored=True)
        return lo, walls, seen

    def port_run(host_seed):
        del slabs[:], maps_read[1:]
        _, got = tfr.run_frontier_slam(seed, tm, tcfg, ANGLES, phases=phases,
                                       phase_ticks=ticks, policy=policy,
                                       host_seed=host_seed)
        return got, list(slabs)

    monkeypatch.setattr(tfr, "explore_phase", teacher_phase)
    monkeypatch.setattr(tfr, "_coverage", teacher_coverage)
    got, planned = port_run(host_seed)
    assert len(planned) == len(rec) == phases
    for (pad, n_wp), r in zip(planned, rec):
        assert n_wp == r["n_wp"]
        np.testing.assert_array_equal(pad, r["pad"])
    assert got["coverage"] == want["coverage"]

    def differs(host_seed):
        _, other = port_run(host_seed)
        return any(n_wp != r["n_wp"] or not np.array_equal(pad, r["pad"])
                   for (pad, n_wp), r in zip(other, rec))

    assert any(differs(host_seed + d) for d in range(1, 5))


# ----------------------------------------------------------------------
# The JAX suite's mechanics on the port.
# ----------------------------------------------------------------------

def test_explore_phase_runs_and_slam_carries():
    _, tm, _, tcfg = _setup()
    st = tfr.init_explore(0, START, tcfg, device="cpu")
    wps = np.asarray([[2.0, 1.2], [2.0, 2.0]], np.float32)
    st2, (tp, ep) = tfr.explore_phase(st, wps, 2, tm, tcfg, ANGLES, 40,
                                      slip_noise=0.02)
    assert tp.shape == (40, 3) and ep.shape == (40, 3)
    assert torch.isfinite(tp).all()
    assert float(st2.slam.logodds.abs().max()) > 1.0
    assert np.hypot(float(st2.robot.x) - 1.25,
                    float(st2.robot.y) - 1.25) > 0.1
    assert float(st2.robot.encoder_left) != 0.0


@pytest.mark.parametrize("policy,kw", [
    ("hybrid", {}), ("wander", dict(novelty_bias=1.0)),
    ("wallfollow", dict(wander_style="wallfollow")), ("frontier", {})])
def test_explore_policies_and_styles_run(policy, kw):
    _, tm, _, tcfg = _setup()
    fst, finfo = tfr.run_frontier_slam(
        11, tm, tcfg, ANGLES, phases=3, phase_ticks=40, slip_noise=0.02,
        policy=policy, **kw)
    cov = finfo["coverage"]
    assert len(cov) == 4 and cov[-1] > 0.05, (policy, cov)
    assert torch.isfinite(fst.est).all()
    assert all(b >= a - 1e-9 for a, b in zip(cov, cov[1:])), (policy, cov)
    assert finfo["truth"].shape == finfo["est"].shape == (120, 3)


def test_wallfollow_turns_away_from_followed_wall():
    _, tm, _, _ = _setup()
    tcfg = interop.config_from(_scfg(maps()[0], particles=8))
    st = tfr.init_explore(0, START, tcfg, device="cpu")
    # Facing a wall dead ahead: the avoidance turn starts at once.
    st = dataclasses.replace(st, robot=trobot.make_robot(
        0.35, 1.25, np.pi, batch=None))
    st2, _ = tfr._explore_tick(
        st, torch.zeros(4, 2), torch.tensor(0, dtype=torch.int32), tm, tcfg,
        ANGLES, 0.0, 0.0, 8.0, 5.0, 0.4, 0.25, 0.1,
        wander_style="wallfollow")
    assert int(st2.turn_left) > 0
    assert float(st2.turn_sign) == -1.0


def test_turn_ticks_round_as_float32():
    _, _, cfg, tcfg = _setup()
    omega = 5.0 * (cfg.motion.wheel_size / 2.0) / (cfg.motion.wheel_space
                                                   / 2.0)
    want = int(jnp.int32(jnp.ceil((jnp.pi / 3.0) / (omega * 0.1))))
    assert tfr.turn_ticks(tcfg, 5.0, 0.1) == want == 9
    # A quotient a hair above an integer in float64 that rounds onto it
    # in float32 takes the float32 ceiling.
    speed = (np.pi / 3.0) / (4.0 * 0.1) * (cfg.motion.wheel_space
                                           / cfg.motion.wheel_size) * (
        1.0 - 1e-9)
    omega = speed * (cfg.motion.wheel_size / 2.0) / (
        cfg.motion.wheel_space / 2.0)
    q = (np.pi / 3.0) / (omega * 0.1)
    assert q > 4.0 and np.float32(q) == 4.0
    want = int(jnp.int32(jnp.ceil((jnp.pi / 3.0) / (omega * 0.1))))
    assert tfr.turn_ticks(tcfg, speed, 0.1) == want == 4


# ----------------------------------------------------------------------
# The slam preset and the CLI.
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["frontier", "hybrid"])
def test_run_slam_explorer_returns_the_jax_keys(mode):
    kw = dict(seed=0, num_ticks=120, num_particles=8, relocalize=False,
              explore_mode=mode)
    want = jpresets.run_slam(jpresets.make_world(num_particles=32), **kw)
    got = tpresets.run_slam(tpresets.make_world(num_particles=32,
                                                device="cpu"), **kw)
    assert list(got) == list(want)
    assert "dead_reckon_final_err_m" not in got
    assert got["explore_mode"] == mode and got["ticks"] == 120
    for k, v in got.items():
        if isinstance(v, float):
            assert np.isfinite(v), k


def test_cli_slam_explore_frontier_line(capsys, monkeypatch):
    make = tpresets.make_world
    monkeypatch.setattr(tpresets, "make_world", lambda **kw: make(
        **dict(kw, num_particles=32)))
    tmain.main(["slam", "--explore", "frontier", "--ticks", "120",
                "--particles", "8", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["preset"] == "slam" and line["explore_mode"] == "frontier"
    assert line["particles"] == 8 and line["ticks"] == 120
    assert "dead_reckon_final_err_m" not in line
    assert {"reloc_converged_frac", "track_on_learned_frac",
            "f1_explored"} <= set(line)
