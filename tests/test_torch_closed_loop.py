"""sim/closed_loop against the JAX package's, on the draws JAX made.

JAX's key tree: run_closed_loop splits its key into k_init and k_run and
k_run into one key a tick (closed_loop.py:129-140); simulate_scan draws
the scan noise from the first of four splits of the tick key
(sensor.py:464-467); the filter draws from the state key
(torch_parity.jax_tick_draws).  The port's closed_loop_step takes those
draws as (ScanDraws, TickDraws).

- Teacher-forced: 30 ticks, each one closed_loop_step from JAX's state
  with JAX's draws, for one robot from a global cloud, a batch of 3
  tracking from a known start, and one robot sensing another map than it
  localizes on (sense_m): robot pose within 1e-5, wheel commands within
  1e-4, wp_idx and wanderer_on exact, the filter state at the tick
  tolerance (>= 99.9 % of particle rows within 1e-5, confidence and
  best pose within 1e-3).
- A whole rollout, 3 episodes x 64 particles x 16 beams x 30 ticks, from
  JAX's initial states with JAX's draws, against jax.vmap of
  run_closed_loop: the true pose within 1e-4 and wp_idx equal at every
  tick until the filters' published poses part by more than the tick
  tolerance (the test says why they may), at >= 90 % of the
  episode-ticks.
- A batch equals its episodes run one by one, bit for bit.
- rollout's graphs (models/compiled on the CPU, K = 3 and 8 ticks a
  graph) equal closed_loop_step called tick by tick, bit for bit: states,
  outputs and both generators.
- mission_waypoints equals JAX's.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig as JFilterConfig, SensorModelConfig as JSensorModelConfig,
)
from montecarlolocalisation_tpu.control import controllers as JC
from montecarlolocalisation_tpu.maps import generator as jgen
from montecarlolocalisation_tpu.maps import maze as jmaze
from montecarlolocalisation_tpu.maps.grid import from_walls as jfrom_walls
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.planning import bfs as jbfs
from montecarlolocalisation_tpu.sim import closed_loop as jcl
from montecarlolocalisation_tpu.sim import robot as jrobot
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.control import controllers as TC
from montecarlolocalisation_tpu_torch.models import compiled, sensor
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.sim import closed_loop as tcl
from montecarlolocalisation_tpu_torch.sim import robot as trobot

from torch_parity import MAP_PATH, jax_tick_draws, maps, stack, t

torch.set_num_threads(1)

N, BEAMS, T, E = 64, 16, 30, 3
ANGLES = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
JCFG = JFilterConfig(num_particles=N,
                     sensor=JSensorModelConfig(ray_mode="fixed"))
TCFG = interop.config_from(JCFG)
START = (2.0, 2.0, 0.0)
WPS = np.array([[2.8, 2.0], [2.8, 2.8], [2.0, 2.8]], np.float32)


@pytest.fixture(scope="module")
def world():
    return maps()


def jax_init(key, jm, start, known_start):
    """JAX's initial ClosedLoopState and tick keys [T, 2], as
    run_closed_loop makes them."""
    k_init, k_run = jax.random.split(key)
    filt = (jfilter.init_tracking_state(k_init, jm, JCFG, start)
            if known_start else jfilter.init_state(k_init, jm, JCFG))
    st = jcl.ClosedLoopState(robot=jrobot.make_robot(*start), filt=filt,
                             wanderer=JC.wanderer_init(),
                             wanderer_on=jnp.bool_(not known_start),
                             wp_idx=jnp.int32(0))
    return st, jax.random.split(k_run, T)


def scan_noise(tick_key):
    """simulate_scan's range normals from a tick key."""
    return jax.random.normal(jax.random.split(tick_key, 4)[0], (BEAMS,))


def port_state(j) -> tcl.ClosedLoopState:
    """The port's ClosedLoopState of a JAX one (a fresh simulator
    generator: the tests inject every draw)."""
    r = j.robot
    return tcl.ClosedLoopState(
        robot=trobot.RobotState(x=t(r.x), y=t(r.y), theta=t(r.theta),
                                encoder_left=t(r.encoder_left),
                                encoder_right=t(r.encoder_right)),
        filt=interop.state_from_numpy(j.filt),
        wanderer=TC.WandererState(
            turn_ticks_left=t(j.wanderer.turn_ticks_left, torch.int32),
            turn_dir=t(j.wanderer.turn_dir, torch.int32)),
        wanderer_on=t(j.wanderer_on, torch.bool),
        wp_idx=t(j.wp_idx, torch.int32), gen=torch.Generator())


def tick_draws(jst, tick_keys, jm, batched):
    """The port's draws for one closed_loop_step of JAX's state `jst`."""
    if not batched:
        return (sensor.ScanDraws(noise=t(scan_noise(tick_keys))),
                jax_tick_draws(jst.filt.key, jm, N, JCFG))
    return (sensor.ScanDraws(noise=t(jax.vmap(scan_noise)(tick_keys))),
            stack([jax_tick_draws(k, jm, N, JCFG) for k in jst.filt.key]))


def close(got, want, atol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=atol)


def assert_filter_close(got, want):
    rows = np.abs(got.particles.numpy()
                  - np.asarray(want.particles)).max(-1) <= 1e-5
    assert rows.mean() >= 0.999, rows.mean()
    close(got.confidence, want.confidence, 1e-3)
    close(got.best_pose, want.best_pose, 1e-3)
    np.testing.assert_array_equal(got.was_lost.numpy(),
                                  np.asarray(want.was_lost))


CASES = {"one_robot_global": dict(batched=False, known_start=False),
         "batch_known_start": dict(batched=True, known_start=True),
         "one_robot_sense_map": dict(batched=False, known_start=True,
                                     sense=True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_teacher_forced_ticks_match_jax(world, case):
    jm, tm = world
    c = CASES[case]
    jsense = tsense = None
    if c.get("sense"):
        # The robot drives on the default maze and senses a generated one.
        walls = jgen.generate_maze(6, 6, seed=3)
        jsense = jfrom_walls(walls)
        tsense = interop.maze_from_numpy(jsense)
    init = functools.partial(jax_init, jm=jm, start=START,
                             known_start=c["known_start"])
    step = functools.partial(jcl.closed_loop_step, waypoints=jnp.asarray(WPS),
                             m=jm, cfg=JCFG, scan_angles=ANGLES,
                             sense_m=jsense)
    if c["batched"]:
        jst, keys = jax.vmap(init)(jax.random.split(jax.random.PRNGKey(7),
                                                    E))
        jstep = jax.jit(jax.vmap(lambda s, k: step(s, k)))
    else:
        jst, keys = init(jax.random.PRNGKey(5))
        jstep = jax.jit(lambda s, k: step(s, k))
    seen_wp, seen_wander = set(), set()
    for tick in range(T):
        k = keys[:, tick] if c["batched"] else keys[tick]
        want_st, want = jstep(jst, k)
        got_st, got = tcl.closed_loop_step(
            port_state(jst), torch.as_tensor(WPS), tm, TCFG, ANGLES,
            sense_m=tsense, draws=tick_draws(jst, k, jm, c["batched"]))
        for name in ("x", "y", "theta"):
            close(getattr(got_st.robot, name), getattr(want_st.robot, name),
                  1e-5)
        close(got.true_pose, want.true_pose, 1e-5)
        close(got.wheel_cmd, want.wheel_cmd, 1e-4)
        close(got.est_pose, want.est_pose, 0.0)
        for name in ("wp_idx", "wanderer_on"):
            np.testing.assert_array_equal(
                getattr(got_st, name).numpy(), np.asarray(getattr(want_st,
                                                                  name)))
        np.testing.assert_array_equal(got.wp_idx.numpy(),
                                      np.asarray(want.wp_idx))
        assert got_st.robot.x.shape == np.asarray(want_st.robot.x).shape
        assert_filter_close(got_st.filt, want_st.filt)
        for name in ("turn_ticks_left", "turn_dir"):
            np.testing.assert_array_equal(
                getattr(got_st.wanderer, name).numpy(),
                np.asarray(getattr(want_st.wanderer, name)))
        seen_wp |= set(np.asarray(want_st.wp_idx).ravel().tolist())
        seen_wander |= set(np.asarray(want_st.wanderer_on).ravel().tolist())
        jst = want_st
    if c["batched"]:
        assert len(seen_wp) > 1, seen_wp            # waypoints reached
    elif not c["known_start"]:
        assert True in seen_wander                  # the wanderer drove


def test_rollout_matches_jax(world):
    jm, tm = world
    keys = jax.random.split(jax.random.PRNGKey(11), E)
    jst, tick_keys = jax.vmap(functools.partial(
        jax_init, jm=jm, start=START, known_start=True))(keys)
    _, want = jax.jit(jax.vmap(lambda k: jcl.run_closed_loop(
        k, jm, JCFG, WPS, T, ANGLES, start_pose=START,
        known_start=True)))(keys)
    noise = jax.vmap(jax.vmap(scan_noise))(tick_keys)
    fkeys = list(jst.filt.key)
    draws = []
    for tick in range(T):
        draws.append((sensor.ScanDraws(noise=t(noise[:, tick])),
                      stack([jax_tick_draws(k, jm, N, JCFG)
                             for k in fkeys])))
        fkeys = [jax.random.split(k, 4)[0] for k in fkeys]
    final, got = tcl.rollout(port_state(jst), WPS, tm, TCFG, T, ANGLES,
                             draws=draws)
    assert got.true_pose.shape == (E, T, 3)
    # Each tick alone holds the tick tolerance (the teacher-forced test),
    # but over a rollout the two packages' float32 states part by an ulp
    # a tick, and a 64-particle filter can turn a discrete choice (a
    # resampling pick, a k-means assignment) on such a difference: its
    # published pose then parts by more than the tick tolerance, 1e-3,
    # and the robots it steers part after it.  The true pose is held to
    # 1e-4 at every tick up to and including the first tick at which the
    # estimates part, and the waypoints reached alike.
    est_gap = np.abs(got.est_pose.numpy()
                     - np.asarray(want.est_pose)).max(-1)
    pose_gap = np.abs(got.true_pose.numpy()
                      - np.asarray(want.true_pose)).max(-1)
    wp_equal = got.wp_idx.numpy() == np.asarray(want.wp_idx)
    held = 0
    for e in range(E):
        parted = np.flatnonzero(est_gap[e] > 1e-3)
        upto = parted[0] + 1 if parted.size else T
        assert pose_gap[e, :upto].max() <= 1e-4, (e, pose_gap[e])
        assert wp_equal[e, :upto].all(), e
        held += upto
    # 87 of the 90 episode-ticks at this seed: one episode's estimates
    # part at tick 27 of 30.
    assert held >= 0.9 * E * T, held
    assert int(got.wp_idx[:, -1].max()) >= 1


def _draws(gen, batch, num_ticks, m):
    """Random closed-loop draws from a torch generator, one pair a tick."""
    return [(sensor.draw_scan(gen, batch + (BEAMS,), m.device),
             tfilter.draw_tick(gen, m, N, TCFG, batch))
            for _ in range(num_ticks)]


def test_batch_equals_episodes_one_by_one(world):
    _, tm = world
    gen = torch.Generator()
    gen.manual_seed(3)
    draws = _draws(gen, (E,), 20, tm)
    state = tcl.init_closed_loop(tm, TCFG, START, seed=4, batch=E)
    final, outs = tcl.rollout(state, WPS, tm, TCFG, 20, ANGLES, draws=draws)
    for e in range(E):
        one = compiled.tree_map(lambda v: v if isinstance(v, torch.Generator)
                                else v[e], state)
        d = [compiled.tree_map(lambda v: v[e], pair) for pair in draws]
        f1, o1 = tcl.rollout(one, WPS, tm, TCFG, 20, ANGLES, draws=d)
        for name in ("true_pose", "est_pose", "confidence", "wp_idx",
                     "wheel_cmd"):
            assert torch.equal(getattr(outs, name)[e], getattr(o1, name)), \
                (e, name)
        assert torch.equal(final.filt.particles[e], f1.filt.particles)
        assert torch.equal(final.robot.pose[e], f1.robot.pose)


def _same_gens(state):
    def copy(g):
        h = torch.Generator()
        h.set_state(g.get_state())
        return h

    return dataclasses.replace(
        state, gen=copy(state.gen),
        filt=dataclasses.replace(state.filt, gen=copy(state.filt.gen)))


@pytest.mark.parametrize("k", [3, 8])
@pytest.mark.parametrize("batch", [None, E])
def test_graphs_equal_eager_ticks(world, monkeypatch, k, batch):
    _, tm = world
    monkeypatch.setattr(compiled, "TICKS_PER_GRAPH", k)
    compiled.graphs.clear()
    state = tcl.init_closed_loop(tm, TCFG, START, seed=9, batch=batch)
    ticks = 20
    eager = _same_gens(state)
    outs = []
    wps = torch.as_tensor(WPS)
    for _ in range(ticks):
        eager, o = tcl.closed_loop_step(eager, wps, tm, TCFG, ANGLES)
        outs.append(o)
    lead = len(state.batch)
    want = tcl.ClosedLoopOutput(**{
        f.name: torch.stack([getattr(o, f.name) for o in outs], dim=lead)
        for f in dataclasses.fields(tcl.ClosedLoopOutput)})
    graphed = _same_gens(state)
    final, got = tcl.rollout(graphed, WPS, tm, TCFG, ticks, ANGLES)
    assert compiled.graphs.builds >= 2     # the chunk and the remainder
    for f in dataclasses.fields(tcl.ClosedLoopOutput):
        assert torch.equal(getattr(got, f.name), getattr(want, f.name)), \
            f.name
    flat_got = compiled.leaves(final)
    flat_want = compiled.leaves(eager)
    for a, b in zip(flat_got, flat_want):
        if isinstance(a, torch.Generator):
            # Both generators advanced exactly as the eager ticks'.
            assert torch.equal(a.get_state(), b.get_state())
        else:
            assert torch.equal(a, b)
    # The caller's generators are the ones advanced.
    assert final.gen is graphed.gen and final.filt.gen is graphed.filt.gen
    assert final.robot.x.shape == (() if batch is None else (batch,))


def test_init_closed_loop(world):
    _, tm = world
    st = tcl.init_closed_loop(tm, TCFG, START, known_start=True, seed=1)
    assert st.batch == () and st.robot.x.shape == ()
    assert not bool(st.wanderer_on) and float(st.filt.confidence) == 1.0
    st = tcl.init_closed_loop(tm, TCFG, START, seed=1, batch=E)
    assert st.batch == (E,) and bool(st.wanderer_on.all())
    assert st.wp_idx.dtype == torch.int32
    assert st.filt.particles.shape == (E, N, 3)


def test_mission_waypoints_from_plan():
    walls = jmaze.walls_to_tensor(jmaze.load_map_file(MAP_PATH))
    path = jbfs.bfs_path(walls, (0, 0), (2, 2))
    got = tcl.mission_waypoints(path)
    want = jcl.mission_waypoints(path)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got[0], [0.4, 0.4], atol=1e-6)
