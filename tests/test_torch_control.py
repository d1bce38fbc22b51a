"""The port's controllers (control/controllers.py, control/timed.py) against
the JAX package's, batched: every controller tick runs on E robots at
once ([E] leading dims, scans [E, B]) against jax.vmap of the JAX tick on
the same numpy inputs, to atol 1e-5 on floats and exactly on phases,
flags, counters and integer commands.

- PID: a teacher-forced sequence through all three phases (rotate, drive,
  done), each tick from JAX's state.
- APF: all three APFConfig presets, with scan points inside and outside
  the influence radius, masked beams and near-goal robots; apf_forces and
  repulsive_force on their own.
- global_p_drive, including robots within the stop distance.
- The wanderer: a blocked robot turning to either side (the halves
  rule), a turn counted down, pad lanes, and the disabled state; the APF
  wanderer.
- timed: the tick counts, the rotate and drive commands, the laser abort
  with and without a mask, and the reference's beam-count quirk.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu import config as jconfig
from montecarlolocalisation_tpu.control import controllers as JC
from montecarlolocalisation_tpu.control import timed as JT
from montecarlolocalisation_tpu.sim import robot as jrobot
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.config import MotionModelConfig
from montecarlolocalisation_tpu_torch.control import controllers as TC
from montecarlolocalisation_tpu_torch.control import timed as TT

torch.set_num_threads(1)

E, B = 16, 24
ATOL = 1e-5
MCFG = jconfig.MotionModelConfig()


def port(j, module=TC):
    """The port's object of a JAX controller state (same class and field
    names), every array a tensor."""
    if dataclasses.is_dataclass(j):
        cls = getattr(module, type(j).__name__)
        return cls(**{f.name: port(getattr(j, f.name), module)
                      for f in dataclasses.fields(cls)})
    return torch.as_tensor(np.array(j))


def assert_close(got, want, path="out"):
    """Tensors against JAX arrays: floats within ATOL, the rest equal."""
    if dataclasses.is_dataclass(want):
        for f in dataclasses.fields(want):
            assert_close(getattr(got, f.name), getattr(want, f.name),
                         f"{path}.{f.name}")
    elif isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (tuple, list)):
        for i, (g, w) in enumerate(zip(got, want)):
            assert_close(g, w, f"{path}[{i}]")
    else:
        w = np.asarray(want)
        g = np.asarray(got)
        assert g.shape == w.shape, (path, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            np.testing.assert_allclose(g, w, rtol=0, atol=ATOL,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(g, w, err_msg=path)


def t(a):
    return torch.as_tensor(np.array(a))


def test_clamp_wheels():
    rng = np.random.default_rng(0)
    left, right = (rng.uniform(-300, 300, E).astype(np.float32)
                   for _ in range(2))
    want = JC.clamp_wheels(jnp.asarray(left), jnp.asarray(right), 100.0)
    assert_close(TC.clamp_wheels(t(left), t(right), 100.0), want)


@pytest.mark.parametrize("wrap", [False, True])
def test_integrate(wrap):
    rng = np.random.default_rng(1)
    f = np.float32
    odom = JC.LocalOdom(*(jnp.asarray(rng.uniform(-3, 3, E).astype(f))
                          for _ in range(5)))
    el, er = (rng.uniform(-3, 3, E).astype(f) for _ in range(2))
    want = jax.vmap(lambda o, a, b: JC._integrate(o, a, b, wrap_theta=wrap))(
        odom, jnp.asarray(el), jnp.asarray(er))
    assert_close(TC._integrate(port(odom), t(el), t(er), wrap_theta=wrap),
                 want)


def _jrobots(n):
    return jax.vmap(lambda x: jrobot.make_robot(x, 0.0, 0.0))(jnp.zeros(n))


def test_pid_sequence_through_all_phases():
    # Targets ahead, aside, behind and near: every robot rotates, drives
    # and finishes within the run; each tick starts from JAX's state.
    rng = np.random.default_rng(2)
    ang = rng.uniform(-np.pi, np.pi, E)
    dist = rng.uniform(0.1, 0.8, E)
    tx, ty = (dist * np.cos(ang)).astype(np.float32), (
        dist * np.sin(ang)).astype(np.float32)
    rb = _jrobots(E)
    st = jax.vmap(lambda x, y, l, r: JC.pid_start(x, y, 6.0, l, r))(
        jnp.asarray(tx), jnp.asarray(ty), rb.encoder_left, rb.encoder_right)
    tick = jax.jit(jax.vmap(JC.pid_tick))
    dyn = jax.jit(jax.vmap(lambda r, wl, wr: jrobot.step_dynamics(
        r, *jrobot.wheel_arcs_from_speeds(wl, wr, 0.1, MCFG), MCFG)))
    tst = TC.pid_start(t(tx), t(ty), 6.0, t(rb.encoder_left),
                       t(rb.encoder_right))
    assert_close(tst, st)
    phases = set()
    for _ in range(300):
        want = tick(st, rb.encoder_left, rb.encoder_right)
        got = TC.pid_tick(port(st), t(rb.encoder_left), t(rb.encoder_right))
        assert_close(got, want)
        st, (wl, wr), done = want
        phases |= set(np.asarray(st.phase).tolist())
        rb = dyn(rb, wl, wr)
        if bool(jnp.all(done)):
            break
    assert phases == {JC.PID_ROTATE, JC.PID_DRIVE, JC.PID_DONE}
    assert bool(jnp.all(done))


def _scan_points(rng, radius):
    """[E, B] points around the robot, from the LIDAR's 0.15 m up to
    three influence radii, and a mask with dead beams."""
    r = rng.uniform(0.15, 3 * radius, (E, B)).astype(np.float32)
    a = rng.uniform(-np.pi, np.pi, (E, B)).astype(np.float32)
    mask = rng.uniform(size=(E, B)) > 0.2
    return r * np.cos(a), r * np.sin(a), mask


@pytest.mark.parametrize("preset", ["avf", "potential_field", "global_apf"])
def test_apf_tick_and_forces(preset):
    jcfg = getattr(jconfig.APFConfig, preset)()
    tcfg = interop.config_from(jcfg)
    rng = np.random.default_rng(3)
    px, py, mask = _scan_points(rng, jcfg.influence_radius)
    f = np.float32
    # Half the robots near their goal (near-goal scheduling, the exit).
    tx = np.where(np.arange(E) % 2, rng.uniform(-1, 1, E),
                  rng.uniform(-0.1, 0.1, E)).astype(f)
    ty = rng.uniform(-0.1, 0.1, E).astype(f)
    odom = JC.LocalOdom(*(jnp.asarray(v.astype(f)) for v in (
        rng.uniform(-0.05, 0.05, E), rng.uniform(-0.05, 0.05, E),
        rng.uniform(-3, 3, E), rng.uniform(-1, 1, E),
        rng.uniform(-1, 1, E))))
    st = JC.APFState(odom=odom, target_x=jnp.asarray(tx),
                     target_y=jnp.asarray(ty),
                     base_speed=jnp.full(E, 6.0, jnp.float32),
                     done=jnp.asarray(np.arange(E) % 5 == 0))
    el, er = (rng.uniform(-1, 1, E).astype(f) for _ in range(2))
    jp = [jnp.asarray(v) for v in (px, py, mask)]
    tp = [t(v) for v in (px, py, mask)]
    want = jax.vmap(lambda s, a, b, x, y, k: JC.apf_tick(
        s, a, b, x, y, k, jcfg))(st, jnp.asarray(el), jnp.asarray(er), *jp)
    got = TC.apf_tick(port(st), t(el), t(er), *tp, tcfg)
    assert_close(got, want)
    assert 0 < int(np.asarray(want[2]).sum()) < E
    forces = jax.vmap(lambda a, b, c, d, x, y, k: JC.apf_forces(
        a, b, c, d, x, y, k, jcfg))(jnp.asarray(tx), jnp.asarray(ty),
                                    odom.x, odom.y, *jp)
    assert_close(TC.apf_forces(t(tx), t(ty), t(odom.x), t(odom.y), *tp,
                               tcfg), forces)
    rep = JC.repulsive_force(*jp, 0.3, 0.05, jcfg)
    assert_close(TC.repulsive_force(*tp, 0.3, 0.05, tcfg), rep)
    assert float(jnp.abs(rep[0]).max()) > 0


def test_global_p_drive():
    rng = np.random.default_rng(4)
    f = np.float32
    pose = np.stack([rng.uniform(0, 4, E), rng.uniform(0, 4, E),
                     rng.uniform(-np.pi, np.pi, E)], -1).astype(f)
    target = pose[:, :2] + rng.uniform(-1, 1, (E, 2)).astype(f)
    target[::4] = pose[::4, :2] + 0.05      # within the stop distance
    want = jax.vmap(lambda p, g: JC.global_p_drive(p, g, 10.0))(
        jnp.asarray(pose), jnp.asarray(target))
    assert_close(TC.global_p_drive(t(pose), t(target), 10.0), want)
    assert 0 < int(np.asarray(want[2]).sum()) < E


@pytest.mark.parametrize("case", ["blocked", "turning", "disabled",
                                  "pad_lanes"])
def test_wanderer_tick(case):
    rng = np.random.default_rng(5)
    ranges = rng.uniform(0.3, 3.0, (E, B)).astype(np.float32)
    mask = np.ones((E, B), bool)
    enabled = np.ones(E, bool)
    left_free = np.arange(E) % 2 == 0
    ticks = np.zeros(E, np.int32)
    if case in ("blocked", "disabled", "pad_lanes"):
        # A wall in front of every robot; the free side decides the turn.
        ranges[left_free, :B // 2] += 2.0
        ranges[~left_free, B // 2:] += 2.0
        ranges[:, B // 2 - 1] = 0.1
    if case == "turning":
        ticks = rng.integers(0, 9, E).astype(np.int32)
        ranges[::3, 2] = 0.15
    if case == "disabled":
        enabled[::2] = False
    if case == "pad_lanes":
        # Beams past each robot's scan are pads (mask False) with a huge
        # range that must not count in the halves.
        mask[:, B - 4:] = False
        ranges[:, B - 4:] = 50.0
    st = JC.WandererState(turn_ticks_left=jnp.asarray(ticks),
                          turn_dir=jnp.asarray(
                              rng.choice([-1, 1], E).astype(np.int32)))
    want = jax.vmap(lambda s, r, k, e: JC.wanderer_tick(s, r, k, e))(
        st, jnp.asarray(ranges), jnp.asarray(mask), jnp.asarray(enabled))
    got = TC.wanderer_tick(port(st), t(ranges), t(mask), t(enabled))
    assert_close(got, want)
    if case == "blocked":
        assert set(np.asarray(want[0].turn_dir).tolist()) == {-1, 1}
        assert (np.asarray(want[0].turn_ticks_left) > 0).all()
    assert_close(TC.wanderer_init((E,)), jax.vmap(
        lambda _: JC.wanderer_init())(jnp.zeros(E)))


def test_avf_wanderer_tick():
    jcfg = jconfig.AVFWandererConfig()
    rng = np.random.default_rng(6)
    px, py, mask = _scan_points(rng, jcfg.influence_radius)
    want = jax.vmap(JC.avf_wanderer_tick)(
        jnp.asarray(px), jnp.asarray(py), jnp.asarray(mask))
    assert_close(TC.avf_wanderer_tick(t(px), t(py), t(mask),
                                      interop.config_from(jcfg)), want)


def test_timed_tick_counts_and_commands():
    tm = MotionModelConfig()
    for args in [(np.pi / 3, 5.0), (-np.pi / 2, 5.0), (0.0, 5.0),
                 (1.0, 0.0)]:
        assert TT.rotate_ticks(*args, cfg=tm) == JT.rotate_ticks(*args)
        assert TT.drive_ticks(*args, cfg=tm) == JT.drive_ticks(*args)
    for fn in ("start_rotate", "start_drive"):
        for value, speed in [(0.7, 5.0), (-0.7, 5.0), (0.4, -5.0)]:
            assert_close(getattr(TT, fn)(value, speed, 0.1, tm),
                         getattr(JT, fn)(value, speed, 0.1))


@pytest.mark.parametrize("mode", ["no_scan", "abort", "masked",
                                  "count_bug"])
def test_timed_tick(mode):
    rng = np.random.default_rng(7)
    starts = [JT.start_drive(d, s) for d, s in zip(
        rng.uniform(0.1, 1.0, E), rng.choice([-5.0, 5.0], E))]
    st = jax.tree_util.tree_map(lambda *v: jnp.stack(v), *starts)
    st = dataclasses.replace(st, aborted=jnp.asarray(np.arange(E) % 7 == 0))
    ranges = rng.uniform(0.3, 3.0, (E, B)).astype(np.float32)
    ranges[::3, 5] = 0.1                     # an obstacle in range
    mask = rng.uniform(size=(E, B)) > 0.3
    scan = dict(no_scan=(None, None), abort=(ranges, None),
                masked=(ranges, mask), count_bug=(ranges, None))[mode]
    bug = mode == "count_bug"
    jscan = [None if v is None else jnp.asarray(v) for v in scan]
    tscan = [None if v is None else t(v) for v in scan]
    for _ in range(3):
        want = jax.vmap(lambda s, r, k: JT.timed_tick(
            s, r, k, count_bug_compat=bug))(st, *jscan) if scan[0] is not \
            None else jax.vmap(JT.timed_tick)(st)
        got = TT.timed_tick(port(st, TT), *tscan, count_bug_compat=bug)
        assert_close(got, want)
        assert_close(TT.is_done(got[0]), JT.is_done(want[0]))
        st = want[0]
    if mode in ("abort", "masked"):
        assert np.asarray(st.aborted).sum() > np.asarray(
            np.arange(E) % 7 == 0).sum()
