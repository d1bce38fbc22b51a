"""The closed loop on the CPU at a tiny size: the closed-loop reference,
its check units and the `closed_loop` driver, in a cell added by files
alone ("closedloop-tiny": 4 episodes x 64 particles x 24 beams, 48 ticks
a pass in segments of 8, the plan from cell (2, 2) to (4, 4), every
segment of the first pass checked).

- The port's closed_loop_step and rollout agree with the reference: the
  particles, the true poses, the wheel commands, the waypoint indices,
  the wanderer and both random streams, bit for bit.
- The reference's plan is the port's BFS; its filter's wanderer commands
  are the port's.
- The cell runs correct and prints the contract's line, traced and
  untraced; the bfloat16 control, four faults planted in the loop (the
  scan noise's sigma 1 % off, the P-drive's gain 1 % off, the diff
  drive's wheel spacing 1 % off, the arrival test on the true pose) and
  the filter's three (test_bench_checks) come out not correct.
- World takes exactly the closed-loop settings the reference implements.
- The reference loads neither JAX, nor the JAX package, nor the port.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import itertools
import json
import os
import subprocess
import sys

import pytest
import torch

from mclbench import compare, control, generator, harness
from mclbench.drivers import closed_loop as cl_driver
from mclbench.reference import closed_loop as ref_cl
from mclbench.reference import filter as ref
from mclbench.reference import maze
from mclbench.world import (CLOSED_LOOP_FIELDS, SUPPORTED_CLOSED_LOOP,
                            WANDERER_FIELDS, World)

from . import test_bench_checks, tiny

CELL = "closedloop-tiny"
SEED = 2**31 + 99
# The closed-loop settings of the planning preset (sim/closed_loop's
# defaults, WandererConfig's fields).
CLOSED_LOOP = dict(base_speed=10.0, arrival_tol=0.2, scan_noise=0.02,
                   known_start=False,
                   wanderer=dict(threshold=0.2, forward_speed=8.0,
                                 turn_speed=5.0, turn_angle=3.14 / 3,
                                 wheel_space=0.265, wheel_size=0.062))
LIMITS = dict(rows_off=0.01, pose_gap=0.5, conf_gap=0.15, truth_gap=1e-4,
              cmd_gap=1e-3, wp_off=0.001)
# Per-layer metrics a later cell would add as files: the traced ticks and
# the reading's K1 and K3 bounds.
METRICS = {
    "cl_ticks_traced": "def read(r):\n    return float(r.ticks)\n",
    "k1_bound_ms": "def read(r):\n"
                   "    return r.bounds.get('k1_ms_per_tick')\n",
    "k3_bound_ms": "def read(r):\n"
                   "    return r.bounds.get('k3_ms_per_tick')\n",
}


def cl_config(particles: int = 64, **closed_loop):
    """The reference robot's filter (ref-1500x34's) with `particles`
    particles and 24 beams, driving its robot."""
    with open(os.path.join(tiny.BENCH, "configs", "ref-1500x34.json")) as f:
        cfg = json.load(f)
    cfg["name"] = CELL
    cfg["filter"]["num_particles"] = particles
    cfg["beams"]["count"] = 24
    cfg["closed_loop"] = json.loads(json.dumps(CLOSED_LOOP))
    cfg["closed_loop"].update(closed_loop)
    return cfg


def cl_traffic(episodes=4, ticks=48, segment_ticks=8, check_segments=5):
    return dict(driver="closed_loop", why="x", episodes=episodes,
                ticks=ticks, segment_ticks=segment_ticks,
                check_segments=check_segments,
                plan=dict(start_cell=[2, 2], goal_cell=[4, 4]),
                limits=dict(LIMITS))


def add_cl_cell(root: str, config: dict, traffic: dict) -> str:
    """The closed-loop cell added to the checkout at `root` by files and
    entries alone: its configuration, its mix, three metric readers, and
    their BENCHMARK.json entries."""
    bench = os.path.join(root, "mclbench")
    for path, obj in ((("configs", CELL), config),
                      (("traffic", CELL), traffic)):
        with open(os.path.join(bench, *path) + ".json", "w") as f:
            json.dump(obj, f)
    for name, src in METRICS.items():
        with open(os.path.join(bench, "metrics", name + ".py"), "w") as f:
            f.write(src)
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append(dict(name=CELL, source="x",
                               file=f"mclbench/configs/{CELL}.json",
                               reduced=["num_particles"], why="x"))
    man["workloads"].append(dict(name=CELL, config=CELL, traffic=CELL,
                                 chips=1, why="x"))
    for m in man["end_to_end"]:
        if "replay1024-ref" in m.get("workloads", []):
            m["workloads"].append(CELL)
    for name in METRICS:
        man["per_layer"].append(dict(
            name=name, unit="ms", better="lower", source="device_trace",
            layer="compiled tick: models/compiled, models/filter",
            moves="updates_per_s", workloads=[CELL]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return add_cl_cell(tiny.make_root(str(tmp_path_factory.mktemp(
        "bench"))), cl_config(), cl_traffic())


def _plan(world):
    with open(world.map_path) as f:
        cells = maze.parse(f.read())
    start, wps = ref_cl.waypoints(ref_cl.plan(cells, (2, 2), (4, 4)),
                                  world.mz.cell_meters)
    return start, wps.to(world.device)


def _port_kw(world):
    from mclbench.program import ClosedLoopProgram

    return ClosedLoopProgram(world, 1, None, None).kw


def test_closed_loop_step_agrees_with_the_reference():
    """One tick at a time from the same seed: every field of the state,
    every output and both generators, bit for bit."""
    from mclbench.program import PortWorld
    from montecarlolocalisation_tpu_torch.sim import closed_loop

    world = World(tiny.ROOT, cl_config(), "cpu")
    pw = PortWorld(world)
    start, wps = _plan(world)
    kw = _port_kw(world)
    e = 6
    st = closed_loop.init_closed_loop(pw.m, pw.cfg, start, False, SEED,
                                      batch=e)
    rs, sim_gen, filt_gen = ref_cl.init(world.mz, world.filter, SEED, e,
                                        start)
    seen = dict(turning=0, wanderer_off=0, arrived=0)
    for t in range(60):
        st, o = closed_loop.closed_loop_step(st, wps, pw.m, pw.cfg,
                                             world.angles, **kw)
        rs, (ro,) = ref_cl.run(rs, sim_gen, filt_gen, wps, 1, world.angles,
                               world.mz, world.filter, world.closed_loop)
        for f in ("true_pose", "est_pose", "confidence", "wp_idx",
                  "wheel_cmd"):
            assert torch.equal(getattr(o, f), getattr(ro, f)), (t, f)
        got = ref_cl.from_program(st)
        for f in ("robot", "turn_ticks_left", "turn_dir", "wanderer_on",
                  "wp_idx"):
            assert torch.equal(getattr(got, f), getattr(rs, f)), (t, f)
        for f in dataclasses.fields(ref.State):
            assert torch.equal(getattr(got.filt, f.name),
                               getattr(rs.filt, f.name)), (t, f.name)
        assert torch.equal(st.gen.get_state(), sim_gen.get_state())
        assert torch.equal(st.filt.gen.get_state(), filt_gen.get_state())
        seen["turning"] += int((rs.turn_ticks_left > 0).sum())
        seen["wanderer_off"] += int((~rs.wanderer_on).sum())
        seen["arrived"] = max(seen["arrived"], int(rs.wp_idx.max()))
    # The stretch takes the wanderer's turns, the P-drive and arrivals.
    assert all(v > 0 for v in seen.values()), seen


def _units(world, seed, program=None, episodes=4, ticks=32, seg=8):
    """Every segment of a pass of `ticks` ticks from the seed `seed`, each
    a compare.ClosedLoopUnit, kept as the driver keeps them; `program` (a
    ClosedLoopProgram's class) replaces the port's entry."""
    from mclbench.program import ClosedLoopProgram

    start, wps = _plan(world)
    prog = (program or ClosedLoopProgram)(world, episodes, wps, start)
    st, units = None, []
    for _ in range(0, ticks, seg):
        before = None if st is None else prog.snapshot(st)
        st, outs = prog.segment(st, seed, seg)
        units.append(cl_driver._unit(dict(
            before=before, seed=seed, n=seg, answers=prog.answers(outs),
            after=prog.snapshot(st)), start, wps))
    return units


@pytest.mark.parametrize("seed", [SEED, 7, 123456789])
def test_rollout_agrees_with_the_reference(seed):
    world = World(tiny.ROOT, cl_config(), "cpu")
    n = compare.check(world, _units(world, seed))
    assert n["units"] == 4 and n["rows"] == 4 * 4 * 64, n
    for k in ("rows_off", "pose_gap", "conf_gap", "weights_gap",
              "truth_gap", "cmd_gap", "wp_off", "sim_gen_off", "gen_off"):
        assert n[k] == 0, (k, n)


def test_the_plan_is_the_ports_bfs():
    """Every pair of cells of the benchmark's maze, and of a maze with a
    short row, plans as planning/bfs.bfs_path does."""
    from montecarlolocalisation_tpu_torch.maps.maze import walls_to_tensor
    from montecarlolocalisation_tpu_torch.planning import bfs

    with open(os.path.join(tiny.BENCH, "data", "default_map.txt")) as f:
        text = f.read()
    ragged = "[[[T, L], [T, R]], [[L, B], [B]], [[L, R, B]]]"
    for t in (text, ragged):
        cells = maze.parse(t)
        walls = walls_to_tensor(cells)
        lattice = list(itertools.product(range(walls.shape[0]),
                                         range(walls.shape[1])))
        for a, b in itertools.product(lattice, repeat=2):
            assert ref_cl.plan(cells, a, b) == bfs.bfs_path(walls, a, b), \
                (a, b)
    assert ref_cl.plan(maze.parse(text), (2, 2), (4, 4)) == [
        (2, 2), (2, 3), (3, 3), (4, 3), (4, 4)]


def test_the_filters_wanderer_commands_are_the_ports():
    """The reference filter's wanderer command, tick by tick on wander
    logs, is the port's mcl_step's, and the stretch gives all three."""
    from mclbench.program import PortWorld
    from montecarlolocalisation_tpu_torch.models import filter as mcl
    from montecarlolocalisation_tpu_torch.models import sensor

    world = World(tiny.ROOT, cl_config(particles=32), "cpu")
    pw = PortWorld(world)
    e = 8
    enc, ranges, _ = generator.logs(5, world.mz, world.angles, world.sensor,
                                    world.motion, e, 60)
    st = mcl.init_state(pw.m, pw.cfg, 11, batch=e)
    rs, gen = ref.init(world.mz, world.filter, 11, e)
    mask = torch.ones(ranges[:, 0].shape, dtype=torch.bool)
    seen = set()
    for t in range(60):
        scan = sensor.make_scan(world.angles, ranges[:, t])
        st, out = mcl.mcl_step(st, enc[:, t, 0], enc[:, t, 1], scan, pw.m,
                               pw.cfg)
        d = ref.draw_tick(gen, world.mz, world.filter, e)
        rs, o = ref.tick(rs, enc[:, t], ranges[:, t], mask, world.angles,
                         world.mz, world.filter, d)
        assert torch.equal(out.wanderer_cmd, o.wanderer_cmd), t
        seen |= set(o.wanderer_cmd.tolist())
    assert seen == {ref.WANDERER_NOOP, ref.WANDERER_STOP,
                    ref.WANDERER_START}


def _run(root, program=None, seed=SEED, trace=False):
    """One run of the cell, long enough to finish the first pass (and, a
    traced one, to reach its profile in the second)."""
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(root, CELL, seed, 2.5 if trace else 1.5, trace,
                           "cpu", program=program, out=out, err=err)
    return res, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
def test_the_closed_loop_cell_added_by_files_runs_correct(root, trace):
    res, out, err = _run(root, trace=bool(trace))
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(LIMITS)
    d = line["diagnostics"]
    assert d["gen_off"] == 0 and d["sim_gen_off"] == 0
    assert d["units"] == 6 and d["answers"] == 4 * 48, d
    tail = err.strip().splitlines()[-(len(LIMITS) + 1):]
    for k in LIMITS:
        assert any(t.startswith(f"check {k} = ") for t in tail)
    if trace:
        m = line["metrics"]
        assert set(m) == set(METRICS)
        assert m["cl_ticks_traced"]["value"] >= 16
        assert m["k1_bound_ms"]["value"] > 0
        assert m["k3_bound_ms"]["value"] > 0
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"updates_per_s", "setup_s"}
        assert line["metrics"]["updates_per_s"]["value"] == pytest.approx(
            4 * 64 * 24 * d["ticks"] / d["window_s"])
        assert d["passes"] >= 1 and 0 <= d["complete_share"] <= 1


def test_the_control_is_not_correct(root):
    res, _, _ = _run(root, control.factory("closed_loop"))
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] > 0.5
    assert res["checks"]["cmd_gap"]["value"] > LIMITS["cmd_gap"]
    assert res["checks"]["truth_gap"]["value"] > LIMITS["truth_gap"]


def _faults():
    from montecarlolocalisation_tpu_torch.control import controllers
    from montecarlolocalisation_tpu_torch.models import sensor
    from montecarlolocalisation_tpu_torch.sim import closed_loop, robot

    real_scan = sensor.simulate_scan
    real_dynamics = robot.step_dynamics
    real_drive = controllers.global_p_drive
    real_step = closed_loop.closed_loop_step

    def scan_sigma(*args, noise_sigma=None, **kw):
        return real_scan(*args, noise_sigma=1.01 * noise_sigma, **kw)

    def p_gain(pose, target, base_speed, gain=7.0, stop_dist=0.1):
        return real_drive(pose, target, base_speed, 1.01 * gain, stop_dist)

    def wheel_space(state, d_left, d_right, cfg):
        return real_dynamics(state, d_left, d_right, dataclasses.replace(
            cfg, wheel_space=1.01 * cfg.wheel_space))

    def arrival_on_truth(state, waypoints, *args, arrival_tol=0.2, **kw):
        """The step, its waypoint index then decided on the true pose."""
        new, out = real_step(state, waypoints, *args,
                             arrival_tol=arrival_tol, **kw)
        n_wp = waypoints.shape[0]
        i = torch.clamp(state.wp_idx, 0, n_wp - 1).long()
        wp = waypoints[i]
        pose = state.robot.pose
        arrived = ((torch.abs(pose[..., 0] - wp[..., 0]) <= arrival_tol)
                   & (torch.abs(pose[..., 1] - wp[..., 1]) <= arrival_tol))
        idx = torch.where(arrived, torch.clamp(state.wp_idx + 1, max=n_wp),
                          state.wp_idx)
        return (dataclasses.replace(new, wp_idx=idx),
                dataclasses.replace(out, wp_idx=idx))

    return dict(scan_sigma=(sensor, "simulate_scan", scan_sigma),
                p_gain=(controllers, "global_p_drive", p_gain),
                wheel_space=(robot, "step_dynamics", wheel_space),
                arrival_on_truth=(closed_loop, "closed_loop_step",
                                  arrival_on_truth))


@pytest.mark.parametrize("kind,number", [
    ("scan_sigma", "rows_off"), ("p_gain", "cmd_gap"),
    ("wheel_space", "truth_gap"), ("arrival_on_truth", "wp_off")])
def test_a_fault_in_the_loop_is_not_correct(root, kind, number,
                                            monkeypatch):
    """Each fault fails the number that judges its stage."""
    module, name, fault = _faults()[kind]
    monkeypatch.setattr(module, name, fault)
    res, _, _ = _run(root)
    assert res["correct"] is False, res["checks"]
    assert res["checks"][number]["value"] > LIMITS[number], res["checks"]


@pytest.mark.parametrize("kind", ["unchanged", "half", "answer"])
def test_a_fault_in_the_filter_is_not_correct(root, kind, monkeypatch):
    module, name, step = test_bench_checks._fault(kind, "closed_loop")
    monkeypatch.setattr(module, name, step)
    res, _, _ = _run(root)
    assert res["correct"] is False, res["checks"]


def test_the_tiny_cell_arrives():
    """arrival_on_truth is seen only where an episode reaches a waypoint
    inside the checked ticks: the sound run's episodes do."""
    world = World(tiny.ROOT, cl_config(), "cpu")
    units = _units(world, SEED, ticks=48)
    assert max(int(u.wp_idx.max()) for u in units) > 0


def _all_supported():
    return [{k: v} for k, allowed in SUPPORTED_CLOSED_LOOP.items()
            for v in allowed]


@pytest.mark.parametrize("change", [
    dict(known_start=True), dict(extra=1), dict(drop="scan_noise"),
    dict(drop_wanderer="turn_angle"), dict(on_slam=True)],
    ids=lambda c: "-".join(f"{k}={v}" for k, v in c.items()))
def test_world_takes_exactly_what_the_closed_loop_reference_implements(
        change):
    for ok in _all_supported():
        World(tiny.ROOT, cl_config(**ok), "cpu")
    assert set(cl_config()["closed_loop"]) == set(CLOSED_LOOP_FIELDS)
    assert set(CLOSED_LOOP["wanderer"]) == set(WANDERER_FIELDS)
    cfg = cl_config()
    c = cfg["closed_loop"]
    if "known_start" in change:
        c["known_start"] = True
    elif "extra" in change:
        c["extra"] = 1
    elif "drop" in change:
        del c[change["drop"]]
    elif "drop_wanderer" in change:
        del c["wanderer"][change["drop_wanderer"]]
    else:
        from .test_bench_slam import slam_config

        cfg = slam_config()
        cfg["closed_loop"] = c
    with pytest.raises(ValueError):
        World(tiny.ROOT, cfg, "cpu")


def test_the_closed_loop_reference_loads_nothing_of_jax_or_the_port():
    """A fresh interpreter runs the closed-loop reference's ticks and lists
    the top-level modules it then holds."""
    code = (
        "import sys\n"
        "from mclbench.tests import test_bench_closed_loop as t\n"
        "from mclbench.tests import tiny\n"
        "from mclbench.world import World\n"
        "from mclbench.reference import closed_loop as ref\n"
        "w = World(tiny.ROOT, t.cl_config(particles=8), 'cpu')\n"
        "start, wps = t._plan(w)\n"
        "st, sg, fg = ref.init(w.mz, w.filter, 3, 2, start)\n"
        "ref.run(st, sg, fg, wps, 3, w.angles, w.mz, w.filter,"
        " w.closed_loop)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    tops = set(ast.literal_eval(r.stdout.strip().splitlines()[-1]))
    assert "mclbench" in tops and "torch" in tops
    assert not tops & set(harness.FORBIDDEN + (
        "montecarlolocalisation_tpu_torch",))
