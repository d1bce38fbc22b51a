"""The committed SLAM cell, `slam-128x49` (configs/rbpf-128x24.json,
traffic/slam16x4x1000-slip8.json), on the CPU at tiny.make_root's size
(2 episodes x 2 replicas x 8 particles x 20 ticks), and its per-layer
metrics on synthetic readings.

- The configuration is test_bench_slam.slam_config(128) field for field
  (the published SLAM row on the reference maze, ref-1500x34's sensor
  and motion, 24 beams), and states its source, deployment, guarantees
  and assumptions, with nothing reduced; the mix keeps the published
  row's 16 logs x 4 replicas x 1000 ticks at 8 % slip, the replay mixes'
  wander otherwise, and the five SLAM limits.
- The cell runs correct and prints the contract's line, traced and
  untraced; the bfloat16 control and four faults planted in the port's
  SLAM tick come out not correct: the maps updated past the keyframe
  gate, a tick that returns its state unchanged, half of the filters
  left unstepped, and filter 0's published pose altered (the SLAM
  counterparts of test_bench_checks.py's faults, which it plants in the
  filter tick).
- On a trace whose SLAM ticks run under their marks (`slam_motion`,
  `slam_field`, `slam_resample`, `slam_map`, then `emit`):
  map_ms_per_tick.slam, field_ms_per_tick.slam and
  resample_ms_per_tick.slam are their stages a tick, ism_roofline and
  slam_field_roofline the reading's bounds over them, and
  slam_ns_per_ray.slam the four stages over the counters' rays a tick;
  each reads None without the marks (the parent's program), without its
  bound, or without the counters.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os

import pytest
import torch

from mclbench import control, harness, program_telemetry
from mclbench.trace import Reading

from . import test_bench_slam, tiny

CELL = "slam-128x49"
TICKS = 4
STAGES = ("map_ms_per_tick.slam", "field_ms_per_tick.slam",
          "resample_ms_per_tick.slam")
SLAM = STAGES + ("ism_roofline", "slam_field_roofline",
                 "slam_ns_per_ray.slam")


def _committed(*path):
    with open(os.path.join(tiny.ROOT, *path)) as f:
        return json.load(f)


def _cell():
    man = _committed("BENCHMARK.json")
    (cell,) = [w for w in man["workloads"] if w["name"] == CELL]
    (conf,) = [c for c in man["configs"] if c["name"] == cell["config"]]
    return man, cell, conf


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, program=None, seed=2**31 + 99, trace=False):
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(root, CELL, seed, 2.0 if trace else 0.5, trace,
                           "cpu", program=program, out=out, err=err)
    return res, out.getvalue(), err.getvalue()


def test_the_configuration_is_the_published_slam_row():
    _, cell, conf = _cell()
    cfg = _committed(*conf["file"].split("/"))
    want = test_bench_slam.slam_config(particles=128)
    for k in ("slam", "map", "beams"):
        assert cfg[k] == want[k], k
    assert cfg["name"] == conf["name"] == cell["config"]
    assert cfg["reduced"] == conf["reduced"] == []
    assert cell["chips"] == 1
    for k in ("source", "deployment"):
        assert isinstance(cfg[k], str) and cfg[k]
    for k in ("guarantees", "assumed"):
        assert cfg[k] and all(isinstance(v, str) for v in cfg[k])


def test_the_mix_keeps_the_published_row():
    _, cell, _ = _cell()
    mix = _committed("mclbench", "traffic", cell["traffic"] + ".json")
    base = _committed("mclbench", "traffic", "logs1024x300.json")
    assert mix["driver"] == "slam"
    assert (mix["episodes"], mix["replicas"], mix["ticks"]) == (16, 4, 1000)
    assert (mix["segment_ticks"], mix["check_segments"]) == (8, 2)
    assert mix["wander"] == dict(base["wander"], slip=0.08)
    assert mix["limits"] == test_bench_slam.LIMITS


@pytest.mark.parametrize("trace", [0, 1])
def test_the_committed_cell_runs_correct(root, trace):
    res, out, err = _run(root, trace=bool(trace))
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    d = line["diagnostics"]
    for k in ("rows_off", "pose_gap", "weights_gap", "map_off",
              "evidence_gap", "gen_off", "kf_off", "resample_off"):
        assert d[k] == 0, (k, d[k])
    checks = line["checks"]
    assert list(checks) == list(test_bench_slam.LIMITS)
    tail = err.strip().splitlines()[-len(checks) - 1:]
    for k in checks:
        assert any(t.startswith(f"check {k} = ") for t in tail)
    cell = harness.load_cell(root, CELL)
    if trace:
        names = {m["name"] for m in cell.per_layer}
        assert set(line["metrics"]) <= names
        assert set(SLAM) <= names
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"updates_per_s", "setup_s"}
        assert line["metrics"]["updates_per_s"]["value"] == pytest.approx(
            2 * 2 * 8 * 24 * d["ticks"] / d["window_s"])


def test_the_control_is_not_correct(root):
    res, _, _ = _run(root, control.factory("slam"))
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] > 0.5
    assert res["checks"]["map_off"]["value"] > (
        res["checks"]["map_off"]["limit"])


def _fault(kind):
    """(module, name, replacement) of a fault in models/slam.slam_step."""
    from montecarlolocalisation_tpu_torch.models import slam

    if kind == "no_keyframe_gate":
        return test_bench_slam._faults()[kind]
    real = slam.slam_step

    def step(state, *args, **kw):
        new, info = real(state, *args, **kw)
        if kind == "unchanged":
            return state, info
        if kind == "half":
            # The second half of the episodes keep the state they had.
            def mix(a, b):
                h = a.shape[0] // 2
                return torch.cat([a[:h], b[h:]])

            return dataclasses.replace(
                new, poses=mix(new.poses, state.poses),
                logodds=mix(new.logodds, state.logodds),
                weights=mix(new.weights, state.weights)), info
        pose = info["pose"].clone()
        pose[0, 0, 0] += 0.25
        return new, dict(info, pose=pose)

    return slam, "slam_step", step


@pytest.mark.parametrize("kind", ["no_keyframe_gate", "unchanged", "half",
                                  "answer"])
def test_a_fault_is_not_correct(root, kind, monkeypatch):
    module, name, fault = _fault(kind)
    monkeypatch.setattr(module, name, fault)
    res, _, _ = _run(root)
    assert res["correct"] is False, res["checks"]
    if kind == "no_keyframe_gate":
        assert res["checks"]["map_off"]["value"] > (
            res["checks"]["map_off"]["limit"])


# Synthetic readings.  A SLAM tick: the draws (bookkeeping), then each
# stage's mark and its ops: motion 3 ns, the field 11, resampling 5 and
# the map update 40, then `emit` and the output slab's copy (bookkeeping).
TICK = [("draws", 2), ("mcl_mark_slam_motion", None), ("propagate", 3),
        ("mcl_mark_slam_field", None), ("blur", 7), ("bilinear", 4),
        ("mcl_mark_slam_resample", None), ("gather_maps", 5),
        ("mcl_mark_slam_map", None), ("ism", 40),
        ("mcl_mark_emit", None), ("slab_copy", 2)]
STAGE_NS = dict(slam_motion=3, slam_field=11, slam_resample=5, slam_map=40)


def _trace(marks=True, bounds=None):
    """Two replays of two ticks, each inside `begin` ... `end`; without
    `marks` the same ops with no mark among them."""
    replay = ([("Memcpy HtoD", 10), ("mcl_mark_begin", None)] + TICK + TICK
              + [("mcl_mark_end", None), ("Memcpy DtoD", 10)])
    ops, t = [], 1000
    for _ in range(2):
        for name, d in replay:
            if d is None and not marks:
                continue
            d = 1 if d is None else d
            ops.append((name, t, t + d))
            t += d + 2
        t += 100
    return Reading(ops=ops, spans=[], window=(ops[0][1], ops[-1][2]),
                   ticks=TICKS, bounds=dict(bounds or {}))


def _read(name, r):
    return harness.metric_reader(tiny.ROOT, name).read(r)


def _counters(monkeypatch, counters):
    monkeypatch.setattr(program_telemetry, "recorded",
                        lambda: ([], counters))


def _per_tick(ns):
    # Two replays of two ticks: a stage's ns a tick times 4 ticks, over 4.
    return 4 * ns * 1e-6 / TICKS


def test_the_slam_marks_split_the_tick():
    r = _trace()
    split = program_telemetry.stage_split(r)
    for stage, ns in STAGE_NS.items():
        assert split[stage] == pytest.approx(_per_tick(ns))
    assert split["bookkeeping"] == pytest.approx(_per_tick(2 + 2))
    assert _read("map_ms_per_tick.slam", r) == pytest.approx(
        _per_tick(40))
    assert _read("field_ms_per_tick.slam", r) == pytest.approx(
        _per_tick(11))
    assert _read("resample_ms_per_tick.slam", r) == pytest.approx(
        _per_tick(5))


def test_the_rooflines_read_the_bounds():
    r = _trace(bounds=dict(ism_ms_per_tick=2e-6,
                           slam_field_ms_per_tick=5e-6))
    assert _read("ism_roofline", r) == pytest.approx(
        100 * 2e-6 / _per_tick(40))
    assert _read("slam_field_roofline", r) == pytest.approx(
        100 * 5e-6 / _per_tick(11))
    # A traced window in which no filter mapped has no ISM bound.
    r = _trace(bounds=dict(slam_field_ms_per_tick=5e-6))
    assert _read("ism_roofline", r) is None
    assert _read("slam_field_roofline", _trace()) is None


def test_ns_per_ray_reads_the_counters(monkeypatch):
    r = _trace()
    rays = 16 * 4 * 128 * 24
    _counters(monkeypatch, {"slam.calls": 8, "slam.rays": 8 * rays})
    want = sum(STAGE_NS.values())
    assert _read("slam_ns_per_ray.slam", r) == pytest.approx(
        _per_tick(want) * 1e6 / rays)
    _counters(monkeypatch, {"refine.calls": 2, "refine.rays": 10})
    assert _read("slam_ns_per_ray.slam", r) is None
    monkeypatch.setattr(program_telemetry, "recorded", lambda: None)
    assert _read("slam_ns_per_ray.slam", r) is None


@pytest.mark.parametrize("name", SLAM)
def test_the_slam_metrics_read_nothing_without_slam_marks(name,
                                                          monkeypatch):
    _counters(monkeypatch, {"slam.calls": 1, "slam.rays": 10})
    bounds = dict(ism_ms_per_tick=1e-6, slam_field_ms_per_tick=1e-6)
    assert _read(name, _trace(marks=False, bounds=bounds)) is None
    # The filter tick's marks open no SLAM stage.
    ops = [(n.replace("slam_", ""), s, e)
           for n, s, e in _trace(bounds=bounds).ops]
    r = Reading(ops=ops, spans=[], window=(ops[0][1], ops[-1][2]),
                ticks=TICKS, bounds=bounds)
    assert _read(name, r) is None
