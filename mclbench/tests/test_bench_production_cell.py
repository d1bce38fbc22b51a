"""The committed production cell, `replay1024-production`
(configs/production-500x24.json, traffic/logs1024x300-gated.json), on
the CPU at tiny.make_root's size (3 episodes x 64 particles x 24 beams x
20 ticks).

- The configuration is presets.make_world's production FilterConfig
  (500 particles, systematic resampling, ESS 0.5, refine 2) field for
  field, and its beams the preset's table; the mix is logs1024x300's
  with a weights_gap limit added; the cell keeps the published row's
  1024 episodes x 300 ticks.
- The cell runs correct: no particle row off, the same random stream,
  the same weights.
- Refinement skipped, the gate firing every tick, the carried weights
  reset to uniform, and the bfloat16 control each come out not correct.
- Both kinds of run print the contract's line, and the last lines on
  standard error name each of the four compared numbers.
"""
from __future__ import annotations

import dataclasses
import io
import json
import os

import pytest

from mclbench import control, harness
from mclbench.reference import filter as ref

from . import test_bench_production, tiny

CELL = "replay1024-production"


def _committed(*path):
    with open(os.path.join(tiny.ROOT, *path)) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _run(root, program=None, seed=2**31 + 99):
    return harness.run_cell(root, CELL, seed, 0.5, False, "cpu",
                            program=program, out=io.StringIO(),
                            err=io.StringIO())


def test_the_configuration_is_the_presets_production_world():
    from montecarlolocalisation_tpu_torch import presets

    world = presets.make_world(num_particles=500,
                               resample_method="systematic",
                               refine_iters=2, ess_threshold=0.5,
                               device="cpu")
    cfg = _committed("mclbench", "configs", "production-500x24.json")
    assert cfg["filter"] == json.loads(json.dumps(
        dataclasses.asdict(world.cfg)))
    table = ref.beam_table(cfg["beams"]).numpy()
    assert table.dtype == world.angles.dtype
    assert (table == world.angles).all()
    assert cfg["map"] == "data/default_map.txt" and cfg["reduced"] == []


def test_the_cell_is_the_published_row():
    man = _committed("BENCHMARK.json")
    (cell,) = [w for w in man["workloads"] if w["name"] == CELL]
    (conf,) = [c for c in man["configs"] if c["name"] == cell["config"]]
    assert cell["chips"] == 1 and conf["reduced"] == []
    mix = _committed("mclbench", "traffic", cell["traffic"] + ".json")
    base = _committed("mclbench", "traffic", "logs1024x300.json")
    assert (mix["episodes"], mix["ticks"]) == (1024, 300)
    for k in set(base) - {"why", "limits"}:
        assert mix[k] == base[k], k
    assert {k: v for k, v in mix["limits"].items()
            if k != "weights_gap"} == base["limits"]
    assert 0 < mix["limits"]["weights_gap"] < 1


def test_the_committed_cell_runs_correct(root):
    res = _run(root)
    assert res["correct"] is True, res["checks"]
    d = res["diagnostics"]
    assert d["rows_off"] == 0.0 and d["gen_off"] == 0
    assert d["weights_gap"] == 0.0
    assert "weights_gap" in res["checks"]


@pytest.mark.parametrize("kind", ["no_refine", "always_fire",
                                  "uniform_carried"])
def test_a_fault_is_not_correct(root, kind, monkeypatch):
    module, name, fault = test_bench_production._faults()[kind]
    monkeypatch.setattr(module, name, fault)
    res = _run(root)
    assert res["correct"] is False, res["checks"]


def test_the_control_is_not_correct(root):
    res = _run(root, control.factory("replay"))
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] > 0.5
    assert res["checks"]["weights_gap"]["value"] > (
        res["checks"]["weights_gap"]["limit"])


@pytest.mark.parametrize("trace", [0, 1])
def test_the_cell_prints_the_contract_line(root, trace):
    out, err = io.StringIO(), io.StringIO()
    harness.run_cell(root, CELL, 2**31 + 17, 0.5, bool(trace), "cpu",
                     out=out, err=err)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    assert line["correct"] is True and line["attempted"] > 0
    cell = harness.load_cell(root, CELL)
    names = {m["name"] for m in (cell.per_layer if trace
                                 else cell.end_to_end)}
    assert set(line["metrics"]) <= names
    if not trace:
        assert set(line["metrics"]) == names
    checks = line["checks"]
    assert list(checks) == ["rows_off", "pose_gap", "conf_gap",
                            "weights_gap"]
    tail = err.getvalue().strip().splitlines()[-len(checks) - 1:]
    for k, c in checks.items():
        assert any(t.startswith(f"check {k} = ") for t in tail)
        assert c["value"] <= c["limit"]
