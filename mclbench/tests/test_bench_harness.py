"""The harness on the CPU at a tiny size: it finds cells, mixes and metrics
by their files, prints the contract's last line, and loads neither JAX nor
the JAX package."""
from __future__ import annotations

import ast
import io
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from mclbench import generator, harness
from mclbench.drivers import fleet
from mclbench.reference import maze

from . import tiny

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _last_line(res_out: io.StringIO) -> dict:
    return json.loads(res_out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", tiny.cells())
def test_tiny_run_prints_the_contract_line(root, workload, trace):
    out, err = io.StringIO(), io.StringIO()
    harness.run_cell(root, workload, 2**31 + 17, 0.5, bool(trace), "cpu",
                     out=out, err=err)
    line = _last_line(out)
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    cell = harness.load_cell(root, workload)
    if trace:
        assert set(line["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
        for m in cell.end_to_end:
            assert line["metrics"][m["name"]]["unit"] == m["unit"]
    tail = err.getvalue().strip().splitlines()
    for k, c in line["checks"].items():
        assert any(t.startswith(f"check {k} = ")
                   for t in tail[-(len(line["checks"]) + 1):])
        assert c["value"] <= c["limit"]


def test_a_new_config_mix_and_metric_are_files_and_entries(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench = os.path.join(root, "mclbench")
    with open(os.path.join(bench, "configs", "ref-1500x34.json")) as f:
        cfg = json.load(f)
    cfg.update(name="ref-32")
    cfg["filter"]["num_particles"] = 32
    with open(os.path.join(bench, "configs", "ref-32.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(bench, "traffic", "fleet-open-10hz.json")) as f:
        mix = json.load(f)
    mix.update(robots=1, period_ms=40)
    with open(os.path.join(bench, "traffic", "one-robot.json"), "w") as f:
        json.dump(mix, f)
    with open(os.path.join(bench, "metrics", "frames_traced.py"), "w") as f:
        f.write("def read(r):\n    return float(r.ticks)\n")
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        man = json.load(f)
    man["configs"].append(dict(name="ref-32", source="x",
                               file="mclbench/configs/ref-32.json",
                               reduced=["num_particles"], why="x"))
    man["workloads"].append(dict(name="one-robot", config="ref-32",
                                 traffic="one-robot", chips=1, why="x"))
    for m in man["end_to_end"]:
        if "workloads" in m and "fleet64-10hz" in m["workloads"]:
            m["workloads"].append("one-robot")
    man["per_layer"].append(dict(
        name="frames_traced", unit="frames", better="higher",
        source="program_counter", layer="servers: io/fleet, io/server",
        moves="frame_p95_ms", workloads=["one-robot"]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    cell = harness.load_cell(root, "one-robot")
    assert cell.config["filter"]["num_particles"] == 32
    assert cell.traffic["robots"] == 1
    assert [m["name"] for m in cell.per_layer] == ["frames_traced"]
    out = io.StringIO()
    harness.run_cell(root, "one-robot", 5, 0.6, True, "cpu", out=out,
                     err=io.StringIO())
    line = _last_line(out)
    assert line["correct"] is True
    assert line["metrics"]["frames_traced"]["value"] >= 1


def test_the_generator_is_deterministic_by_seed():
    mz = maze.load(os.path.join(tiny.BENCH, "data", "default_map.txt"))
    with open(os.path.join(tiny.BENCH, "configs", "ref-1500x34.json")) as f:
        f_cfg = json.load(f)["filter"]
    angles = torch.linspace(-2.0, 2.0, 5)

    def logs(seed):
        return generator.logs(seed, mz, angles, f_cfg["sensor"],
                              f_cfg["motion"], 3, 12)

    a, b, c = logs(2**31 + 5), logs(2**31 + 5), logs(2**31 + 6)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert not torch.equal(a[1], c[1])
    assert fleet.frame_lines(a[0], a[1]) == fleet.frame_lines(b[0], b[1])
    # Every robot wanders on its own trajectory.
    assert len({tuple(p) for p in a[2][:, -1, :2].tolist()}) == 3


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("montecarlolocalisation_tpu_torch.models", "jaxfoo",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "montecarlolocalisation_tpu.maps", sys)
    assert harness.forbidden_modules() == ["montecarlolocalisation_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package(root):
    code = ("import io, sys; from mclbench import harness; "
            f"harness.run_cell({root!r}, 'fleet64-10hz', 3, 0.3, False, "
            "'cpu', out=io.StringIO(), err=io.StringIO()); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, "-c", code], cwd=tiny.ROOT,
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr
    tops = set(ast.literal_eval(r.stdout.strip().splitlines()[-1]))
    assert "montecarlolocalisation_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN)


def test_the_reference_imports_nothing_of_the_port():
    port = "montecarlolocalisation_tpu_torch"
    files = [os.path.join(tiny.BENCH, "reference", f)
             for f in os.listdir(os.path.join(tiny.BENCH, "reference"))
             if f.endswith(".py")]
    files += [os.path.join(tiny.BENCH, f) for f in
              ("generator.py", "bounds.py", "compare.py", "control.py")]
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     and not node.level else [])
            for n in names:
                assert n.split(".")[0] not in (port,) + harness.FORBIDDEN, \
                    (path, n)


def test_without_a_card_the_command_fails_and_prints_no_result(tmp_path):
    r = subprocess.run([sys.executable, "-m", "mclbench.run", "--workload",
                        "fleet64-10hz", "--seed", "1", "--seconds", "1"],
                       cwd=tiny.ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0 and r.stdout.strip() == ""


def test_the_benchmark_alone_fails_and_prints_no_result(tmp_path):
    shutil.copytree(tiny.BENCH, tmp_path / "mclbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(tiny.ROOT, "BENCHMARK.json"), tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    r = subprocess.run([sys.executable, "-m", "mclbench.run", "--workload",
                        "global-1m", "--seed", "1", "--seconds", "1"],
                       cwd=tmp_path, capture_output=True, text=True,
                       timeout=300, env=env)
    assert r.returncode != 0 and r.stdout.strip() == ""


@pytest.mark.card
@pytest.mark.parametrize("workload", tiny.cells())
def test_every_cell_runs_correct_on_the_card(card, workload):
    r = subprocess.run([sys.executable, "-m", "mclbench.run", "--workload",
                        workload, "--seed", "4242", "--seconds", "3"],
                       cwd=tiny.ROOT, capture_output=True, text=True,
                       timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] is True and line["device"]["platform"] == "gpu"
