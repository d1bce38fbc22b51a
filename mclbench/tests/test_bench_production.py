"""The production schedule on the CPU at a tiny size: ESS-gated
resampling (carried importance weights, the gate a per-filter select),
gradient refinement on the DDA caster and the importance-weighted
confidence, in a cell added by files alone ("production-tiny": 3
episodes x 64 particles x 24 beams x 20 ticks, systematic, ESS 0.5,
refine 2, the fixed caster, through run_episode_batch).

- The port agrees with the reference: no particle row off, the same
  random stream, and the same answers and weights.
- Three faults planted in the port's tick, and the bfloat16 control,
  come out not correct: refinement skipped, the gate firing every tick,
  the carried weights reset to uniform.
- The three cells' checks give the parent's numbers on the same seeds,
  and the reference's states and outputs are the parent's bit for bit.
- World takes exactly the settings the reference implements.
- The reference loads neither JAX, nor the JAX package, nor the port.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from mclbench import compare, control, harness
from mclbench.world import World

from . import fixed, tiny

CELL = "production-tiny"
SEEDS = (2**31 + 7, 99, 123456789)
# The parent's numbers (rows_off, pose_gap, conf_gap, songs_off, gen_off,
# answers, rows) and the digest of its reference, at tiny.make_root's
# size: the sound units, then the bfloat16 control's.
PARENT = [
    ("fleet64-10hz", 2147483655, [0.0, 0.0, 0.0, 0, 0, 32, 256],
     "f3a92dff3cd6c636c3f8b822740bfb9ded8d09556b98f8fb61858677c9621321"),
    ("fleet64-10hz", 12345, [0.0, 0.0, 0.0, 0, 0, 32, 256],
     "4a25219cacae617f375a80771a4a5bbf8cfb804f756b812dbbcf8e08693f1e89"),
    ("global-1m", 2147483655, [0.0, 0.0, 0.0, 0, 0, 16, 512],
     "daec69088f65a3c8b72edb9f93ceded08f2e52022650b6c4ed84a8f3c75fc3b0"),
    ("global-1m", 12345, [0.0, 0.0, 0.0, 0, 0, 16, 512],
     "4b4241001743627bba6ae3d082ea2e2a921d06834cde609a1077d70641a9d814"),
    ("replay1024-ref", 2147483655, [0.0, 0.0, 0.0, 0, 0, 48, 384],
     "6d2eb70ac5ea622b61699812e10cc355545607f8b266e0e31f5893bebb7e59fb"),
    ("replay1024-ref", 12345, [0.0, 0.0, 0.0, 0, 0, 48, 384],
     "705eb03d2a6e8593c2ef6baa541661b62b1821f445cadd3d298f48b20a88cc21"),
]
PARENT_CONTROL = [
    ("fleet64-10hz", 2147483655, [1.0, 99.0, 0.59375, 2, 0]),
    ("fleet64-10hz", 12345, [1.0, 99.0, 0.71875, 1, 0]),
    ("global-1m", 2147483655, [1.0, 0.0, 0.203125, 0, 0]),
    ("global-1m", 12345, [1.0, 0.0, 0.3671875, 0, 0]),
    ("replay1024-ref", 2147483655, [1.0, 99.0, 0.609375, 2, 0]),
    ("replay1024-ref", 12345, [1.0, 99.0, 0.625, 2, 0]),
]
NUMBERS = ("rows_off", "pose_gap", "conf_gap", "songs_off", "gen_off",
           "answers", "rows")


def production_config(particles: int = 64, method: str = "systematic",
                      ess=0.5, iters: int = 2, ray_mode: str = "fixed"):
    """ref-1500x34's filter under the production schedule, on the
    24-beam table of the published production row."""
    with open(os.path.join(tiny.BENCH, "configs", "ref-1500x34.json")) as f:
        cfg = json.load(f)
    filt = cfg["filter"]
    filt["num_particles"] = particles
    filt["resample"].update(method=method, ess_threshold=ess)
    filt["refine"].update(iters=iters, ray_mode="dda")
    filt["sensor"]["ray_mode"] = ray_mode
    cfg.update(name=CELL, beams=dict(count=24, min_deg=-118.0,
                                     max_deg=118.0))
    return cfg


def _traffic(episodes=3, ticks=20):
    with open(os.path.join(tiny.BENCH, "traffic", "logs1024x300.json")) as f:
        t = json.load(f)
    t.update(episodes=episodes, ticks=ticks)
    return t


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(str(tmp_path_factory.mktemp("bench")))
    bench = os.path.join(root, "mclbench")
    for path, obj in ((("configs", CELL), production_config()),
                      (("traffic", CELL), _traffic())):
        with open(os.path.join(bench, *path) + ".json", "w") as f:
            json.dump(obj, f)
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
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


def _run(root, program=None, seed=2**31 + 99):
    return harness.run_cell(root, CELL, seed, 0.5, False, "cpu",
                            program=program, out=io.StringIO(),
                            err=io.StringIO())


CASES = [dict(), dict(method="multinomial", iters=1),
         dict(ray_mode="analytic"), dict(iters=0), dict(ess=None)]


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(
    f"{k}={v}" for k, v in c.items()) or "production")
def test_the_port_agrees_with_the_reference(case):
    world = World(tiny.ROOT, production_config(**case), "cpu")
    for seed in SEEDS:
        n = compare.check(world, fixed.units(world, _traffic(), seed,
                                             segments=3, seg=7))
        assert n["rows"] == 3 * 3 * 64 and n["rows_off_count"] == 0, n
        assert n["gen_off"] == 0 and n["songs_off"] == 0, n
        assert n["pose_gap"] == 0.0 and n["conf_gap"] == 0.0, n
        assert n["weights_gap"] == 0.0, n


def test_the_tiny_world_takes_both_branches_of_the_gate_and_refines():
    """The faults below are seen only where the gate both fires and
    skips, and refinement moves particles."""
    from mclbench import generator
    from mclbench.reference import filter as ref
    from mclbench.reference import refine

    world = World(tiny.ROOT, production_config(), "cpu")
    t = _traffic()
    enc, ranges, _ = generator.logs(5, world.mz, world.angles, world.sensor,
                                    world.motion, 3, 20,
                                    generator.Wander(**t["wander"]))
    mask = torch.ones(ranges[:, 0].shape, dtype=torch.bool)
    st, gen = ref.init(world.mz, world.filter, 7, 3)
    fired = skipped = moved = 0
    for k in range(20):
        d = ref.draw_tick(gen, world.mz, world.filter, 3)
        _, parts = ref.motion(st, enc[:, k, 0], enc[:, k, 1], d["normals"],
                              world.motion, torch.float32)
        refined = refine.refine(world.mz, parts, ranges[:, k], mask,
                                world.angles, world.filter)
        moved += int((refined != parts).any(-1).sum())
        st, _ = ref.tick(st, enc[:, k], ranges[:, k], mask, world.angles,
                         world.mz, world.filter, d)
        uniform = (st.weights == st.weights[:, :1]).all(-1)
        fired += int(uniform.sum())
        skipped += int((~uniform).sum())
    assert fired > 3 and skipped > 3 and moved > 20 * 3 * 64 // 4


def test_the_production_cell_runs_correct(root):
    res = _run(root)
    assert res["correct"] is True, res["checks"]
    assert res["diagnostics"]["weights_gap"] == 0.0
    assert res["diagnostics"]["gen_off"] == 0


def _faults():
    from montecarlolocalisation_tpu_torch.models import refine, resample

    real_refine = refine.refine_particles
    real_gate = resample.ess_gated_resample

    def no_refine(m, particles, scan, cfg):
        return real_refine(m, particles, scan, dataclasses.replace(
            cfg, refine=dataclasses.replace(cfg.refine, iters=0)))

    def always_fire(particles, likelihood, carried_w, inj, jitter_state,
                    m, cfg, draws):
        cfg = dataclasses.replace(cfg, resample=dataclasses.replace(
            cfg.resample, ess_threshold=float("inf")))
        return real_gate(particles, likelihood, carried_w, inj,
                         jitter_state, m, cfg, draws)

    def uniform_carried(particles, likelihood, carried_w, *args):
        return real_gate(particles, likelihood,
                         torch.full_like(carried_w, 1.0 / carried_w.shape[-1]),
                         *args)

    return dict(no_refine=(refine, "refine_particles", no_refine),
                always_fire=(resample, "ess_gated_resample", always_fire),
                uniform_carried=(resample, "ess_gated_resample",
                                 uniform_carried))


@pytest.mark.parametrize("kind", ["no_refine", "always_fire",
                                  "uniform_carried"])
def test_a_fault_is_not_correct(root, kind, monkeypatch):
    module, name, fault = _faults()[kind]
    monkeypatch.setattr(module, name, fault)
    res = _run(root)
    assert res["correct"] is False, res["checks"]


def test_the_control_is_not_correct(root):
    res = _run(root, control.factory("replay"))
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] > 0.5


@pytest.mark.parametrize("workload,seed,numbers,digest", PARENT)
def test_the_three_cells_check_as_on_the_parent(workload, seed, numbers,
                                                digest, tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = harness.load_cell(root, workload)
    world = World(root, cell.config, "cpu")
    us = fixed.units(world, cell.traffic, seed)
    n = compare.check(world, us)
    assert [n[k] for k in NUMBERS] == numbers
    assert n["weights_gap"] == 0.0
    assert fixed.digest(world, us) == digest


@pytest.mark.parametrize("workload,seed,numbers", PARENT_CONTROL)
def test_the_three_cells_control_checks_as_on_the_parent(workload, seed,
                                                         numbers, tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = harness.load_cell(root, workload)
    world = World(root, cell.config, "cpu")
    us = fixed.units(world, cell.traffic, seed,
                     program=control.ReplayControl)
    n = compare.check(world, us)
    assert [n[k] for k in NUMBERS[:5]] == numbers


@pytest.mark.parametrize("group,key,value", [
    ("resample", "ess_threshold", 0.3), ("refine", "iters", 3),
    ("refine", "ray_mode", "analytic"), ("sensor", "ray_mode", "dda")])
def test_world_takes_exactly_what_the_reference_implements(group, key,
                                                           value):
    for iters in (0, 1, 2):
        World(tiny.ROOT, production_config(iters=iters), "cpu")
    World(tiny.ROOT, production_config(ess=None), "cpu")
    cfg = production_config()
    cfg["filter"][group][key] = value
    with pytest.raises(ValueError):
        World(tiny.ROOT, cfg, "cpu")


def test_the_reference_loads_nothing_of_jax_or_the_port():
    """A fresh interpreter runs the reference's production tick and lists
    the top-level modules it then holds."""
    code = (
        "import json, sys\n"
        "from mclbench.tests import test_bench_production as t\n"
        "from mclbench.tests import tiny\n"
        "from mclbench.world import World\n"
        "from mclbench.reference import filter as ref\n"
        "import torch\n"
        "w = World(tiny.ROOT, t.production_config(particles=16), 'cpu')\n"
        "st, gen = ref.init(w.mz, w.filter, 3, 2)\n"
        "d = ref.draw_tick(gen, w.mz, w.filter, 2)\n"
        "r = torch.full((2, 24), 0.5)\n"
        "ref.tick(st, torch.ones(2, 2), r, r > 0, w.angles, w.mz,\n"
        "         w.filter, d)\n"
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
