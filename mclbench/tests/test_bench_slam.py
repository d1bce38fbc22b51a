"""RBPF SLAM on the CPU at a tiny size: the SLAM reference, its check
units, the slipping wander and the `slam` driver, in a cell added by
files alone ("slam-tiny": 2 episodes x 2 replicas x 8 particles, 49 x 49
maps, 24 beams, 20 ticks at 8 % slip, keyframes at 0.15 m / 0.5 rad, the
ESS gate at 0.7, through run_slam_episode).

- The port's slam_step and run_slam_episode agree with the reference:
  the particles, maps, weights, evidence, published poses and random
  stream.
- The cell runs correct and prints the contract's line, traced and
  untraced; the bfloat16 control and three faults planted in the port's
  tick come out not correct: l_free 1 % off, the maps updated past the
  keyframe gate, the maps not permuted with the resampled poses.
- Logs without slip and the four cells' checks are the parent's.
- World takes exactly the SLAM settings the reference implements.
- The reference loads neither JAX, nor the JAX package, nor the port.
"""
from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import subprocess
import sys

import pytest
import torch

from mclbench import compare, control, generator, harness
from mclbench.drivers import slam as slam_driver
from mclbench.reference import slam as ref_slam
from mclbench.world import SUPPORTED_SLAM, World

from . import fixed, tiny

CELL = "slam-tiny"
SEEDS = (2**31 + 7, 99, 123456789)
MAPPING = dict(height=49, width=49, resolution=0.1, origin_x=0.0,
               origin_y=0.0, l_occ=0.9, l_free=0.35, clamp=8.0,
               half_width=0.055, hit_margin=0.04, hit_depth=0.07,
               max_trusted_range=1.02)
# SLAMConfig's fields beside mapping, sensor and motion, as the published
# SLAM row sets them (BENCH_DETAILS.md:858-870).
FIELDS = dict(z_hit=0.85, z_rand=0.15, field_sigma_px=1.0,
              field_radius_px=4, z_short=0.5, free_samples=6,
              free_margin=0.18, alpha_scale=1.0, ess_threshold=0.7,
              refine_iters=0, refine_step_xy=0.01, refine_step_theta=0.01,
              proposal_candidates=1, keyframe_trans=0.15, keyframe_rot=0.5,
              closure=False, closure_xy_range=0.15, closure_xy_steps=7,
              closure_theta_range=0.1, closure_theta_steps=7,
              closure_margin=2.0, closure_gain=1.0, closure_min_beams=8,
              closure_max_turn=0.05, closure_cooldown=2,
              closure_theta_margin=1.0, dtype="float32")
# The parent's reference digests and check numbers of the four cells, and
# the digest of their slip-free logs (3 robots x 25 ticks), at
# tiny.make_root's size.
PARENT = [
    ("fleet64-10hz", 2147483653,
     "ec9bf1d81e21bdf2b5472401c902d7fdeacdc8997ef24e14fdd9cf673462aca7",
     "f16ba54f4ab79f4e2bf5f7e4ef906d6352f74087bc29cdb28f09b339f75aa6f4",
     [0.0, 0.0, 0.0, 0.0, 0, 0, 32, 256]),
    ("fleet64-10hz", 4242,
     "dcbed4632657780378278871f1775669640d9b9b92204551e3a22e27f7ba2bb2",
     "d5843f531cb1420f63b3de242d50a1162eb20e86274e3a0e772f25e98729147f",
     [0.0, 0.0, 0.0, 0.0, 0, 0, 32, 256]),
    ("global-1m", 2147483653,
     "8a8036a3e0c6d465e3490634178f40fc394519c3f6ca55945586e0c74e95b78c",
     "f16ba54f4ab79f4e2bf5f7e4ef906d6352f74087bc29cdb28f09b339f75aa6f4",
     [0.0, 0.0, 0.0, 0.0, 0, 0, 16, 512]),
    ("global-1m", 4242,
     "09ac3c0b98b51f4e82dd2003f05abff9785589951e8fcb3b610371b24e85a1c5",
     "d5843f531cb1420f63b3de242d50a1162eb20e86274e3a0e772f25e98729147f",
     [0.0, 0.0, 0.0, 0.0, 0, 0, 16, 512]),
    ("replay1024-ref", 2147483653,
     "c9e492ca3ffabed71ec8eb5a314b7fa4c652ed0ff5e763bf0ec19c0ccc165cae",
     "f16ba54f4ab79f4e2bf5f7e4ef906d6352f74087bc29cdb28f09b339f75aa6f4",
     [0.0, 0.0, 0.0, 0.0, 0, 0, 48, 384]),
    ("replay1024-ref", 4242,
     "ff0a563d695b10a2f8ee6315727a0451901cc6176addc1c606297c5c4f18881f",
     "d5843f531cb1420f63b3de242d50a1162eb20e86274e3a0e772f25e98729147f",
     [0.0, 0.0, 0.0, 0.0, 0, 0, 48, 384]),
    ("replay1024-production", 2147483653,
     "db102f2e308e6830decdace6657bfa0228e787df57a66df0e28c724a5fb01f00",
     "cb6817f63b921dd93b23a3280fd20eea190b9db1f4187e4c9b03f8e0a58c5e51",
     [0.0, 0.0, 0.0, 0.0, 0, 0, 48, 384]),
    ("replay1024-production", 4242,
     "55c1d0754a5756100a91df3aab1fad86fc58a14a7375fdb87af1ff501b91c451",
     "83bfd1694256784087ca60afac810f3d6a37a45bef165bbaa63c4591b1cce2c7",
     [0.0, 0.0, 0.0, 0.0, 0, 0, 48, 384]),
]
NUMBERS = ("rows_off", "pose_gap", "conf_gap", "weights_gap", "songs_off",
           "gen_off", "answers", "rows")
LIMITS = dict(rows_off=0.01, pose_gap=0.01, weights_gap=0.001,
              map_off=0.001, evidence_gap=0.01)
# Per-layer metrics a later cell would add as files: the traced ticks and
# the reading's two SLAM bounds.
METRICS = {
    "slam_ticks_traced": "def read(r):\n    return float(r.ticks)\n",
    "ism_bound_ms": "def read(r):\n"
                    "    return r.bounds.get('ism_ms_per_tick')\n",
    "slam_field_bound_ms":
        "def read(r):\n    return r.bounds.get('slam_field_ms_per_tick')\n",
}


def slam_config(particles: int = 8, keyframe=(0.15, 0.5), **fields):
    """A SLAM configuration on the reference maze's 49 x 49 grid, the
    sensor and motion of ref-1500x34, the published SLAM row's settings
    with `particles` particles."""
    with open(os.path.join(tiny.BENCH, "configs", "ref-1500x34.json")) as f:
        ref = json.load(f)["filter"]
    s = dict(num_particles=particles, mapping=dict(MAPPING),
             sensor=ref["sensor"], motion=ref["motion"], **FIELDS)
    s.update(keyframe_trans=keyframe[0], keyframe_rot=keyframe[1], **fields)
    return dict(name=CELL, slam=s, map="data/default_map.txt",
                beams=dict(count=24, min_deg=-118.0, max_deg=118.0))


def slam_traffic(episodes=2, replicas=2, ticks=20, segment_ticks=8):
    return dict(driver="slam", why="x", episodes=episodes,
                replicas=replicas, ticks=ticks, segment_ticks=segment_ticks,
                check_segments=2,
                wander=dict(speed=0.04, obstacle_stop=0.4, turn_ticks=10,
                            scan_noise=0.02, start_offset=0.2, slip=0.08),
                limits=dict(LIMITS))


def add_slam_cell(root: str, config: dict, traffic: dict) -> str:
    """The SLAM cell added to the checkout at `root` by files and entries
    alone: its configuration, its mix, three metric readers, and their
    BENCHMARK.json entries."""
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
            layer="slam: models/slam, models/mapping",
            moves="updates_per_s", workloads=[CELL]))
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return add_slam_cell(tiny.make_root(str(tmp_path_factory.mktemp(
        "bench"))), slam_config(), slam_traffic())


def _units(world, seed, program=None, episodes=2, replicas=2, ticks=24,
           seg=8):
    """Every segment of a pass over `ticks` ticks of slipping logs from
    the filter seed `seed`, each a compare.SLAMUnit; `program` (a
    SLAMProgram's class) replaces the port's entry."""
    from mclbench.program import SLAMProgram

    w = generator.Wander(slip=0.08)
    enc, ranges, _ = generator.logs(seed, world.mz, world.angles,
                                    world.sensor, world.motion, episodes,
                                    ticks, w)
    start = generator.starts(seed, world.mz, episodes, w)
    prog = (program or SLAMProgram)(world, episodes, replicas)
    st, units = None, []
    for t0 in range(0, ticks, seg):
        before = None if st is None else prog.snapshot(st)
        st, poses = prog.segment(st, seed, start, enc[:, t0:t0 + seg],
                                 ranges[:, t0:t0 + seg])
        last = t0 + seg >= ticks
        units.append(slam_driver._unit(dict(
            before=before, seed=seed, t0=t0, n=seg, pose=poses,
            after=prog.snapshot(st),
            chosen=prog.winners(st) if last else None), start, enc, ranges))
    return units


def _assert_exact(n):
    assert n["rows_off_count"] == 0 and n["map_off_count"] == 0, n
    assert n["weights_gap"] == 0.0 and n["evidence_gap"] == 0.0, n
    assert n["pose_gap"] == 0.0 and n["gen_off"] == 0, n
    assert n["kf_off"] == 0 and n["resample_off"] == 0, n
    assert n["chosen_off"] == 0, n


@pytest.mark.parametrize("keyframe", [(0.15, 0.5), (0.0, 0.0)])
def test_run_slam_episode_agrees_with_the_reference(keyframe):
    world = World(tiny.ROOT, slam_config(keyframe=keyframe), "cpu")
    for seed in SEEDS:
        n = compare.check(world, _units(world, seed))
        assert n["rows"] == 3 * 2 * 2 * 8 and n["filters"] == 12, n
        _assert_exact(n)


def test_slam_step_agrees_with_the_reference():
    """One tick at a time from the same state and generator: every field
    of the state and the published pose, bit for bit."""
    from mclbench.program import slam_config as port_config
    from montecarlolocalisation_tpu_torch.models import slam

    world = World(tiny.ROOT, slam_config(particles=16), "cpu")
    cfg = port_config(world.slam)
    w = generator.Wander(slip=0.08)
    enc, ranges, _ = generator.logs(11, world.mz, world.angles,
                                    world.sensor, world.motion, 3, 30, w)
    start = generator.starts(11, world.mz, 3, w)
    st = slam.init_slam(5, start, cfg, (3,), "cpu")
    rs, gen = ref_slam.init(world.slam, 5, start, (3,))
    mask = torch.ones(ranges[:, 0].shape, dtype=torch.bool)
    mapped = resampled = 0
    for t in range(30):
        st, info = slam.slam_step(st, enc[:, t, 0], enc[:, t, 1],
                                  ranges[:, t], world.angles, mask, cfg)
        d = ref_slam.draw(gen, world.slam, (3,), "cpu")
        rs, o = ref_slam.tick(rs, enc[:, t], ranges[:, t], mask,
                              world.angles, world.slam, d)
        got = ref_slam.from_program(st)
        for f in dataclasses.fields(ref_slam.State):
            assert torch.equal(getattr(got, f.name), getattr(rs, f.name)), \
                (t, f.name)
        assert torch.equal(info["pose"], o.pose)
        assert torch.equal(info["mapped"], o.mapped)
        assert torch.equal(info["resampled"], o.resampled)
        assert torch.equal(st.gen.get_state(), gen.get_state())
        mapped += int(o.mapped.sum())
        resampled += int(o.resampled.sum())
    # The stretch takes both branches of the keyframe and the ESS gates.
    assert 0 < mapped < 90 and 0 < resampled < 90


def _run(root, program=None, seed=2**31 + 99, trace=False):
    """One run of the cell; a traced one long enough to reach its
    profile."""
    out, err = io.StringIO(), io.StringIO()
    res = harness.run_cell(root, CELL, seed, 2.0 if trace else 0.5, trace,
                           "cpu",
                           program=program, out=out, err=err)
    return res, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("trace", [0, 1])
def test_the_slam_cell_added_by_files_runs_correct(root, trace):
    res, out, err = _run(root, trace=bool(trace))
    line = json.loads(out.strip().splitlines()[-1])
    assert line == json.loads(json.dumps(res))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"] and list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert set(line["checks"]) == set(LIMITS)
    assert line["diagnostics"]["gen_off"] == 0
    assert line["diagnostics"]["units"] >= 1
    tail = err.strip().splitlines()[-(len(LIMITS) + 1):]
    for k in LIMITS:
        assert any(t.startswith(f"check {k} = ") for t in tail)
    if trace:
        m = line["metrics"]
        assert set(m) == set(METRICS)
        assert m["slam_ticks_traced"]["value"] >= 2
        assert m["ism_bound_ms"]["value"] > 0
        assert m["slam_field_bound_ms"]["value"] > 0
        assert {"busy_s", "window_s"} <= set(line["device"])
    else:
        assert set(line["metrics"]) == {"updates_per_s", "setup_s"}
        d = line["diagnostics"]
        assert line["metrics"]["updates_per_s"]["value"] == pytest.approx(
            2 * 2 * 8 * 24 * d["ticks"] / d["window_s"])


def test_the_control_is_not_correct(root):
    res, _, _ = _run(root, control.factory("slam"))
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] > 0.5
    assert res["checks"]["map_off"]["value"] > LIMITS["map_off"]


def _faults():
    from montecarlolocalisation_tpu_torch.models import mapping, slam

    real = slam.slam_step

    def with_cfg(change):
        def step(state, enc_l, enc_r, ranges, angles, mask, cfg,
                 draws=None):
            return real(state, enc_l, enc_r, ranges, angles, mask,
                        change(cfg), draws)
        return step

    def l_free(cfg):
        return dataclasses.replace(cfg, mapping=dataclasses.replace(
            cfg.mapping, l_free=cfg.mapping.l_free * 1.01))

    def no_gate(cfg):
        return dataclasses.replace(cfg, keyframe_trans=0.0,
                                   keyframe_rot=0.0)

    def unpermuted(state, enc_l, enc_r, ranges, angles, mask, cfg,
                   draws=None):
        new, info = real(state, enc_l, enc_r, ranges, angles, mask, cfg,
                         draws)
        painted = mapping.update_map(
            state.logodds, new.poses, ranges.float()[..., None, :], angles,
            mask.float()[..., None, :], cfg.mapping, cfg.sensor)
        maps = torch.where(info["mapped"][..., None, None, None], painted,
                           state.logodds)
        return dataclasses.replace(new, logodds=maps), info

    return dict(l_free=(slam, "slam_step", with_cfg(l_free)),
                no_keyframe_gate=(slam, "slam_step", with_cfg(no_gate)),
                maps_not_permuted=(slam, "slam_step", unpermuted))


@pytest.mark.parametrize("kind", ["l_free", "no_keyframe_gate",
                                  "maps_not_permuted"])
def test_a_fault_is_not_correct(root, kind, monkeypatch):
    module, name, fault = _faults()[kind]
    monkeypatch.setattr(module, name, fault)
    res, _, _ = _run(root)
    assert res["correct"] is False, res["checks"]
    assert res["checks"]["map_off"]["value"] > LIMITS["map_off"]


def test_the_tiny_world_resamples_and_permutes_maps():
    """maps_not_permuted is seen only where a resample moves a map to
    another slot: the stretch's resamples change the maps' order."""
    world = World(tiny.ROOT, slam_config(), "cpu")
    moved = 0
    for u in _units(world, 2**31 + 99, ticks=16):
        st, outs, _ = compare.run_slam_reference(world, u)
        moved += sum(int(o.resampled.sum()) for o in outs)
    assert moved > 0


def test_slip_moves_the_robot_off_its_encoders():
    """With slip the encoders record the commanded arcs: dead reckoning
    from them leaves the true path; without, it follows it."""
    world = World(tiny.ROOT, slam_config(), "cpu")

    def drift(slip):
        w = generator.Wander(slip=slip)
        enc, _, poses = generator.logs(3, world.mz, world.angles,
                                       world.sensor, world.motion, 4, 40, w)
        odom = torch.cat([generator.starts(3, world.mz, 4, w),
                          torch.zeros(4, 2)], -1)
        for t in range(40):
            odom = ref_slam.odometry(odom, enc[:, t, 0], enc[:, t, 1],
                                     world.motion)[0]
        return float(torch.hypot(odom[:, 0] - poses[:, -1, 0],
                                 odom[:, 1] - poses[:, -1, 1]).max())

    assert drift(0.0) < 1e-3 < 0.01 < drift(0.08)


@pytest.mark.parametrize("workload,seed,digest,logs,numbers", PARENT)
def test_the_four_cells_check_as_on_the_parent(workload, seed, digest,
                                               logs, numbers, tmp_path):
    root = tiny.make_root(str(tmp_path))
    cell = harness.load_cell(root, workload)
    world = World(root, cell.config, "cpu")
    us = fixed.units(world, cell.traffic, seed)
    n = compare.check(world, us)
    assert [n[k] for k in NUMBERS] == numbers
    assert fixed.digest(world, us) == digest
    h = hashlib.sha256()
    for t in generator.logs(seed, world.mz, world.angles, world.sensor,
                            world.motion, 3, 25,
                            generator.Wander(**cell.traffic["wander"])):
        h.update(t.numpy().tobytes())
    assert h.hexdigest() == logs


def _all_supported():
    out = []
    for key, allowed in SUPPORTED_SLAM.items():
        for v in allowed:
            fields = (dict(zip(key, v)) if isinstance(key, tuple)
                      else {key: v})
            out.append(fields)
    return out


@pytest.mark.parametrize("fields", [
    dict(proposal_candidates=4), dict(refine_iters=2), dict(closure=True),
    dict(ess_threshold=0.5), dict(keyframe_trans=0.1, keyframe_rot=0.35),
    dict(keyframe_trans=0.15, keyframe_rot=0.0), dict(dtype="bfloat16")],
    ids=lambda f: "-".join(f"{k}={v}" for k, v in f.items()))
def test_world_takes_exactly_what_the_slam_reference_implements(fields):
    for ok in _all_supported():
        cfg = slam_config()
        cfg["slam"].update(ok)
        World(tiny.ROOT, cfg, "cpu")
    cfg = slam_config()
    cfg["slam"].update(fields)
    with pytest.raises(ValueError):
        World(tiny.ROOT, cfg, "cpu")


def test_world_refuses_a_map_the_program_reads_in_windows():
    cfg = slam_config()
    cfg["slam"]["mapping"].update(height=97, width=97)
    with pytest.raises(ValueError):
        World(tiny.ROOT, cfg, "cpu")


def test_the_slam_reference_loads_nothing_of_jax_or_the_port():
    """A fresh interpreter runs the SLAM reference's ticks and lists the
    top-level modules it then holds."""
    code = (
        "import sys, torch\n"
        "from mclbench.tests import test_bench_slam as t\n"
        "from mclbench.tests import tiny\n"
        "from mclbench.world import World\n"
        "from mclbench.reference import slam as ref\n"
        "w = World(tiny.ROOT, t.slam_config(particles=4), 'cpu')\n"
        "st, gen = ref.init(w.slam, 3, torch.tensor([1.2, 1.2, 0.0]),"
        " (2,))\n"
        "r = torch.full((2, 3, 24), 0.5)\n"
        "ref.run(st, gen, torch.ones(2, 3, 2), r, r > 0, w.angles,"
        " w.slam)\n"
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
