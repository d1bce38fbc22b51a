"""The port's localisation and moving presets, its CLI lines and `--map`.

- The default maze and the challenge preset's gold and pickup files are
  the port's own copies, byte-equal to the JAX package's, and
  presets.DEFAULT_MAP points at the copy.
- run_moving equals the JAX package's exactly: the wanderer's path reads
  only the noise-free forward ray, so no random draw reaches it.
- run_localisation runs the filter on the wander (its draws are torch's).
- The CLI's localisation and moving lines carry the keys of the JAX CLI's
  (__main__.py:151-164, :182-185), and `--map` takes a map_server YAML.
- run_planning and run_challenge plan what the JAX presets plan (the BFS
  path, the mission's legs and gold cost, the same cells driven from the
  first cell's centre) and drive it closed-loop; the CLI's planning and
  challenge lines carry the JAX CLI's keys (__main__.py:165-181) and its
  plan, legs and tsp_gold_cost.
- The replay fixture is the port's own byte-equal copy.
- _maze_from_wall_tensor builds JAX's maze; run_mapping and run_slam (at
  small sizes) return the keys of the JAX presets (presets.py:175-606),
  and the CLI's mapping and slam lines carry the JAX CLI's keys
  (__main__.py:193-232) with the flags passed through, `--explore`
  among them; an unknown explore_mode, `--slam-replicas` under a
  non-wander explorer and `--explore` outside the slam preset are
  refused (tests/test_torch_frontier.py runs the frontier explorer).
"""
import json
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu import presets as jpresets
from montecarlolocalisation_tpu.planning import bfs as jbfs
from montecarlolocalisation_tpu.planning import mission as jmission
from montecarlolocalisation_tpu.sim import closed_loop as jcl
from montecarlolocalisation_tpu_torch import __main__ as tmain
from montecarlolocalisation_tpu_torch import presets as tpresets
from montecarlolocalisation_tpu_torch.maps import pgm as tpgm

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
LOCALISATION_KEYS = {"preset", "confidence", "best_pose", "true_pose",
                     "position_error_m", "songs"}
MOVING_KEYS = {"preset", "ticks", "distance_m", "final_pose"}
PLANNING_KEYS = {"preset", "plan", "waypoints_reached", "waypoints_total",
                 "final_confidence"}
CHALLENGE_KEYS = {"preset", "tsp_gold_cost", "legs", "waypoints_reached"}
RELOC_KEYS = {"reloc_converged_frac", "reloc_median_error_m",
              "reloc_in_coverage_n", "reloc_in_coverage_frac"}
MAPPING_KEYS = {"preset", "robots", "ticks_per_robot", "explored_frac",
                "precision", "recall", "f1"} | RELOC_KEYS
SLAM_KEYS = {"preset", "particles", "ticks", "slip_noise", "explore_mode",
             "slam_final_err_m", "explored_edge_frac", "precision_explored",
             "recall_explored", "f1_explored", "precision", "recall", "f1",
             "dead_reckon_final_err_m", "track_on_learned_frac",
             "track_median_error_m", "track_in_coverage_n",
             "track_in_coverage_frac",
             "track_to_coverage_edge_frac"} | RELOC_KEYS
MISSION_KEYS = {"mission_waypoints_reached", "mission_waypoints_total",
                "mission_legs"}


@pytest.mark.parametrize("name", ["DEFAULT_MAP", "DEFAULT_GOLD",
                                  "DEFAULT_PICKUP"])
def test_map_data_is_the_ports_own_byte_equal_copy(name):
    ours, theirs = getattr(tpresets, name), getattr(jpresets, name)
    assert osp.dirname(ours) == osp.join(
        ROOT, "montecarlolocalisation_tpu_torch", "maps")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_run_moving_equals_jax():
    jworld = jpresets.make_world(num_particles=64)
    tworld = tpresets.make_world(num_particles=64, device="cpu")
    want = jpresets.run_moving(jworld, seed=0, num_ticks=80)
    got = tpresets.run_moving(tworld, seed=0, num_ticks=80)
    assert got == want


def test_run_localisation_runs_the_filter():
    world = tpresets.make_world(num_particles=256, device="cpu")
    final, outs, truth = tpresets.run_localisation(world, seed=1,
                                                   num_ticks=30)
    assert final.particles.shape == (256, 3)
    assert outs.confidence.shape == (30,) and truth.shape == (30, 3)
    assert torch.isfinite(final.particles).all()
    assert torch.allclose(truth[0, :2], torch.tensor([2.09, 2.05]),
                          atol=0.05)


def _cli(*args):
    r = subprocess.run([sys.executable, "-m",
                        "montecarlolocalisation_tpu_torch", *args,
                        "--device", "cpu"], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return json.loads(r.stdout.strip().splitlines()[-1])


def test_cli_localisation_and_moving_lines(tmp_path):
    line = _cli("localisation", "--particles", "128", "--ticks", "20")
    assert set(line) == LOCALISATION_KEYS
    assert line["preset"] == "localisation"
    assert len(line["best_pose"]) == 3 and len(line["true_pose"]) == 3
    moving = _cli("moving", "--ticks", "40")
    assert set(moving) == MOVING_KEYS and moving["ticks"] == 40
    assert moving == dict(preset="moving", **jpresets.run_moving(
        jpresets.make_world(), num_ticks=40))


def test_cli_map_takes_a_yaml(tmp_path):
    src = tpresets.make_world(device="cpu").maze
    yaml = str(tmp_path / "maze.yaml")
    tpgm.export_map(src, str(tmp_path / "maze.pgm"), yaml)
    a = _cli("moving", "--ticks", "30", "--map", yaml)
    assert a == dict(preset="moving", **tpresets.run_moving(
        tpresets.make_world(device="cpu"), num_ticks=30))
    line = _cli("localisation", "--particles", "64", "--ticks", "5",
                "--map", yaml)
    assert set(line) == LOCALISATION_KEYS
    assert np.isfinite(line["confidence"])


def _jax_mission():
    walls = jpresets.make_world().walls
    return walls, jmission.plan_mission(
        walls, (5, 0), jmission.load_waypoints(jpresets.DEFAULT_GOLD),
        jmission.load_waypoints(jpresets.DEFAULT_PICKUP))


def test_run_planning_plans_as_jax():
    world = tpresets.make_world(num_particles=64, device="cpu")
    path, final, outs = tpresets.run_planning(world, seed=1, num_ticks=12)
    want = jbfs.bfs_path(jpresets.make_world().walls, (2, 2), (4, 4))
    assert path == want and len(want) - 1 == 4
    assert outs.true_pose.shape == (12, 3) and final.robot.x.shape == ()
    # The robot starts at the first cell's centre, heading 0.
    first = jcl.mission_waypoints(want)[0]
    assert torch.allclose(outs.true_pose[0, :2], torch.as_tensor(first),
                          atol=0.05)
    assert torch.isfinite(outs.true_pose).all()


def test_run_challenge_plans_as_jax():
    world = tpresets.make_world(num_particles=64, device="cpu")
    plan, final, outs = tpresets.run_challenge(world, seed=0, num_ticks=10)
    _, want = _jax_mission()
    assert plan.gold_cost == want.gold_cost
    assert [(l.goal, l.path) for l in plan.legs] == [(l.goal, l.path)
                                                    for l in want.legs]
    cells = 1 + sum(len(l.path) - 1 for l in want.legs)
    assert cells - 1 == 17                      # driven waypoints
    assert outs.wp_idx.shape == (10,) and int(final.wp_idx) >= 0


def test_cli_planning_and_challenge_lines():
    line = _cli("planning", "--particles", "64", "--ticks", "10")
    assert set(line) == PLANNING_KEYS and line["preset"] == "planning"
    want = jbfs.bfs_path(jpresets.make_world().walls, (2, 2), (4, 4))
    assert line["plan"] == [list(c) for c in want]
    assert line["waypoints_total"] == 4
    assert 0 <= line["waypoints_reached"] <= 4
    assert np.isfinite(line["final_confidence"])
    line = _cli("challenge", "--particles", "64", "--ticks", "10")
    assert set(line) == CHALLENGE_KEYS and line["preset"] == "challenge"
    _, plan = _jax_mission()
    assert line["tsp_gold_cost"] == plan.gold_cost
    assert line["legs"] == [list(l.goal) for l in plan.legs]


def test_replay_fixture_is_the_ports_own_byte_equal_copy():
    from montecarlolocalisation_tpu_torch.tools import render_episode

    ours = render_episode.FIXTURE
    assert osp.dirname(ours) == osp.join(
        ROOT, "montecarlolocalisation_tpu_torch", "data")
    theirs = osp.join(ROOT, "montecarlolocalisation_tpu", "data",
                      "replay_6x6.npz")
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()


def test_maze_from_wall_tensor_equals_jax():
    rng = np.random.RandomState(0)
    walls = rng.uniform(size=(6, 6, 4)) < 0.4
    want = jpresets._maze_from_wall_tensor(walls)
    got = tpresets._maze_from_wall_tensor(walls, device="cpu")
    for f in ("occ", "occ_dilated", "walls", "row_lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_run_mapping_and_run_slam_return_the_jax_keys(tmp_path):
    world = tpresets.make_world(num_particles=32, device="cpu")
    out = tpresets.run_mapping(world, seed=0, num_ticks=40, robots=2,
                               relocalize=False,
                               export=str(tmp_path / "learned"))
    assert set(out) == (MAPPING_KEYS - RELOC_KEYS - {"preset"}) | {
        "exported"}
    assert out["robots"] == 2 and 0.0 < out["explored_frac"] < 1.0
    assert 0.0 <= out["f1"] <= 1.0
    learned = tpgm.from_pgm(out["exported"], device="cpu")
    assert learned.occ.shape == world.maze.occ.shape
    odom = tpresets.run_mapping(world, seed=0, num_ticks=40, robots=2,
                                relocalize=False, pose_source="odom",
                                slip_noise=0.03)
    assert np.isfinite(odom["f1"])
    with pytest.raises(ValueError, match="pose_source"):
        tpresets.run_mapping(world, pose_source="gps")
    out = tpresets.run_slam(world, seed=0, num_ticks=30, num_particles=8,
                            replicas=2, mission=True, mission_ticks=20)
    assert set(out) == (SLAM_KEYS | MISSION_KEYS) - {"preset"}
    assert out["particles"] == 8 and out["ticks"] == 30
    for k in ("slam_final_err_m", "dead_reckon_final_err_m", "f1",
              "track_median_error_m"):
        assert np.isfinite(out[k]), k
    with pytest.raises(ValueError, match="unknown explore_mode"):
        tpresets.run_slam(world, explore_mode="spiral")


def _main(capsys, *argv):
    tmain.main(list(argv) + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_mapping_line(capsys):
    line = _main(capsys, "mapping", "--ticks", "20", "--robots", "2",
                 "--particles", "16")
    assert set(line) == MAPPING_KEYS and line["preset"] == "mapping"
    assert line["robots"] == 2 and line["ticks_per_robot"] == 20


def test_cli_slam_line_passes_its_flags(capsys, monkeypatch):
    """The slam preset's line: its keys come from run_slam (held above),
    the flags reach it, and SLAM's --particles is its own."""
    seen = {}

    def fake_run_slam(world, **kw):
        seen.update(kw, world_particles=world.cfg.num_particles)
        return {k: 0.5 for k in SLAM_KEYS - {"preset"}}

    monkeypatch.setattr(tpresets, "run_slam", fake_run_slam)
    line = _main(capsys, "slam", "--ticks", "30", "--particles", "64",
                 "--slam-replicas", "2", "--slip", "0.08",
                 "--keyframe", "0.1:0.35", "--mission",
                 "--slam-candidates", "3")
    assert set(line) == SLAM_KEYS and line["preset"] == "slam"
    assert seen == dict(seed=0, num_ticks=30, num_particles=64,
                        slip_noise=0.08, mission=True, export=None,
                        proposal_candidates=3, replicas=2,
                        explore_mode="wander", keyframe=(0.1, 0.35),
                        world_particles=1500)
    seen.clear()
    _main(capsys, "slam")
    assert (seen["num_ticks"], seen["num_particles"], seen["slip_noise"],
            seen["replicas"]) == (1000, 128, 0.03, 4)
    assert "keyframe" not in seen        # run_slam's default, 0.15:0.5


@pytest.mark.parametrize("argv,message", [
    (["localisation", "--explore", "frontier"], "--explore applies"),
    (["slam", "--explore", "hybrid", "--slam-replicas", "2"],
     "wander explorer only"),
    (["mapping", "--mission"], "--mission applies"),
    (["localisation", "--slip", "0.1"], "--slip applies"),
    (["serve", "--slam-serve", "--robots", "2", "--slam-replicas", "2"],
     "--slam-replicas applies"),
    (["slam", "--keyframe", "0.1"], "TRANS:ROT"),
])
def test_cli_refuses_flags_that_change_nothing(capsys, argv, message):
    with pytest.raises(SystemExit):
        tmain.main(argv + ["--device", "cpu"])
    assert message in capsys.readouterr().err
