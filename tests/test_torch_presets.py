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
