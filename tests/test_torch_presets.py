"""The port's localisation and moving presets, its CLI lines and `--map`.

- The default maze and the challenge preset's gold and pickup files are
  the port's own copies, byte-equal to the JAX package's, and
  presets.DEFAULT_MAP points at the copy.
- run_moving equals the JAX package's exactly: the wanderer's path reads
  only the noise-free forward ray, so no random draw reaches it.
- run_localisation runs the filter on the wander (its draws are torch's).
- The CLI's localisation and moving lines carry the keys of the JAX CLI's
  (__main__.py:151-164, :182-185), and `--map` takes a map_server YAML.
"""
import json
import os.path as osp
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu import presets as jpresets
from montecarlolocalisation_tpu_torch import presets as tpresets
from montecarlolocalisation_tpu_torch.maps import pgm as tpgm

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
LOCALISATION_KEYS = {"preset", "confidence", "best_pose", "true_pose",
                     "position_error_m", "songs"}
MOVING_KEYS = {"preset", "ticks", "distance_m", "final_pose"}


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
