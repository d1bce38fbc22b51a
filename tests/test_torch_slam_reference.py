"""The port's RBPF SLAM against the benchmark's plain-torch SLAM
reference (mclbench/reference/slam.py), bit for bit on the CPU.

run_slam_episode over 2 episodes x 2 replicas of the benchmark's SLAM
configuration (mclbench/configs/rbpf-128x24.json at 8 particles: the
published SLAM row's keyframes, ESS gate and mapping on the reference
maze's 49 x 49 grid), 20 ticks of seeded random wander logs with 8 %
wheel slip, from each of three seeds: the particles, maps, weights,
scores, odometry, keyframe poses, log evidence, the published mean poses
a tick and the generator's state equal the reference's replay of the
same stream exactly.  The stage marks are called in their places
(`slam_motion`, `slam_field`, `slam_resample`, `slam_map`, `emit` each
tick; on the CPU a mark launches nothing) and change no value.  The
stretch maps and resamples, so both gates take both branches.
"""
import json
import os

import pytest
import torch

from mclbench import generator
from mclbench.program import slam_config
from mclbench.reference import slam as ref_slam
from mclbench.world import World
from montecarlolocalisation_tpu_torch.models import slam
from montecarlolocalisation_tpu_torch.utils import profiling

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
CONFIG = os.path.join(ROOT, "mclbench", "configs", "rbpf-128x24.json")
E, K, P, T = 2, 2, 8, 20
STAGES = ["slam_motion", "slam_field", "slam_resample", "slam_map", "emit"]


@pytest.fixture(scope="module")
def world():
    with open(CONFIG) as f:
        cfg = json.load(f)
    cfg["slam"]["num_particles"] = P
    return World(ROOT, cfg, "cpu")


@pytest.mark.parametrize("seed", [2**31 + 7, 99, 123456789])
def test_run_slam_episode_agrees_with_the_reference(world, seed,
                                                    monkeypatch):
    seen = []
    real = profiling.mark

    def mark(name, device):
        seen.append(name)
        real(name, device)

    monkeypatch.setattr(profiling, "mark", mark)
    w = generator.Wander(slip=0.08)
    enc, ranges, _ = generator.logs(seed, world.mz, world.angles,
                                    world.sensor, world.motion, E, T, w)
    start = generator.starts(seed, world.mz, E, w)
    final, poses = slam.run_slam_episode(
        seed, enc[:, None], ranges[:, None], world.angles,
        slam_config(world.slam), start[:, None, :], batch=(E, K),
        device="cpu")

    st, gen = ref_slam.init(world.slam, seed, start[:, None, :], (E, K))
    rg = ranges[:, None].expand(E, K, T, ranges.shape[-1])
    mask = torch.ones(rg.shape, dtype=torch.bool)
    st, outs = ref_slam.run(st, gen, enc[:, None].expand(E, K, T, 2), rg,
                            mask, world.angles, world.slam)

    got = ref_slam.from_program(final)
    for f in ("poses", "logodds", "weights", "scores", "odom", "kf_pose",
              "log_evidence"):
        assert torch.equal(getattr(got, f), getattr(st, f)), f
    assert torch.equal(poses, torch.stack([o.pose for o in outs], dim=2))
    assert torch.equal(final.gen.get_state(), gen.get_state())
    mapped = sum(int(o.mapped.sum()) for o in outs)
    resampled = sum(int(o.resampled.sum()) for o in outs)
    assert 0 < mapped < E * K * T and 0 < resampled < E * K * T
    # Every tick ran its marks in order, each graph's warm-up tick too,
    # and each of the three calls (8, 8 and 4 ticks) one begin and end.
    ticks = [n for n in seen if n in STAGES]
    assert len(ticks) >= T * len(STAGES)
    assert ticks == STAGES * (len(ticks) // len(STAGES))
    assert seen.count("begin") == seen.count("end") == 3
