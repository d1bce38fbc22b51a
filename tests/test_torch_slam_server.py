"""io/server.SLAMServer and io/fleet.SLAMFleetServer on CPU tensors (the
JAX suite's tests/test_server.py:120-248 and tests/test_fleet.py:202-291
are the model).

- A server's replies equal run_slam_episode from the same seed, and its
  final state equals the episode's, bit for bit.
- A JSONL session has the JAX server's reply keys and value types, and
  its errors land on the same lines.
- export_map writes a PGM + YAML that the port's maps/pgm loader reads,
  with the fitted walls in the reply; checkpoint/restore repeats the
  next replies exactly; replica mode reports the replica with the most
  evidence.
- Robot r of a fleet equals a standalone server of seed seed * R + r, bit
  for bit; the fused map covers more than one robot's; reset_robot leaves
  the others untouched; a fleet checkpoint repeats its replies.
- `serve --slam-serve` answers a session, one robot and --robots 2, with
  128 SLAM particles whatever --particles says (the JAX CLI's
  behaviour).
- In replica mode (K = 2, P = 16) `stats` replies what the JAX server
  replies: particles = K, the state's leading size.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import MappingConfig as JMapping
from montecarlolocalisation_tpu.config import SLAMConfig as JSLAM
from montecarlolocalisation_tpu.io.server import SLAMServer as JaxSLAMServer
from montecarlolocalisation_tpu.presets import make_world as jax_world
from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.config import SLAMConfig
from montecarlolocalisation_tpu_torch.io.fleet import SLAMFleetServer
from montecarlolocalisation_tpu_torch.io.server import SLAMServer
from montecarlolocalisation_tpu_torch.maps import pgm
from montecarlolocalisation_tpu_torch.models import slam
from montecarlolocalisation_tpu_torch.sim import robot

torch.set_num_threads(1)

# P a multiple of 32: a batch then equals its filters one by one on the
# CPU (a torch CPU kernel's result can depend on where a value sits).
P, BEAMS, TICKS, R = 32, 12, 10, 3
START = (1.25, 1.25, 0.0)


def _world():
    return presets.make_world(num_particles=64, num_beams=BEAMS,
                              device="cpu")


def _cfg(world):
    return SLAMConfig(num_particles=P,
                      mapping=presets._mapping_config(world.maze),
                      sensor=world.cfg.sensor, motion=world.cfg.motion,
                      keyframe_trans=0.15, keyframe_rot=0.5)


def _episode(world, batch=R, ticks=TICKS):
    gen = torch.Generator()
    gen.manual_seed(4)
    enc, scans, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, ticks, batch=batch,
        start_pose=START, slip_noise=0.03, explore=True)
    return enc, scans


def _frame(enc, scans, k, r=0):
    return dict(encoder_left=float(enc[r, k, 0]),
                encoder_right=float(enc[r, k, 1]),
                ranges=scans[r, k].tolist())


class _Sink:
    def __init__(self):
        self.text = ""

    def write(self, s):
        self.text += s
        return len(s)

    def flush(self):
        pass


def _serve(server, lines):
    sink = _Sink()
    ticks = server.serve(lines, sink)
    return ticks, [json.loads(s) for s in sink.text.splitlines()]


def test_replies_equal_the_offline_episode_bit_for_bit():
    world = _world()
    cfg = _cfg(world)
    enc, scans = _episode(world, batch=1)
    server = SLAMServer(cfg, world.angles, seed=7, device="cpu")
    replies = [server.tick(**_frame(enc, scans, k)) for k in range(TICKS)]
    final, poses = slam.run_slam_episode(7, enc[0], scans[0], world.angles,
                                         cfg, START)
    assert [r["pose"] for r in replies] == [
        [round(float(v), 6) for v in p] for p in poses]
    st = server.state
    for f in ("poses", "logodds", "weights", "scores", "kf_pose",
              "log_evidence"):
        assert torch.equal(getattr(st, f), getattr(final, f)), f
    assert [r["tick"] for r in replies] == list(range(1, TICKS + 1))
    assert any(r["mapped"] for r in replies)


def _types(v):
    return [_types(x) for x in v] if isinstance(v, list) else type(v)


def test_session_matches_jax_server(tmp_path):
    world = _world()
    enc, scans = _episode(world, batch=1, ticks=3)
    lines = [json.dumps(_frame(enc, scans, k)) for k in range(3)]
    lines[1:1] = ['{"cmd": "stats"}', "not json",
                  '{"encoder_left": 0.1}', '{"cmd": "fly"}']
    lines += ['{"cmd": "reset", "seed": 2}', lines[0],
              json.dumps(dict(cmd="export_map", path=str(tmp_path / "m"))),
              '{"cmd": "shutdown"}', lines[0]]
    ticks, replies = _serve(SLAMServer(_cfg(world), world.angles,
                                       device="cpu"), lines)
    jw = jax_world(num_particles=64, num_beams=BEAMS)
    m = jw.maze
    jcfg = JSLAM(num_particles=P,
                 mapping=JMapping(height=m.height, width=m.width,
                                  resolution=float(m.resolution)),
                 sensor=jw.cfg.sensor, motion=jw.cfg.motion,
                 keyframe_trans=0.15, keyframe_rot=0.5)
    jserver = JaxSLAMServer(jcfg, jw.angles)
    sink = _Sink()
    jserver.serve(lines, sink)
    jreplies = [json.loads(s) for s in sink.text.splitlines()]
    assert ticks == jserver.tick_count == 1
    assert len(replies) == len(jreplies) == 11
    for got, want in zip(replies, jreplies):
        assert set(got) == set(want), (got, want)
        if "error" not in want:
            assert {k: _types(v) for k, v in got.items()
                    if k != "walls"} == {k: _types(v) for k, v in
                                         want.items() if k != "walls"}
    assert replies[1] == {"tick": 1, "particles": P}
    assert replies[2] == jreplies[2]            # the same bad-json text
    assert replies[5]["tick"] == 2 and replies[8]["tick"] == 1
    assert replies[7] == replies[10] == {"ok": True}
    # The learned maps differ (other draws); the wall rows' shape does not.
    assert [len(row) for row in replies[9]["walls"]] == \
        [len(row) for row in jreplies[9]["walls"]]


def test_export_checkpoint_and_replicas(tmp_path):
    world = _world()
    cfg = _cfg(world)
    enc, scans = _episode(world, batch=1)
    server = SLAMServer(cfg, world.angles, seed=1, device="cpu")
    for k in range(6):
        server.tick(**_frame(enc, scans, k))
    out = server.export_map(str(tmp_path / "learned.yaml"))
    assert out["ok"] and out["yaml"] == str(tmp_path / "learned.yaml")
    assert len(out["walls"]) == world.maze.n_rows
    back = pgm.from_pgm(out["yaml"], device="cpu")
    assert back.occ.shape == world.maze.occ.shape
    server.checkpoint(str(tmp_path / "c.npz"))
    after = [server.tick(**_frame(enc, scans, k)) for k in range(6, TICKS)]
    server.restore(str(tmp_path / "c.npz"))
    assert server.tick_count == 6
    assert [server.tick(**_frame(enc, scans, k))
            for k in range(6, TICKS)] == after
    rep = SLAMServer(cfg, world.angles, seed=1, replicas=3, device="cpu")
    for k in range(4):
        reply = rep.tick(**_frame(enc, scans, k))
    assert set(reply) == {"tick", "pose", "best_pose", "ess", "mapped",
                          "replica", "log_evidence"}
    ev = rep.state.log_evidence
    assert reply["replica"] == int(torch.argmax(ev))
    assert reply["log_evidence"] == [round(float(e), 2) for e in ev]
    assert rep.export_map(str(tmp_path / "r"))["ok"]


def test_fleet_robots_equal_standalone_servers_bit_for_bit(tmp_path):
    world = _world()
    cfg = _cfg(world)
    enc, scans = _episode(world)
    starts = [START, (1.2, 1.3, 0.0), (1.3, 1.2, 0.0)]
    fleet = SLAMFleetServer(cfg, world.angles, starts, seed=2, device="cpu")
    singles = [SLAMServer(cfg, world.angles, start_pose=starts[r],
                          seed=2 * R + r, device="cpu") for r in range(R)]
    for k in range(TICKS):
        reply = fleet.tick(enc[:, k, 0].numpy(), enc[:, k, 1].numpy(),
                           scans[:, k].numpy())
        for r in range(R):
            one = singles[r].tick(**_frame(enc, scans, k, r))
            for key in ("pose", "best_pose", "ess", "mapped"):
                assert reply[key][r] == one[key], (k, r, key)
    st = fleet.state
    for r in range(R):
        for f in ("poses", "logodds", "weights", "log_evidence"):
            assert torch.equal(getattr(st, f)[r],
                               getattr(singles[r].state, f)), (r, f)
    fused = fleet.fused_logodds()
    assert np.mean(np.abs(fused) > 0.5) > np.mean(
        np.abs(slam.best_map(singles[0].state).numpy()) > 0.5)
    assert fleet.export_map(str(tmp_path / "fused"))["ok"]
    # One robot redeployed; the others untouched.
    before = fleet.state
    fleet.reset_robot(1, seed=5)
    after = fleet.state
    assert torch.equal(after.logodds[0], before.logodds[0])
    assert not after.logodds[1].any()
    assert torch.equal(after.poses[1], torch.tensor(starts[1]).expand(P, 3))
    with pytest.raises(ValueError):
        fleet.reset_robot(R)
    fleet.checkpoint(str(tmp_path / "f.npz"))
    want = fleet.tick(enc[:, 0, 0].numpy(), enc[:, 0, 1].numpy(),
                      scans[:, 0].numpy())
    fleet.restore(str(tmp_path / "f.npz"))
    assert fleet.tick(enc[:, 0, 0].numpy(), enc[:, 0, 1].numpy(),
                      scans[:, 0].numpy()) == want
    _, replies = _serve(fleet, ['{"cmd": "stats"}',
                                '{"cmd": "reset", "robot": 0}',
                                json.dumps(dict(encoder_left=[0.1] * R,
                                                encoder_right=[0.1] * R,
                                                ranges=[[0.5] * BEAMS])),
                                '{"cmd": "shutdown"}'])
    assert replies[0] == {"tick": TICKS + 1, "robots": R}
    assert replies[1] == {"ok": True}
    assert replies[2]["error"].startswith("ValueError")


def _jax_cfg(particles):
    jw = jax_world(num_particles=64, num_beams=BEAMS)
    m = jw.maze
    return jw, JSLAM(num_particles=particles,
                     mapping=JMapping(height=m.height, width=m.width,
                                      resolution=float(m.resolution)),
                     sensor=jw.cfg.sensor, motion=jw.cfg.motion,
                     keyframe_trans=0.15, keyframe_rot=0.5)


def test_replica_stats_match_jax_server():
    world = _world()
    enc, scans = _episode(world, batch=1, ticks=2)
    lines = [json.dumps(_frame(enc, scans, k)) for k in range(2)]
    lines += ['{"cmd": "stats"}']
    cfg = SLAMConfig(num_particles=16,
                     mapping=presets._mapping_config(world.maze),
                     sensor=world.cfg.sensor, motion=world.cfg.motion,
                     keyframe_trans=0.15, keyframe_rot=0.5)
    _, replies = _serve(SLAMServer(cfg, world.angles, replicas=2,
                                   device="cpu"), lines)
    jw, jcfg = _jax_cfg(16)
    sink = _Sink()
    JaxSLAMServer(jcfg, jw.angles, replicas=2).serve(lines, sink)
    jreplies = [json.loads(x) for x in sink.text.splitlines()]
    assert replies[-1] == jreplies[-1] == {"tick": 2, "particles": 2}
    # One filter: the particles.
    _, replies = _serve(SLAMServer(cfg, world.angles, device="cpu"),
                        lines[2:])
    assert replies == [{"tick": 0, "particles": 16}]


@pytest.mark.parametrize("robots", [1, 2])
def test_serve_slam_cli(robots):
    world = _world()
    enc, scans = _episode(world, batch=robots, ticks=3)
    if robots == 1:
        lines = [json.dumps(_frame(enc, scans, k)) for k in range(3)]
    else:
        lines = [json.dumps(dict(encoder_left=enc[:, k, 0].tolist(),
                                 encoder_right=enc[:, k, 1].tolist(),
                                 ranges=scans[:, k].tolist()))
                 for k in range(3)]
    if robots == 1:
        lines.append('{"cmd": "stats"}')
    r = subprocess.run(
        [sys.executable, "-m", "montecarlolocalisation_tpu_torch", "serve",
         "--slam-serve", "--robots", str(robots), "--particles", "16",
         "--beams", str(BEAMS), "--device", "cpu"]
        + (["--slam-replicas", "2"] if robots == 1 else []),
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    replies = [json.loads(s) for s in r.stdout.splitlines()]
    if robots == 1:
        # --particles 16 is not the SLAM server's count: the JAX CLI sets
        # it for the slam preset only, and serve --slam-serve runs 128
        # (here in 2 replicas, which stats counts).
        assert replies.pop() == {"tick": 3, "particles": 2}
    assert [x["tick"] for x in replies] == [1, 2, 3]
    keys = {"tick", "pose", "best_pose", "ess", "mapped"}
    assert set(replies[0]) == (keys | {"replica", "log_evidence"}
                               if robots == 1 else keys)
    summary = json.loads(r.stderr.strip().splitlines()[-1])
    assert summary == dict(preset="serve", slam=True, robots=robots,
                           ticks=3)


def test_serve_slam_cli_particles_match_jax_cli():
    """serve --slam-serve --particles 16 runs 128 SLAM particles in both
    CLIs: --particles counts SLAM particles for the slam preset only (JAX
    __main__.py:133).  One replica, so stats counts the particles."""
    world = _world()
    enc, scans = _episode(world, batch=1, ticks=2)
    text = "\n".join([json.dumps(_frame(enc, scans, k)) for k in range(2)]
                     + ['{"cmd": "stats"}']) + "\n"
    argv = ["serve", "--slam-serve", "--particles", "16", "--beams",
            str(BEAMS), "--slam-replicas", "1"]
    stats = []
    for pkg, extra in (("montecarlolocalisation_tpu_torch",
                        ["--device", "cpu"]),
                       ("montecarlolocalisation_tpu", [])):
        r = subprocess.run([sys.executable, "-m", pkg, *argv, *extra],
                           input=text, capture_output=True, text=True,
                           timeout=300,
                           env=dict(os.environ, JAX_PLATFORMS="cpu"))
        assert r.returncode == 0, r.stderr[-2000:]
        out = r.stdout.strip().splitlines()
        assert len(out) == 3, out
        stats.append(json.loads(out[-1]))
    assert stats[0] == stats[1] == {"tick": 2, "particles": 128}
