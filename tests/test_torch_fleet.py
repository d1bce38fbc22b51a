"""io/fleet: the port's MCLFleetServer on CPU tensors.

- A JSONL session against the JAX package's fleet server: the replies
  have the same keys and value types, and the errors land on the same
  lines.
- `reset` of one robot leaves the other robots untouched.
- Robot r's reply equals a single-filter tick of robot r's state with the
  same draws.
- Pipelined replies lag by one tick and carry their own tick index.
- checkpoint/restore and raw_scans answer; their bad lines get error
  replies.
- The `serve --robots R --pipeline` CLI answers a session.
"""
import json
import subprocess
import sys

import numpy as np
import torch

from montecarlolocalisation_tpu.io.fleet import MCLFleetServer as JaxFleet
from montecarlolocalisation_tpu.presets import make_world as jax_world
from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.io.fleet import MCLFleetServer
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import sensor
from montecarlolocalisation_tpu_torch.sim import robot

from torch_parity import episode

torch.set_num_threads(1)

R, N, BEAMS, TICKS = 3, 128, 8, 3


def _world():
    return presets.make_world(num_particles=N, num_beams=BEAMS,
                              device="cpu")


def _frames(world, ticks=TICKS):
    gen = torch.Generator()
    gen.manual_seed(1)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, ticks, batch=R)
    return [dict(encoder_left=enc[:, k, 0].tolist(),
                 encoder_right=enc[:, k, 1].tolist(),
                 ranges=ranges[:, k].tolist()) for k in range(ticks)]


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
    ticks = server.serve(lines, out_stream=sink)
    return ticks, [json.loads(s) for s in sink.text.splitlines()]


def _types(v):
    return [_types(x) for x in v] if isinstance(v, list) else type(v)


def test_session_matches_jax_fleet():
    world = _world()
    frames = [json.dumps(f) for f in _frames(world)]
    masked = dict(json.loads(frames[1]), mask=[[1.0] * (BEAMS - 1) + [0.0]]
                  * R)
    lines = [frames[0], json.dumps(masked), json.dumps({"cmd": "stats"}),
             "{not json", json.dumps({"encoder_left": [0.1] * R}),
             json.dumps({"cmd": "fly"}),
             json.dumps({"cmd": "reset", "robot": 1, "seed": 4}), frames[2],
             json.dumps({"cmd": "reset", "seed": 2}), frames[0],
             json.dumps({"cmd": "shutdown"}), frames[1]]
    ticks, replies = _serve(MCLFleetServer(world.maze, world.cfg,
                                           world.angles, R), lines)
    jw = jax_world(num_particles=N, num_beams=BEAMS)
    jticks, jreplies = _serve(JaxFleet(jw.maze, jw.cfg, jw.angles, R),
                              lines)
    assert ticks == jticks == 1
    assert len(replies) == len(jreplies) == 11
    for got, want in zip(replies, jreplies):
        assert set(got) == set(want), (got, want)
        if "error" not in want:
            assert {k: _types(v) for k, v in got.items()} == \
                {k: _types(v) for k, v in want.items()}
    assert [r["tick"] for r in replies if "exact_pose" in r] == [1, 2, 3, 1]
    assert replies[3] == jreplies[3]                  # the same bad-json text
    assert replies[4]["error"].startswith("KeyError")
    assert replies[5] == {"error": "unknown cmd 'fly'"}
    assert replies[2]["n_robots"] == R and len(replies[2]["confidence"]) == R
    assert replies[0]["cell_pose"] == [[-1, -1, -1]] * R


def test_reset_robot_leaves_the_others_untouched():
    world = _world()
    fleet = MCLFleetServer(world.maze, world.cfg, world.angles, R, seed=3)
    for f in _frames(world, 2):
        fleet.tick(f["encoder_left"], f["encoder_right"], f["ranges"])
    before = fleet.state
    fleet.reset_robot(1, seed=5)
    after = fleet.state
    fresh = tfilter.init_state(world.maze, world.cfg, 5 * R + 1)
    for r in (0, 2):
        assert torch.equal(after.particles[r], before.particles[r])
        assert torch.equal(after.odom.x[r], before.odom.x[r])
        assert torch.equal(after.best_pose[r], before.best_pose[r])
    assert torch.equal(after.particles[1], fresh.particles)
    assert float(after.confidence[1]) == 0.0
    assert after.gen is before.gen


def test_robot_reply_equals_a_single_filter_tick():
    # The fleet draws its tick from its own generator: a copy of that
    # generator gives the same draws to the single-filter ticks.
    world = _world()
    fleet = MCLFleetServer(world.maze, world.cfg, world.angles, R, seed=0)
    for f in _frames(world):
        state0 = fleet.state
        gen = torch.Generator()
        gen.set_state(state0.gen.get_state())
        draws = tfilter.draw_tick(gen, world.maze, N, world.cfg, (R,))
        reply = fleet.tick(f["encoder_left"], f["encoder_right"],
                           f["ranges"])
        for r in range(R):
            scan = sensor.Scan(
                angles=torch.as_tensor(world.angles),
                ranges=torch.tensor(f["ranges"][r], dtype=torch.float32),
                mask=torch.ones(BEAMS, dtype=torch.bool))
            enc = np.float32([f["encoder_left"][r], f["encoder_right"][r]])
            one, out = tfilter.mcl_step(
                episode(state0, r), torch.tensor(enc[0]),
                torch.tensor(enc[1]), scan, world.maze, world.cfg,
                draws=episode(draws, r))
            assert torch.equal(fleet.state.particles[r], one.particles)
            assert reply["confidence"][r] == round(float(out.confidence), 6)
            assert reply["exact_pose"][r] == [round(float(v), 6)
                                              for v in out.exact_pose]
            assert reply["n_injected"][r] == int(out.n_injected)


def test_pipelined_replies_lag_one_tick():
    world = _world()
    frames = _frames(world)
    sync = MCLFleetServer(world.maze, world.cfg, world.angles, R, seed=2)
    pipe = MCLFleetServer(world.maze, world.cfg, world.angles, R, seed=2,
                          pipeline=True)
    want = [sync.tick(f["encoder_left"], f["encoder_right"], f["ranges"])
            for f in frames]
    got = [pipe.tick(f["encoder_left"], f["encoder_right"], f["ranges"])
           for f in frames]
    assert got[0] is None
    assert got[1:] == want[:-1]
    assert pipe.flush() == want[-1]
    assert pipe.flush() is None
    # In a session, a command drains the tick in flight first.
    lines = [json.dumps(frames[0]), json.dumps({"cmd": "stats"})]
    _, replies = _serve(MCLFleetServer(world.maze, world.cfg, world.angles,
                                       R, seed=2, pipeline=True), lines)
    assert [("tick" in r, "exact_pose" in r) for r in replies] == \
        [(True, True), (True, False)]


def test_unported_commands_and_raw_scans_get_error_replies(tmp_path):
    # checkpoint, restore and raw_scans are ported now: they answer, and
    # only a bad line of theirs (a missing checkpoint, too few raw scans)
    # or an unknown command gets an error reply.
    world = _world()
    raw = dict(encoder_left=[0.0] * R, encoder_right=[0.0] * R,
               raw_scans=[dict(ranges=[0.5] * 10, angle_min=-1.0,
                               angle_increment=0.2)] * R)
    short = dict(raw, raw_scans=raw["raw_scans"][:1])
    path = str(tmp_path / "fleet.npz")
    lines = [json.dumps({"cmd": "checkpoint", "path": path}),
             json.dumps({"cmd": "restore", "path": path}),
             json.dumps(raw), json.dumps(short),
             json.dumps({"cmd": "restore", "path": path + ".missing"}),
             json.dumps({"cmd": "fly"}), json.dumps({"cmd": "shutdown"})]
    ticks, replies = _serve(MCLFleetServer(world.maze, world.cfg,
                                           world.angles, R), lines)
    assert ticks == 1
    assert replies[0] == replies[1] == {"ok": True}
    assert replies[2]["tick"] == 1 and len(replies[2]["confidence"]) == R
    assert [sorted(r) for r in replies[3:6]] == [["error"]] * 3
    assert "1 raw scans" in replies[3]["error"]
    assert replies[5] == {"error": "unknown cmd 'fly'"}
    assert replies[6] == {"ok": True}


def test_serve_fleet_cli():
    world = _world()
    lines = [json.dumps(f) for f in _frames(world)]
    r = subprocess.run(
        [sys.executable, "-m", "montecarlolocalisation_tpu_torch", "serve",
         "--robots", str(R), "--pipeline", "--particles", str(N), "--beams",
         str(BEAMS), "--device", "cpu"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    replies = [json.loads(s) for s in r.stdout.splitlines()]
    assert [x["tick"] for x in replies] == [1, 2, 3]
    summary = json.loads(r.stderr.strip().splitlines()[-1])
    assert summary["robots"] == R and summary["ticks"] == TICKS
    assert len(summary["final_confidence"]) == R
