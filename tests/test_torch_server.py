"""The port's MCLServer on CPU tensors against the JAX package's server:
one JSONL session with sensor frames (one masked), `stats`, a line that is
not JSON, a frame missing a key, an unknown command, `reset` and
`shutdown`.  The replies must have the same keys and value types, the
errors must land on the same lines, and the tick count must be right.  The
serve CLI preset answers the same session."""
import json
import subprocess
import sys

import numpy as np
import torch

from montecarlolocalisation_tpu.io.server import MCLServer as JaxServer
from montecarlolocalisation_tpu.presets import make_world as jax_world
from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.io.server import MCLServer
from montecarlolocalisation_tpu_torch.models import sensor

torch.set_num_threads(1)

N, BEAMS = 256, 8


def _session():
    world = presets.make_world(num_particles=N, num_beams=BEAMS,
                               device="cpu")
    lines = []
    for k in range(3):
        ranges = sensor.simulate_scan(world.maze, [1.25 + 0.02 * k, 1.25, 0.0],
                                      world.angles, world.cfg.sensor).ranges
        frame = dict(encoder_left=0.3 * (k + 1), encoder_right=0.3 * (k + 1),
                     ranges=[float(r) for r in ranges])
        if k == 1:
            frame["mask"] = [1.0] * (BEAMS - 2) + [0.0, 0.0]
        lines.append(json.dumps(frame))
    lines[2:2] = [json.dumps({"cmd": "stats"}), "{not json",
                  json.dumps({"encoder_left": 0.1, "ranges": [0.5] * BEAMS}),
                  json.dumps({"cmd": "fly"})]
    lines += ["", json.dumps({"cmd": "reset", "seed": 2}), lines[0],
              json.dumps({"cmd": "shutdown"}), lines[1]]
    return world, lines


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


def test_session_matches_jax_server():
    world, lines = _session()
    ticks, replies = _serve(MCLServer(world.maze, world.cfg, world.angles,
                                      seed=0), lines)
    jw = jax_world(num_particles=N, num_beams=BEAMS)
    jticks, jreplies = _serve(JaxServer(jw.maze, jw.cfg, jw.angles, seed=0),
                              lines)
    assert ticks == jticks == 1        # reset zeroed the count; one more tick
    assert len(replies) == len(jreplies) == 10
    for got, want in zip(replies, jreplies):
        assert set(got) == set(want), (got, want)
        if "error" not in want:
            assert {k: _types(v) for k, v in got.items()} == \
                {k: _types(v) for k, v in want.items()}
    assert [r["tick"] for r in replies if "exact_pose" in r] == [1, 2, 3, 1]
    assert replies[2] == {"tick": 2, "confidence": replies[2]["confidence"]}
    assert replies[3] == jreplies[3]                  # the same bad-json text
    assert replies[4]["error"].startswith("KeyError")
    assert replies[5] == {"error": "unknown cmd 'fly'"}
    assert replies[7] == {"ok": True} and replies[9] == {"ok": True}
    first = replies[0]
    assert first["exact_pose"] == [-1.0, -1.0, -1.0]  # nothing published yet
    assert first["cell_pose"] == [-1, -1, -1]


def test_serve_cli():
    _, lines = _session()
    r = subprocess.run(
        [sys.executable, "-m", "montecarlolocalisation_tpu_torch", "serve",
         "--particles", str(N), "--beams", str(BEAMS), "--seed", "1",
         "--device", "cpu"],
        input="\n".join(lines) + "\n", capture_output=True, text=True,
        timeout=300)
    assert r.returncode == 0, r.stderr
    replies = [json.loads(s) for s in r.stdout.splitlines()]
    assert len(replies) == 10
    assert sum("exact_pose" in x for x in replies) == 4
    summary = json.loads(r.stderr.strip().splitlines()[-1])
    assert summary["preset"] == "serve" and summary["ticks"] == 1
