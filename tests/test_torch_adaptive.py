"""io/server: the elastic and KLD particle budgets of the port's MCLServer
against the JAX package's.

- The adapt policy (`_lattice_size`, `_maybe_adapt`) on the same reply
  sequence takes the same particle counts, tick by tick, in both modes.
- A served session with `adapt` answers with the JAX server's keys and
  value types ("particles", "kld_target" included), and its counts stay
  on the halving lattice.
- The resize is resample.resize_particles with the state's generator.
- The CLI's --adapt flag serves, and is refused where it would change
  nothing.
"""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.io.server import MCLServer as JaxServer
from montecarlolocalisation_tpu.presets import make_world as jax_world
from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.io.server import MCLServer
from montecarlolocalisation_tpu_torch.models import sensor

torch.set_num_threads(1)

BEAMS = 8
ADAPT = (64, 1024)


def _servers(mode, patience=3):
    world = presets.make_world(num_particles=256, num_beams=BEAMS,
                               device="cpu")
    jw = jax_world(num_particles=256, num_beams=BEAMS)
    kw = dict(adapt=ADAPT, adapt_patience=patience, adapt_mode=mode)
    return (MCLServer(world.maze, world.cfg, world.angles, **kw),
            JaxServer(jw.maze, jw.cfg, jw.angles, **kw), world)


def _replies(rng, n):
    """A reply sequence: confident runs, a lost song, KLD targets from
    one particle to past n_max."""
    out = []
    for k in range(n):
        song = 1 if k in (17, 31) else (2 if k == 20 else 0)
        conf = float(rng.choice([0.2, 0.6, 0.9, 0.95])) if k % 7 else 0.1
        target = float(rng.choice([1.0, 30.0, 100.0, 300.0, 700.0, 5000.0]))
        out.append((dict(song=song, confidence=conf), target))
    return out


@pytest.mark.parametrize("mode", ["patience", "kld"])
def test_adapt_policy_matches_jax(mode):
    port, jax_server, _ = _servers(mode)
    assert port.num_particles == jax_server.num_particles == ADAPT[1]
    for target in (0.0, 1.0, 63.0, 64.0, 65.0, 127.9, 128.0, 500.0, 513.0,
                   1024.0, 1e6):
        assert port._lattice_size(target) == jax_server._lattice_size(target)
    rng = np.random.default_rng(0)
    counts = []
    for reply, target in _replies(rng, 60):
        port._maybe_adapt(reply, kld_target=target)
        jax_server._maybe_adapt(reply, kld_target=target)
        assert port.num_particles == jax_server.num_particles
        assert port._confident_run == jax_server._confident_run
        counts.append(port.num_particles)
    # The sequence walks the lattice down and snaps back to n_max.
    assert min(counts) < ADAPT[1] and counts.count(ADAPT[1]) > 1
    assert all(c in (64, 128, 256, 512, 1024) for c in counts)
    assert port.state.weights.shape == (port.num_particles,)


def _frames(world, n):
    lines = []
    for k in range(n):
        pose = [1.25 + 0.02 * k, 1.25, 0.05 * k]
        ranges = sensor.simulate_scan(world.maze, pose, world.angles,
                                      world.cfg.sensor).ranges
        lines.append(json.dumps(dict(encoder_left=0.3 * (k + 1),
                                     encoder_right=0.35 * (k + 1),
                                     ranges=[float(r) for r in ranges])))
    return lines


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
    server.serve(lines, out_stream=sink)
    return [json.loads(s) for s in sink.text.splitlines()]


def _types(v):
    return [_types(x) for x in v] if isinstance(v, list) else type(v)


@pytest.mark.parametrize("mode", ["patience", "kld"])
def test_adaptive_session_has_jax_keys_and_lattice_counts(mode):
    port, jax_server, world = _servers(mode, patience=2)
    lines = _frames(world, 8)
    got, want = _serve(port, lines), _serve(jax_server, lines)
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert {k: _types(v) for k, v in g.items()} == \
            {k: _types(v) for k, v in w.items()}
    assert ("kld_target" in got[0]) == (mode == "kld")
    assert got[0]["particles"] == ADAPT[1]
    assert all(r["particles"] in (64, 128, 256, 512, 1024) for r in got)


def test_resize_draws_from_the_state_generator():
    port, _, _ = _servers("patience")
    before = port.state.gen.get_state().clone()
    port._set_particle_count(128)
    assert port.num_particles == 128
    assert not torch.equal(before, port.state.gen.get_state())
    assert torch.allclose(port.state.weights, torch.full((128,), 1 / 128))
    port._set_particle_count(128)            # no-op at the same count
    assert port.num_particles == 128
    with pytest.raises(ValueError):
        MCLServer(port.m, port.cfg, port.angles, adapt=(512, 64))
    with pytest.raises(ValueError):
        MCLServer(port.m, port.cfg, port.angles, adapt=ADAPT,
                  adapt_mode="budget")


def _cli(*args, stdin=""):
    return subprocess.run(
        [sys.executable, "-m", "montecarlolocalisation_tpu_torch", *args,
         "--device", "cpu"], input=stdin, capture_output=True, text=True,
        timeout=300)


def test_adapt_cli_serves_and_refuses_misplaced_flags():
    world = presets.make_world(num_particles=256, num_beams=BEAMS,
                               device="cpu")
    lines = _frames(world, 3)
    r = _cli("serve", "--particles", "256", "--beams", str(BEAMS),
             "--adapt", "kld:64:512", "--ess", "0.5",
             stdin="\n".join(lines) + "\n")
    assert r.returncode == 0, r.stderr
    replies = [json.loads(s) for s in r.stdout.splitlines()]
    assert [x["particles"] for x in replies][0] == 512
    assert all("kld_target" in x for x in replies)
    for bad in (["sweep", "--adapt", "64:512"],
                ["serve", "--robots", "2", "--adapt", "64:512"],
                ["serve", "--adapt", "512:64"],
                ["serve", "--adapt", "lots"],
                ["serve", "--pipeline"]):
        r = _cli(*bad)
        assert r.returncode == 2 and "error" in r.stderr, bad
