"""io/logs and the servers' checkpoint/restore on CPU tensors.

- EpisodeLog round-trips, and reads a log the JAX package wrote.
- save_state/load_state round-trip one filter and a batch, generator
  included, so a filter resumed from a checkpoint repeats the
  uninterrupted run bit for bit.
- MCLServer (with the KLD budget, raw scans among the frames) and
  MCLFleetServer restored from a checkpoint repeat the replies of the
  uninterrupted session exactly.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.io import logs as jlogs
from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.io import logs
from montecarlolocalisation_tpu_torch.io.fleet import MCLFleetServer
from montecarlolocalisation_tpu_torch.io.server import MCLServer
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import sensor
from montecarlolocalisation_tpu_torch.sim import robot

torch.set_num_threads(1)

N, BEAMS = 256, 8


def _world(**kw):
    return presets.make_world(num_particles=N, num_beams=BEAMS,
                              device="cpu", **kw)


def test_episode_log_round_trips_and_reads_jax_logs(tmp_path):
    rng = np.random.default_rng(0)
    arrays = dict(encoders=rng.random((5, 2)).astype(np.float32),
                  scan_ranges=rng.random((5, BEAMS)).astype(np.float32),
                  scan_angles=rng.random(BEAMS).astype(np.float32),
                  scan_mask=rng.random((5, BEAMS)) > 0.2,
                  true_poses=rng.random((5, 3)).astype(np.float32))
    for writer in (logs.EpisodeLog, jlogs.EpisodeLog):
        path = str(tmp_path / f"{writer.__module__}.npz")
        writer(**arrays, meta=dict(seed=3)).save(path)
        back = logs.EpisodeLog.load(path)
        assert back.num_ticks == 5 and back.meta == dict(seed=3)
        for k, v in arrays.items():
            np.testing.assert_array_equal(getattr(back, k), v)


def _states_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if dataclasses.is_dataclass(x):
            _states_equal(x, y)
        elif isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), f.name
        else:
            assert torch.equal(x.get_state(), y.get_state())


@pytest.mark.parametrize("batch", [None, 3])
def test_resume_from_a_checkpoint_is_bit_identical(tmp_path, batch):
    world = _world(ess_threshold=0.5, refine_iters=1,
                   resample_method="systematic")
    gen = torch.Generator()
    gen.manual_seed(2)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, 8, batch=batch or 1)
    if batch is None:
        enc, ranges = enc[0], ranges[0]
    state = tfilter.init_state(world.maze, world.cfg, seed=4, batch=batch)
    first, _ = tfilter.run_episode(state, enc[..., :4, :], ranges[..., :4, :],
                                   world.angles, world.maze, world.cfg)
    path = str(tmp_path / "state.npz")
    logs.save_state(path, first, dict(tick=4))
    straight, outs = tfilter.run_episode(first, enc[..., 4:, :],
                                         ranges[..., 4:, :], world.angles,
                                         world.maze, world.cfg)
    restored, extra = logs.load_state(path, "cpu")
    assert extra == dict(tick=4)
    resumed, routs = tfilter.run_episode(restored, enc[..., 4:, :],
                                         ranges[..., 4:, :], world.angles,
                                         world.maze, world.cfg)
    _states_equal(straight, resumed)
    for f in dataclasses.fields(outs):
        assert torch.equal(getattr(outs, f.name), getattr(routs, f.name))


def test_load_state_refuses_another_generator_type(tmp_path):
    world = _world()
    path = str(tmp_path / "s.npz")
    logs.save_state(path, tfilter.init_state(world.maze, world.cfg))
    with pytest.raises(ValueError, match="cpu generator"):
        logs.load_state(path, "meta")


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


def _frame(world, k, raw=False):
    pose = [1.25 + 0.03 * k, 1.25 + 0.01 * k, 0.1 * k]
    ranges = sensor.simulate_scan(world.maze, pose, world.angles,
                                  world.cfg.sensor).ranges.numpy()
    enc = dict(encoder_left=0.3 * (k + 1), encoder_right=0.32 * (k + 1))
    if not raw:
        return json.dumps(dict(enc, ranges=ranges.tolist()))
    # A raw scan whose beam_skip-th beams land on the table.
    skip = world.cfg.sensor.beam_skip
    full = np.repeat(ranges, skip)
    full[1::7] = np.nan
    return json.dumps(dict(enc, raw_scan=dict(
        ranges=[None if not np.isfinite(v) else float(v) for v in full],
        angle_min=-2.0, angle_increment=4.0 / len(full))))


def test_server_restore_repeats_the_session_exactly(tmp_path):
    world = _world(ess_threshold=0.5, resample_method="systematic")
    path = str(tmp_path / "server.npz")
    frames = [_frame(world, k, raw=k % 2 == 1) for k in range(10)]
    server = MCLServer(world.maze, world.cfg, world.angles, seed=3,
                       adapt=(64, 512), adapt_patience=2, adapt_mode="kld")
    first = _serve(server, frames[:5])
    # A budget below the KLD target at the checkpoint: the next tick runs
    # at 64 and grows the budget, restored or not.
    server._set_particle_count(64)
    first += _serve(server, [json.dumps(dict(cmd="checkpoint", path=path))])
    assert first[-1] == {"ok": True} and all("error" not in r
                                             for r in first)
    rest = _serve(server, frames[5:])
    again = _serve(server, [json.dumps(dict(cmd="restore", path=path))]
                   + frames[5:])
    assert again[0] == {"ok": True}
    assert again[1:] == rest
    assert [r["tick"] for r in rest] == [6, 7, 8, 9, 10]
    assert rest[0]["particles"] == 64 and rest[1]["particles"] == 512
    bad = _serve(server, [json.dumps(dict(cmd="restore",
                                          path=path + ".none"))])
    assert list(bad[0]) == ["error"]


def test_fleet_restore_repeats_the_session_exactly(tmp_path):
    world = _world()
    gen = torch.Generator()
    gen.manual_seed(1)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, 6, batch=3)
    frames = [json.dumps(dict(encoder_left=enc[:, k, 0].tolist(),
                              encoder_right=enc[:, k, 1].tolist(),
                              ranges=ranges[:, k].tolist()))
              for k in range(6)]
    path = str(tmp_path / "fleet.npz")
    fleet = MCLFleetServer(world.maze, world.cfg, world.angles, 3, seed=5,
                           pipeline=True)
    _serve(fleet, frames[:3] + [json.dumps(dict(cmd="checkpoint",
                                                path=path))])
    rest = _serve(fleet, frames[3:])
    again = _serve(fleet, [json.dumps(dict(cmd="restore", path=path))]
                   + frames[3:])
    assert again[0] == {"ok": True} and again[1:] == rest
    assert [r["tick"] for r in rest] == [4, 5, 6]
    one = MCLServer(world.maze, world.cfg, world.angles)
    with pytest.raises(ValueError, match="batch"):
        one.restore(path)
    with pytest.raises(ValueError, match="robots"):
        MCLFleetServer(world.maze, world.cfg, world.angles, 2).restore(path)
