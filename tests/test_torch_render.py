"""The port's render tool (montecarlolocalisation_tpu_torch/tools/
render_episode.py) on the CPU, checked as tests/test_tools.py:27-72
checks the JAX tool: frames at ticks 0, every, 2 every, ... and the last,
of the map's shape times the scale, uint8 RGB, changing over the episode;
the strip's PPM header and width.  Each of the four sources runs (the
replay fixture, a simulated wander with a kidnap, the closed loop with its
APF panel, SLAM), and a SLAM frame of a given log-odds grid and poses is
byte-equal to the JAX tool's.
"""
import os.path as osp
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.config import FilterConfig
from montecarlolocalisation_tpu_torch.io.logs import EpisodeLog
from montecarlolocalisation_tpu_torch.tools import render_episode as tool

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOOLS = osp.join(ROOT, "tools")


@pytest.fixture(scope="module")
def jax_tool():
    sys.path.insert(0, TOOLS)
    try:
        import render_episode as mod
    finally:
        sys.path.remove(TOOLS)
    return mod


def _maze():
    return presets.make_world(device="cpu").maze


def _check_frames(frames, labels, want_labels, shape):
    assert labels == want_labels
    assert len(frames) == len(labels)
    assert all(f.shape == shape and f.dtype == np.uint8 for f in frames)
    assert any(not np.array_equal(frames[0], f) for f in frames[1:])


def test_log_replay_frames(tmp_path):
    m = _maze()
    log = EpisodeLog.load(tool.FIXTURE)
    log = EpisodeLog(encoders=log.encoders[:12],
                     scan_ranges=log.scan_ranges[:12],
                     scan_angles=log.scan_angles,
                     true_poses=log.true_poses[:12])
    cfg = FilterConfig(num_particles=128)
    frames, labels = tool.run_and_capture(m, cfg, log, every=4, scale=2)
    h, w = m.occ.shape
    _check_frames(frames, labels, [0, 4, 8, 11], (2 * h, 2 * w, 3))
    strip = str(tmp_path / "strip.ppm")
    tool.save_strip(frames, strip, max_frames=3)
    with open(strip, "rb") as f:
        data = f.read()
    assert data[:2] == b"P6" and f"{3 * 2 * w} {2 * h}".encode() in data


def test_simulated_kidnap_frames():
    m = _maze()
    cfg = FilterConfig(num_particles=128)
    log = tool.simulated_log(m, cfg, num_ticks=13, seed=0, beams=8,
                             kidnap=6)
    assert log.encoders.shape == (13, 2) and log.scan_ranges.shape == (13, 8)
    # The truth jumps to the kidnap pose at tick 6 (and moves on from it
    # within that tick).
    np.testing.assert_allclose(log.true_poses[6, :2], (3.65, 3.65),
                               atol=0.05)
    assert np.hypot(*(log.true_poses[6, :2] - log.true_poses[5, :2])) > 1.0
    frames, labels = tool.run_and_capture(m, cfg, log, every=4, scale=2)
    h, w = m.occ.shape
    _check_frames(frames, labels, [0, 4, 8, 12], (2 * h, 2 * w, 3))


def test_cli_kidnap_needs_simulate(capsys):
    with pytest.raises(SystemExit):
        tool.main(["--log", "--kidnap", "5", "--device", "cpu"])
    assert "--kidnap applies to --simulate" in capsys.readouterr().err


def test_closed_loop_frames():
    m = _maze()
    frames, labels = tool.run_closed_loop_capture(
        m, FilterConfig(num_particles=64), num_ticks=12, seed=0, every=4,
        scale=2, beams=8)
    h, w = m.occ.shape
    assert labels == [0, 4, 8]
    # The map frame, then the APF panel beside it.
    assert all(f.shape[0] == 2 * h and f.shape[1] > 2 * w for f in frames)
    assert all(f.dtype == np.uint8 for f in frames)


def test_slam_frames():
    m = _maze()
    frames, labels = tool.run_slam_capture(m, num_ticks=10, seed=0, every=4,
                                           scale=2, beams=8)
    h, w = m.occ.shape
    _check_frames(frames, labels, [0, 4, 8, 9], (2 * h, 2 * w, 3))


def test_slam_frame_is_byte_equal_to_the_jax_tools(jax_tool, monkeypatch):
    """The JAX tool renders a given grid and estimate (its best_map and
    slam_step stubbed to return them) over its own wander's truth; the
    port renders the same inputs."""
    from montecarlolocalisation_tpu.config import FilterConfig as JFilter
    from montecarlolocalisation_tpu.maps import from_map_file
    from montecarlolocalisation_tpu.models import slam as jslam
    from montecarlolocalisation_tpu.sim import robot as jrobot

    rng = np.random.RandomState(0)
    grid = rng.uniform(-9, 9, (49, 49)).astype(np.float32)
    est = np.array([2.3, 1.7, 0.4], np.float32)
    monkeypatch.setattr(jslam, "best_map", lambda st: jnp.asarray(grid))
    monkeypatch.setattr(jslam, "slam_step", lambda st, *a, **k: (
        st, dict(pose=jnp.asarray(est))))
    jm = from_map_file(presets.DEFAULT_MAP)
    want, labels = jax_tool.run_slam_capture(jm, 6, 0, 5, 3, 8)
    angles = np.deg2rad(np.linspace(-118.0, 118.0, 8)).astype(np.float32)
    _, _, truth = jrobot.generate_wander_episode(
        jax.random.PRNGKey(0), jm, JFilter(), angles, 6,
        start_pose=(1.25, 1.25, 0.0), slip_noise=0.05, explore=True)
    truth = np.asarray(truth)
    m = _maze()
    for t, frame in zip(labels, want):
        got = tool.render_slam_frame(grid, truth[t], est, m, 3)
        assert got.tobytes() == frame.tobytes()


def test_cli_writes_the_strip(tmp_path):
    r = subprocess.run(
        [sys.executable, "-m",
         "montecarlolocalisation_tpu_torch.tools.render_episode", "--slam",
         "--ticks", "6", "--every", "3", "--scale", "1", "--beams", "8",
         "--device", "cpu", "--strip", str(tmp_path / "s.ppm"),
         "--out", str(tmp_path / "s.gif")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "3 frames, ticks 0...5" in r.stdout
    with open(tmp_path / "s.ppm", "rb") as f:
        assert f.read(2) == b"P6"
