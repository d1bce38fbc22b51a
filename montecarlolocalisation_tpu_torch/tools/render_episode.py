"""Render an episode to image frames: a PPM strip and, where PIL imports, a
GIF.  The port's counterpart of tools/render_episode.py.

When an episode locks onto a maze alias the convergence numbers alone
cannot show it; a strip of the particle cloud over time can (the
reference's analog: the RViz PoseArray topics, monte_carlo.cpp:563-608).
Four sources:

  --log PATH      replay an EpisodeLog (.npz; default: the port's copy of
                  the replay fixture) through the filter
  --simulate      a wander episode on the map (sim/robot), through the
                  filter; `--kidnap T` teleports the truth to (3.65, 3.65,
                  1.57) at tick T while the encoders integrate on
  --closed-loop   closed-loop plan execution, with the heading-error arrow
                  (moveToPosition_server.cpp:94-130) and the APF force
                  panel (avf.cpp:292-294) the reference publishes
  --slam          RBPF SLAM map growth: the best particle's log-odds grid
                  (walls dark, free space light, unknown grey), the true
                  pose green and the SLAM estimate red

Usage:
  python -m montecarlolocalisation_tpu_torch.tools.render_episode --log
  python -m montecarlolocalisation_tpu_torch.tools.render_episode \\
      --simulate --kidnap 60 --ticks 150 --device cpu
  python -m montecarlolocalisation_tpu_torch.tools.render_episode \\
      --closed-loop --ticks 150 --device cpu
  python -m montecarlolocalisation_tpu_torch.tools.render_episode --slam

Every run goes through the port's graphs on `--device` (default cuda): a
frame's state is read between graph replays.
"""
from __future__ import annotations

import argparse
import os.path as osp

import numpy as np
import torch

from ..config import (APFConfig, FilterConfig, MappingConfig, SLAMConfig,
                      SensorModelConfig)
from ..io.logs import EpisodeLog
from ..maps import from_map_file
from ..utils import viz

_PKG = osp.dirname(osp.dirname(osp.abspath(__file__)))
DEFAULT_MAP = osp.join(_PKG, "maps", "default_map.txt")
FIXTURE = osp.join(_PKG, "data", "replay_6x6.npz")


def _capture_ticks(num_ticks: int, every: int) -> list:
    """The ticks a frame shows: 0, every, 2 every, ... and the last."""
    return sorted(set(range(0, num_ticks, every)) | {num_ticks - 1})


def _chunks(num_ticks: int, every: int):
    """(first tick, ticks) of the runs between two captured ticks."""
    t0 = 0
    for t in _capture_ticks(num_ticks, every):
        yield t0, t + 1 - t0
        t0 = t + 1


def run_and_capture(m, cfg: FilterConfig, log: EpisodeLog, every: int,
                    scale: int):
    """The filter over the log, a frame every `every` ticks and at the
    last: the cloud, its weights, the best and the true pose.  Returns
    (frames, their ticks)."""
    from ..models import filter as mcl

    dev = m.device
    state = mcl.init_state(m, cfg, cfg.num_particles)
    enc = torch.as_tensor(log.encoders, dtype=torch.float32, device=dev)
    ranges = torch.as_tensor(log.scan_ranges, dtype=torch.float32,
                             device=dev)
    angles = torch.as_tensor(log.scan_angles, dtype=torch.float32,
                             device=dev)
    mask = (torch.ones(ranges.shape, dtype=torch.bool, device=dev)
            if log.scan_mask is None
            else torch.as_tensor(log.scan_mask, device=dev).to(torch.bool))
    occ = m.occ.cpu().numpy()
    frames, labels = [], []
    for t0, n in _chunks(log.num_ticks, every):
        state, _ = mcl.run_ticks(state, enc[t0:t0 + n], ranges[t0:t0 + n],
                                 mask[t0:t0 + n], angles, m, cfg)
        t = t0 + n - 1
        truth = log.true_poses[t] if log.true_poses is not None else None
        frames.append(viz.render_filter(
            occ, particles=state.particles, weights=state.weights,
            best_pose=state.best_pose, true_pose=truth,
            resolution=float(m.resolution), scale=scale))
        labels.append(t)
    return frames, labels


def _beam_table(beams: int) -> np.ndarray:
    return np.deg2rad(np.linspace(-118.0, 118.0, beams)).astype(np.float32)


def simulated_log(m, cfg: FilterConfig, num_ticks: int, seed: int,
                  beams: int, kidnap: int = 0) -> EpisodeLog:
    """A wander episode from (1.25, 1.25, 0) as an EpisodeLog with its
    true poses; with `kidnap` > 0 the truth jumps to (3.65, 3.65, 1.57)
    at that tick (tools/render_episode.py:282-296 of the JAX package)."""
    from ..sim import robot

    angles = _beam_table(beams)
    kw = (dict(kidnap_tick=kidnap, kidnap_pose=(3.65, 3.65, 1.57))
          if kidnap else {})
    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    enc, ranges, poses = robot.generate_wander_episode(
        gen, m, cfg, angles, num_ticks, **kw)
    return EpisodeLog(encoders=enc[0].cpu().numpy(),
                      scan_ranges=ranges[0].cpu().numpy(),
                      scan_angles=angles, true_poses=poses[0].cpu().numpy())


def run_closed_loop_capture(m, cfg: FilterConfig, num_ticks: int, seed: int,
                            every: int, scale: int, beams: int):
    """A BFS plan from cell (1, 1) across the maze driven closed-loop from
    a known start, a frame every `every` ticks: the map, the estimate and
    the truth, the heading-error arrow toward the current waypoint and,
    as a side panel, the APF field at the true pose in the robot frame
    (potential_field gains: the preset with live repulsion)."""
    from ..control import controllers as C
    from ..models import sensor
    from ..planning import bfs
    from ..sim import closed_loop
    from ..utils.angles import normalize_angle

    dev = m.device
    angles = _beam_table(beams)
    path = bfs.bfs_path(m.walls, (1, 1), (m.n_rows - 2, m.n_cols - 2))
    wps = closed_loop.mission_waypoints(path, float(m.cell_meters))[1:]
    _, outs = closed_loop.run_closed_loop(m, cfg, wps, num_ticks, angles,
                                          known_start=True, seed=seed)
    true_p = outs.true_pose.cpu().numpy()
    est_p = outs.est_pose.cpu().numpy()
    wp_idx = outs.wp_idx.cpu().numpy()
    occ = m.occ.cpu().numpy()
    apf_cfg = APFConfig.potential_field()
    frames, labels = [], []
    for t in range(0, num_ticks, every):
        img = viz.render_filter(occ, best_pose=est_p[t], true_pose=true_p[t],
                                resolution=float(m.resolution), scale=scale)
        wp = wps[min(int(wp_idx[t]), len(wps) - 1)]
        est = est_p[t]
        if est[0] >= 0:
            err = normalize_angle(torch.tensor(
                float(np.arctan2(wp[1] - est[1], wp[0] - est[0]) - est[2])))
            img = viz.draw_heading_error(img, est, float(err),
                                         resolution=float(m.resolution),
                                         scale=scale)
        # The APF panel: the scan re-simulated at the true pose, the
        # waypoint in the robot frame (the reference's "laser" frame).
        scan = sensor.simulate_scan(
            m, torch.as_tensor(true_p[t], device=dev), angles, cfg.sensor)
        r = scan.ranges.cpu().numpy()
        a = scan.angles.cpu().numpy()
        px_r, py_r = r * np.cos(a), r * np.sin(a)
        th = true_p[t, 2]
        dxw, dyw = wp[0] - true_p[t, 0], wp[1] - true_p[t, 1]
        tx = dxw * np.cos(-th) - dyw * np.sin(-th)
        ty = dxw * np.sin(-th) + dyw * np.cos(-th)

        def f32(v):
            return torch.tensor(v, dtype=torch.float32)

        forces = C.apf_forces(f32(tx), f32(ty), f32(0.0), f32(0.0),
                              f32(px_r), f32(py_r),
                              scan.mask.cpu(), apf_cfg)
        apf_img = viz.render_apf(px_r, py_r, scan.mask.cpu().numpy(), forces)
        h = img.shape[0]
        ah, aw = apf_img.shape[:2]
        panel = np.full((h, aw, 3), 255, np.uint8)
        panel[:min(h, ah), :] = apf_img[:min(h, ah)]
        frames.append(np.concatenate([img, panel], axis=1))
        labels.append(t)
    return frames, labels


def render_slam_frame(logodds, true_pose, est_pose, m, scale: int):
    """One SLAM frame: the log-odds grid [H, W] as grey (127 - 100 tanh(lo
    / 4): unknown mid-grey, free light, walls dark), the true pose a green
    square, the estimate a red one."""
    lo = np.asarray(logodds)
    grey = np.clip(127.0 - 100.0 * np.tanh(lo / 4.0), 0, 255
                   ).astype(np.uint8)
    img = np.repeat(np.repeat(grey, scale, 0), scale, 1)
    img = np.stack([img] * 3, -1)
    for pose, color in ((true_pose, (0, 200, 0)), (est_pose, (220, 0, 0))):
        c = int((pose[0] - m.origin_x) / float(m.resolution) * scale)
        r = int((pose[1] - m.origin_y) / float(m.resolution) * scale)
        rr = slice(max(r - scale // 2, 0), r + scale // 2 + 1)
        cc = slice(max(c - scale // 2, 0), c + scale // 2 + 1)
        img[rr, cc] = color
    return img


def run_slam_capture(m, num_ticks: int, seed: int, every: int, scale: int,
                     beams: int):
    """SLAM map growth: a 64-particle SLAM filter (keyframes 0.15 m /
    0.5 rad) over a wander with 5 % wheel slip from (1.25, 1.25, 0), a
    frame every `every` ticks (render_slam_frame of the best particle's
    map)."""
    from ..models import slam
    from ..sim import robot

    dev = m.device
    fcfg = FilterConfig()
    angles = _beam_table(beams)
    scfg = SLAMConfig(
        num_particles=64,
        mapping=MappingConfig(height=m.height, width=m.width,
                              resolution=float(m.resolution),
                              origin_x=float(m.origin_x),
                              origin_y=float(m.origin_y)),
        sensor=fcfg.sensor, motion=fcfg.motion,
        keyframe_trans=0.15, keyframe_rot=0.5)
    start = (1.25, 1.25, 0.0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    enc, scans, truth = robot.generate_wander_episode(
        gen, m, fcfg, angles, num_ticks, start_pose=start, slip_noise=0.05,
        explore=True)
    enc, scans = enc[0], scans[0]
    truth = truth[0].cpu().numpy()
    st = slam.init_slam(seed + 1, start, scfg, (), dev)
    ang = torch.as_tensor(angles, device=dev)
    frames, labels = [], []
    for t0, n in _chunks(num_ticks, every):
        st, infos = slam.run_slam_ticks(
            st, enc[t0:t0 + n], scans[t0:t0 + n],
            torch.ones_like(scans[t0:t0 + n]), ang, scfg)
        t = t0 + n - 1
        frames.append(render_slam_frame(
            slam.best_map(st).cpu().numpy(), truth[t],
            infos["pose"][-1].cpu().numpy(), m, scale))
        labels.append(t)
    return frames, labels


def save_strip(frames, path: str, max_frames: int = 12) -> None:
    idx = np.linspace(0, len(frames) - 1, min(max_frames, len(frames)))
    strip = np.concatenate([frames[int(i)] for i in idx], axis=1)
    viz.save_ppm(strip, path)


def save_gif(frames, path: str, ms_per_frame: int = 120) -> bool:
    try:
        from PIL import Image
    except ImportError:
        return False
    imgs = [Image.fromarray(f) for f in frames]
    imgs[0].save(path, save_all=True, append_images=imgs[1:],
                 duration=ms_per_frame, loop=0)
    return True


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m montecarlolocalisation_tpu_torch.tools."
             "render_episode", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--log", nargs="?", const=FIXTURE,
                     help="EpisodeLog .npz to replay (default: the replay "
                          "fixture)")
    src.add_argument("--simulate", action="store_true",
                     help="a wander episode on the map")
    src.add_argument("--closed-loop", action="store_true",
                     help="closed-loop plan execution with the controller "
                          "debug markers")
    src.add_argument("--slam", action="store_true",
                     help="RBPF SLAM map growth")
    ap.add_argument("--map", default=DEFAULT_MAP)
    ap.add_argument("--ticks", type=int, default=150,
                    help="simulate, closed-loop and slam: ticks to run")
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--every", type=int, default=5,
                    help="a frame every N ticks")
    ap.add_argument("--scale", type=int, default=8,
                    help="image pixels a map pixel")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--kidnap", type=int, default=0,
                    help="simulate: a kidnap at this tick (0 = none)")
    ap.add_argument("--out", default="episode.gif")
    ap.add_argument("--strip", default="episode_strip.ppm")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for name in ("ticks", "particles", "beams", "every", "scale"):
        if getattr(args, name) < 1:
            ap.error(f"--{name} must be >= 1")
    if args.kidnap and not args.simulate:
        ap.error("--kidnap applies to --simulate")
    if args.kidnap < 0:
        ap.error("--kidnap must be >= 0")

    m = from_map_file(args.map, device=args.device)
    cfg = FilterConfig(num_particles=args.particles,
                       sensor=SensorModelConfig())
    if args.slam:
        frames, labels = run_slam_capture(m, args.ticks, args.seed,
                                          args.every, args.scale, args.beams)
    elif args.closed_loop:
        frames, labels = run_closed_loop_capture(
            m, cfg, args.ticks, args.seed, args.every, args.scale,
            args.beams)
    else:
        log = (simulated_log(m, cfg, args.ticks, args.seed, args.beams,
                             args.kidnap)
               if args.simulate else EpisodeLog.load(args.log))
        frames, labels = run_and_capture(m, cfg, log, args.every,
                                         args.scale)
    save_strip(frames, args.strip)
    print(f"wrote {args.strip} ({len(frames)} frames, ticks {labels[0]}..."
          f"{labels[-1]})")
    if save_gif(frames, args.out):
        print(f"wrote {args.out}")
    else:
        print("PIL unavailable: GIF skipped (strip written)")


if __name__ == "__main__":
    main()
