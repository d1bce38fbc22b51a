"""The check of what the window produced, against the plain reference.

A check unit is a stretch of ticks the program ran in the window: from
the program's own state at its start (a copy the driver kept, with its
generator's state), or from the filter's seed where the stretch starts a
filter; the inputs the program was handed; the program's published
answers; and the program's particles at its end.  The reference
(mclbench/reference) runs the same ticks from the same start with the
same random stream, and the numbers below compare the two:

  rows_off   the share of particle rows, at the ends of the units, that
             differ from the reference's by more than 1e-4 (m, rad);
  pose_gap   the widest gap of a published pose from the reference's:
             the larger of the xy distance (m) and the heading difference
             (rad) to the reference's best pose, or, where the program's
             pose is the center of another of the reference's k-means
             clusters (a near tie of cluster weights), the xy distance to
             that center; 99 where one side publishes a pose and the
             other the (-1, -1, -1) sentinel with the confidence clear of
             the threshold;
  conf_gap   the widest gap of a published confidence;
  weights_gap the widest gap of a particle's weight, times N, at the
             ends of the units (the ESS gate carries weights from tick
             to tick; resampling every tick leaves them uniform).

A number is compared where the traffic mix's `limits` names it.
Diagnostics, not compared: songs_off (songs that differ, outside ticks
whose confidence sits within CONF_MARGIN of its threshold) and gen_off
(units after which the program's generator state differs from the
reference's, i.e. it drew other random numbers than the stream gives).

A SLAM check unit (`SLAMUnit`) is a stretch of ticks of E x K SLAM
filters (E episodes, K replicas): the program's SLAM state and generator
at its start (or the pass's seed and start poses), the encoders and
ranges handed over, each tick's published weighted-mean pose, and the
state at its end.  The SLAM reference (reference/slam.py) runs it, and:

  rows_off    the share of particle poses at the units' ends off the
              reference's by more than ROW_TOL (m, rad);
  weights_gap the widest gap of a particle's weight, times P, at the ends;
  pose_gap    the widest gap of a published mean pose from the
              reference's: the larger of the xy distance (m) and the
              heading difference (rad), every tick;
  map_off     the share of map pixels, over every particle's map at the
              units' ends, more than MAP_TOL log-odds from the reference's;
  evidence_gap the widest gap of a filter's log evidence at the ends (the
              replicas' race is decided on it).

Its diagnostics: kf_off and resample_off (filters whose last keyframe
pose, or whose weights' being uniform after the last tick, differ at the
units' ends: the keyframe and resampling decisions), chosen_off (episodes
whose winner at a pass's end differs from the reference's argmax) and
gen_off.

A closed-loop check unit (`ClosedLoopUnit`) is a stretch of ticks of E
episodes in which each filter drives its own robot through the plan's
waypoints: the program's closed-loop state at its start with both
generators' states (or the pass's seed and start pose), the waypoints,
each tick's true pose, estimate, confidence, waypoint index and wheel
commands, and the state at its end.  The closed-loop reference
(reference/closed_loop.py) follows the program's path one tick at a
time (ref_cl.follow): each tick from the program's previous true pose
and waypoint index, its controller on the program's published estimate,
its robot moved by the program's command; its filter runs on from the
unit's start, on the scans cast from the program's true poses and the
encoders the program's commands turn.  Compared: rows_off, pose_gap,
conf_gap and weights_gap as the filter's units define them (the
program's best pose of a tick is the estimate the next tick publishes),
and, each tick's against the reference's from the same inputs:

  truth_gap  the widest gap of a true pose (the diff drive): the larger
             of the xy distance (m) and the heading difference (rad);
  cmd_gap    the widest gap of a wheel command (the controllers, the
             wanderer's latch);
  wp_off     the share of episode-ticks whose waypoint index (the
             arrival test) differs.

Its diagnostics: complete (episodes at the units' ends past the last
waypoint, the program's), sim_gen_off and gen_off (units after which the
simulator's or the filter's generator state differs from the
reference's).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .reference import closed_loop as ref_cl
from .reference import filter as ref
from .reference import slam as ref_slam

ROW_TOL = 1e-4
MAP_TOL = 1e-3
CONF_MARGIN = 0.02
SENTINEL_GAP = 99.0


@dataclasses.dataclass
class Unit:
    """One stretch of ticks of E filters (see the module docstring)."""

    start: Optional[ref.State]      # None: from `seed`
    gen_state: Optional[torch.Tensor]
    seed: int
    enc: torch.Tensor               # [E, T, 2]
    ranges: torch.Tensor            # [E, T, B]
    confidence: torch.Tensor        # [E, T] published
    song: torch.Tensor              # [E, T]
    best_pose: torch.Tensor         # [E, T, 3] each tick's best pose
    after: Optional[torch.Tensor]   # [E, N, 3] particles at the end
    gen_after: Optional[torch.Tensor] = None
    weights_after: Optional[torch.Tensor] = None   # [E, N] at the end


@dataclasses.dataclass
class SLAMUnit:
    """One stretch of ticks of E x K SLAM filters (module docstring)."""

    start: Optional[ref_slam.State]   # None: from `seed` at start_pose
    gen_state: Optional[torch.Tensor]
    seed: int
    start_pose: torch.Tensor          # [E, 3]
    enc: torch.Tensor                 # [E, T, 2], shared by the replicas
    ranges: torch.Tensor              # [E, T, B]
    pose: torch.Tensor                # [E, K, T, 3] published mean poses
    after: ref_slam.State             # the program's state at the end
    gen_after: Optional[torch.Tensor] = None
    chosen: Optional[torch.Tensor] = None   # [E] winners, at a pass's end


@dataclasses.dataclass
class ClosedLoopUnit:
    """One stretch of ticks of E closed-loop episodes (module
    docstring)."""

    start: Optional[ref_cl.State]     # None: from `seed` at start_pose
    gen_state: Optional[tuple]        # (simulator's, filter's) states
    seed: int
    start_pose: tuple                 # (x, y, heading)
    waypoints: torch.Tensor           # [n, 2]
    true_pose: torch.Tensor           # [E, T, 3]
    est_pose: torch.Tensor            # [E, T, 3]
    confidence: torch.Tensor          # [E, T]
    wp_idx: torch.Tensor              # [E, T]
    wheel_cmd: torch.Tensor           # [E, T, 2]
    after: ref_cl.State
    gen_after: Optional[tuple] = None


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def run_reference(world, u: Unit):
    """The reference over a unit: (State, [Output a tick], generator)."""
    e = u.enc.shape[0]
    if u.start is None:
        st, gen = ref.init(world.mz, world.filter, u.seed, e)
    else:
        st = ref.State(**{k: v.to(world.device)
                          for k, v in vars(u.start).items()})
        gen = torch.Generator(device=world.device)
        gen.set_state(u.gen_state)
    mask = torch.ones(u.ranges.shape, dtype=torch.bool,
                      device=world.device)
    st, outs = ref.run(st, gen, u.enc.to(world.device),
                       u.ranges.to(world.device), mask, world.angles,
                       world.mz, world.filter)
    return st, outs, gen


def pose_gaps(best, out: ref.Output):
    """Gaps [E] of the program's best poses [E, 3] from one reference
    tick's (module docstring)."""
    dev = out.pose.device
    best = best.to(dev, torch.float32)
    p_ok = best[:, 0] >= 0
    r_ok = out.pose[:, 0] >= 0
    near_thr = torch.abs(out.confidence - out.threshold) < CONF_MARGIN
    d_best = torch.maximum(
        torch.hypot(best[:, 0] - out.pose[:, 0], best[:, 1] - out.pose[:, 1]),
        torch.abs(wrap(best[:, 2] - out.pose[:, 2])))
    # The other clusters: every center but the best one's.
    other = torch.hypot(out.centers[..., 0] - out.pose[:, None, 0],
                        out.centers[..., 1] - out.pose[:, None, 1]) > 0
    d_other = torch.where(other, torch.hypot(
        best[:, None, 0] - out.centers[..., 0],
        best[:, None, 1] - out.centers[..., 1]), math.inf).amin(-1)
    both = torch.minimum(d_best, d_other)
    gap = torch.where(p_ok & r_ok, both, 0.0)
    return torch.where((p_ok != r_ok) & ~near_thr, SENTINEL_GAP, gap)


def _row_gaps(a, b):
    """Gaps [...] of particle rows [..., 3]: the larger of the widest
    coordinate difference (m) and the heading difference (rad)."""
    return torch.maximum(torch.abs(a[..., :2] - b[..., :2]).amax(-1),
                         torch.abs(wrap(a[..., 2] - b[..., 2])))


def check(world, units: list) -> dict:
    """The compared numbers and the diagnostics over `units`."""
    if world.slam is not None:
        return check_slam(world, units)
    if world.closed_loop is not None:
        return check_closed_loop(world, units)
    rows = rows_off = 0
    pose_gap = conf_gap = weights_gap = 0.0
    songs_off = gen_off = 0
    answers = 0
    for u in units:
        st, outs, gen = run_reference(world, u)
        for t, o in enumerate(outs):
            pose_gap = max(pose_gap, float(pose_gaps(
                u.best_pose[:, t], o).max()))
            conf_gap = max(conf_gap, float(torch.abs(
                u.confidence[:, t].to(o.confidence) - o.confidence).max()))
            prev = (o.prev_confidence, o.prev_threshold)
            clear = torch.abs(prev[0] - prev[1]) >= CONF_MARGIN
            songs_off += int(((u.song[:, t].to(o.song.device) != o.song)
                              & clear).sum())
            answers += o.song.numel()
        if u.after is not None:
            d = _row_gaps(u.after.to(st.particles.device), st.particles)
            rows += d.numel()
            rows_off += int((d > ROW_TOL).sum())
        if u.weights_after is not None:
            w = u.weights_after.to(st.weights)
            weights_gap = max(weights_gap, float(
                torch.abs(w - st.weights).max()) * w.shape[-1])
        if u.gen_after is not None:
            gen_off += int(not torch.equal(gen.get_state(), u.gen_after))
    return dict(rows_off=rows_off / max(rows, 1), pose_gap=pose_gap,
                conf_gap=conf_gap, weights_gap=weights_gap,
                songs_off=songs_off, gen_off=gen_off,
                units=len(units), answers=answers, rows=rows,
                rows_off_count=rows_off)


def run_slam_reference(world, u: SLAMUnit, dtype=torch.float32):
    """The SLAM reference over a unit: (State, [Output a tick],
    generator)."""
    dev = world.device
    k = u.pose.shape[1]
    batch = (u.enc.shape[0], k)
    if u.start is None:
        st, gen = ref_slam.init(world.slam, u.seed,
                                u.start_pose.to(dev)[:, None, :], batch)
    else:
        st = ref_slam.State(**{f: v.to(dev)
                               for f, v in vars(u.start).items()})
        gen = torch.Generator(device=dev)
        gen.set_state(u.gen_state)
    enc = u.enc.to(dev)[:, None].expand(batch + u.enc.shape[1:])
    ranges = u.ranges.to(dev)[:, None].expand(batch + u.ranges.shape[1:])
    mask = torch.ones(ranges.shape, dtype=torch.bool, device=dev)
    st, outs = ref_slam.run(st, gen, enc, ranges, mask, world.angles,
                            world.slam, dtype)
    return st, outs, gen


def _pose_gap(a, b):
    """max(xy distance, |heading difference|) of poses [..., 3]."""
    return torch.maximum(torch.hypot(a[..., 0] - b[..., 0],
                                     a[..., 1] - b[..., 1]),
                         torch.abs(wrap(a[..., 2] - b[..., 2])))


def check_slam(world, units: list) -> dict:
    """The compared numbers and the diagnostics over SLAM units."""
    rows = rows_off = pixels = map_off = 0
    pose_gap = weights_gap = evidence_gap = 0.0
    kf_off = resample_off = chosen_off = gen_off = filters = answers = 0
    for u in units:
        st, outs, gen = run_slam_reference(world, u)
        for t, o in enumerate(outs):
            pose_gap = max(pose_gap, float(_pose_gap(
                u.pose[:, :, t].to(o.pose), o.pose).max()))
            answers += o.pose[..., 0].numel()
        a = ref_slam.State(**{f: v.to(st.poses.device)
                              for f, v in vars(u.after).items()})
        d = _pose_gap(a.poses, st.poses)
        rows += d.numel()
        rows_off += int((d > ROW_TOL).sum())
        p = a.weights.shape[-1]
        weights_gap = max(weights_gap, float(
            torch.abs(a.weights - st.weights).max()) * p)
        off = torch.abs(a.logodds - st.logodds) > MAP_TOL
        pixels += off.numel()
        map_off += int(off.sum())
        evidence_gap = max(evidence_gap, float(
            torch.abs(a.log_evidence - st.log_evidence).max()))
        filters += a.log_evidence.numel()
        kf_off += int((_pose_gap(a.kf_pose, st.kf_pose) > ROW_TOL).sum())
        uniform = (a.weights == a.weights[..., :1]).all(-1)
        resample_off += int((uniform != (st.weights == st.weights[
            ..., :1]).all(-1)).sum())
        if u.chosen is not None:
            chosen_off += int((u.chosen.to(st.log_evidence.device)
                               != torch.argmax(st.log_evidence,
                                               dim=-1)).sum())
        if u.gen_after is not None:
            gen_off += int(not torch.equal(gen.get_state(), u.gen_after))
    return dict(rows_off=rows_off / max(rows, 1), pose_gap=pose_gap,
                weights_gap=weights_gap, map_off=map_off / max(pixels, 1),
                evidence_gap=evidence_gap, kf_off=kf_off,
                resample_off=resample_off, chosen_off=chosen_off,
                gen_off=gen_off, units=len(units), answers=answers,
                rows=rows, rows_off_count=rows_off, filters=filters,
                map_off_count=map_off)


def run_closed_loop_reference(world, u: ClosedLoopUnit):
    """The closed-loop reference along a unit's path (ref_cl.follow):
    (State, [Output a tick], (simulator's generator, filter's
    generator))."""
    dev = world.device
    e = u.true_pose.shape[0]
    if u.start is None:
        st, sim_gen, filt_gen = ref_cl.init(world.mz, world.filter, u.seed,
                                            e, u.start_pose)
    else:
        st = ref_cl.to(u.start, dev)
        sim_gen = torch.Generator(device=dev)
        sim_gen.set_state(u.gen_state[0])
        filt_gen = torch.Generator(device=dev)
        filt_gen.set_state(u.gen_state[1])
    path = {f: getattr(u, f).to(dev) for f in ("true_pose", "est_pose",
                                                "wp_idx", "wheel_cmd")}
    st, outs = ref_cl.follow(st, sim_gen, filt_gen, u.waypoints.to(dev),
                             path, world.angles, world.mz, world.filter,
                             world.closed_loop)
    return st, outs, (sim_gen, filt_gen)


def check_closed_loop(world, units: list) -> dict:
    """The compared numbers and the diagnostics over closed-loop units."""
    rows = rows_off = wp_off = episode_ticks = 0
    pose_gap = conf_gap = weights_gap = truth_gap = cmd_gap = 0.0
    complete = episodes = sim_gen_off = gen_off = 0
    for u in units:
        st, outs, (sim_gen, filt_gen) = run_closed_loop_reference(world, u)
        dev = st.robot.device
        a = ref_cl.to(u.after, dev)
        n = len(outs)
        for t, o in enumerate(outs):
            best = (u.est_pose[:, t + 1] if t + 1 < n
                    else a.filt.best_pose)
            pose_gap = max(pose_gap, float(pose_gaps(best, o.filt).max()))
            conf_gap = max(conf_gap, float(torch.abs(
                u.confidence[:, t].to(dev) - o.confidence).max()))
            truth_gap = max(truth_gap, float(_pose_gap(
                u.true_pose[:, t].to(dev), o.true_pose).max()))
            cmd_gap = max(cmd_gap, float(torch.abs(
                u.wheel_cmd[:, t].to(dev) - o.wheel_cmd).max()))
            wp_off += int((u.wp_idx[:, t].to(dev) != o.wp_idx).sum())
            episode_ticks += o.wp_idx.numel()
        d = _row_gaps(a.filt.particles, st.filt.particles)
        rows += d.numel()
        rows_off += int((d > ROW_TOL).sum())
        w = a.filt.weights
        weights_gap = max(weights_gap, float(
            torch.abs(w - st.filt.weights).max()) * w.shape[-1])
        complete += int((a.wp_idx >= u.waypoints.shape[0]).sum())
        episodes += a.wp_idx.numel()
        if u.gen_after is not None:
            sim_gen_off += int(not torch.equal(sim_gen.get_state(),
                                               u.gen_after[0]))
            gen_off += int(not torch.equal(filt_gen.get_state(),
                                           u.gen_after[1]))
    return dict(rows_off=rows_off / max(rows, 1), pose_gap=pose_gap,
                conf_gap=conf_gap, weights_gap=weights_gap,
                truth_gap=truth_gap, cmd_gap=cmd_gap,
                wp_off=wp_off / max(episode_ticks, 1),
                complete=complete / max(episodes, 1),
                sim_gen_off=sim_gen_off, gen_off=gen_off, units=len(units),
                answers=episode_ticks, rows=rows, rows_off_count=rows_off,
                wp_off_count=wp_off)
