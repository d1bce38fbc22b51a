"""The closed-loop driver: E robots, each driven through a plan's waypoints
by the filter that localises it (sim/closed_loop: the simulated LIDAR,
the filter tick, the controllers and the diff drive in one tick), as the
closed-loop sweeps run them.

Traffic parameters (mclbench/traffic/<mix>.json): `episodes` (E),
`ticks` (a pass's length), `segment_ticks` (the ticks handed to the entry
a call; the state carries over), `check_segments` (segments the check
follows besides the first), `plan` (`start_cell` and `goal_cell`, [row,
col] of the maze's cells) and `limits` (the check's: compare.py's
closed-loop numbers).

The plan is the breadth-first cell path from start_cell to goal_cell
(reference/closed_loop.plan): every robot starts at the centre of its
first cell, heading 0, and drives to the centres of the later ones.

Set-up runs a pass's first segment and its last (the remainder's shape),
which build every graph the window replays, then times a few segments for
the length of a traced run's profile.  The window runs pass after pass,
each pass from init_closed_loop with a seed of its own, until --seconds
have passed, and ends at a synchronize after the last call; updates_per_s
is E x N x B x the ticks completed over the window's length, the replay
cells' definition.  The diagnostics add the share of the episodes of each
pass the window finished that passed the last waypoint
(`complete_share`) and their median waypoint index.

The check follows the window's first segment and `check_segments` more,
drawn from the run's seed alone among the first pass's segments: for
each, the state the call started from (with both generators' states; None
at the pass's start), the answers and the state it returned.  A traced
run profiles whole segments from the second pass on, and keeps the
states that begin the first few: the reading's K1 and K3 bounds
(drivers/replay.py's) are counted from them once the window has closed.
"""
from __future__ import annotations

import gc
import statistics
import time

from .. import generator
from ..compare import ClosedLoopUnit
from ..reference import closed_loop as ref_cl
from ..reference import maze
from ..trace import Profile, Reading, span
from . import Run, pick
from .replay import PROFILE_SECONDS, _bounds, pass_seed

# The traced segments whose start states the bounds read, at most.
BOUND_SEGMENTS = 4


def run(world, traffic: dict, seed: int, seconds: float, trace: bool,
        program=None) -> Run:
    e = int(traffic["episodes"])
    ticks = int(traffic["ticks"])
    seg = int(traffic["segment_ticks"])
    s_pass, s_check = generator.seeds(seed, 2)
    marks = [time.perf_counter()]
    with open(world.map_path) as f:
        cells = maze.parse(f.read())
    path = ref_cl.plan(cells, traffic["plan"]["start_cell"],
                       traffic["plan"]["goal_cell"])
    if not path:
        raise ValueError(f"no path from {traffic['plan']['start_cell']} to "
                         f"{traffic['plan']['goal_cell']} in {world.map_path}")
    start, wps = ref_cl.waypoints(path, world.mz.cell_meters)
    wps = wps.to(world.device)
    if program is None:
        from ..program import ClosedLoopProgram

        program = ClosedLoopProgram(world, e, wps, start)
    else:
        program = program(world, e, wps, start)
    spans_ = [(t0, min(seg, ticks - t0)) for t0 in range(0, ticks, seg)]
    world.synchronize()
    marks.append(time.perf_counter())

    # Set-up: a pass's first segment and its last (the remainder's shape)
    # build every graph the window replays; then a few segments, timed,
    # set the traced run's profile length.
    w_seed = pass_seed(s_pass, -1)
    st = program.segment(None, w_seed, spans_[0][1])[0]
    program.segment(st, w_seed, spans_[-1][1])
    world.synchronize()
    marks.append(time.perf_counter())
    timed = min(4, len(spans_))
    t0 = time.perf_counter()
    st = None
    for _, n in spans_[:timed]:
        st = program.segment(st, w_seed, n)[0]
    world.synchronize()
    seg_s = (time.perf_counter() - t0) / timed
    marks.append(time.perf_counter())
    checked = {0} | set(pick(s_check, int(traffic["check_segments"]), 1,
                             len(spans_)))
    prof_first = prof_last = -1
    prof = None
    if trace:
        prof_first = len(spans_)
        prof_last = prof_first + max(2, int(PROFILE_SECONDS / seg_s))
        prof = Profile(world.device.type == "cuda")
        prof.warm_up()

    kept = {}             # segment j -> dict for the check
    prof_states = []      # (filter state and generator, seed, t0) traced
    finals = []           # [E] waypoint indices at each pass's end
    done_ticks = attempted = 0
    j = p = 0
    st = None
    prof_ops = None
    gc.collect()
    gc.freeze()
    start_t = time.perf_counter()
    while True:
        p_seed = pass_seed(s_pass, p)
        for t0, n in spans_:
            if j == prof_first:
                world.synchronize()
                prof.start()
                time.sleep(0.05)
                t_prof = time.perf_counter()
            traced = prof_first <= j < prof_last
            if j in checked or (traced
                                and len(prof_states) < BOUND_SEGMENTS):
                before = None if st is None else program.snapshot(st)
                if j in checked:
                    kept[j] = dict(before=before, seed=p_seed, n=n)
                elif before is None:
                    prof_states.append((None, ref_cl.seeds(p_seed)[1], t0))
                else:
                    prof_states.append(((before[0].filt, before[1][1]),
                                        p_seed, t0))
            if traced:
                with span("segment call"):
                    st, outs = program.segment(st, p_seed, n)
            else:
                st, outs = program.segment(st, p_seed, n)
            if j in kept:
                kept[j].update(answers=program.answers(outs),
                               after=program.snapshot(st))
            attempted += 1
            done_ticks += n
            j += 1
            if j == prof_last:
                world.synchronize()
                time.sleep(max(0.05, time.perf_counter() - t_prof))
                prof.stop()
                prof_ops = prof.events()
                prof_ticks = sum(spans_[jj % len(spans_)][1]
                                 for jj in range(prof_first, prof_last))
            if time.perf_counter() - start_t >= seconds:
                break
        else:
            finals.append(program.progress(st))
            st = None
            p += 1
            continue
        break
    world.synchronize()
    window = time.perf_counter() - start_t
    if trace and prof_ops is None:
        # The window ended before the traced segments did.
        if j > prof_first:
            prof.stop()
            prof_ops = prof.events()
        else:
            prof_ops = ([], [])
        prof_ticks = max(1, j - max(prof_first, 0)) * seg
    n_part = world.filter["num_particles"]
    nb = world.angles.shape[0]
    reached = [int(v) for f in finals for v in f.tolist()]
    metrics = dict(updates_per_s=e * n_part * nb * done_ticks / window,
                   window_s=window, ticks=done_ticks, segment_s=seg_s,
                   passes=len(finals),
                   complete_share=(sum(v >= wps.shape[0] for v in reached)
                                   / len(reached) if reached else None),
                   median_waypoints=(statistics.median(reached)
                                     if reached else None),
                   setup_parts_s=dict(zip(
                       ("plan_and_program", "warm_up", "timing"),
                       (b - a for a, b in zip(marks, marks[1:])))))
    units = [_unit(k, start, wps) for k in kept.values() if "after" in k]
    reading = None
    if trace:
        ops, spans = prof_ops
        busy = [(s, t) for _, s, t in ops]
        win = ((min(s for s, _ in busy), max(t for _, t in busy)) if busy
               else (0, 1))
        reading = Reading(ops=ops, spans=spans, window=win, ticks=prof_ticks,
                          pending=lambda: _bounds(world, prof_states, e))
    return Run(window_start=start_t, metrics=metrics, attempted=attempted,
               failed=0, units=units, reading=reading,
               free=getattr(program, "free", lambda: None))


def _unit(k: dict, start, wps) -> ClosedLoopUnit:
    before, gen = k["before"] if k["before"] is not None else (None, None)
    after, gen_after = k["after"]
    a = k["answers"]
    return ClosedLoopUnit(start=before, gen_state=gen, seed=k["seed"],
                          start_pose=start, waypoints=wps,
                          true_pose=a["true_pose"], est_pose=a["est_pose"],
                          confidence=a["confidence"], wp_idx=a["wp_idx"],
                          wheel_cmd=a["wheel_cmd"], after=after,
                          gen_after=gen_after)
