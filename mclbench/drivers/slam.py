"""The SLAM driver: recorded wander logs replayed through RBPF SLAM
(models/slam.run_slam_episode) over [E, K] filters, E episodes each with
K replicas racing on evidence, as the SLAM sweeps run them.

Traffic parameters (mclbench/traffic/<mix>.json): `episodes` (E, one log
each), `replicas` (K), `ticks` (a log's length), `segment_ticks` (the
ticks handed to the entry a call; the state carries over),
`check_segments` (segments the check follows besides the first),
`wander` (the generator's settings, `slip` among them) and `limits` (the
check's: compare.py's SLAM numbers).

Set-up makes the logs and the start poses from the seed
(mclbench/generator.py) and runs a pass's first segment and its last,
which build every graph the window replays, then times a few segments.
The window runs pass after pass over the same logs, each pass a fresh
filter seed from the robots' start poses, and ends each pass with the
replicas' argmax of the log evidence (as run_slam_replicas picks the
winners), until --seconds have passed; it ends at a synchronize after
the last call.  updates_per_s is E x K x P x B x the ticks completed
over the window's length, the replay cells' definition.

For the check, the driver keeps, for segments drawn as drivers/replay.py
draws them, the state the call started from (a copy, with its
generator's state; None at a pass's start), the published mean poses,
the state it returned and, at a pass's end, the winners.  A traced run
also keeps the states that begin the traced segments: the reading's
bounds (ism_ms_per_tick, slam_field_ms_per_tick) are counted on the
reference's ticks from them, once the window has closed.
"""
from __future__ import annotations

import gc
import time

import torch

from .. import bounds, generator
from ..compare import SLAMUnit
from ..reference import slam as ref_slam
from ..trace import Profile, Reading, span
from . import Run, pick
from .replay import PROFILE_SECONDS, pass_seed

# The traced segments whose start states the bounds read, at most.
BOUND_SEGMENTS = 8


def run(world, traffic: dict, seed: int, seconds: float, trace: bool,
        program=None) -> Run:
    e = int(traffic["episodes"])
    k = int(traffic["replicas"])
    ticks = int(traffic["ticks"])
    seg = int(traffic["segment_ticks"])
    s_traffic, s_filter, s_check = generator.seeds(seed, 3)
    marks = [time.perf_counter()]
    wander = generator.Wander(**traffic["wander"])
    enc, ranges, _ = generator.logs(
        s_traffic, world.mz, world.angles, world.sensor, world.motion, e,
        ticks, wander)
    start = generator.starts(s_traffic, world.mz, e, wander)
    if program is None:
        from ..program import SLAMProgram

        program = SLAMProgram(world, e, k)
    else:
        program = program(world, e, k)
    spans_ = [(t0, min(seg, ticks - t0)) for t0 in range(0, ticks, seg)]
    world.synchronize()
    marks.append(time.perf_counter())

    def call(st, p_seed, t0, n):
        return program.segment(st, p_seed, start, enc[:, t0:t0 + n],
                               ranges[:, t0:t0 + n])

    # Set-up: a pass's first segment and its last (the remainder's shape)
    # build every graph the window replays; then a few segments, timed,
    # place the checked segments inside the window.
    w_seed = pass_seed(s_filter, -1)
    st = call(None, w_seed, *spans_[0])[0]
    program.winners(call(st, w_seed, *spans_[-1])[0])
    world.synchronize()
    marks.append(time.perf_counter())
    timed = min(4, len(spans_))
    t0 = time.perf_counter()
    st = None
    for t, n in spans_[:timed]:
        st = call(st, w_seed, t, n)[0]
    world.synchronize()
    seg_s = (time.perf_counter() - t0) / timed
    marks.append(time.perf_counter())
    expect = max(2, int(0.8 * seconds / seg_s))
    checked = {0} | set(pick(s_check, int(traffic["check_segments"]), 1,
                             expect))
    prof_first = prof_last = -1
    prof = None
    if trace:
        n_prof = max(2, int(PROFILE_SECONDS / seg_s))
        prof_first = max(1, (expect - n_prof) // 2)
        prof_last = prof_first + n_prof
        # The checked segments' copies stay out of the profile: those of
        # the segments just before and after it fall outside it.
        checked -= set(range(prof_first, prof_last))
        prof = Profile(world.device.type == "cuda")
        prof.warm_up()

    kept = {}             # segment j -> dict for the check
    prof_states = []      # (state, generator state, seed, t0, n) traced
    done_ticks = attempted = 0
    j = p = 0
    st = None
    prof_ops = None
    gc.collect()
    gc.freeze()
    start_t = time.perf_counter()
    while True:
        p_seed = pass_seed(s_filter, p)
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
                    kept[j] = dict(before=before, seed=p_seed, t0=t0, n=n)
                else:
                    prof_states.append((before, p_seed, t0, n))
            if traced:
                with span("segment call"):
                    st, poses = call(st, p_seed, t0, n)
            else:
                st, poses = call(st, p_seed, t0, n)
            last = t0 + n >= ticks
            chosen = program.winners(st) if last else None
            if j in kept:
                kept[j].update(pose=poses, after=program.snapshot(st),
                               chosen=chosen)
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
    n_part = world.slam["num_particles"]
    nb = world.angles.shape[0]
    metrics = dict(updates_per_s=e * k * n_part * nb * done_ticks / window,
                   window_s=window, ticks=done_ticks, segment_s=seg_s,
                   setup_parts_s=dict(zip(
                       ("logs_and_program", "warm_up", "timing"),
                       (b - a for a, b in zip(marks, marks[1:])))))
    units = [_unit(kk, start, enc, ranges) for kk in kept.values()
             if "after" in kk]
    reading = None
    if trace:
        ops, spans = prof_ops
        busy = [(s, t) for _, s, t in ops]
        win = ((min(s for s, _ in busy), max(t for _, t in busy)) if busy
               else (0, 1))
        reading = Reading(
            ops=ops, spans=spans, window=win, ticks=prof_ticks,
            pending=lambda: _bounds(world, prof_states, start, enc,
                                    ranges, k))
    return Run(window_start=start_t, metrics=metrics, attempted=attempted,
               failed=0, units=units, reading=reading,
               free=getattr(program, "free", lambda: None))


def _unit(kk: dict, start, enc, ranges) -> SLAMUnit:
    t0, n = kk["t0"], kk["n"]
    before, gen = kk["before"] if kk["before"] is not None else (None, None)
    after, gen_after = kk["after"]
    return SLAMUnit(start=before, gen_state=gen, seed=kk["seed"],
                    start_pose=start, enc=enc[:, t0:t0 + n],
                    ranges=ranges[:, t0:t0 + n], pose=kk["pose"],
                    after=after, gen_after=gen_after, chosen=kk["chosen"])


def _bounds(world, states, start, enc, ranges, replicas: int) -> dict:
    """The yardstick's ISM and field bounds a tick, averaged over the
    ticks of the traced segments whose start states were kept: the
    reference runs each such segment from its state, and each tick's
    mapped filters and their poses give its ISM bound."""
    cfg = world.slam
    e = enc.shape[0]
    batch = (e, replicas)
    ism, fld = [], []
    for before, p_seed, t0, n in states:
        if before is None:
            st, gen = ref_slam.init(cfg, p_seed, start[:, None, :], batch)
        else:
            st, g = before
            gen = torch.Generator(device=world.device)
            gen.set_state(g)
        rg = ranges[:, None, t0:t0 + n].expand(batch + (n,) +
                                               ranges.shape[-1:])
        mask = torch.ones(rg.shape, dtype=torch.bool, device=rg.device)
        en = enc[:, None, t0:t0 + n].expand(batch + (n, 2))
        _, outs = ref_slam.run(st, gen, en, rg, mask, world.angles, cfg)
        for t, o in enumerate(outs):
            ism.append(bounds.ism_bound(o.poses, rg[:, :, t], mask[:, :, t],
                                        world.angles, o.mapped,
                                        cfg)["bound_ms"])
            fld.append(bounds.slam_field_bound(
                e * replicas, cfg, world.angles.shape[0])["bound_ms"])
    out = {}
    if fld:
        out["slam_field_ms_per_tick"] = sum(fld) / len(fld)
    if sum(ism) > 0:
        # No tick mapped: nothing for a map update's roofline to read.
        out["ism_ms_per_tick"] = sum(ism) / len(ism)
    return out
