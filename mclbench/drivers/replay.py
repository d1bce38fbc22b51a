"""The replay driver: recorded logs replayed back to back through an
episode entry, as offline sweeps and global localisation runs do.

Traffic parameters (mclbench/traffic/<mix>.json): `entry`
("run_episode": one filter; "run_episode_batch": `episodes` filters),
`episodes`, `ticks` (a log's length), `segment_ticks` (the ticks handed to
the entry a call; the state carries over), `check_segments` (segments the
check follows besides the first), `wander` (the generator's settings) and
`limits` (the check's).

Set-up makes the logs from the seed (mclbench/generator.py) and runs one
pass, which builds every graph the window replays.  The window runs pass
after pass over the same logs, each pass a fresh filter with its own seed,
until --seconds have passed, and ends at a synchronize after the last
call; updates_per_s is episodes x particles x beams x the ticks completed
over the window's length.

For the check, the driver keeps, for the sampled segments, the state the
call started from (the previous call's result, or the pass's seed), its
generator's state, the answers and the state it returned (its
particles and weights, and its generator's state).
"""
from __future__ import annotations

import gc
import time

import torch

from .. import bounds, generator
from ..compare import Unit
from ..reference import filter as ref
from ..trace import Profile, Reading, span
from . import Run, pick

PROFILE_SECONDS = 1.0


def pass_seed(s_filter: int, p: int) -> int:
    return generator.seeds(s_filter * 1_000_003 + p, 1)[0]


def run(world, traffic: dict, seed: int, seconds: float, trace: bool,
        program=None) -> Run:
    e = int(traffic["episodes"])
    ticks = int(traffic["ticks"])
    seg = int(traffic["segment_ticks"])
    s_traffic, s_filter, s_check = generator.seeds(seed, 3)
    marks = [time.perf_counter()]
    enc, ranges, _ = generator.logs(
        s_traffic, world.mz, world.angles, world.sensor, world.motion, e,
        ticks, generator.Wander(**traffic["wander"]))
    if program is None:
        from ..program import ReplayProgram

        program = ReplayProgram(world, traffic["entry"], e)
    else:
        program = program(world, traffic["entry"], e)
    spans_ = [(t0, min(seg, ticks - t0)) for t0 in range(0, ticks, seg)]
    world.synchronize()
    marks.append(time.perf_counter())

    def call(st, p_seed, t0, n):
        return program.segment(st, p_seed, enc[:, t0:t0 + n],
                               ranges[:, t0:t0 + n])[0]

    # Set-up: a pass's first segment and its last (the remainder's shape)
    # build every graph the window replays; then a few segments, timed,
    # place the checked segments inside the window.
    w_seed = pass_seed(s_filter, -1)
    st = call(None, w_seed, *spans_[0])
    call(st, w_seed, *spans_[-1])
    world.synchronize()
    marks.append(time.perf_counter())
    timed = min(4, len(spans_))
    t0 = time.perf_counter()
    st = None
    for t, n in spans_[:timed]:
        st = call(st, w_seed, t, n)
    world.synchronize()
    seg_s = (time.perf_counter() - t0) / timed
    marks.append(time.perf_counter())
    expect = max(2, int(0.8 * seconds / seg_s))
    n_check = int(traffic["check_segments"])
    checked = {0} | set(pick(s_check, n_check, 1, expect))
    prof_first = prof_last = -1
    prof = None
    if trace:
        n_prof = max(2, int(PROFILE_SECONDS / seg_s))
        prof_first = max(1, (expect - n_prof) // 2)
        prof_last = prof_first + n_prof
        checked -= set(range(prof_first - 1, prof_last + 1))
        prof = Profile(world.device.type == "cuda")
        prof.warm_up()

    kept = {}             # segment j -> dict for the check
    prof_states = []      # (state, generator state, t0) at traced segments
    done_ticks = attempted = failed = 0
    j = p = 0
    st = None
    prof_ops = None
    # Set-up's objects out of the collector's way, so that a full
    # collection in the window scans only what the window makes.
    gc.collect()
    gc.freeze()
    start = time.perf_counter()
    while True:
        p_seed = pass_seed(s_filter, p)
        for t0, n in spans_:
            if j == prof_first:
                world.synchronize()
                prof.start()
                time.sleep(0.05)
                t_prof = time.perf_counter()
            traced = prof_first <= j < prof_last
            if j in checked or (traced and len(prof_states) < 4):
                before = None if st is None else program.snapshot(st)
                if j in checked:
                    kept[j] = dict(before=before, seed=p_seed, t0=t0, n=n)
                else:
                    prof_states.append((before, p_seed, t0))
            if traced:
                with span("segment call"):
                    st, outs = program.segment(st, p_seed,
                                               enc[:, t0:t0 + n],
                                               ranges[:, t0:t0 + n])
            else:
                st, outs = program.segment(st, p_seed, enc[:, t0:t0 + n],
                                           ranges[:, t0:t0 + n])
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
                prof_ticks = sum(spans_[(jj % len(spans_))][1]
                                 for jj in range(prof_first, prof_last))
            if time.perf_counter() - start >= seconds:
                break
        else:
            st = None
            p += 1
            continue
        break
    world.synchronize()
    window = time.perf_counter() - start
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
    metrics = dict(updates_per_s=e * n_part * nb * done_ticks / window,
                   window_s=window, ticks=done_ticks, segment_s=seg_s,
                   setup_parts_s=dict(zip(
                       ("logs_and_program", "warm_up", "timing"),
                       (b - a for a, b in zip(marks, marks[1:])))))

    units = [_unit(world, k, enc, ranges) for k in kept.values()
             if "after" in k]
    reading = None
    if trace:
        ops, spans = prof_ops
        busy = [(s, t) for _, s, t in ops]
        win = ((min(s for s, _ in busy), max(t for _, t in busy)) if busy
               else (0, 1))
        reading = Reading(ops=ops, spans=spans, window=win, ticks=prof_ticks,
                          pending=lambda: _bounds(world, prof_states, e))
    return Run(window_start=start, metrics=metrics, attempted=attempted,
               failed=failed, units=units,
               reading=reading, free=getattr(program, "free", lambda: None))


def _unit(world, k: dict, enc, ranges) -> Unit:
    t0, n = k["t0"], k["n"]
    a = k["answers"]
    after, gen_after = k["after"]
    best = torch.cat([a["exact_pose"][:, 1:].float(),
                      after.best_pose[:, None]], dim=1)
    start, gen = k["before"] if k["before"] is not None else (None, None)
    return Unit(start=start, gen_state=gen, seed=k["seed"],
                enc=enc[:, t0:t0 + n], ranges=ranges[:, t0:t0 + n],
                confidence=a["confidence"], song=a["song"], best_pose=best,
                after=after.particles, gen_after=gen_after,
                weights_after=after.weights)


def _bounds(world, states, episodes: int) -> dict:
    """The yardstick's K1 and K3 bounds a tick, on the states that began
    the traced segments (a pass's first segment: the seed's cloud), with
    the k-means draws of their first tick from the state's random
    stream."""
    k1, k3 = [], []
    for before, p_seed, _ in states:
        if before is None:
            st, gen = ref.init(world.mz, world.filter, p_seed, episodes)
        else:
            st, g = before
            gen = torch.Generator(device=world.device)
            gen.set_state(g)
        d = ref.draw_tick(gen, world.mz, world.filter, episodes)
        parts = st.particles
        k1.append(bounds.k1_bound(world.mz, parts, world.angles,
                                  world.sensor)["bound_ms"])
        xy = parts[..., :2]
        c0 = torch.take_along_dim(xy, d["kmeans_init"][..., None], dim=-2)
        rs = torch.take_along_dim(
            xy, d["kmeans_reseed"].reshape(xy.shape[0], -1)[..., None],
            dim=-2).reshape(d["kmeans_reseed"].shape + (2,))
        k3.append(bounds.k3_bound(xy, c0, rs)["bound_ms"])
    if not k1:
        return {}
    return dict(k1_ms_per_tick=sum(k1) / len(k1),
                k3_ms_per_tick=sum(k3) / len(k3))
