"""The fleet driver: an open loop of fleet frames into the fleet server's
JSONL `serve`, as a fleet host runs it.

Traffic parameters (mclbench/traffic/<mix>.json): `robots`, `period_ms`
(one fleet frame due every period), `warmup_frames` (served in set-up;
the first captures the server's graph), `wander` (the generator's
settings) and `limits` (the check's).

Set-up makes every robot's log from the seed (mclbench/generator.py) and
encodes each fleet frame as the JSON line a fleet host receives:
{"encoder_left": [R], "encoder_right": [R], "ranges": [R][B],
"mask": [R][B]}.  In the window, frame k is due at start + k * period
whatever the server is doing; it is handed to `serve` at its due time, or
as soon as the server asks for it after that, and it is timed from its
due time to the moment its reply line is written.  A frame whose reply is
an error, or that gets none, has failed and misses every limit.

For the check, the driver keeps a copy of the fleet's state in host
memory, with its generator's state, before every frame (in the idle time
after the previous reply, outside every frame's time); a traced run keeps
none inside its traced frames.
"""
from __future__ import annotations

import gc
import json
import math
import time

import torch

from .. import generator
from ..compare import Unit
from ..reference import filter as ref
from ..trace import Profile, Reading, span
from . import Run, nearest_rank, sleep_until


class _Sink:
    """The server's output stream: each reply line with the time it was
    written (flushed)."""

    def __init__(self, on_reply=None):
        self._buf = []
        self.lines = []
        self.times = []
        self.on_reply = on_reply

    def write(self, s: str) -> int:
        self._buf.append(s)
        return len(s)

    def flush(self) -> None:
        text = "".join(self._buf)
        self._buf.clear()
        for line in text.splitlines():
            if line.strip():
                self.times.append(time.perf_counter())
                self.lines.append(line)
                if self.on_reply is not None:
                    self.on_reply()


def frame_lines(enc, ranges) -> list:
    """One JSON line a fleet frame: enc [R, T, 2], ranges [R, T, B]."""
    enc = enc.cpu()
    ranges = ranges.cpu()
    r, t, b = ranges.shape
    mask = [[True] * b] * r
    return [json.dumps(dict(encoder_left=enc[:, k, 0].tolist(),
                            encoder_right=enc[:, k, 1].tolist(),
                            ranges=ranges[:, k].tolist(), mask=mask))
            for k in range(t)]


def run(world, traffic: dict, seed: int, seconds: float, trace: bool,
        program=None) -> Run:
    robots = int(traffic["robots"])
    period = traffic["period_ms"] * 1e-3
    warm = int(traffic["warmup_frames"])
    n_win = max(1, math.ceil(seconds / period - 1e-9))
    total = warm + n_win
    s_traffic, s_filter = generator.seeds(seed, 2)
    marks = [time.perf_counter()]
    enc, ranges, _ = generator.logs(
        s_traffic, world.mz, world.angles, world.sensor, world.motion,
        robots, total, generator.Wander(**traffic["wander"]))
    world.synchronize()
    marks.append(time.perf_counter())
    lines = frame_lines(enc, ranges)
    marks.append(time.perf_counter())
    if program is None:
        from ..program import FleetProgram

        program = FleetProgram(world, robots, s_filter)
    else:
        program = program(world, robots, s_filter)
    server = program.server
    marks.append(time.perf_counter())
    snaps = {}          # frame k -> (state, generator state) before it
    sink = _Sink()

    def snapshot():
        """The fleet's state, copied to host memory (the copies stay off
        the card, whose memory peak is the program's)."""
        st, gen = program.snapshot()
        return ref.State(**{k: v.cpu() for k, v in vars(st).items()}), gen

    def warm_lines():
        for k in range(warm):
            if k:
                snaps[k] = snapshot()
            yield lines[k]
        snaps[warm] = snapshot()

    server.serve(warm_lines(), sink)
    world.synchronize()
    marks.append(time.perf_counter())

    # Traced run: frames [p0, p1) in the profile, no copies kept there.
    p0 = p1 = -1
    prof = None
    if trace:
        n_prof = max(1, min(20, n_win // 3))
        p0 = warm + (n_win - n_prof) // 2
        p1 = p0 + n_prof
        prof = Profile(world.device.type == "cuda")
        prof.warm_up()
    due = [0.0] * n_win
    handed = [0.0] * n_win
    state = dict(span=None)

    def replied():
        if state["span"] is not None:
            state["span"].__exit__(None, None, None)
            state["span"] = None

    sink.on_reply = replied
    # Set-up's objects out of the collector's way, so that a full
    # collection in the window scans only what the window makes.
    gc.collect()
    gc.freeze()
    start = time.perf_counter()

    def window_lines():
        for i in range(n_win):
            k = warm + i
            due[i] = start + i * period
            if k == p1:
                sleep_until(due[i] - 0.01)
                prof.stop()
                stopped.append(time.perf_counter())
            if k > warm and not p0 < k < p1:
                snaps[k] = snapshot()
            if k == p0:
                sleep_until(due[i] - 0.05)
                prof.start()
            if p0 <= k < p1:
                with span("idle until the frame is due"):
                    sleep_until(due[i])
                handed[i] = time.perf_counter()
                state["span"] = span("serve frame")
                state["span"].__enter__()
            else:
                sleep_until(due[i])
                handed[i] = time.perf_counter()
            yield lines[k]
        if p1 == warm + n_win:
            prof.stop()
            stopped.append(time.perf_counter())
        snaps[warm + n_win] = snapshot()

    stopped = []
    server.serve(window_lines(), sink)
    world.synchronize()

    replies = [json.loads(x) for x in sink.lines]
    n_warm_replies = warm
    win = replies[n_warm_replies:]
    win_t = sink.times[n_warm_replies:]
    lat, failed = [], 0
    for i in range(n_win):
        ok = i < len(win) and "error" not in win[i]
        if not ok:
            failed += 1
        lat.append((win_t[i] - due[i]) * 1e3 if ok else math.inf)
    metrics = dict(frame_p50_ms=nearest_rank(lat, 0.50),
                   latency_ms_quantiles={
                       str(q): nearest_rank(lat, q)
                       for q in (0.1, 0.25, 0.75, 0.9, 0.99, 1.0)},
                   service_ms_median=nearest_rank(
                       [(t - h) * 1e3 for t, h in zip(win_t, handed)], 0.5),
                   frame_p95_ms=nearest_rank(lat, 0.95),
                   late_ms_max=max(h - d for h, d in zip(handed, due)) * 1e3,
                   setup_parts_s=dict(zip(
                       ("logs", "frames", "program", "warm_up"),
                       (b - a for a, b in zip(marks, marks[1:])))))

    units = _units(world, replies, snaps, enc, ranges, s_filter, total)
    reading = None
    if trace:
        ops, spans = prof.events()
        frames = range(p0 - warm, p1 - warm)
        # The frames outside the profile, and not due before its stop had
        # returned: the profiler slows the host's work while it runs.
        outside = [i for i in range(n_win) if i < frames.start
                   or (i >= frames.stop and due[i] > stopped[0])]
        service = [(sink.times[warm + i] - handed[i]) * 1e3
                   for i in outside if math.isfinite(lat[i])]
        # The window on the profiler's clock: the spans of the frames and
        # the periods between them.
        ns = sorted(spans, key=lambda s: s[1])
        w0 = ns[0][1] if ns else 0
        reading = Reading(ops=ops, spans=spans,
                          window=(w0, w0 + int(len(frames) * period * 1e9)),
                          ticks=len(frames), service_ms=service,
                          latency_ms=[lat[i] for i in outside])
    return Run(window_start=start, metrics=metrics, attempted=n_win,
               failed=failed, units=units,
               reading=reading)


def _units(world, replies, snaps, enc, ranges, s_filter, total) -> list:
    """One check unit a frame whose reply and end state are known: frame
    0 from the filter seed, every other frame from the copy kept before
    it."""
    units = []
    for k in range(total):
        if k >= len(replies) or k + 1 not in snaps:
            continue
        if k and k not in snaps:
            continue
        rep = replies[k]
        if "error" in rep:
            continue
        after, gen_after = snaps[k + 1]
        nxt = replies[k + 1] if k + 1 < len(replies) else None
        best = (torch.tensor(nxt["exact_pose"]) if nxt and "error" not in nxt
                else after.best_pose[:].cpu())
        start, gen = snaps[k] if k else (None, None)
        units.append(Unit(
            start=start, gen_state=gen, seed=s_filter,
            enc=enc[:, k:k + 1], ranges=ranges[:, k:k + 1],
            confidence=torch.tensor(rep["confidence"])[:, None],
            song=torch.tensor(rep["song"])[:, None],
            best_pose=best[:, None], after=after.particles,
            gen_after=gen_after))
    return units
