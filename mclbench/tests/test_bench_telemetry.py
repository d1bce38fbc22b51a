"""The per-layer metrics that read the program's own marks, spans and
counters (mclbench/program_telemetry.py), each on a synthetic reading.

- A replay trace with stage marks: each stage's, the outside's and the
  idle-in-graph numbers; stages, outside and the marks' own time add up
  to the device's busy time; the idle inside the graph is a part of
  idle_share.replay.
- A fleet session: the frames of the session that holds the traced
  window, less those that overlap it (widened by one period) or built a
  graph, and the medians of their phases.
- graph_setup_s sums the capture and instantiation counters.
- Every reader gives None where there is nothing to read: a trace with
  no mark (the parent's program), a port with no recorder.
- A mark of any other name opens a stage of that name: a `refine` mark
  between `motion` and `weights` takes its time from `motion`; on traces
  of today's marks the split is the one the fixed set of marks gave.
"""
from __future__ import annotations

import random

import pytest

from mclbench import harness, program_telemetry
from mclbench.trace import Reading

from . import tiny

STAGE_METRICS = ("motion", "weights", "resample", "cluster", "bookkeeping")


def _read(name, r):
    return harness.metric_reader(tiny.ROOT, name).read(r)


def _replay_ops():
    """Two replays of two ticks each, every op 10 ns with a 2 ns gap after
    it, each replay with a copy-in before it and a copy-out after it
    (outside its extent), and a 100 ns gap between the replays."""
    tick = ["bookkeeping_op", "mcl_mark_motion", "motion_op",
            "mcl_mark_weights", "beam_weights_batched_kernel",
            "mcl_mark_resample", "resample_op", "mcl_mark_cluster",
            "void kmeans_kernel<3>", "mcl_mark_emit", "slab_copy"]
    replay = (["Memcpy HtoD", "mcl_mark_begin"] + tick + tick
              + ["mcl_mark_end", "Memcpy DtoD"])
    ops, t = [], 1000
    for _ in range(2):
        for name in replay:
            ops.append((name, t, t + 10))
            t += 12
        t += 100
    return ops


def _replay_reading(ops):
    return Reading(ops=ops, spans=[], window=(ops[0][1], ops[-1][2]),
                   ticks=4)


def test_stage_metrics_split_the_device_time():
    ops = _replay_ops()
    r = _replay_reading(ops)
    per_tick = 1e-6 / 4
    # Per replay: motion, weights, resample, cluster 2 ops each; the
    # bookkeeping 4 (the begin's and the emit's); outside 2 copies.
    for stage in ("motion", "weights", "resample", "cluster"):
        assert _read(f"{stage}_ms_per_tick.replay", r) == pytest.approx(
            2 * 2 * 10 * per_tick)
    assert _read("bookkeeping_ms_per_tick.replay", r) == pytest.approx(
        2 * 4 * 10 * per_tick)
    assert _read("outside_graph_ms_per_tick.replay", r) == pytest.approx(
        2 * 2 * 10 * per_tick)
    split = program_telemetry.stage_split(r)
    assert split["marks"] == pytest.approx(2 * 12 * 10 * per_tick)
    total = sum(split[k] for k in program_telemetry.STAGES + ("outside",
                                                              "marks"))
    assert total == pytest.approx(_read("device_ms_per_tick.replay", r))
    # K1 and K3 lie inside their stages.
    assert _read("weights_ms_per_tick.replay", r) >= r.ms_per_tick(
        lambda n: "beam_weights" in n)
    assert _read("cluster_ms_per_tick.replay", r) >= r.ms_per_tick(
        lambda n: "kmeans_kernel" in n)


def test_idle_in_graph_is_the_gaps_inside_the_extents():
    ops = _replay_ops()
    r = _replay_reading(ops)
    # An extent: begin, 22 tick ops and end, 24 ops, 23 gaps of 2 ns.
    window = r.window[1] - r.window[0]
    want = 100.0 * 2 * 23 * 2 / window
    got = _read("idle_in_graph_share.replay", r)
    assert got == pytest.approx(want)
    assert got < _read("idle_share.replay", r)


def test_a_mark_of_another_name_opens_its_own_stage():
    """Each motion op is followed by a refine op, with and without a
    refine mark before it: with the mark, the refine stage takes the
    refine ops' time from the motion stage."""
    def trace(mark):
        out = []
        for name, s, e in _replay_ops():
            if name == "motion_op":
                out += [("motion_op", s, s + 4)]
                if mark:
                    out.append(("mcl_mark_refine", s + 4, s + 5))
                out.append(("refine_op", s + 5, s + 10))
            else:
                out.append((name, s, e))
        return _replay_reading(out)

    before = program_telemetry.stage_split(trace(False))
    r = trace(True)
    split = program_telemetry.stage_split(r)
    per_tick = 1e-6 / 4
    assert "refine" not in before
    assert before["motion"] == pytest.approx(4 * 9 * per_tick)
    assert split["motion"] == pytest.approx(4 * 4 * per_tick)
    assert split["refine"] == pytest.approx(4 * 5 * per_tick)
    assert program_telemetry.stage_ms(r, "refine") == split["refine"]
    for k in ("weights", "resample", "cluster", "bookkeeping", "outside"):
        assert split[k] == before[k]
    assert list(split)[:7] == list(program_telemetry.STAGES) + [
        "outside", "marks"]
    # A stage that no mark opened reads nothing.
    assert program_telemetry.stage_ms(trace(False), "refine") is None


def _mixed_trace(seed=5, n=400):
    """Today's seven marks among kernels, in a random order, with random
    lengths and overlaps."""
    rng = random.Random(seed)
    names = ([f"mcl_mark_{m}" for m in ("begin", "motion", "weights",
                                        "resample", "cluster", "emit",
                                        "end")]
             + ["op_a", "beam_weights_batched_kernel",
                "void kmeans_kernel<3>", "Memcpy HtoD"] * 3)
    ops, t = [], 1000
    for _ in range(n):
        d = rng.randint(1, 40)
        ops.append((rng.choice(names), t, t + d))
        t += d + rng.randint(0, 30) - 8
    return ops


def test_todays_marks_split_as_before():
    """The splits the fixed set of marks gave, to the bit."""
    split = program_telemetry.stage_split(_replay_reading(_replay_ops()))
    assert split == {
        "motion": 9.999999999999999e-06, "weights": 9.999999999999999e-06,
        "resample": 9.999999999999999e-06, "cluster": 9.999999999999999e-06,
        "bookkeeping": 1.9999999999999998e-05,
        "outside": 9.999999999999999e-06, "marks": 5.9999999999999995e-05,
        "idle_in_graph_share": 12.742382271468143}
    ops = _mixed_trace()
    r = Reading(ops=ops, spans=[], window=(ops[0][1],
                                           max(e for _, _, e in ops)),
                ticks=7)
    assert program_telemetry.stage_split(r) == {
        "motion": 9.728571428571428e-05, "weights": 7.328571428571429e-05,
        "resample": 8.685714285714285e-05,
        "cluster": 0.00010285714285714284, "bookkeeping": 0.000247,
        "outside": 0.00010957142857142857, "marks": 0.00044399999999999995,
        "idle_in_graph_share": 4.783908670834466}


def test_replay_metrics_read_nothing_without_marks():
    ops = [op for op in _replay_ops() if "mcl_mark_" not in op[0]]
    r = _replay_reading(ops)
    for name in ([f"{s}_ms_per_tick.replay" for s in STAGE_METRICS]
                 + ["outside_graph_ms_per_tick.replay",
                    "idle_in_graph_share.replay"]):
        assert _read(name, r) is None
    assert _read("device_ms_per_tick.replay", r) is not None


def _span(name, id, parent, start, end):
    from montecarlolocalisation_tpu_torch.utils.profiling import Span

    return Span(name, id, parent, start, end)


PHASES = ("fleet.decode", "fleet.stage", "fleet.launch", "fleet.wait",
          "fleet.reply", "fleet.write")


def _frame(tick, start, ms, build=False):
    """A frame at `start` ns whose six phases take ms[i] ms each, one
    after another, with 1 us of the frame's own time at its end."""
    spans, t = [], start
    for name, d in zip(PHASES, ms):
        end = t + int(d * 1e6)
        spans.append(_span(name, tick, "fleet.frame", t, end))
        if build and name == "fleet.launch":
            spans.append(_span("graph.build", tick, "graph.lookup", t + 1,
                               end - 1))
        t = end
    spans.append(_span("fleet.frame", tick, "fleet.serve", start, t + 1000))
    return spans


def _fleet(monkeypatch):
    """A warm-up session (3 frames, the first building its graph), then
    the window's session: 10 frames every 100 ms, the traced window over
    frames 4 and 5.  Frame k's phases take (k, 1, 2, 0.5, 0.25, 0.125)
    ms."""
    ms = 1_000_000
    spans = []
    for k in range(3):
        spans += _frame(k + 1, k * 20 * ms, (0.1, 1, 50, 0.5, 0.25, 0.125),
                        build=k == 0)
    spans.append(_span("fleet.serve", 0, None, 0, 70 * ms))
    t0 = 1000 * ms
    for k in range(10):
        spans += _frame(4 + k, t0 + k * 100 * ms,
                        (k, 1, 2, 0.5, 0.25, 0.125))
    spans.append(_span("fleet.serve", 1, None, t0 - ms, t0 + 1000 * ms))
    monkeypatch.setattr(program_telemetry, "recorded",
                        lambda: (spans, {}))
    # The traced window: frames 4 and 5 of the session (k = 4, 5), from
    # 50 ms before the first is due.
    w0 = t0 + 400 * ms - 50 * ms
    return Reading(ops=[], spans=[], window=(w0, w0 + 200 * ms), ticks=2)


def test_fleet_metrics_take_the_frames_outside_the_profile(monkeypatch):
    r = _fleet(monkeypatch)
    frames = program_telemetry.fleet_frames(r)
    # Of the window's 10 frames, k = 4, 5 lie in the window and k = 6 in
    # the period after it; the warm-up's frames are another session's.
    assert len(frames) == 7
    assert sorted(f["fleet.decode"] for f in frames) == pytest.approx(
        [0, 1, 2, 3, 7, 8, 9])
    assert _read("decode_ms.fleet", r) == pytest.approx(3 + 1)
    assert _read("launch_ms.fleet", r) == pytest.approx(2)
    assert _read("wait_ms.fleet", r) == pytest.approx(0.5)
    assert _read("encode_ms.fleet", r) == pytest.approx(0.375)


def test_fleet_metrics_drop_a_frame_that_built_a_graph(monkeypatch):
    r = _fleet(monkeypatch)
    spans, _ = program_telemetry.recorded()
    frame = min((s for s in spans if s.name == "fleet.frame" and s.id > 3),
                key=lambda s: s.start)
    spans.append(_span("graph.build", frame.id, "graph.lookup",
                       frame.start + 10, frame.start + 20))
    assert len(program_telemetry.fleet_frames(r)) == 6


def test_readers_read_nothing_without_the_recorder(monkeypatch):
    r = _fleet(monkeypatch)
    monkeypatch.setattr(program_telemetry, "recorded", lambda: None)
    for name in ("decode_ms.fleet", "launch_ms.fleet", "wait_ms.fleet",
                 "encode_ms.fleet", "graph_setup_s"):
        assert _read(name, r) is None


def test_graph_setup_sums_the_capture_counters(monkeypatch):
    r = Reading(ops=[], spans=[], window=(0, 1), ticks=1)
    monkeypatch.setattr(program_telemetry, "recorded", lambda: (
        [], {"graph.capture_s": 0.5, "graph.instantiate_s": 0.25,
             "graph.builds": 3}))
    assert _read("graph_setup_s", r) == pytest.approx(0.75)
    monkeypatch.setattr(program_telemetry, "recorded",
                        lambda: ([], {"graph.builds": 3}))
    assert _read("graph_setup_s", r) is None


def test_the_port_recorder_is_read():
    got = program_telemetry.recorded()
    assert got is not None
    spans, counters = got
    assert isinstance(spans, list) and isinstance(counters, dict)
