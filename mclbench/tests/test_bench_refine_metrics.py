"""The refinement's per-layer metrics on synthetic readings.

- A replay trace whose motion stage holds the production schedule's
  refinement under its three marks (`refine`, then `refine_grad` and
  `refine_score` a round): refine_ms_per_tick.replay is the three stages,
  refine_grad_ms_per_tick.replay the gradient's, and
  refine_score_ms_per_tick.replay the start's and the proposals'
  scoring; `motion` loses exactly their time, and nothing else moves.
- refine_ns_per_ray.replay is the three stages' time over the rays a
  tick, the port's counters refine.rays over refine.calls.
- Each reads None on a trace without refine marks (the parent's
  program, or a cell without refinement) and the ns-per-ray metric
  without the counters.
"""
from __future__ import annotations

import pytest

from mclbench import harness, program_telemetry
from mclbench.trace import Reading

from . import tiny

TICKS = 4
REFINE = ("refine_ms_per_tick.replay", "refine_grad_ms_per_tick.replay",
          "refine_score_ms_per_tick.replay", "refine_ns_per_ray.replay")


def _read(name, r):
    return harness.metric_reader(tiny.ROOT, name).read(r)


def _trace(marks: bool):
    """Two replays of two ticks.  A tick: a bookkeeping op, the motion
    mark and a 4 ns motion op, then the refinement (the start's scoring 3
    ns; two rounds of a 7 ns gradient and a 5 ns scoring), then weights,
    resample, cluster and emit, as the tick's stage marks run them.
    Without `marks` the refinement's ops follow motion's unmarked."""
    refine = [("mcl_mark_refine", None), ("score_start", 3)]
    for _ in range(2):
        refine += [("mcl_mark_refine_grad", None), ("dda_fwd_bwd", 7),
                   ("mcl_mark_refine_score", None), ("score_prop", 5)]
    tick = ([("bookkeeping_op", 10), ("mcl_mark_motion", None),
             ("motion_op", 4)]
            + [(n, d) for n, d in refine if marks or d is not None]
            + [("mcl_mark_weights", None), ("beam_weights_batched_kernel",
                                            10),
               ("mcl_mark_resample", None), ("resample_op", 10),
               ("mcl_mark_cluster", None), ("void kmeans_kernel<3>", 10),
               ("mcl_mark_emit", None), ("slab_copy", 10)])
    replay = ([("Memcpy HtoD", 10), ("mcl_mark_begin", None)] + tick + tick
              + [("mcl_mark_end", None), ("Memcpy DtoD", 10)])
    ops, t = [], 1000
    for _ in range(2):
        for name, d in replay:
            d = 1 if d is None else d
            ops.append((name, t, t + d))
            t += d + 2
        t += 100
    return Reading(ops=ops, spans=[], window=(ops[0][1], ops[-1][2]),
                   ticks=TICKS)


def _counters(monkeypatch, counters):
    monkeypatch.setattr(program_telemetry, "recorded",
                        lambda: ([], counters))


def test_the_refine_marks_split_the_motion_stage():
    before = program_telemetry.stage_split(_trace(False))
    r = _trace(True)
    split = program_telemetry.stage_split(r)
    per_tick = 1e-6 / TICKS
    # Two replays of two ticks: each stage's ns a tick times 4 ticks.
    assert before["motion"] == pytest.approx(4 * (4 + 3 + 2 * 12)
                                             * per_tick)
    assert split["motion"] == pytest.approx(4 * 4 * per_tick)
    assert _read("refine_grad_ms_per_tick.replay", r) == pytest.approx(
        4 * 2 * 7 * per_tick)
    assert _read("refine_score_ms_per_tick.replay", r) == pytest.approx(
        4 * (3 + 2 * 5) * per_tick)
    refine_ms = _read("refine_ms_per_tick.replay", r)
    assert refine_ms == pytest.approx(4 * (3 + 2 * 12) * per_tick)
    assert split["motion"] + refine_ms == pytest.approx(before["motion"])
    for k in ("weights", "resample", "cluster", "bookkeeping", "outside"):
        assert split[k] == before[k]
    assert _read("motion_ms_per_tick.replay", r) == split["motion"]


def test_ns_per_ray_reads_the_counters(monkeypatch):
    r = _trace(True)
    e, n, b, iters = 1024, 500, 24, 2
    rays = e * n * b * (1 + 2 * iters)
    _counters(monkeypatch, {"refine.calls": 3, "refine.rays": 3 * rays})
    want = _read("refine_ms_per_tick.replay", r) * 1e6 / rays
    assert _read("refine_ns_per_ray.replay", r) == pytest.approx(want)
    _counters(monkeypatch, {"graph.builds": 2})
    assert _read("refine_ns_per_ray.replay", r) is None
    monkeypatch.setattr(program_telemetry, "recorded", lambda: None)
    assert _read("refine_ns_per_ray.replay", r) is None


@pytest.mark.parametrize("name", REFINE)
def test_the_refine_metrics_read_nothing_without_refine_marks(
        name, monkeypatch):
    _counters(monkeypatch, {"refine.calls": 1, "refine.rays": 10})
    assert _read(name, _trace(False)) is None
    ops = [op for op in _trace(True).ops if "mcl_mark_" not in op[0]]
    assert _read(name, Reading(ops=ops, spans=[], window=(ops[0][1],
                                                          ops[-1][2]),
                               ticks=TICKS)) is None
