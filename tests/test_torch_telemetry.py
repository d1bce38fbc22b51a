"""utils/profiling's recorder, the stage marks and the graph counters on
the CPU.

- The recorder nests spans, carries ids and parents, keeps a bounded ring
  and adds counters; a span lies inside the CPU profiler's interval of
  the record_function around it (one clock); trace() writes the spans
  into its trace.json.
- A fleet session records `fleet.frame` and its six children in order
  under the frame's tick, none for a command line, and the reply spans of
  the tick answered in pipelined mode; under a profile no event carries a
  program span's name; the `telemetry` command replies with the counters
  and the spans' quantiles.
- An episode call's spans share its id.
- mcl_step marks motion, weights, resample, cluster, emit in order,
  and where refinement is on, refine after motion, then refine_grad and
  refine_score a round; TickGraph marks begin and end once a call; on
  the CPU no mark loads the kernel library.
- refine.calls and refine.rays add 1 and E x N x B x (1 + 2 iters) a
  refinement call, and nothing where refinement is off.
- slam_step marks slam_motion, slam_field, slam_resample, slam_map and
  emit in order, with one or three proposal candidates and with the
  closure on or off; slam.calls and slam.rays add 1 and E x K x P x B a
  call, and nothing on filter ticks.
- graph.builds and graph.capture_s survive GraphCache.clear(), whose
  stats() counts the graphs gone.
"""
import dataclasses
import json
import os
import time

import pytest
import torch

from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.config import SLAMConfig
from montecarlolocalisation_tpu_torch.io.fleet import MCLFleetServer
from montecarlolocalisation_tpu_torch.models import compiled
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import sensor
from montecarlolocalisation_tpu_torch.models import slam as tslam
from montecarlolocalisation_tpu_torch.ops import build
from montecarlolocalisation_tpu_torch.parallel import episodes
from montecarlolocalisation_tpu_torch.sim import robot
from montecarlolocalisation_tpu_torch.utils import profiling

torch.set_num_threads(1)

R, N, BEAMS = 2, 64, 8
FRAME_CHILDREN = ["fleet.decode", "fleet.stage", "fleet.launch",
                  "fleet.wait", "fleet.reply", "fleet.write"]


@pytest.fixture(scope="module")
def world():
    return presets.make_world(num_particles=N, num_beams=BEAMS,
                              device="cpu")


def _lines(world, ticks):
    gen = torch.Generator()
    gen.manual_seed(3)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, ticks, batch=R)
    return [json.dumps(dict(encoder_left=enc[:, k, 0].tolist(),
                            encoder_right=enc[:, k, 1].tolist(),
                            ranges=ranges[:, k].tolist()))
            for k in range(ticks)]


class _Sink:
    def __init__(self):
        self.text = ""

    def write(self, s):
        self.text += s
        return len(s)

    def flush(self):
        pass


def _serve(world, lines, pipeline=False):
    """A session on a new server: (replies, the spans it recorded)."""
    server = MCLFleetServer(world.maze, world.cfg, world.angles,
                            n_robots=R, seed=0, pipeline=pipeline)
    sink = _Sink()
    t0 = time.time_ns()
    server.serve(lines, out_stream=sink)
    return ([json.loads(x) for x in sink.text.splitlines()],
            _since(t0))


def _since(t0):
    return [s for s in profiling.recorded()[0] if s.start >= t0]


def _children(spans, parent_name, parent_id):
    return sorted((s for s in spans if s.parent == parent_name
                   and s.id == parent_id), key=lambda s: s.start)


def test_recorder_nests_spans_keeps_a_ring_and_counts():
    rec = profiling.Recorder(limit=4)
    with rec.span("outer", 7) as outer:
        with rec.span("inner"):
            pass
        rec.record("after", outer.start, outer.start + 5)
        with rec.span("other", 9):
            pass
    spans, counters = rec.read()
    assert [(s.name, s.id, s.parent) for s in spans] == [
        ("inner", 7, "outer"), ("after", 7, "outer"), ("other", 9, "outer"),
        ("outer", 7, None)]
    inner, outer = spans[0], spans[3]
    assert outer.start <= inner.start <= inner.end <= outer.end
    # The ring keeps the last 4: each root span pushes the oldest out, and
    # takes a new id.
    for name in ("root", "root2"):
        with rec.span(name):
            pass
    spans = rec.read()[0]
    assert [s.name for s in spans] == ["other", "outer", "root", "root2"]
    ids = [s.id for s in spans[-2:]]
    assert ids[0] != ids[1] and not {7, 9} & set(ids)
    rec.count("a")
    rec.count("a", 2)
    rec.count("s", 0.25)
    assert counters == {}
    assert rec.read()[1] == {"a": 3, "s": 0.25}


def test_span_lies_inside_the_profilers_interval():
    from torch.profiler import ProfilerActivity, profile, record_function

    rec = profiling.Recorder()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(3):
            with record_function("telemetry_probe"):
                with rec.span("probe"):
                    torch.ones(16).sum()
    probes = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "telemetry_probe")
    spans = sorted((s.start, s.end) for s in rec.read()[0])
    assert len(probes) == len(spans) == 3
    for (p0, p1), (s0, s1) in zip(probes, spans):
        assert p0 <= s0 <= s1 <= p1


def test_fleet_frames_record_their_spans_in_order(world):
    lines = _lines(world, 3)
    lines.insert(1, json.dumps({"cmd": "stats"}))
    replies, spans = _serve(world, lines)
    ticks = [r["tick"] for r in replies if "exact_pose" in r]
    assert ticks == [1, 2, 3]
    frames = [s for s in spans if s.name == "fleet.frame"]
    assert [s.id for s in frames] == ticks           # none for the command
    assert all(s.parent == "fleet.serve" for s in frames)
    (session,) = [s for s in spans if s.name == "fleet.serve"]
    for f in frames:
        kids = _children(spans, "fleet.frame", f.id)
        assert [k.name for k in kids] == FRAME_CHILDREN
        assert f.start <= kids[0].start and kids[-1].end <= f.end
        assert all(a.end <= b.start for a, b in zip(kids, kids[1:]))
        assert session.start <= f.start and f.end <= session.end
        graph = _children(spans, "fleet.launch", f.id)
        assert [g.name for g in graph][-2:] == ["graph.copy_in",
                                                "graph.replay"]
    # Only the first frame built its graph.
    built = [s.id for s in spans if s.name == "graph.build"]
    assert built == [1]


def test_pipelined_reply_spans_carry_the_tick_they_answer(world):
    replies, spans = _serve(world, _lines(world, 3), pipeline=True)
    assert [r["tick"] for r in replies] == [1, 2, 3]
    frames = [s for s in spans if s.name == "fleet.frame"]
    assert [f.id for f in frames] == [1, 2, 3]
    for f in frames:
        inside = sorted((s for s in spans if s.parent == "fleet.frame"
                         and f.start <= s.start and s.end <= f.end),
                        key=lambda s: s.start)
        want = [(n, f.id) for n in FRAME_CHILDREN[:3]]
        if f.id > 1:
            want += [(n, f.id - 1) for n in FRAME_CHILDREN[3:]]
        assert [(s.name, s.id) for s in inside] == want
    # The last reply drains after the stream ends, outside every frame.
    last = [s.name for s in spans if s.id == 3 and s.parent == "fleet.serve"
            and s.name != "fleet.frame"]
    assert last == FRAME_CHILDREN[3:]


def test_no_profiler_event_carries_a_program_span_name(world):
    from torch.profiler import ProfilerActivity, profile

    lines = _lines(world, 3)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, spans = _serve(world, lines)
    names = {s.name for s in spans}
    assert {"fleet.frame", "graph.replay"} <= names
    events = {e.name() for e in prof.profiler.kineto_results.events()}
    assert events and not names & events


def test_telemetry_command_replies_counters_and_quantiles(world):
    lines = _lines(world, 3) + [json.dumps({"cmd": "telemetry"})]
    replies, _ = _serve(world, lines)
    tel = replies[-1]
    assert set(tel) == {"counters", "spans"}
    assert tel["counters"]["graph.builds"] >= 1
    assert "launches.beam_weights_batched_cuda" in tel["counters"]
    assert set(FRAME_CHILDREN) | {"fleet.frame"} <= set(tel["spans"])
    for q in tel["spans"].values():
        assert q["n"] >= 3 and 0 <= q["p50_ms"] <= q["p99_ms"]


def test_episode_call_spans_share_its_id(world):
    m, cfg = world.maze, world.cfg
    enc = torch.zeros(3, 5, 2)
    ranges = torch.full((3, 5, BEAMS), 1.0)
    t0 = time.time_ns()
    episodes.run_episode_batch(0, m, cfg, enc, ranges, world.angles)
    spans = _since(t0)
    (outer,) = [s for s in spans if s.parent is None]
    assert outer.name == "episode.call"
    assert {s.id for s in spans} == {outer.id}
    names = [s.name for s in sorted(spans, key=lambda s: s.start)]
    assert names[:4] == ["episode.call", "episode.prep", "episode.call",
                         "episode.prep"]
    assert {"graph.lookup", "graph.copy_in", "graph.replay",
            "episode.copy_out"} <= set(names)


def _refining(cfg, iters):
    return dataclasses.replace(cfg, refine=dataclasses.replace(
        cfg.refine, iters=iters))


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_mcl_step_marks_the_stages_in_order(world, monkeypatch, iters):
    seen = []
    monkeypatch.setattr(profiling, "mark",
                        lambda name, device: seen.append(name))
    cfg = _refining(world.cfg, iters)
    st = tfilter.init_state(world.maze, cfg, seed=0)
    scan = sensor.make_scan(world.angles, torch.ones(BEAMS))
    tfilter.mcl_step(st, 0.1, 0.1, scan, world.maze, cfg)
    refine = (["refine"] + ["refine_grad", "refine_score"] * iters
              if iters else [])
    assert seen == (["motion"] + refine
                    + ["weights", "resample", "cluster", "emit"])


@pytest.mark.parametrize("iters", [0, 1, 2])
def test_refine_counts_its_calls_and_rays(world, iters):
    cfg = _refining(world.cfg, iters)
    e = 3
    st = tfilter.init_state(world.maze, cfg, seed=0, batch=e)
    scan = sensor.make_scan(world.angles, torch.ones(e, BEAMS))
    before = profiling.recorded()[1]
    for _ in range(2):
        st, _ = tfilter.mcl_step(st, torch.full((e,), 0.1),
                                 torch.full((e,), 0.1), scan, world.maze,
                                 cfg)
    after = profiling.recorded()[1]

    def added(name):
        return after.get(name, 0) - before.get(name, 0)

    calls = 2 if iters else 0
    assert added("refine.calls") == calls
    assert added("refine.rays") == calls * e * N * BEAMS * (1 + 2 * iters)


def test_tick_graph_marks_begin_and_end_once_a_call(monkeypatch):
    seen = []
    monkeypatch.setattr(profiling, "mark",
                        lambda name, device: seen.append(name))

    def step(c, x, consts):
        profiling.mark("motion", x["x"].device)
        v = c["v"] + x["x"]
        return dict(v=v), v

    carry = dict(v=torch.zeros(3))
    xs = dict(x=torch.ones(4, 3))
    graph = compiled.TickGraph(step, carry, xs)
    seen.clear()                       # the warm-up's tick
    graph(carry, xs)
    graph(carry, xs)
    assert seen == (["begin"] + ["motion"] * 4 + ["end"]) * 2
    assert not build.loaded()


def test_graph_counters_survive_clear_and_stats_counts_the_gone():
    cache = compiled.GraphCache()
    carry = dict(v=torch.zeros(3))
    xs = dict(x=torch.ones(1, 3))

    def step(c, x, consts, scale):
        v = c["v"] + scale * x["x"]
        return dict(v=v), v

    before = profiling.recorded()[1]
    for scale in (1.0, 2.0, 1.0):
        compiled.cached(cache, step, carry, xs, None, 0,
                        scale=scale)(carry, xs)
    cache.entries()[0].capture_s = 0.25      # as a capture on a card sets
    cache.clear()
    after = profiling.recorded()[1]
    assert after["graph.builds"] - before.get("graph.builds", 0) == 2
    assert after["graph.hits"] - before.get("graph.hits", 0) == 1
    assert after.get("graph.capture_s", 0) == before.get("graph.capture_s",
                                                         0)   # no capture
    stats = cache.stats()
    assert stats["entries"] == 0 and stats["pool_bytes"] == 0
    assert (stats["builds"], stats["hits"], stats["replays"]) == (2, 1, 3)
    assert stats["capture_s"] == 0.25 and stats["instantiate_s"] == 0.0


def test_trace_writes_the_program_spans(tmp_path):
    logdir = str(tmp_path / "trace")
    with profiling.span("outside"):
        pass
    with profiling.trace(logdir):
        with profiling.span("traced.outer", 5):
            with profiling.span("traced.inner"):
                torch.ones(64).cumsum(0)
    with open(os.path.join(logdir, "trace.json")) as f:
        doc = json.load(f)
    mine = [e for e in doc["traceEvents"] if e.get("cat") == "program_span"]
    assert [e["name"] for e in mine] == ["traced.inner", "traced.outer"]
    assert all(e["ph"] == "X" and e["args"]["id"] == 5 for e in mine)
    assert mine[0]["args"]["parent"] == "traced.outer"
    inner, outer = mine
    # One microsecond timeline: the cumsum the inner span encloses lies
    # inside it (to the export's rounding).
    (op,) = [e for e in doc["traceEvents"] if e.get("name") == "aten::cumsum"]
    eps = 1.0
    assert outer["ts"] - eps <= inner["ts"] <= op["ts"] + eps
    assert op["ts"] + op["dur"] <= inner["ts"] + inner["dur"] + eps
    assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"] + eps


def _slam(world, batch, **fields):
    """A SLAM config of 8 particles on the default 49 x 49 grid with the
    world's sensor and motion, a fresh state of leading dims `batch`, and
    a tick's inputs: encoders [*batch] and ranges [*batch, B]."""
    cfg = SLAMConfig(num_particles=8, sensor=world.cfg.sensor,
                     motion=world.cfg.motion, **fields)
    st = tslam.init_slam(0, torch.tensor([1.25, 1.25, 0.0]), cfg, batch,
                         "cpu")
    gen = torch.Generator()
    gen.manual_seed(4)
    ranges = 0.2 + 0.8 * torch.rand(batch + (BEAMS,), generator=gen)
    enc = torch.full(batch, 0.3)
    return cfg, st, enc, ranges


@pytest.mark.parametrize("closure", [False, True])
@pytest.mark.parametrize("candidates", [1, 3])
def test_slam_step_marks_the_stages_in_order(world, monkeypatch, candidates,
                                             closure):
    seen = []
    monkeypatch.setattr(profiling, "mark",
                        lambda name, device: seen.append(name))
    cfg, st, enc, ranges = _slam(world, (2,),
                                 proposal_candidates=candidates,
                                 closure=closure, keyframe_trans=0.15,
                                 keyframe_rot=0.5)
    mask = torch.ones(ranges.shape, dtype=torch.bool)
    for _ in range(2):
        st, _ = tslam.slam_step(st, enc, enc + 0.1, ranges, world.angles,
                                mask, cfg)
    assert seen == ["slam_motion", "slam_field", "slam_resample", "slam_map",
                    "emit"] * 2
    assert not build.loaded()


def test_slam_counts_its_calls_and_rays(world):
    e, k = 2, 3
    cfg, st, enc, ranges = _slam(world, (e, k))
    mask = torch.ones(ranges.shape, dtype=torch.bool)
    before = profiling.recorded()[1]
    for _ in range(2):
        st, _ = tslam.slam_step(st, enc, enc + 0.1, ranges, world.angles,
                                mask, cfg)
    mid = profiling.recorded()[1]
    fst = tfilter.init_state(world.maze, world.cfg, seed=0, batch=e)
    scan = sensor.make_scan(world.angles, torch.ones(e, BEAMS))
    for _ in range(2):
        fst, _ = tfilter.mcl_step(fst, torch.full((e,), 0.1),
                                  torch.full((e,), 0.1), scan, world.maze,
                                  world.cfg)
    after = profiling.recorded()[1]
    for name, want in (("slam.calls", 2),
                       ("slam.rays", 2 * e * k * 8 * BEAMS)):
        assert mid.get(name, 0) - before.get(name, 0) == want
        assert after.get(name, 0) == mid.get(name, 0)
