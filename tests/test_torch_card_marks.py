"""The stage marks on a CUDA card (marked `card`: skips without one).

A profiled replay of a captured 8-tick graph runs the mark kernels in
stage order, five a tick and `begin` and `end` once, and the recorder's
span around the replay begins, on the profiler's clock, before the
replay's `begin` mark.  Under the production schedule (ESS 0.5, two
rounds of refinement) the replay also runs `refine` after `motion`, then
`refine_grad` and `refine_score` once a round, inside the graph.  RBPF
SLAM's graph (models/slam, 2 episodes x 2 replicas x 128 particles)
runs `slam_motion`, `slam_field`, `slam_resample`, `slam_map` and `emit`
a tick inside `begin` ... `end`, and its device state is the eager
ticks' bit for bit.  The suite's conftest imports JAX, which a card's
host may lack, so run this file alone there:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_card_marks.py
"""
import dataclasses
import time

import pytest
import torch

pytestmark = pytest.mark.card

TICKS, EPISODES = 8, 4


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the stage marks run on the card")
    return torch.device("cuda")


def _profiled_marks(run):
    """The mark kernels (start ns, name) that `run` ran on the card, in
    device order, and the time.time_ns() at which it was called."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        t0 = time.time_ns()
        out = run()
        torch.cuda.synchronize()
        time.sleep(0.05)
    marks = sorted((e.start_ns(), e.name())
                   for e in prof.profiler.kineto_results.events()
                   if "CUDA" in str(e.device_type())
                   and e.name().startswith("mcl_mark_"))
    return marks, t0, out


def _replay_marks(card, **schedule):
    """The mark kernels that one profiled replay of a captured graph ran,
    in device order, and the start of the recorder's `graph.replay` span
    around it."""
    from montecarlolocalisation_tpu_torch import presets
    from montecarlolocalisation_tpu_torch.models import filter as mcl
    from montecarlolocalisation_tpu_torch.sim import robot
    from montecarlolocalisation_tpu_torch.utils import profiling

    world = presets.make_world(num_beams=34, device=card, **schedule)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, TICKS, batch=EPISODES)
    mask = torch.ones(ranges.shape, dtype=torch.bool, device=card)
    angles = torch.as_tensor(world.angles, device=card)

    def replay(state):
        return mcl.run_ticks(state, enc, ranges, mask, angles, world.maze,
                             world.cfg)[0]

    st = replay(mcl.init_state(world.maze, world.cfg, seed=0,
                               batch=EPISODES))       # builds the graph
    marks, t0, _ = _profiled_marks(lambda: replay(st))
    (span,) = [s for s in profiling.recorded()[0]
               if s.name == "graph.replay" and s.start >= t0]
    return marks, span.start


def _expected(motion):
    stages = motion + ["weights", "resample", "cluster", "emit"]
    return (["mcl_mark_begin"] + [f"mcl_mark_{s}" for s in stages] * TICKS
            + ["mcl_mark_end"])


def test_replay_runs_the_marks_in_stage_order(card):
    marks, span_start = _replay_marks(card, num_particles=1500)
    assert [n for _, n in marks] == _expected(["motion"])
    assert span_start < marks[0][0]


def test_replay_runs_the_refine_marks_inside_the_graph(card):
    marks, span_start = _replay_marks(
        card, num_particles=500, resample_method="systematic",
        refine_iters=2, ess_threshold=0.5)
    rounds = ["refine_grad", "refine_score"] * 2
    assert [n for _, n in marks] == _expected(["motion", "refine"]
                                              + rounds)
    assert span_start < marks[0][0]


def test_slam_replay_runs_the_slam_marks_inside_the_graph(card):
    from montecarlolocalisation_tpu_torch import presets
    from montecarlolocalisation_tpu_torch.config import SLAMConfig
    from montecarlolocalisation_tpu_torch.models import slam
    from montecarlolocalisation_tpu_torch.sim import robot
    from montecarlolocalisation_tpu_torch.utils import profiling

    world = presets.make_world(num_beams=24, device=card)
    cfg = SLAMConfig(num_particles=128, sensor=world.cfg.sensor,
                     motion=world.cfg.motion, keyframe_trans=0.15,
                     keyframe_rot=0.5)
    gen = torch.Generator(device=card)
    gen.manual_seed(0)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, TICKS, batch=2)
    batch = (2, 2)
    angles = torch.as_tensor(world.angles, device=card)
    start = torch.tensor([1.25, 1.25, 0.0], device=card)

    def episode(state0):
        return slam.run_slam_episode(0, enc[:, None], ranges[:, None],
                                     angles, cfg, start, state0=state0,
                                     batch=batch, device=card)[0]

    st0 = slam.init_slam(0, start, cfg, batch, card)
    episode(st0)                                       # builds the graph
    g0 = st0.gen.get_state()          # a call moves the caller's generator
    marks, t0, got = _profiled_marks(lambda: episode(st0))
    stages = ["slam_motion", "slam_field", "slam_resample", "slam_map",
              "emit"]
    assert [n for _, n in marks] == (
        ["mcl_mark_begin"] + [f"mcl_mark_{s}" for s in stages] * TICKS
        + ["mcl_mark_end"])
    (span,) = [s for s in profiling.recorded()[0]
               if s.name == "graph.replay" and s.start >= t0]
    assert span.start < marks[0][0]
    # The eager ticks, marks launched between their stages, give the
    # replay's bits.
    st = dataclasses.replace(st0, gen=torch.Generator(device=card))
    st.gen.set_state(g0)
    mask = torch.ones(ranges.shape[-1:], device=card)
    for t in range(TICKS):
        st, _ = slam.slam_step(st, enc[:, None, t, 0], enc[:, None, t, 1],
                               ranges[:, None, t], angles, mask, cfg)
    for f in ("poses", "logodds", "weights", "scores", "log_evidence"):
        assert torch.equal(getattr(st, f), getattr(got, f)), f
