"""sim/plan_exec against the JAX package's: execute_plan and
execute_plan_subgoals on the same robot and plan, each action's end
position (the trace) and the final pose within 1e-4; the JAX suite's
behaviour checks hold for the port (the square loop returns to its
start, a straight plan is one drive)."""
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import FilterConfig as JFilterConfig
from montecarlolocalisation_tpu.sim import plan_exec as jexec
from montecarlolocalisation_tpu.sim import robot as jrobot
from montecarlolocalisation_tpu_torch.config import (
    DIR_DOWN, DIR_LEFT, DIR_RIGHT, DIR_UP, FilterConfig,
)
from montecarlolocalisation_tpu_torch.sim import plan_exec as texec
from montecarlolocalisation_tpu_torch.sim import robot as trobot

torch.set_num_threads(1)

CASES = {
    "square_loop": ("execute_plan", (2.0, 2.0, 0.0),
                    [DIR_RIGHT, DIR_DOWN, DIR_LEFT, DIR_UP]),
    "turn_by_direction_diff": ("execute_plan", (2.0, 2.0, np.pi / 2),
                               [DIR_RIGHT]),
    "subgoals_straight": ("execute_plan_subgoals", (0.4, 2.0, 0.0),
                          [DIR_RIGHT] * 4),
    "subgoals_l_path": ("execute_plan_subgoals", (2.0, 2.0, 0.0),
                        [DIR_RIGHT, DIR_DOWN, DIR_DOWN]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_traces_match_jax(case):
    fn, start, plan = CASES[case]
    jrb, want = getattr(jexec, fn)(jrobot.make_robot(*start), plan,
                                   JFilterConfig())
    rb = trobot.make_robot(*start, batch=None)
    trb, got = getattr(texec, fn)(rb, plan, FilterConfig())
    assert len(got) == len(want)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=0,
                               atol=1e-4)
    np.testing.assert_allclose(
        [float(trb.x), float(trb.y), float(trb.theta)],
        [float(jrb.x), float(jrb.y), float(jrb.theta)], rtol=0, atol=1e-4)
    assert trb.x.shape == ()
    if case == "square_loop":
        wp = [(2.8, 2.0), (2.8, 2.8), (2.0, 2.8), (2.0, 2.0)]
        for (gx, gy), (wx, wy) in zip(got, wp):
            assert np.hypot(gx - wx, gy - wy) < 0.1
    if case == "subgoals_straight":
        assert len(got) == 1


def test_pose_provider_is_consulted():
    calls = []

    def provider(r):
        calls.append(1)
        return float(r.x), float(r.y), float(r.theta)

    rb = trobot.make_robot(2.0, 2.0, 0.0, batch=None)
    _, trace = texec.execute_plan(rb, [DIR_RIGHT], FilterConfig(),
                                  pose_provider=provider)
    _, want = jexec.execute_plan(jrobot.make_robot(2.0, 2.0, 0.0),
                                 [DIR_RIGHT], JFilterConfig())
    assert calls
    np.testing.assert_allclose(trace, want, rtol=0, atol=1e-4)
