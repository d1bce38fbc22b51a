"""`correct` comes out false for the control and for each fault a cell can
have, on the CPU at a tiny size: the harness runs as on the card (its look
for a card skipped) with the timed path broken underneath.

The faults, planted in the tick that the cell's entry runs
(models/filter.mcl_step for the filter's and the closed loop's cells,
models/slam.slam_step for SLAM's): a step that returns its state
unchanged; half of the batch (the filters, or one filter's particles; for
SLAM the episodes) left unstepped; an answer altered where it is produced
(filter 0's published confidence; episode 0's published SLAM poses).
One card runs each cell, so no exchange between chips can be left out.
"""
from __future__ import annotations

import dataclasses
import io

import pytest
import torch

from mclbench import control, harness

from . import tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def _half(new, old):
    """new with the second half of its filters (one filter: of its
    particles) as in old."""
    def mix(a, b):
        if not isinstance(a, torch.Tensor) or a.dim() == 0:
            return a
        axis = 0 if old.particles.dim() == 3 else (
            a.dim() - 2 if a.shape[-1] == 3 else a.dim() - 1)
        if a.dim() <= axis:
            return a
        h = a.shape[axis] // 2
        return torch.cat([a.narrow(axis, 0, h),
                          b.narrow(axis, h, a.shape[axis] - h)], dim=axis)

    return dataclasses.replace(
        new, particles=mix(new.particles, old.particles),
        weights=mix(new.weights, old.weights))


def _half_episodes(new, old):
    """A SLAM state with the second half of its episodes as in old."""
    def mix(a, b):
        h = a.shape[0] // 2
        return torch.cat([a[:h], b[h:]])

    return dataclasses.replace(new, **{
        f: mix(getattr(new, f), getattr(old, f))
        for f in ("poses", "logodds", "weights", "scores", "kf_pose",
                  "log_evidence")})


def _fault(kind, driver: str = "replay"):
    """(module, name, the faulty step) for the tick the driver's entry
    runs."""
    if driver == "slam":
        from montecarlolocalisation_tpu_torch.models import slam as module

        name = "slam_step"
    else:
        from montecarlolocalisation_tpu_torch.models import filter as module

        name = "mcl_step"
    real = getattr(module, name)

    def step(state, *args, **kw):
        new, out = real(state, *args, **kw)
        if kind == "unchanged":
            return state, out
        if kind == "half":
            half = _half_episodes if driver == "slam" else _half
            return half(new, state), out
        if driver == "slam":
            pose = out["pose"].clone()
            pose[0] = pose[0] + 0.25
            return new, dict(out, pose=pose)
        conf = out.confidence.clone()
        if conf.dim():
            conf[0] = conf[0] + 0.25
        else:
            conf = conf + 0.25
        return new, dataclasses.replace(out, confidence=conf)

    return module, name, step


def _run(root, workload, program=None):
    return harness.run_cell(root, workload, 2**31 + 99, 0.5, False, "cpu",
                            program=program, out=io.StringIO(),
                            err=io.StringIO())


@pytest.mark.parametrize("workload", tiny.cells())
def test_the_control_is_not_correct(root, workload):
    cell = harness.load_cell(root, workload)
    res = _run(root, workload, control.factory(cell.traffic["driver"]))
    assert res["correct"] is False
    assert res["checks"]["rows_off"]["value"] > 0.5


@pytest.mark.parametrize("kind", ["unchanged", "half", "answer"])
@pytest.mark.parametrize("workload", tiny.cells())
def test_a_fault_is_not_correct(root, workload, kind, monkeypatch):
    assert _run(root, workload)["correct"] is True
    cell = harness.load_cell(root, workload)
    module, name, step = _fault(kind, cell.traffic["driver"])
    monkeypatch.setattr(module, name, step)
    res = _run(root, workload)
    assert res["correct"] is False, res["checks"]
