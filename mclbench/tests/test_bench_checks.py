"""`correct` comes out false for the control and for each fault a cell can
have, on the CPU at a tiny size: the harness runs as on the card (its look
for a card skipped) with the timed path broken underneath.

The faults, planted in the port's tick (models/filter.mcl_step, which
every cell's entry runs): a step that returns its state unchanged; half
of the batch (the filters, or one filter's particles) left unstepped; an
answer altered where it is produced (filter 0's published confidence).
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


def _fault(kind):
    from montecarlolocalisation_tpu_torch.models import filter as mcl

    real = mcl.mcl_step

    def step(state, *args, **kw):
        new, out = real(state, *args, **kw)
        if kind == "unchanged":
            return state, out
        if kind == "half":
            return _half(new, state), out
        conf = out.confidence.clone()
        if conf.dim():
            conf[0] = conf[0] + 0.25
        else:
            conf = conf + 0.25
        return new, dataclasses.replace(out, confidence=conf)

    return mcl, step


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
    mcl, step = _fault(kind)
    monkeypatch.setattr(mcl, "mcl_step", step)
    res = _run(root, workload)
    assert res["correct"] is False, res["checks"]
