"""models/refine: the port's autograd hill-climb against the JAX package's
jax.grad one, on the same particles and scan.

Tolerances: >= 99.9 % of refined rows within atol 1e-5, on one filter
[N, 3] and on a batch [E, N, 3] (against JAX's vmap).  A row may differ
by a whole step where the two packages disagree on sign(dL/dtheta) or on
an accept decision: the beam sums add in another order, so a gradient
near 0 or a proposal that ties the current likelihood can fall either
way.  Ties are common under the fixed march, which is piecewise constant
in the pose: a step that moves no sample across a pixel leaves every
beam's term as it was.  The port then sums equal terms to an equal
likelihood and keeps the particle; XLA's two fusions may round the two
sums apart and take the step.  So under the fixed march the rows counted
are those on which the port met no exact tie (at most 10 % of them may
tie).  In log mode the rows counted are those whose likelihood is above
refine.eps (1e-9): below it log(w + eps) is flat to within rounding, and
the gradient (under 1e-19 there, or 0 where it underflows) points where
the last bits of either package's sums send it.  The likelihood rtol
1e-5; the gradients of >= 99.9 % of rows within rtol 1e-3 + atol 1e-3 of
the row's scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig, RefineConfig, SensorModelConfig,
)
from montecarlolocalisation_tpu.models import refine as jrefine
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu_torch.interop import config_from
from montecarlolocalisation_tpu_torch.models import refine as trefine
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.utils.angles import normalize_angle

from torch_parity import maps, t

torch.set_num_threads(1)

N, BEAMS = 1024, 24
TRUTH = np.float32([[1.25, 1.25, 0.3], [2.05, 1.2, 1.6], [1.2, 2.8, -2.0]])


def _cfg(ray_mode="fixed", iters=2, combine="sum"):
    return FilterConfig(
        num_particles=N,
        sensor=SensorModelConfig(ray_mode=ray_mode, beam_combine=combine),
        refine=RefineConfig(iters=iters))


def _inputs(jm, truth, seed):
    """A cloud of N particles within ~0.15 m / 0.2 rad of `truth`, and the
    noisy scan seen from it."""
    rng = np.random.default_rng(seed)
    parts = (truth + rng.normal(0.0, [0.15, 0.15, 0.2], (N, 3))).astype(
        np.float32)
    angles = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
    ranges = np.asarray(jsensor.simulate_scan(
        jm, jnp.asarray(truth), angles, SensorModelConfig()).ranges)
    ranges = np.clip(ranges + rng.normal(0, 0.01, BEAMS), 0, 1).astype(
        np.float32)
    return parts, angles, ranges


def _close_rows(a, b, atol=1e-5):
    return np.all(np.abs(a - b) <= atol, axis=-1).mean()


def port_ties(m, parts, scan, cfg):
    """(refined rows, [..., N] bool): trefine.refine_particles' rounds
    replayed, and the rows on which some round proposed a step whose
    likelihood equals the current one exactly."""
    rc = cfg.refine
    acc = dataclasses.replace(cfg.sensor, lookup_mode="auto")

    def value(p):
        return tsensor.beam_weights_dense(m, p, scan, acc,
                                          cfg.valid_pos_offset)

    p = parts
    w = value(p)
    tied = torch.zeros(w.shape, dtype=torch.bool)
    for _ in range(rc.iters):
        _, g = trefine.likelihood_and_grad(m, p, scan, cfg.sensor, rc,
                                           cfg.valid_pos_offset)
        gn = torch.sqrt(g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1])
        prop = torch.stack([
            p[..., 0] + rc.step_xy * g[..., 0] / (gn + 1e-20),
            p[..., 1] + rc.step_xy * g[..., 1] / (gn + 1e-20),
            normalize_angle(p[..., 2] + rc.step_theta
                            * torch.sign(g[..., 2]))], dim=-1)
        w_prop = value(prop)
        tied |= (w_prop == w) & (w > 0)
        p = torch.where((w_prop > w)[..., None], prop, p)
        w = torch.maximum(w_prop, w)
    return p, tied.numpy()


def counted_rows(m, parts, scan, cfg, got):
    """The rows the tolerance counts (module docstring)."""
    if cfg.sensor.ray_mode != "fixed":
        return np.ones(got.shape[:-1], bool)
    replay, tied = port_ties(m, parts, scan, cfg)
    assert torch.equal(replay, got)        # the replay is the climb
    assert tied.mean() <= 0.1
    return ~tied


@pytest.mark.parametrize("ray_mode,combine", [
    ("fixed", "sum"), ("analytic", "sum"), ("fixed", "log"),
])
def test_refine_particles_matches_jax(ray_mode, combine):
    jm, tm = maps()
    cfg = _cfg(ray_mode, combine=combine)
    parts, angles, ranges = _inputs(jm, TRUTH[0], 1)
    jscan = jsensor.make_scan(angles, ranges)
    want = np.asarray(jax.jit(lambda p: jrefine.refine_particles(
        jm, p, jscan, cfg))(jnp.asarray(parts)))
    tscan, tcfg = tsensor.make_scan(angles, ranges), config_from(cfg)
    got = trefine.refine_particles(tm, t(parts), tscan, tcfg)
    rows = counted_rows(tm, t(parts), tscan, tcfg, got)
    got = got.numpy()
    if combine == "log":
        w0 = jax.jit(lambda p: jsensor._beam_weights_dense(
            jm, p, jscan, cfg.sensor, cfg.valid_pos_offset, "gather"))(
            jnp.asarray(parts))
        rows &= np.asarray(w0) > cfg.refine.eps
        assert rows.mean() > 0.3
    assert _close_rows(got[rows], want[rows]) >= 0.999
    moved = np.any(want != parts, axis=1).mean()
    assert moved > 0.3      # the climb moves a good share of the cloud


def test_refine_batch_matches_jax_vmap_and_its_episodes():
    jm, tm = maps()
    cfg = _cfg()
    ins = [_inputs(jm, TRUTH[e], 10 + e) for e in range(3)]
    parts = np.stack([i[0] for i in ins])
    angles = ins[0][1]
    ranges = np.stack([i[2] for i in ins])
    mask = np.ones_like(ranges, bool)
    mask[1, 3] = False
    want = np.asarray(jax.jit(jax.vmap(
        lambda p, r, k: jrefine.refine_particles(
            jm, p, jsensor.Scan(jnp.asarray(angles), r, k), cfg)))(
        jnp.asarray(parts), jnp.asarray(ranges), jnp.asarray(mask)))
    tcfg = config_from(cfg)
    tscan = tsensor.make_scan(angles, ranges, mask)
    got = trefine.refine_particles(tm, t(parts), tscan, tcfg)
    rows = counted_rows(tm, t(parts), tscan, tcfg, got)
    assert _close_rows(got.numpy()[rows], want[rows]) >= 0.999
    for e in range(3):
        one = trefine.refine_particles(
            tm, t(parts[e]), tsensor.make_scan(angles, ranges[e], mask[e]),
            tcfg)
        np.testing.assert_allclose(got[e].numpy(), one.numpy(), rtol=0,
                                   atol=1e-6)


def test_likelihood_and_grad_matches_jax():
    jm, tm = maps()
    cfg = _cfg()
    parts, angles, ranges = _inputs(jm, TRUTH[1], 3)
    jw, jg = jrefine.likelihood_and_grad(
        jm, jnp.asarray(parts), jsensor.make_scan(angles, ranges),
        cfg.sensor, cfg.refine, cfg.valid_pos_offset)
    tw, tg = trefine.likelihood_and_grad(
        tm, t(parts), tsensor.make_scan(angles, ranges),
        config_from(cfg.sensor), config_from(cfg.refine),
        cfg.valid_pos_offset)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-5,
                               atol=1e-7)
    jg = np.asarray(jg)
    scale = np.max(np.abs(jg), axis=1, keepdims=True)
    ok = np.all(np.abs(tg.numpy() - jg) <= 1e-3 + 1e-3 * scale, axis=1)
    assert ok.mean() >= 0.999
    assert np.abs(jg).max() > 1.0        # a real gradient, not all zero


def test_zero_iters_is_the_identity():
    _, tm = maps()
    cfg = config_from(_cfg(iters=0))
    p = torch.rand(16, 3)
    scan = tsensor.make_scan(np.zeros(4, np.float32), np.ones(4, np.float32))
    assert trefine.refine_particles(tm, p, scan, cfg) is p
