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

The port's gradient on the "dda" objective is closed-form (models/refine
closed_form_grad over raycast.dda_walk and dda_vjp), so the tests above
hold the closed form against jax.grad.  Against the port's own autograd
through raycast.raycast_dda, on the hard cases of tests/refine_cases.py:
the distances exactly, each ray's derivative in (ox, oy, angle) within
rtol 1e-6 + atol 1e-9; the whole objective's likelihood and gradient bit
for bit (the closed form sums over the beams with torch's own sum, as
autograd's backward does).  CPU particles never take the kernels: their
refine_particles is the dense loop, bit for bit.
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
from montecarlolocalisation_tpu_torch.maps import grid as tgrid
from montecarlolocalisation_tpu_torch.models import raycast as traycast
from montecarlolocalisation_tpu_torch.models import refine as trefine
from montecarlolocalisation_tpu_torch.models import sensor as tsensor
from montecarlolocalisation_tpu_torch.ops import refine as trefine_ops
from montecarlolocalisation_tpu_torch.utils.angles import normalize_angle

import refine_cases as cases
import refine_walk_mirror as walk_mirror
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


def _autograd_dda(m, ox, oy, ang, cfg):
    """raycast_dda's distance and autograd's derivative in (ox, oy, ang)."""
    leaves = [v.clone().requires_grad_(True) for v in (ox, oy, ang)]
    with torch.enable_grad():
        d = traycast.raycast_dda(m, *leaves, cfg)
        grads = torch.autograd.grad(d.sum(), leaves)
    return d.detach(), torch.stack(grads, dim=-1)


def _closed_form_dda(m, ox, oy, ang, cfg):
    """dda_walk's distance and dda_vjp's derivative in (ox, oy, ang)."""
    walk = traycast.dda_walk(m, ox, oy, ang, cfg)
    grads = traycast.dda_vjp(m, walk, torch.ones_like(walk.dist), cfg)
    return walk.dist, torch.stack(grads, dim=-1)


@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_dda_closed_form_derivative_matches_autograd(kind, quantize):
    _, tm = maps()
    cfg = config_from(SensorModelConfig(ray_mode="dda",
                                        quantize_ray_deg=quantize))
    ox, oy, ang = (t(v) for v in cases.rays(tm, 4000, kind, seed=3))
    want_d, want_g = _autograd_dda(tm, ox, oy, ang, cfg)
    got_d, got_g = _closed_form_dda(tm, ox, oy, ang, cfg)
    assert torch.equal(got_d, want_d)
    np.testing.assert_allclose(got_g.numpy(), want_g.numpy(), rtol=1e-6,
                               atol=1e-9)
    walk = traycast.dda_walk(tm, ox, oy, ang, cfg)
    hit = walk.hit.numpy()
    if kind in ("walls", "off_map"):
        assert not hit.any() and not got_g.numpy().any()
    else:
        assert hit.mean() > 0.2 and (~hit).any()
        # |d dist / d ox| is 1 / |cos| >= 1 where x takes the hit.
        assert np.abs(got_g.numpy()[hit]).max() >= 0.99
    if kind == "axes":            # sin(0) = 0: the eps clamp on y
        assert (walk.dy == 0).any()


@pytest.mark.parametrize("combine", ["sum", "log"])
def test_closed_form_grad_matches_autograd(combine):
    _, tm = maps()
    cfg = config_from(SensorModelConfig(beam_combine=combine))
    rc = config_from(RefineConfig(iters=2))
    nb, e = 24, 3
    parts = np.stack([np.concatenate([cases.particles(tm, 150, k, seed=i)
                                      for k in cases.KINDS])
                      for i in range(e)])
    ranges, mask = cases.scan_arrays(nb, e, seed=5)
    scan = tsensor.make_scan(cases.beam_table(nb), ranges, mask)
    p = t(parts)
    w, g = trefine.closed_form_grad(tm, p, scan, cfg, rc, 0.1)
    dcfg = dataclasses.replace(cfg, ray_mode="dda")
    with torch.enable_grad():
        q = p.clone().requires_grad_(True)
        want_w = tsensor.beam_weights_dense(tm, q, scan, dcfg, 0.1)
        (want_g,) = torch.autograd.grad(
            torch.sum(torch.log(want_w + rc.eps)), q)
    assert torch.equal(w, want_w.detach())
    assert torch.equal(g, want_g)
    assert (want_g != 0).any(-1).float().mean() > 0.2   # real gradients
    assert (w == 0).any() and (w > 0).any()         # gated and scored rows


@pytest.mark.parametrize("nb,outputs,width", [
    (24, 512_000, 16), (34, 1_500, 32), (24, 3, 16), (7, 100, 4),
    (1, 10, 1), (200, 4, 128), (100, 10_000, 32),
])
def test_reduce_width_follows_torchs_reduce_config(nb, outputs, width):
    """The lanes of torch's CUDA sum over a contiguous last dim
    (Reduce.cuh setReduceConfig: the largest power of two <= nb, at most a
    warp while the outputs fill a 512-thread block)."""
    assert trefine_ops.reduce_width(nb, outputs) == width


def _dense_loop(m, particles, scan, cfg):
    """refine_particles' rounds as the dense path runs them:
    likelihood_and_grad, the step, the dense scoring, torch.where and
    torch.maximum."""
    acc = dataclasses.replace(cfg.sensor, lookup_mode="auto")

    def value(q):
        return tsensor.beam_weights_dense(m, q, scan, acc,
                                          cfg.valid_pos_offset)

    p, w = particles, value(particles)
    for _ in range(cfg.refine.iters):
        _, g = trefine.likelihood_and_grad(m, p, scan, cfg.sensor,
                                           cfg.refine, cfg.valid_pos_offset)
        prop = trefine.propose(p, g, cfg.refine)
        w_prop = value(prop)
        p = torch.where((w_prop > w)[..., None], prop, p)
        w = torch.maximum(w_prop, w)
    return p


def test_cpu_particles_run_the_dense_loop():
    """On CPU tensors refine_particles never takes the kernels: it is the
    dense loop bit for bit, one filter and a batch, and launches
    nothing."""
    _, tm = maps()
    cfg = config_from(_cfg())
    nb = 24
    launches = (trefine_ops.refine_grad_cuda.launches,
                trefine_ops.refine_score_cuda.launches)
    for lead in ((), (3,)):
        e = int(np.prod(lead)) if lead else 1
        parts = np.stack([np.concatenate(
            [cases.particles(tm, 120, k, seed=7 + i) for k in cases.KINDS])
            for i in range(e)]).reshape(*lead, -1, 3)
        ranges, mask = cases.scan_arrays(nb, e, seed=9)
        if not lead:
            ranges, mask = ranges[0], mask[0]
        scan = tsensor.make_scan(cases.beam_table(nb), ranges, mask)
        assert not trefine_ops.kernels_take(tm, t(parts), cfg)
        got = trefine.refine_particles(tm, t(parts), scan, cfg)
        assert torch.equal(got, _dense_loop(tm, t(parts), scan, cfg))
        assert (got != t(parts)).any(-1).float().mean() > 0.1
    assert launches == (trefine_ops.refine_grad_cuda.launches,
                        trefine_ops.refine_score_cuda.launches)


class _OnCard:
    """Stands for CUDA particles of a given rank: kernels_take reads only
    the device and the rank."""

    is_cuda = True

    def __init__(self, rank):
        self.rank = rank

    def dim(self):
        return self.rank


def test_kernels_take_only_what_they_implement():
    _, tm = maps()
    cfg = config_from(_cfg())
    p = torch.zeros(2, 5, 3)
    assert trefine_ops.kernels_take(tm, _OnCard(3), cfg)
    assert trefine_ops.kernels_take(tm, _OnCard(2), cfg)
    assert not trefine_ops.kernels_take(tm, p, cfg)        # CPU particles
    off = [dataclasses.replace(cfg, sensor=dataclasses.replace(
               cfg.sensor, beam_combine="log")),
           dataclasses.replace(cfg, sensor=dataclasses.replace(
               cfg.sensor, ray_mode="analytic")),
           dataclasses.replace(cfg, refine=dataclasses.replace(
               cfg.refine, ray_mode="analytic")),
           dataclasses.replace(cfg, valid_pos_offset=0.15)]
    for c in off:
        assert not trefine_ops.kernels_take(tm, _OnCard(3), c)
    stack = tgrid.stack_maps([tm, tm])
    assert not trefine_ops.kernels_take(stack, _OnCard(3), cfg)
    assert not trefine_ops.kernels_take(tm, _OnCard(1), cfg)
    with pytest.raises(ValueError):
        trefine_ops.refine_grad_cuda(tm, p, p[0, :, 0], p[..., 0],
                                     p[..., 0], cfg)


# -- refine_grad_kernel's walks: their plain mirror (refine_walk_mirror) --

@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("kind", cases.KINDS)
def test_walk_mirror_follows_the_dda_walk(kind, quantize):
    """The mirror walks each ray as raycast's DDA does: its distances are
    raycast_dda's bit for bit and its codes dda_walk's hit, axis and steps
    along the axis; a ray takes at least one step more than its hit axis
    records, at most dda_iters, and none from a wall pixel or off the
    map."""
    _, tm = maps()
    cfg = config_from(SensorModelConfig(ray_mode="dda",
                                        quantize_ray_deg=quantize))
    parts = t(cases.particles(tm, 600, kind, seed=5))
    angles = -t(cases.beam_table(BEAMS))      # the sensor negates them
    got = walk_mirror.walks(tm, parts, angles, cfg)
    x, y, th = parts[:, 0], parts[:, 1], parts[:, 2]
    ox, oy, ray = torch.broadcast_tensors(
        (x + cfg.laser_offset * torch.cos(th))[:, None],
        (y + cfg.laser_offset * torch.sin(th))[:, None], th[:, None] + angles)
    want = traycast.dda_walk(tm, ox, oy, ray, cfg)
    assert torch.equal(got["dist"], traycast.raycast_dda(tm, ox, oy, ray,
                                                         cfg))
    assert torch.equal(got["dist"], want.dist)
    code, steps = got["code"], got["steps"]
    assert torch.equal(code >= 0, want.hit)
    assert torch.equal((code & 1).bool()[want.hit], want.axis_x[want.hit])
    assert torch.equal((code >> 1)[want.hit], want.steps[want.hit])
    assert (steps[want.hit] > want.steps[want.hit]).all()
    assert int(steps.max()) <= traycast.dda_iters(tm, cfg)
    ix = torch.floor((ox - tm.origin_x) * tm.inv_resolution).to(torch.int32)
    iy = torch.floor((oy - tm.origin_y) * tm.inv_resolution).to(torch.int32)
    on_map = (ix >= 0) & (iy >= 0) & (ix < tm.width) & (iy < tm.height)
    assert torch.equal(steps == 0, tgrid.lookup(tm.occ, ix, iy) | ~on_map)
    if kind in ("walls", "off_map"):
        assert not want.hit.any() and not steps.any()
    else:
        assert want.hit.float().mean() > 0.2 and (steps > 4).any()


def test_walk_counts_take_each_warps_longest_ray():
    """A warp of 32 consecutive rows walks a beam until its longest ray
    ends: 32 lane-steps a step, twice past the records; the grid's last
    warp may hold fewer rows, and its lanes still count."""
    gen = torch.Generator().manual_seed(7)
    nb = walk_mirror.RECORDS + 3
    steps = torch.randint(0, 23, (2, 45, nb), generator=gen,
                          dtype=torch.int32)
    got = walk_mirror.counts(steps)
    flat = steps.reshape(90, nb).tolist()
    slots = 0
    for w0 in range(0, 90, 32):
        for b in range(nb):
            longest = max(row[b] for row in flat[w0:w0 + 32])
            slots += 32 * longest * (2 if b >= walk_mirror.RECORDS else 1)
    assert got == dict(steps=int(steps.sum()), slots=slots)
    assert got["steps"] < got["slots"]


def test_walk_stats_needs_the_card():
    """walk_stats counts the kernel's walks: CPU particles have no kernel
    to count (the mirror is their count); the records hold the kernel's
    kRecords beams."""
    _, tm = maps()
    cfg = config_from(_cfg())
    scan = tsensor.make_scan(cases.beam_table(BEAMS), np.ones(BEAMS,
                                                               np.float32))
    with pytest.raises(ValueError, match="CUDA"):
        trefine_ops.walk_stats(tm, torch.zeros(4, 3), scan, cfg)
    assert walk_mirror.RECORDS == 48
