"""Refinement's kernels (csrc/refine.cu) on a CUDA card (marked `card`:
skips without one).

At N = 1000 particles (no multiple of a block or a warp), on one filter
[N, 3] and on a batch of 4, over the hard cases of tests/refine_cases.py
(origins on and within 1e-6 of pixel edges, rays along each axis, origins
on wall pixels and off the map, rays that reach max_range, masked beams,
invalid poses), with and without quantize_ray_deg, in both raster forms
(ops/weights.raster_form, K1's rule: the default maze's 392 bytes of words
in shared memory, or forced into the device form; and a generated maze
past 1 KB of words, which takes the device form unforced):

- refine_score_kernel's likelihood against beam_weights_dense (the fixed
  march, sum mode) bit for bit, and its acceptance against
  torch.where and torch.maximum on the dense scoring of the proposals;
- refine_grad_kernel's walks against raycast_dda bit for bit, its DDA
  likelihood against the dense path's bit for bit, its gradient against
  torch.autograd.grad through the dense DDA within rtol 1e-5 of each
  row's scale on >= 99.99 % of rows (the rest listed), its proposals
  against models/refine.closed_form_grad and propose bit for bit; at 24
  beams, 34 and a count past the beams its records hold;
- the same walks, likelihood and proposals on particle orders that load
  a warp's walks differently (a uniform cloud, tight warps, rays that all
  run to max range, origins on wall pixels and off the map), and
  ops/refine.walk_stats equal to tests/refine_walk_mirror's counts;
- refine_particles at the production shapes (1024 x 500 x 24) against the
  dense path with autograd: the rows equal (the share that differs
  reported), `iters` launches of refine_grad_kernel and 1 + iters of
  refine_score_kernel a call, and no torch.autograd; walk_stats equal to
  the mirror's counts there;
- a TickGraph replay of the production schedule equal to its ticks run
  eagerly on the graph's buffers.

The suite's conftest imports JAX, which a card's host may lack, so run
this file alone there:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_card_refine.py
"""
import dataclasses

import numpy as np
import pytest
import torch

import refine_cases as cases
import refine_walk_mirror as walk_mirror

pytestmark = pytest.mark.card

N = 1000        # no multiple of a block (256 threads) or a warp (32)
EPISODES = 4
BEAMS = 24
MAP = "montecarlolocalisation_tpu/maps/default_map.txt"
# A generated maze of LARGE x LARGE cells: 129 x 129 px, 645 words (2,580
# bytes) one bit a pixel, past ops/weights.SHARED_RASTER_BYTES.
LARGE = 16
# The production scan, the reference robot's, and a count past the beams
# refine_grad_kernel's records hold (walked again in pass 2).
BEAM_COUNTS = (BEAMS, 34, walk_mirror.RECORDS + 12)


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the refinement kernels run on the card")
    return torch.device("cuda")


def _cfg(quantize=False, iters=2):
    from montecarlolocalisation_tpu_torch.config import (
        FilterConfig, RefineConfig, ResampleConfig, SensorModelConfig)

    return FilterConfig(
        num_particles=N, sensor=SensorModelConfig(quantize_ray_deg=quantize),
        refine=RefineConfig(iters=iters),
        resample=ResampleConfig(method="systematic", ess_threshold=0.5))


def _case(card, episodes, seed, quantize, cells=None, beams=BEAMS):
    """(map, particles [N, 3] or [E, N, 3] mixing every kind, scan, cfg)
    on the default maze, or on a generated maze of cells x cells."""
    from montecarlolocalisation_tpu_torch.maps import generator, grid
    from montecarlolocalisation_tpu_torch.models import sensor

    m = (grid.from_map_file(MAP, device=card) if cells is None else
         grid.from_walls(generator.generate_maze(cells, cells, seed=cells),
                         device=card))
    e = episodes or 1
    per = -(-N // len(cases.KINDS))
    parts = np.stack([np.concatenate(
        [cases.particles(m, per, k, seed=seed + 10 * i)
         for k in cases.KINDS])[:N] for i in range(e)])
    ranges, mask = cases.scan_arrays(beams, e, seed=seed)
    if not episodes:
        parts, ranges, mask = parts[0], ranges[0], mask[0]
    scan = sensor.make_scan(cases.beam_table(beams), ranges, mask,
                            device=card)
    return m, cases.as_tensor(parts, card), scan, _cfg(quantize)


def _autograd(m, parts, scan, cfg):
    """The dense path's DDA likelihood and autograd's gradient."""
    from montecarlolocalisation_tpu_torch.models import sensor

    dcfg = dataclasses.replace(cfg.sensor, ray_mode="dda",
                               lookup_mode="auto")
    with torch.enable_grad():
        q = parts.detach().clone().requires_grad_(True)
        w = sensor.beam_weights_dense(m, q, scan, dcfg, cfg.valid_pos_offset)
        (g,) = torch.autograd.grad(torch.sum(torch.log(w + cfg.refine.eps)),
                                   q)
    return w.detach(), g


def _dense_refine(m, parts, scan, cfg):
    """refine_particles as the dense path runs it: autograd through the
    dense DDA, the dense fixed march scoring."""
    from montecarlolocalisation_tpu_torch.models import refine, sensor

    acc = dataclasses.replace(cfg.sensor, lookup_mode="auto")

    def value(q):
        return sensor.beam_weights_dense(m, q, scan, acc,
                                         cfg.valid_pos_offset)

    p, w = parts, value(parts)
    for _ in range(cfg.refine.iters):
        _, g = _autograd(m, p, scan, cfg)
        prop = refine.propose(p, g, cfg.refine)
        w_prop = value(prop)
        p = torch.where((w_prop > w)[..., None], prop, p)
        w = torch.maximum(w_prop, w)
    return p


@pytest.mark.parametrize("beams", BEAM_COUNTS)
@pytest.mark.parametrize("form,cells", [
    pytest.param("shared", None, id="shared"),
    pytest.param("device", None, id="device"),
    pytest.param("device", LARGE, id="device_past_1kb")])
@pytest.mark.parametrize("quantize", [False, True])
@pytest.mark.parametrize("episodes", [0, EPISODES])
def test_kernels_equal_the_dense_path(card, episodes, quantize, form, cells,
                                      beams, monkeypatch):
    from montecarlolocalisation_tpu_torch.models import refine, sensor
    from montecarlolocalisation_tpu_torch.ops import refine as kref
    from montecarlolocalisation_tpu_torch.ops import weights

    if form == "device" and cells is None:
        monkeypatch.setattr(weights, "SHARED_RASTER_BYTES", 0)
    m, parts, scan, cfg = _case(card, episodes, seed=1 + episodes,
                                quantize=quantize, cells=cells, beams=beams)
    assert weights.raster_form(m, cfg.sensor) == form
    lead = parts.shape[:-1]
    p, ang, ranges, mask = kref.beam_inputs(parts, scan, cfg)

    # The start's scoring: the fixed march, bit for bit.
    acc = dataclasses.replace(cfg.sensor, lookup_mode="auto")
    want_w = sensor.beam_weights_dense(m, parts, scan, acc,
                                       cfg.valid_pos_offset)
    w = kref.refine_score_cuda(m, p, ang, ranges, mask, cfg)
    assert torch.equal(w.reshape(lead), want_w)
    assert (want_w == 0).any() and (want_w > 0).any()

    # The gradient's launch: walks, likelihood, gradient, proposals.
    prop, lik, grad, dists = kref.refine_grad_cuda(m, p, ang, ranges, mask,
                                                   cfg, detail=True)
    dcfg = dataclasses.replace(cfg.sensor, ray_mode="dda",
                               lookup_mode="auto")
    want_d = sensor.expected_ranges(m, parts, scan.angles, dcfg)
    assert torch.equal(dists.reshape(want_d.shape), want_d)
    assert (want_d == cfg.sensor.max_range).any() and (want_d == 0).any()
    want_lik, want_g = _autograd(m, parts, scan, cfg)
    assert torch.equal(lik.reshape(lead), want_lik)
    got_g = grad.reshape(want_g.shape)
    scale = want_g.abs().amax(-1, keepdim=True)
    close = ((got_g - want_g).abs() <= 1e-5 * scale).all(-1)
    outside = [(tuple(i), got_g[tuple(i)].tolist(), want_g[tuple(i)].tolist())
               for i in (~close).nonzero()[:10].tolist()]
    assert close.float().mean() >= 0.9999, outside
    assert (scale > 1.0).any()
    print(f"gradient rows equal to autograd's bit for bit: "
          f"{float((got_g == want_g).all(-1).float().mean()):.6f}")
    _, closed = refine.closed_form_grad(m, parts, scan, cfg.sensor,
                                        cfg.refine, cfg.valid_pos_offset)
    assert torch.equal(prop.reshape(parts.shape),
                       refine.propose(parts, closed, cfg.refine))
    dense = refine.propose(parts, want_g, cfg.refine)
    assert (prop.reshape(parts.shape) == dense).all(-1).float().mean() \
        >= 0.9999

    # The acceptance in place, against torch.where and torch.maximum.
    w_prop = sensor.beam_weights_dense(m, prop.reshape(parts.shape), scan,
                                       acc, cfg.valid_pos_offset)
    w_prop = w_prop.reshape(w.shape)
    want_p = torch.where((w_prop > w)[..., None], prop, p)
    want_w = torch.maximum(w_prop, w)
    kref.refine_score_cuda(m, p, ang, ranges, mask, cfg, w, prop)
    assert torch.equal(p, want_p) and torch.equal(w, want_w)
    assert (p != prop).any() and (p == prop).all(-1).any()


def _stats_equal_the_mirror(m, parts, scan, cfg):
    """ops/refine.walk_stats on these inputs equals the mirror's counts of
    the same walks, whose distances are the kernel's."""
    from montecarlolocalisation_tpu_torch.ops import refine as kref

    p, ang, ranges, mask = kref.beam_inputs(parts, scan, cfg)
    mirror = walk_mirror.walks(m, p, ang, cfg.sensor)
    _, _, _, dists = kref.refine_grad_cuda(m, p, ang, ranges, mask, cfg,
                                           detail=True)
    assert torch.equal(dists, mirror["dist"])
    got = kref.walk_stats(m, parts, scan, cfg)
    want = walk_mirror.counts(mirror["steps"])
    assert {k: got[k] for k in want} == want
    assert got["rays"] == p.shape[0] * p.shape[1] * ang.shape[0]
    print(f"walk lane share {got['lane_share']:.4f} "
          f"({got['steps']} steps of {got['slots']} lane-steps)")
    return got


def _order(card, kind, beams, seed=11):
    """(map, particles [E, N, 3], scan, cfg) of one particle order: a
    uniform cloud; tight warps (32 rows within 5 cm and 0.05 rad of a
    pose); rays that all run to max range (cell centres, a 0.15 m range);
    origins on wall pixels and off the map."""
    from montecarlolocalisation_tpu_torch.maps import grid
    from montecarlolocalisation_tpu_torch.models import resample, sensor

    m = grid.from_map_file(MAP, device=card)
    cfg = _cfg()
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=card)
    gen.manual_seed(seed)
    if kind == "uniform":
        parts = resample.sample_uniform_particles(gen, m, EPISODES * N)
    elif kind == "tight":
        centre = cases.particles(m, EPISODES * N // 32 + 1, "cloud",
                                 seed=seed)
        parts = cases.as_tensor(np.repeat(centre, 32, 0)[:EPISODES * N]
                                + rng.normal(0.0, [0.05, 0.05, 0.05],
                                             (EPISODES * N, 3)), card)
    elif kind == "max_range":
        cells = rng.integers(0, 6, (EPISODES * N, 2))
        th = rng.uniform(-np.pi, np.pi, EPISODES * N)
        parts = cases.as_tensor(np.stack([0.4 + 0.8 * cells[:, 0],
                                          0.4 + 0.8 * cells[:, 1], th], -1),
                                card)
        cfg = dataclasses.replace(cfg, sensor=dataclasses.replace(
            cfg.sensor, max_range=0.15))
    else:
        half = EPISODES * N // 2
        parts = cases.as_tensor(np.concatenate([
            cases.particles(m, half, "walls", seed=seed),
            cases.particles(m, EPISODES * N - half, "off_map",
                            seed=seed + 1)]), card)
    ranges, mask = cases.scan_arrays(beams, EPISODES, seed=seed,
                                     max_range=cfg.sensor.max_range)
    scan = sensor.make_scan(cases.beam_table(beams), ranges, mask,
                            device=card)
    return m, parts.reshape(EPISODES, N, 3), scan, cfg


@pytest.mark.parametrize("beams", BEAM_COUNTS)
@pytest.mark.parametrize("kind", ["uniform", "tight", "max_range",
                                  "walls_off_map"])
def test_walks_on_particle_orders(card, kind, beams):
    """On each particle order the walks equal raycast_dda's, the DDA
    likelihood the dense path's and the proposals closed_form_grad's and
    propose's, bit for bit; walk_stats equals the mirror's counts."""
    from montecarlolocalisation_tpu_torch.models import refine, sensor
    from montecarlolocalisation_tpu_torch.ops import refine as kref

    m, parts, scan, cfg = _order(card, kind, beams)
    p, ang, ranges, mask = kref.beam_inputs(parts, scan, cfg)
    prop, lik, _, dists = kref.refine_grad_cuda(m, p, ang, ranges, mask,
                                                cfg, detail=True)
    dcfg = dataclasses.replace(cfg.sensor, ray_mode="dda",
                               lookup_mode="auto")
    want_d = sensor.expected_ranges(m, parts, scan.angles, dcfg)
    assert torch.equal(dists, want_d)
    if kind == "max_range":
        assert (want_d == cfg.sensor.max_range).all()
    if kind == "walls_off_map":
        assert ((want_d == 0) | (want_d == cfg.sensor.max_range)).all()
    want_lik, closed = refine.closed_form_grad(
        m, parts, scan, cfg.sensor, cfg.refine, cfg.valid_pos_offset)
    assert torch.equal(lik, want_lik)
    assert torch.equal(prop, refine.propose(parts, closed, cfg.refine))
    got = _stats_equal_the_mirror(m, parts, scan, cfg)
    if kind == "walls_off_map":
        assert got["steps"] == got["slots"] == 0
    else:
        assert 0 < got["steps"] < got["slots"]


def _production(card, seed=7):
    """The production cell's shapes: 1024 filters of 500 particles about
    a simulated pose each, a noisy scan of 24 beams from it."""
    from montecarlolocalisation_tpu_torch.maps import grid
    from montecarlolocalisation_tpu_torch.models import sensor

    m = grid.from_map_file(MAP, device=card)
    e, n = 1024, 500
    rng = np.random.default_rng(seed)
    truth = cases.particles(m, e, "cloud", seed=seed).astype(np.float64)
    parts = truth[:, None, :] + rng.normal(0.0, [0.15, 0.15, 0.2],
                                           (e, n, 3))
    cfg = dataclasses.replace(_cfg(), num_particles=n)
    angles = np.deg2rad(np.linspace(-118.0, 118.0, BEAMS)).astype(np.float32)
    seen = sensor.simulate_scan(m, cases.as_tensor(truth, card), angles,
                                cfg.sensor)
    noise = cases.as_tensor(rng.normal(0.0, 0.02, (e, BEAMS)), card)
    scan = sensor.make_scan(angles, torch.clamp(seen.ranges + noise, 0, 1),
                            device=card)
    return m, cases.as_tensor(parts, card), scan, cfg


def test_refine_particles_at_production_shapes(card, monkeypatch):
    from montecarlolocalisation_tpu_torch.models import refine
    from montecarlolocalisation_tpu_torch.ops import refine as kref

    m, parts, scan, cfg = _production(card)
    want = _dense_refine(m, parts, scan, cfg)

    def no_autograd(*a, **k):
        raise AssertionError("the kernels' path ran torch.autograd")

    monkeypatch.setattr(torch.autograd, "grad", no_autograd)
    monkeypatch.setattr(torch.autograd, "backward", no_autograd)
    before = (kref.refine_grad_cuda.launches,
              kref.refine_score_cuda.launches)
    got = refine.refine_particles(m, parts, scan, cfg)
    torch.cuda.synchronize()
    launched = (kref.refine_grad_cuda.launches - before[0],
                kref.refine_score_cuda.launches - before[1])
    assert launched == (cfg.refine.iters, 1 + cfg.refine.iters)
    same = (got == want).all(-1)
    print(f"rows equal to the dense path's: "
          f"{float(same.float().mean()):.6f} of {same.numel()}")
    assert bool(same.all())
    assert (got != parts).any(-1).float().mean() > 0.3     # the climb moved
    _stats_equal_the_mirror(m, parts, scan, cfg)


def test_tickgraph_replay_equals_eager_ticks(card, monkeypatch):
    from montecarlolocalisation_tpu_torch import presets
    from montecarlolocalisation_tpu_torch.models import compiled
    from montecarlolocalisation_tpu_torch.models import filter as mcl
    from montecarlolocalisation_tpu_torch.sim import robot

    world = presets.make_world(num_particles=500, refine_iters=2,
                               resample_method="systematic",
                               ess_threshold=0.5, device=card)
    gen = torch.Generator(device=card)
    gen.manual_seed(3)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, 8, batch=EPISODES)
    mask = torch.ones(ranges.shape, dtype=torch.bool, device=card)
    angles = torch.as_tensor(world.angles, device=card)

    def run():
        st = mcl.init_state(world.maze, world.cfg, seed=5, batch=EPISODES)
        for _ in range(2):
            st = mcl.run_ticks(st, enc, ranges, mask, angles, world.maze,
                               world.cfg)[0]
        return st

    replayed = compiled.replayed["refine_grad_cuda"]
    graph = run()
    assert compiled.replayed["refine_grad_cuda"] > replayed
    with monkeypatch.context() as mp:
        mp.setattr(compiled.TickGraph, "_capture", lambda self: None)
        mp.setattr(compiled, "graphs", compiled.GraphCache())
        eager = run()
    compared = []

    def same(a, b):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
            compared.append(a.numel())
        return a

    compiled.tree_map(same, graph, eager)
    assert sum(compared) >= EPISODES * 500 * 4
