"""SLAM's inverse sensor model kernel (csrc/ism.cu, ops/ism) on a CUDA card
(marked `card`: skips without one).

Against models/mapping.update_map_plain, the plain torch form, run on the
same card, bit for bit (the float32 bits equal, so -0 and +0 differ):

- the SLAM cell's shape, [16, 4, 128] maps of 49 x 49 px with 24 beams
  (mclbench's rbpf-128x24): random poses and scans with masked beams,
  beams at max_range and past max_trusted_range, one scan a map and one
  a filter; the gate open (None), closed, mixed by filter (as slam_step
  passes it) and by map;
- among those maps, poses and ranges constructed so that, for pixels of
  an axis-aligned beam, proj falls exactly on 0, on r - hit_margin and on
  r + hit_depth, and perp exactly on half_width (the test counts those
  ties on the plain form's own geometry and needs each);
- a windowed stack, [4, 32] maps of 128 x 128 px, its windows clamped at
  every border, gated by map;
- after every call the input maps unchanged, one launch counted
  (`ism_update_cuda.launches`, `ism.calls`) and its maps (`ism.maps`);
- SLAM ticks with keyframes (models/slam.run_slam_ticks, [2, 2] filters x
  128 particles, 24 ticks) replayed through TickGraph equal to the same
  ticks run eagerly, and equal to the ticks with the plain form.

The suite's conftest imports JAX, which a card's host may lack, so run
this file alone there:

    python -m pytest --noconftest -p no:cacheprovider -m card \\
        tests/test_torch_card_ism.py
"""
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.card

E, K, P, BEAMS = 16, 4, 128, 24
TIES = 512          # maps of the cell's stack posed on exact thresholds


@pytest.fixture
def card():
    """The CUDA device, or a skip where there is none (decided when the
    test runs, never at import)."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the ISM kernel runs on the card")
    return torch.device("cuda")


def _configs(height=49, width=49):
    from montecarlolocalisation_tpu_torch.config import (MappingConfig,
                                                         SensorModelConfig)

    return MappingConfig(height=height, width=width), SensorModelConfig()


def _angles(dev):
    return torch.deg2rad(torch.linspace(-118.0, 118.0, BEAMS,
                                        dtype=torch.float64)).to(
        torch.float32).to(dev)


def _counts():
    from montecarlolocalisation_tpu_torch.ops import ism
    from montecarlolocalisation_tpu_torch.utils import profiling

    c = profiling.recorder.counters
    return (ism.ism_update_cuda.launches, c.get("ism.calls", 0),
            c.get("ism.maps", 0))


def _same(a, b):
    return a.shape == b.shape and torch.equal(a.view(torch.int32),
                                              b.view(torch.int32))


def _both(lo, poses, ranges, angles, mask, mc, sc, paint=None):
    """(kernel, plain) for one call, with the input unchanged and one
    launch counted."""
    from montecarlolocalisation_tpu_torch.models import mapping

    before, counts = lo.clone(), _counts()
    got = mapping.update_map(lo, poses, ranges, angles, mask, mc, sc,
                             paint=paint)
    torch.cuda.synchronize()
    after = _counts()
    maps = got[..., 0, 0].numel()
    assert after == (counts[0] + 1, counts[1] + 1, counts[2] + maps)
    assert _same(lo, before)
    want = mapping.update_map_plain(lo, poses, ranges, angles, mask, mc, sc,
                                    paint=paint)
    return got, want


def _search(target, other, sub=False, tries=64):
    """Float32 x with fl(x + other) == target (fl(x - other) where `sub`),
    searched a few ulps around target -+ other; NaN where none is found."""
    x0 = (target + other if sub else target - other).astype(np.float32)
    out = np.full(target.shape, np.nan, np.float32)
    for steps in range(tries):
        for sgn in (1, -1):
            x = x0.copy()
            for _ in range(steps):
                x = np.nextafter(x, np.float32(sgn * np.inf))
            got = (x - other) if sub else (x + other)
            hit = np.isnan(out) & (got.astype(np.float32) == target)
            out[hit] = x[hit]
        if not np.isnan(out).any():
            break
    return out


def _tie_inputs(n, mc, sc, angles, dev, rng):
    """Poses [n, 3], ranges and mask [n, B] that put one beam of each map
    along +x exactly (ray 0: cos 1, sin 0), its ray origin on a pixel
    centre's x (proj 0 at that column) and half_width below row 0's
    centre (perp half_width on row 0), with the beam's range such that
    r - hit_margin (even maps) or r + hit_depth (odd maps) equals a
    later column's proj exactly."""
    sign = -1.0 if sc.negate_beam_angle else 1.0
    # Beams within 30 degrees of the heading: the origin's offset across
    # the beam, under 0.05 m, keeps y + that offset exact, so the search
    # reaches y's target.
    near = np.flatnonzero(np.abs(angles.cpu().numpy()) < np.deg2rad(30.0))
    b = near[rng.randint(0, len(near), n)]
    theta = -(sign * angles.cpu().numpy()[b])
    th = torch.as_tensor(theta, device=dev)
    tx = (sc.laser_offset * torch.cos(th)).cpu().numpy()
    ty = (sc.laser_offset * torch.sin(th)).cpu().numpy()
    f = np.float32
    res = f(mc.resolution)
    j0 = rng.randint(2, 20, n)
    px0 = (f(mc.origin_x) + (j0.astype(f) + f(0.5)) * res).astype(f)
    py0 = f(mc.origin_y) + (f(0.0) + f(0.5)) * res
    hw = f(mc.half_width)
    oy = np.full(n, f(py0 - hw), f)
    assert f(py0 - oy[0]) == hw
    x = _search(px0, tx)
    y = _search(oy, ty)
    # r - hit_margin within proj's binade (proj 0.3 or 0.4 m), so r's
    # grid is as fine as proj's.
    lo_side = np.arange(n) % 2 == 0
    j1 = j0 + np.where(lo_side, rng.randint(3, 5, n), rng.randint(3, 8, n))
    px1 = (f(mc.origin_x) + (j1.astype(f) + f(0.5)) * res).astype(f)
    dx1 = (px1 - px0).astype(f)
    r = np.where(lo_side, _search(dx1, f(mc.hit_margin), sub=True),
                 _search(dx1, -f(mc.hit_depth), sub=True))
    ok = ~(np.isnan(x) | np.isnan(y) | np.isnan(r))
    assert ok.mean() > 0.9, ok.mean()
    poses = np.stack([np.where(ok, x, 1.0), np.where(ok, y, 1.0),
                      theta], -1).astype(f)
    ranges = rng.uniform(0.05, 1.1, (n, BEAMS)).astype(f)
    ranges[np.arange(n), b] = np.where(ok, r, 0.5)
    mask = np.ones((n, BEAMS), f)
    return (torch.as_tensor(poses, device=dev),
            torch.as_tensor(ranges, device=dev),
            torch.as_tensor(mask, device=dev), torch.as_tensor(b))


def _tie_counts(poses, ranges, beam, mc, sc, angles):
    """Pairs of each map's aligned beam whose proj equals 0, r -
    hit_margin, r + hit_depth, and whose perp equals half_width, on the
    plain form's geometry."""
    from montecarlolocalisation_tpu_torch.models import mapping

    ox, oy, ray, r, _, _ = mapping._scan_geometry(
        poses, ranges, angles, torch.ones_like(ranges), mc, sc)
    idx = beam.to(poses.device)[:, None]
    c = torch.cos(ray).gather(1, idx)[:, :, None]
    s = torch.sin(ray).gather(1, idx)[:, :, None]
    rb = r.gather(1, idx)[:, :, None]
    dev = poses.device
    px = mc.origin_x + (torch.arange(mc.width, device=dev).float() + 0.5) \
        * mc.resolution
    py = mc.origin_y + (torch.arange(mc.height, device=dev).float()
                        + 0.5) * mc.resolution
    dx = px[None, None, :] - ox[:, None, None]
    dy = py[None, :, None] - oy[:, None, None]
    proj = dx * c + dy * s
    perp = torch.abs(dy * c - dx * s)
    on = perp <= mc.half_width
    return dict(
        zero=int((on & (proj == 0.0)).sum()),
        r_lo=int((on & (proj == rb - mc.hit_margin)).sum()),
        r_hi=int((on & (proj == rb + mc.hit_depth)).sum()),
        half_width=int((perp == mc.half_width).sum()))


def _cell_inputs(dev, seed=7):
    """The cell's stack: maps [E, K, P, 49, 49], poses [E, K, P, 3], ranges
    and mask [E, K, P, B] (TIES maps posed on thresholds among them)."""
    mc, sc = _configs()
    rng = np.random.RandomState(seed)
    angles = _angles(dev)
    lo = rng.uniform(-8.0, 8.0, (E, K, P, 49, 49)).astype(np.float32)
    lo[..., 0, :3] = [8.0, -8.0, -0.0]
    poses = np.stack([rng.uniform(0.0, 4.9, (E, K, P)),
                      rng.uniform(0.0, 4.9, (E, K, P)),
                      rng.uniform(-np.pi, np.pi, (E, K, P))],
                     -1).astype(np.float32)
    ranges = rng.uniform(0.05, 1.1, (E, K, P, BEAMS)).astype(np.float32)
    ranges[rng.uniform(size=ranges.shape) < 0.1] = sc.max_range
    ranges[rng.uniform(size=ranges.shape) < 0.05] = 1.05
    mask = (rng.uniform(size=ranges.shape) > 0.1).astype(np.float32)
    t = lambda a: torch.as_tensor(a, device=dev)   # noqa: E731
    lo, poses, ranges, mask = t(lo), t(poses), t(ranges), t(mask)
    tp, tr, tm, beam = _tie_inputs(TIES, mc, sc, angles, dev, rng)
    flat = (E * K * P,)
    poses.view(flat + (3,))[:TIES] = tp
    ranges.view(flat + (BEAMS,))[:TIES] = tr
    mask.view(flat + (BEAMS,))[:TIES] = tm
    ties = _tie_counts(tp, tr, beam, mc, sc, angles)
    print("exact ties on the aligned beams:", ties)
    assert min(ties.values()) > 0, ties
    return mc, sc, angles, lo, poses, ranges, mask


def test_kernel_equals_plain_at_the_cell_shape(card):
    mc, sc, angles, lo, poses, ranges, mask = _cell_inputs(card)
    rng = np.random.RandomState(3)
    gates = dict(
        open=None,
        closed=torch.zeros((E, K, 1), dtype=torch.bool, device=card),
        by_filter=torch.as_tensor(rng.uniform(size=(E, K, 1)) < 0.3,
                                  device=card),
        by_map=torch.as_tensor(rng.uniform(size=(E, K, P)) < 0.5,
                               device=card))
    for name, paint in gates.items():
        got, want = _both(lo, poses, ranges, angles, mask, mc, sc, paint)
        assert _same(got, want), name
        if name == "closed":
            assert _same(got, lo)
        else:
            assert not torch.equal(got, lo)
    # One scan a filter, as slam_step passes it.
    got, want = _both(lo, poses, ranges[..., :1, :], angles,
                      mask[..., :1, :], mc, sc, gates["by_filter"])
    assert _same(got, want)


def test_kernel_equals_plain_windowed(card):
    from montecarlolocalisation_tpu_torch.models import mapping

    mc, sc = _configs(128, 128)
    assert 2 * mapping.sensor_window_px(mc) <= 128
    rng = np.random.RandomState(9)
    e, p = 4, 32
    lo = torch.as_tensor(rng.uniform(-8, 8, (e, p, 128, 128)).astype(
        np.float32), device=card)
    xy = rng.uniform(-0.3, 13.1, (e, p, 2))
    xy[0, :4] = [[-0.3, -0.3], [13.1, 13.1], [-0.3, 13.1], [13.1, -0.3]]
    poses = torch.as_tensor(np.concatenate(
        [xy, rng.uniform(-np.pi, np.pi, (e, p, 1))], -1).astype(np.float32),
        device=card)
    ranges = torch.as_tensor(rng.uniform(0.05, 1.1, (e, p, BEAMS)).astype(
        np.float32), device=card)
    mask = torch.as_tensor((rng.uniform(size=(e, p, BEAMS)) > 0.1).astype(
        np.float32), device=card)
    paint = torch.as_tensor(rng.uniform(size=(e, p)) < 0.7, device=card)
    for gate in (None, paint):
        got, want = _both(lo, poses, ranges, _angles(card), mask, mc, sc,
                          gate)
        assert _same(got, want)


def test_slam_ticks_graph_eager_and_plain(card, monkeypatch):
    from montecarlolocalisation_tpu_torch import presets
    from montecarlolocalisation_tpu_torch.config import (FilterConfig,
                                                         SLAMConfig)
    from montecarlolocalisation_tpu_torch.models import compiled, slam
    from montecarlolocalisation_tpu_torch.ops import ism
    from montecarlolocalisation_tpu_torch.sim import robot

    world = presets.make_world(num_beams=BEAMS, device=card)
    fc = FilterConfig()
    cfg = SLAMConfig(num_particles=P,
                     mapping=presets._mapping_config(world.maze),
                     sensor=fc.sensor, motion=fc.motion,
                     keyframe_trans=0.15, keyframe_rot=0.5)
    batch, ticks, k = (2, 2), 24, compiled.TICKS_PER_GRAPH
    start = (1.25, 1.25, 0.0)
    gen = torch.Generator(device=card)
    gen.manual_seed(11)
    enc, scans, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, ticks, batch=batch[0],
        start_pose=start, slip_noise=0.08, explore=True)
    angles = torch.as_tensor(world.angles, device=card)
    e = enc[:, None].expand(batch + enc.shape[1:])
    r = scans[:, None].expand(batch + scans.shape[1:])
    ones = torch.ones_like(r)

    def run():
        st = slam.init_slam(3, start, cfg, batch, card)
        mapped = []
        for t0 in range(0, ticks, k):
            st, ys = slam.run_slam_ticks(
                st, e[..., t0:t0 + k, :], r[..., t0:t0 + k, :],
                ones[..., t0:t0 + k, :], angles, cfg)
            st = compiled.detach_state(st)
            mapped.append(ys["mapped"].clone())
        return st, torch.cat(mapped, dim=-1)

    replayed = compiled.replayed["ism_update_cuda"]
    graph, mapped = run()
    assert compiled.replayed["ism_update_cuda"] > replayed
    assert bool(mapped.any()) and not bool(mapped.all())
    with monkeypatch.context() as mp:
        mp.setattr(compiled.TickGraph, "_capture", lambda self: None)
        mp.setattr(compiled, "graphs", compiled.GraphCache())
        eager = run()
        launches = ism.ism_update_cuda.launches
        mp.setattr(ism, "kernel_takes", lambda *a: False)
        plain = run()
        assert ism.ism_update_cuda.launches == launches
    compared = []

    def same(a, b):
        if isinstance(a, torch.Tensor):
            assert _same(a, b) if a.dtype == torch.float32 else \
                torch.equal(a, b)
            compared.append(a.numel())
        return a

    for other in (eager, plain):
        compared.clear()
        compiled.tree_map(same, (graph, mapped), other)
        assert sum(compared) >= 4 * P * 49 * 49
