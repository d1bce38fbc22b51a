"""A plain-torch mirror of the analytic K1's cast schedule (csrc/weights.cu,
beam_weights_cast_kernel), and the hard cases its tests run.

Per (ray, axis) pair the kernel's lockstep pass evaluates the first
candidate slab ahead of the origin: line k0 where the ray runs toward it,
runs along the lines or starts inside it, else k0 + sgn.  The beam's
distance is then the least of smax (0 where the origin lies on a wall
pixel) and both axes' first hits, and a pair is deferred where its next
slab's line exists and the ray enters it before that distance.  After each
chunk of beams a warp of 32 particles queues its deferred pairs, one a
lane at a time in lane order (a lane's vertical pairs in beam order, then
its horizontal ones) while fewer than 32 wait, and otherwise runs a round:
lanes take the top min(count, 32) pairs, each reads its beam's distance as
the round starts, evaluates its slab, lowers the distance where the hit
is earlier, and goes back on top at the next slab where the ray enters it
before the lower of the two.

The slab arithmetic is the plain cast's (ops/analytic), so the mirror's
distances can be held to beam_weights_plain's, and its counts to
ops/weights.cast_stats'.  Imports torch and the port only (the card's
host has no JAX).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from montecarlolocalisation_tpu_torch import presets
from montecarlolocalisation_tpu_torch.config import (
    WALL_LEFT, WALL_TOP, SensorModelConfig,
)
from montecarlolocalisation_tpu_torch.maps import from_walls
from montecarlolocalisation_tpu_torch.models import raycast, resample, sensor
from montecarlolocalisation_tpu_torch.ops import analytic, weights

WARP = 32
BEAMS = np.deg2rad(np.linspace(-118.0, 118.0, 34)).astype(np.float32)


def _axis(m, gu, gv, du, dv, vertical, smax, n_cand, span):
    ax = analytic._Axis(m, vertical=vertical)
    prep = analytic._axis_prepare(gu, gv, ax)
    ray = analytic._axis_ray(du, dv)
    slabs = [analytic._slab(gu, gv, ray, ax, prep, c, smax, span)
             for c in range(n_cand)]
    t_in = torch.stack([s[0] for s in slabs], -1)
    hit = torch.stack([s[1] for s in slabs], -1)
    k = prep[0][..., None] + ray.sgn[..., None] * torch.arange(
        n_cand, dtype=torch.int32, device=gu.device)
    first = torch.where(ray.small | (du < 0) | prep[1], 0, 1)
    return dict(t_in=t_in, hit=hit, first=first, small=ray.small,
                valid=(k >= 0) & (k < ax.n_lines), origin0=prep[2])


def schedule(m, particles, scan: sensor.Scan, cfg: SensorModelConfig):
    """The schedule on particles [N, 3] or [E, N, 3] and a scan: a dict of
    `px` and `dist` [E, N, B] (the distances in pixels and m); `hit`,
    `t_in` and `evaluated` [E, N, B, 2, n_cand] (the plain cast's hit of
    each candidate in pixels, INF where it has none; its entry time;
    whether the kernel evaluates it); `first` [E, N, B, 2]; `items` [E, N,
    B, 2] (a pair's queued slabs); `inb` [E, N, 1]; and the counts
    `lockstep_slabs`, `queued_slabs`, `deferred` and `rounds`."""
    parts = particles if particles.dim() == 3 else particles[None]
    th = parts[..., 2]
    ox = parts[..., 0] + cfg.laser_offset * torch.cos(th)
    oy = parts[..., 1] + cfg.laser_offset * torch.sin(th)
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    ray = raycast.maybe_quantize(th[..., None] + sign * scan.angles, cfg)
    dx, dy = torch.cos(ray), torch.sin(ray)
    smax, n_cand, span = analytic.cast_constants(m, cfg.max_range)
    gx = ((ox - m.origin_x) * m.inv_resolution)[..., None].expand(dx.shape)
    gy = ((oy - m.origin_y) * m.inv_resolution)[..., None].expand(dx.shape)
    inb = (gx >= 0.0) & (gy >= 0.0) & (gx < float(m.width)) & (
        gy < float(m.height))
    axes = [_axis(m, gx, gy, dx, dy, True, smax, n_cand, span),
            _axis(m, gy, gx, dy, dx, False, smax, n_cand, span)]
    stack = lambda key: torch.stack([a[key] for a in axes], -2)
    hit, t_in, valid = stack("hit"), stack("t_in"), stack("valid")
    first = torch.stack([a["first"] for a in axes], -1)
    small = torch.stack([a["small"] for a in axes], -1)
    take = lambda x, c: torch.gather(x, -1, c[..., None])[..., 0]
    s = torch.where(axes[0]["origin0"] | axes[1]["origin0"], 0.0, smax)
    s = torch.where(inb, torch.minimum(s, take(hit, first).amin(-1)), smax)
    nxt = (first + 1).clamp(max=n_cand - 1)
    more = (inb[..., None] & ~small & (first + 1 < n_cand)
            & take(valid, nxt) & (take(t_in, nxt) < s[..., None]))
    cand = torch.arange(n_cand, device=s.device)
    evaluated = (cand == first[..., None]) & inb[..., None, None]
    dist, done, items, rounds = _queues(
        s.cpu().numpy(), more.cpu().numpy(), first.cpu().numpy(),
        hit.cpu().numpy(), t_in.cpu().numpy(), valid.cpu().numpy())
    final = torch.as_tensor(dist, device=s.device)
    return dict(
        px=final, dist=final * m.resolution, hit=hit, t_in=t_in,
        evaluated=evaluated | torch.as_tensor(done, device=s.device),
        first=first, items=torch.as_tensor(items, device=s.device),
        inb=inb[..., :1], lockstep_slabs=2 * int(inb.sum()),
        queued_slabs=int(items.sum()), deferred=int(more.sum()),
        rounds=rounds)


def chunks(nb: int):
    """The kernel's chunks of beams: as many as CAST_CHUNK beams a chunk
    needs, their sizes as even as whole beams allow."""
    k = -(-nb // weights.CAST_CHUNK)
    return [(c * nb // k, (c + 1) * nb // k) for c in range(k)]


def _queues(s, more, first, hit, t_in, valid):
    """Every warp's queue, chunk by chunk (numpy arrays as schedule names
    them): the final distances, the slabs the queues evaluate, each pair's
    queued slabs and the rounds."""
    dist = s.copy()
    done = np.zeros(hit.shape, dtype=bool)
    items = np.zeros(more.shape, dtype=np.int64)
    n_ep, n, nb, _, n_cand = hit.shape
    rounds = 0
    for e in range(n_ep):
        for w0 in range(0, n, WARP):
            lanes = range(w0, min(w0 + WARP, n))
            for b0, b1 in chunks(nb):
                pend = {p: [(b, a) for a in (0, 1) for b in range(b0, b1)
                            if more[e, p, b, a]] for p in lanes}
                q = []
                while True:
                    ready = [p for p in lanes if pend[p]]
                    if len(q) < WARP and ready:
                        q += [(p, *pend[p].pop(0), None) for p in ready]
                    elif q:
                        top = q[-min(len(q), WARP):]
                        del q[-len(top):]
                        bounds = [dist[e, p, b] for p, b, _, _ in top]
                        for (p, b, a, c), bound in zip(top, bounds):
                            c = first[e, p, b, a] + 1 if c is None else c
                            h = hit[e, p, b, a, c]
                            done[e, p, b, a, c] = True
                            items[e, p, b, a] += 1
                            dist[e, p, b] = min(dist[e, p, b], h)
                            bound = min(bound, h)
                            if c + 1 < n_cand and valid[e, p, b, a, c + 1] \
                                    and t_in[e, p, b, a, c + 1] < bound:
                                q.append((p, b, a, c + 1))
                        rounds += 1
                    else:
                        break
    return dist, done, items, rounds


# -- the hard cases --------------------------------------------------------

def random_maze(cells: int, seed: int, device):
    """A random maze of cells x cells, each top and left wall present with
    probability 0.4: gridlines 8 * cells + 1 px long."""
    rng = np.random.default_rng(seed)
    walls = [[[w for w in (WALL_TOP, WALL_LEFT) if rng.random() < 0.4]
              for _ in range(cells)] for _ in range(cells)]
    return from_walls(walls, device=device)


def _place(m, origin_px, th, cfg):
    """Particles [N, 3] whose laser origins lie at origin_px [N, 2]
    (pixels) with headings th."""
    ox = origin_px[:, 0] * m.resolution + m.origin_x
    oy = origin_px[:, 1] * m.resolution + m.origin_y
    return torch.stack([ox - cfg.laser_offset * torch.cos(th),
                        oy - cfg.laser_offset * torch.sin(th), th], -1)


def _scan(m, angles, gen, episodes=None):
    """A scan over `angles` with ranges drawn up to the maze's extent and
    two dead lanes; ranges and mask [B], or [E, B]."""
    lead = () if episodes is None else (episodes,)
    nb = len(angles)
    ranges = torch.rand(lead + (nb,), generator=gen, device=m.device) * 1.2
    mask = torch.ones(lead + (nb,), dtype=torch.bool, device=m.device)
    mask[..., [1, nb // 2]] = False
    return sensor.Scan(angles=torch.as_tensor(angles, device=m.device),
                       ranges=ranges, mask=mask)


def particles_of(kind: str, m, n: int, gen, cfg):
    """Particles [N, 3] of one hard case (see CASES)."""
    dev = m.device
    u = lambda *s: torch.rand(s or (n,), generator=gen, device=dev)
    if kind in ("uniform", "maze241", "range4m", "beams360"):
        return resample.sample_uniform_particles(gen, m, n)
    if kind == "near_gridline":
        # Origins within 2 px of a gridline, rays within 37 degrees of its
        # normal: a vertical line's when vertical, a horizontal one's else.
        vertical = u() < 0.5
        lines = (m.width - 1) // 8 + 1
        across = 8 * torch.floor(u() * lines) + 4 * (u() - 0.5)
        along = u() * (m.height - 1)
        px = torch.stack([torch.where(vertical, across, along),
                          torch.where(vertical, along, across)], -1)
        normal = torch.where(vertical, 0.0, math.pi / 2) + torch.where(
            u() < 0.5, 0.0, math.pi)
        return _place(m, px.clamp(0.0, m.width - 1e-3),
                      normal + math.radians(37.0) * (2 * u() - 1), cfg)
    if kind == "parallel":
        turns = torch.tensor([0.0, math.pi / 2, math.pi, -math.pi / 2],
                             device=dev)
        parts = resample.sample_uniform_particles(gen, m, n)
        parts[:, 2] = turns[torch.arange(n, device=dev) % 4]
        return parts
    if kind == "wall_off_map":
        # A third on wall pixels of the gridlines, a third off the map, a
        # third uniform.
        walls = torch.nonzero(m.occ.reshape(m.height, m.width))
        pick = walls[torch.randint(0, walls.shape[0], (n,), generator=gen,
                                   device=dev)]
        on_wall = torch.stack([pick[:, 1], pick[:, 0]], -1).float() + u(n, 2)
        off = (u(n, 2) - 0.5) * 4 * m.width
        off = torch.where(off.abs() < m.width, off + 2 * m.width, off)
        third = torch.arange(n, device=dev) % 3
        px = torch.where((third == 0)[:, None], on_wall,
                         torch.where((third == 1)[:, None], off,
                                     u(n, 2) * (m.width - 1)))
        return _place(m, px, (2 * u() - 1) * math.pi, cfg)
    if kind == "word_boundary":
        # Origins in or beside a gridline at a multiple of 32 px along it,
        # heading nearly along it: the band crosses a 32-bit word.
        seams = max(1, (m.width - 1) // 32)
        cross = 8 * torch.floor(u() * ((m.width - 1) // 8 + 1)) + 1.5 * u()
        seam = 32 * torch.floor(1 + u() * seams) + 8 * (u() - 0.5)
        vertical = u() < 0.5
        px = torch.stack([torch.where(vertical, cross, seam),
                          torch.where(vertical, seam, cross)], -1)
        th = (torch.where(vertical, math.pi / 2, 0.0)
              + torch.where(u() < 0.5, 0.0, math.pi) + 0.6 * (u() - 0.5))
        return _place(m, px.clamp(0.0, m.width - 1e-3), th, cfg)
    raise ValueError(kind)


# name -> (maze: "default" or cells of a random maze, beams, max range)
CASES = {
    "uniform": ("default", BEAMS, 1.0),
    "near_gridline": ("default", np.deg2rad(np.linspace(
        -37.0, 37.0, 24)).astype(np.float32), 1.0),
    "parallel": ("default", np.concatenate([np.float32(
        [0.0, math.pi / 2, -math.pi / 2, math.pi]), BEAMS[4:]]), 1.0),
    "wall_off_map": ("default", BEAMS, 1.0),
    "word_boundary": (9, BEAMS, 1.0),
    "maze241": (30, BEAMS, 1.0),
    "range4m": ("default", BEAMS, 4.0),
    "beams360": ("default", np.deg2rad(np.arange(-180.0, 180.0, 1.0))
                 .astype(np.float32), 1.0),
}


def case(kind: str, n: int, device, seed: int = 0, combine: str = "sum",
         quantize: bool = False, episodes=None):
    """(maze, particles [N, 3] or [E, N, 3], scan, config) of one case of
    CASES; the default maze is the presets' 49 x 49 px one."""
    where, angles, max_range = CASES[kind]
    m = presets.make_world(device=device).maze if where == "default" \
        else random_maze(where, seed=where, device=device)
    cfg = SensorModelConfig(ray_mode="analytic", beam_combine=combine,
                            max_range=max_range, quantize_ray_deg=quantize)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if episodes is None:
        parts = particles_of(kind, m, n, gen, cfg)
    else:
        parts = torch.stack([particles_of(kind, m, n, gen, cfg)
                             for _ in range(episodes)])
    return m, parts, _scan(m, angles, gen, episodes), cfg
