"""The reference RBPF SLAM tick in plain torch: the semantics the benchmark
holds the program's SLAM to.

Rao-Blackwellized particle-filter SLAM as the JAX package's
models/slam.py and models/mapping.py describe it (slam_step, update_map):
each particle carries a pose and its own log-odds occupancy grid.  One
tick of a batch of independent filters (poses [..., P, 3], maps
[..., P, H, W], every per-filter scalar [...]; the leading dims are
episodes, or episodes x replicas):

  1. the odometry proposal: the encoders' diff-drive move split into
     (rot1, trans, rot2), with the turning-in-place split (trans < 1e-4:
     rot1 = 0, rot2 = the whole turn), then per-particle noise with the
     odometry model's alphas times alpha_scale, the heading wrapped;
  2. the likelihood field of each particle's map before this tick's
     update: the wallness sigmoid(4 (l - l_occ / 2)) rebased so that
     unknown is zero, blurred by a banded Gaussian on both axes (two
     matrix products, clipped at 1) for the endpoints, kept sharp for the
     free-space stations;
  3. the scan's log-likelihood on each particle's own field: a returned
     beam's endpoint (half a pixel past the return) scores
     log(z_hit field + z_rand); every valid beam adds log(1 - z_short wall)
     at `free_samples` stations short of the return by free_margin; a
     sample is a four-tap bilinear read that is 0 outside the pixel-centre
     hull of the map and gives a missing tap (the last pixel, an integer
     coordinate) weight 0;
  4. the evidence: log_evidence += logsumexp(log w + loglik), then the
     weights normalized;
  5. ESS-gated systematic resampling: where 1 / sum(w^2) < ess_threshold P,
     (k + u0) / P against the weight CDF (accumulated in float64), the
     maps and the pre-resample scores riding along, the weights then
     uniform;
  6. the weighted mean pose (circular heading);
  7. the keyframe gate: a filter maps this tick where its mean pose moved
     keyframe_trans (m) or turned keyframe_rot (rad) since its last
     keyframe; with both 0, every tick maps;
  8. the inverse sensor model: every (pixel, beam) pair classified by the
     pixel centre's distance along the beam and across it, free short of
     the return less hit_margin, hit from there to hit_depth past it
     (returned beams only), within half_width of the beam; the map adds
     l_occ a hit and subtracts l_free a crossing, clamped to +-clamp.

Random numbers: a tick draws, from the state's torch.Generator and in
this order, the motion normals [..., 3, P] and the resampling offset u0
[...], u0 on every tick whether or not the gate fires (`draw`); the
initial state draws nothing (every particle at the known start pose,
empty maps, uniform weights).

Departures from the published description, each the port's and noted
so: the JAX package splits a threefry key a tick, where the port's
states carry one torch.Generator that this reference replays; the JAX
package's bilinear sample contracts tent weights (a TPU workaround for
gathers), read here as the equivalent four-tap gather with the same
edges; its weight CDF is a float32 cumsum, here accumulated in float64
(the port's choice, so that the card's sum does not vary); the closure,
proposal candidates, gradient scan matching and the windows the port
takes on maps over twice a scan's reach are not implemented
(`mclbench/world.py` admits no configuration that uses them).

Floating point: float32, with the divisions by constants taken as
products with float32 reciprocals where the program folds them so, and
the ISM's counts accumulated beam after beam (small integers, exact).
`dtype` runs the particles' move, the field and the scan likelihood, and
the map's sum in another precision (the control: bfloat16).
"""
from __future__ import annotations

import dataclasses
import math

import torch

from .caster import recip


@dataclasses.dataclass
class State:
    """A batch of reference SLAM filters: poses [..., P, 3], maps
    [..., P, H, W], weights and scores [..., P], odometry [..., 5] (x, y,
    theta, encoder_left, encoder_right), the last keyframe's mean pose
    [..., 3] and the accumulated log evidence [...]."""

    poses: torch.Tensor
    logodds: torch.Tensor
    weights: torch.Tensor
    scores: torch.Tensor
    odom: torch.Tensor
    kf_pose: torch.Tensor
    log_evidence: torch.Tensor


@dataclasses.dataclass
class Output:
    """One tick's numbers: the published weighted mean pose [..., 3], the
    ESS, whether the filter resampled and mapped [...], and the poses the
    map update read [..., P, 3]."""

    pose: torch.Tensor
    ess: torch.Tensor
    resampled: torch.Tensor
    mapped: torch.Tensor
    poses: torch.Tensor


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def init(cfg: dict, seed: int, start, batch) -> tuple:
    """(State, generator) of filters of leading dims `batch`, every particle
    at its filter's start pose (start [..., 3] broadcast to batch), the
    generator seeded with `seed`."""
    b = tuple(batch)
    start = start.to(torch.float32)
    dev = start.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    p = cfg["num_particles"]
    mp = cfg["mapping"]
    sp = start.expand(b + (3,))
    w = torch.full(b + (p,), 1.0 / p, dtype=torch.float32, device=dev)
    zero = torch.zeros(b, dtype=torch.float32, device=dev)
    st = State(poses=sp[..., None, :].expand(b + (p, 3)).clone(),
               logodds=torch.zeros(b + (p, mp["height"], mp["width"]),
                                   dtype=torch.float32, device=dev),
               weights=w, scores=w.clone(),
               odom=torch.cat([sp, zero[..., None], zero[..., None]], -1),
               kf_pose=torch.full(b + (3,), -1e6, dtype=torch.float32,
                                  device=dev),
               log_evidence=zero.clone())
    return st, gen


def draw(gen, cfg: dict, batch, device) -> dict:
    """One tick's random numbers, in the stream's order."""
    b = tuple(batch)
    return dict(normals=torch.randn(b + (3, cfg["num_particles"]),
                                    generator=gen, device=device),
                u0=torch.rand(b, generator=gen, device=device))


def odometry(odom, enc_l, enc_r, mc: dict):
    """The diff-drive odometry [..., 5] after the encoders, and its
    (rot1, trans, rot2) with the turning-in-place split."""
    x0, y0, th0, el0, er0 = odom.unbind(-1)
    d_left = (enc_l - el0) * mc["wheel_size"] * 0.5
    d_right = (enc_r - er0) * mc["wheel_size"] * 0.5
    d_center = 0.5 * (d_left + d_right)
    d_theta = (d_left - d_right) * recip(mc["wheel_space"])
    x = x0 + d_center * torch.cos(th0 + 0.5 * d_theta)
    y = y0 + d_center * torch.sin(th0 + 0.5 * d_theta)
    th = wrap(th0 + d_theta)
    rot1 = torch.atan2(y - y0, x - x0) - th0
    trans = torch.sqrt((y - y0) ** 2 + (x - x0) ** 2)
    rot2 = th - th0 - rot1
    in_place = trans < 1e-4
    rot2 = torch.where(in_place, rot1 + rot2, rot2)
    rot1 = torch.where(in_place, 0.0, rot1)
    return torch.stack([x, y, th, enc_l, enc_r], dim=-1), rot1, trans, rot2


def propose(poses, rot1, trans, rot2, normals, cfg: dict, dtype):
    """Every particle moved by its own noisy (rot1, trans, rot2); normals
    [..., 3, P].  Computed in `dtype`, returned in float32."""
    mc = cfg["motion"]
    a1, a2, a3, a4 = (mc[f"alpha_{i}"] * cfg["alpha_scale"]
                      for i in (1, 2, 3, 4))
    sd_r1 = torch.sqrt(a1 * torch.abs(rot1) + a2 * trans)
    sd_tr = torch.sqrt(a3 * trans + a4 * (torch.abs(rot1) + torch.abs(rot2)))
    sd_r2 = torch.sqrt(a1 * torch.abs(rot2) + a2 * trans)
    n1, n2, n3 = normals.unbind(-2)
    r1 = (rot1[..., None] + sd_r1[..., None] * n1).to(dtype)
    tr = (trans[..., None] + sd_tr[..., None] * n2).to(dtype)
    r2 = (rot2[..., None] + sd_r2[..., None] * n3).to(dtype)
    p = poses.to(dtype)
    theta = p[..., 2]
    heading = theta + r1
    x = p[..., 0] + tr * torch.cos(heading)
    y = p[..., 1] + tr * torch.sin(heading)
    return torch.stack([x, y, wrap(theta + r1 + r2)], dim=-1).float()


def blur_matrix(n: int, sigma: float, radius: int, device):
    """The banded 1-D Gaussian [n, n], 1 on the diagonal, 0 beyond
    `radius` pixels."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    d = torch.abs(i[:, None] - i[None, :])
    return torch.where(d <= radius, torch.exp(-0.5 * (d / sigma) ** 2), 0.0)


def field(logodds, cfg: dict, dtype=torch.float32):
    """(blurred, sharp) wallness fields of maps [..., H, W], in `dtype`."""
    l_occ = cfg["mapping"]["l_occ"]
    lo = logodds.to(dtype)
    s = torch.sigmoid(4.0 * (lo - 0.5 * l_occ))
    s0 = 1.0 / (1.0 + math.exp(2.0 * l_occ))
    wall = torch.clamp_min((s - s0) / (1.0 - s0), 0.0)
    h, w = lo.shape[-2], lo.shape[-1]
    kh, kw = (blur_matrix(n, cfg["field_sigma_px"], cfg["field_radius_px"],
                          lo.device).to(dtype) for n in (h, w))
    blurred = torch.clamp(torch.matmul(torch.matmul(kh, wall), kw), 0.0,
                          1.0)
    return blurred, wall


def bilinear(f, ex, ey, mp: dict):
    """Samples [..., P, S] of fields [..., P, h, w] at world points ex, ey
    [..., P, S]: the four taps' bilinear blend, 0 outside the hull of the
    pixel centres."""
    h, w = f.shape[-2], f.shape[-1]
    inv = recip(mp["resolution"])
    u = (ex - mp["origin_x"]) * inv - 0.5
    v = (ey - mp["origin_y"]) * inv - 0.5
    inside = ((u >= 0.0) & (u <= w - 1.0) & (v >= 0.0)
              & (v <= h - 1.0)).to(f.dtype)
    u = torch.clamp(u, 0.0, w - 1.0)
    v = torch.clamp(v, 0.0, h - 1.0)
    u0, v0 = torch.floor(u), torch.floor(v)
    wu0 = 1.0 - torch.abs(u - u0)
    wu1 = torch.clamp_min(1.0 - torch.abs(u - (u0 + 1.0)), 0.0)
    wv0 = 1.0 - torch.abs(v - v0)
    wv1 = torch.clamp_min(1.0 - torch.abs(v - (v0 + 1.0)), 0.0)
    c0, r0 = u0.to(torch.int64), v0.to(torch.int64)
    c1 = torch.clamp(c0 + 1, max=w - 1)
    r1 = torch.clamp(r0 + 1, max=h - 1)
    flat = f.flatten(-2)

    def tap(r, c):
        return torch.gather(flat, -1, r * w + c)

    blend = (wv0 * (wu0 * tap(r0, c0) + wu1 * tap(r0, c1))
             + wv1 * (wu0 * tap(r1, c0) + wu1 * tap(r1, c1)))
    return inside * blend


def origins(poses, sensor: dict):
    """Ray origins (ox, oy) [..., P, 1], laser_offset ahead of the poses,
    and the headings [..., P, 1]."""
    th = poses[..., 2:3]
    off = sensor["laser_offset"]
    return (poses[..., 0:1] + off * torch.cos(th),
            poses[..., 1:2] + off * torch.sin(th), th)


def loglik(fields, poses, ranges, mask, angles, cfg: dict):
    """Scan log-likelihood [..., P] of poses [..., P, 3] on their own
    fields; ranges and mask [..., B].  Computed in the fields' dtype."""
    blurred, wall = fields
    dt = blurred.dtype
    sensor, mp = cfg["sensor"], cfg["mapping"]
    poses = poses.to(dt)
    ox, oy, th = origins(poses, sensor)
    sign = -1.0 if sensor["negate_beam_angle"] else 1.0
    ray = th + sign * angles.to(dt)                              # [..., P, B]
    rb = ranges.to(dt)[..., None, :]                              # [..., 1, B]
    r = rb + 0.5 * mp["resolution"]
    ex = ox + r * torch.cos(ray)
    ey = oy + r * torch.sin(ray)
    hit = bilinear(blurred, ex, ey, mp)
    valid = mask[..., None, :].to(dt) * (
        rb <= mp["max_trusted_range"]).to(dt)
    returned = valid * (rb < sensor["max_range"] - 1e-6).to(dt)
    per_beam = torch.log(cfg["z_hit"] * hit + cfg["z_rand"]) * returned
    n_free = cfg["free_samples"]
    if cfg["z_short"] > 0.0 and n_free > 0:
        cr, sr = torch.cos(ray), torch.sin(ray)
        fracs = (torch.arange(1, n_free + 1, dtype=torch.float32,
                              device=poses.device) / n_free).to(dt)
        s = torch.clamp_min(rb - cfg["free_margin"], 0.0)[..., None] * fracs
        shape = ray.shape + (n_free,)
        sx = torch.broadcast_to(ox[..., None] + s * cr[..., None],
                                shape).flatten(-2)
        sy = torch.broadcast_to(oy[..., None] + s * sr[..., None],
                                shape).flatten(-2)
        k = bilinear(wall, sx, sy, mp).unflatten(-1, (ray.shape[-1],
                                                      n_free))
        per_beam = per_beam + (
            torch.sum(torch.log1p(-cfg["z_short"] * k), dim=-1) * valid)
    return torch.sum(per_beam, dim=-1).float()


def systematic(cdf, u0):
    """Systematic resampling's sources [..., P]: output k takes the first
    i whose CDF reaches (k + u0) / P, through the cumulative offspring
    counts (kept monotone)."""
    n = cdf.shape[-1]
    counts = torch.clamp(torch.floor(n * cdf - u0[..., None]).to(
        torch.int32) + 1, 0, n)
    counts = torch.cummax(counts, dim=-1).values
    k = torch.arange(n, dtype=torch.int32, device=cdf.device)
    key = torch.minimum(k, counts[..., -1:] - 1).contiguous()
    return torch.searchsorted(counts, key, right=True).clamp(max=n - 1)


def ism_counts(poses, ranges, mask, angles, cfg: dict):
    """The inverse sensor model's (hits, crossings) [..., P, H, W] of one
    scan (ranges and mask [..., B]) from poses [..., P, 3]: for each beam,
    the pixels whose centre lies within half_width of it and short of the
    return less hit_margin (a crossing), or from there to hit_depth past
    it on a returned beam (a hit); beams masked or past max_trusted_range
    add nothing."""
    mp, sensor = cfg["mapping"], cfg["sensor"]
    h, w = mp["height"], mp["width"]
    res = mp["resolution"]
    dev = poses.device
    x, y, th = poses.unbind(-1)
    off = sensor["laser_offset"]
    ox = x + off * torch.cos(th)
    oy = y + off * torch.sin(th)
    sign = -1.0 if sensor["negate_beam_angle"] else 1.0
    ray = th[..., None] + sign * angles                          # [..., P, B]
    r = ranges.to(torch.float32)[..., None, :]                   # [..., 1, B]
    valid = mask[..., None, :].to(torch.float32) * (
        r <= mp["max_trusted_range"]).to(torch.float32)
    returned = (r < sensor["max_range"] - 1e-6).to(torch.float32)
    cb, sb = torch.cos(ray), torch.sin(ray)
    px = mp["origin_x"] + (torch.arange(w, device=dev).to(torch.float32)
                           + 0.5) * res
    py = mp["origin_y"] + (torch.arange(h, device=dev).to(torch.float32)
                           + 0.5) * res
    dx = px[None, :] - ox[..., None, None]                       # [..., 1, W]
    dy = py[:, None] - oy[..., None, None]                       # [..., H, 1]
    hits = torch.zeros(poses.shape[:-1] + (h, w), dtype=torch.float32,
                       device=dev)
    frees = torch.zeros_like(hits)
    for b in range(ray.shape[-1]):
        def beam(v):
            return v[..., b, None, None]

        c, s, rr = beam(cb), beam(sb), beam(r)
        along = dx * c + dy * s
        across = torch.abs(dy * c - dx * s)
        on = (across <= mp["half_width"]).to(torch.float32) * beam(valid)
        frees = frees + on * ((along >= 0.0) & (
            along < rr - mp["hit_margin"])).to(torch.float32)
        hits = hits + on * beam(returned) * (
            (along >= rr - mp["hit_margin"])
            & (along <= rr + mp["hit_depth"])).to(torch.float32)
    return hits, frees


def update_maps(logodds, poses, ranges, mask, angles, cfg: dict,
                dtype=torch.float32):
    """Every particle's map [..., P, H, W] after one scan at its pose, the
    sum taken in `dtype`."""
    mp = cfg["mapping"]
    hits, frees = ism_counts(poses, ranges, mask, angles, cfg)
    delta = mp["l_occ"] * hits - mp["l_free"] * frees
    return torch.clamp(logodds.to(dtype) + delta.to(dtype), -mp["clamp"],
                       mp["clamp"]).float()


def tick(st: State, enc, ranges, mask, angles, cfg: dict, d: dict,
         dtype=torch.float32):
    """One tick of every filter: encoders [..., 2], ranges and mask
    [..., B], beam table [B]; returns (State, Output)."""
    p = st.poses.shape[-2]
    odom, rot1, trans, rot2 = odometry(st.odom, enc[..., 0], enc[..., 1],
                                       cfg["motion"])
    poses = propose(st.poses, rot1, trans, rot2, d["normals"], cfg, dtype)
    ll = loglik(field(st.logodds, cfg, dtype), poses, ranges, mask, angles,
                cfg)
    logw = torch.log(st.weights) + ll
    log_evidence = st.log_evidence + torch.logsumexp(logw, dim=-1)
    logw = logw - torch.amax(logw, dim=-1, keepdim=True)
    w = torch.exp(logw)
    w = w / torch.sum(w, dim=-1, keepdim=True)

    ess = 1.0 / torch.sum(w * w, dim=-1)
    fire = ess < cfg["ess_threshold"] * p
    idx = systematic(torch.cumsum(w.double(), dim=-1).to(torch.float32),
                     d["u0"]).to(torch.int64)
    poses = torch.where(fire[..., None, None], torch.take_along_dim(
        poses, idx[..., None], dim=-2), poses)
    logodds = torch.where(fire[..., None, None, None], torch.take_along_dim(
        st.logodds, idx[..., None, None], dim=-3), st.logodds)
    scores = torch.where(fire[..., None], torch.take_along_dim(w, idx, -1),
                         w)
    w = torch.where(fire[..., None], torch.full_like(w, 1.0 / p), w)

    mean = torch.stack([
        torch.sum(w * poses[..., 0], dim=-1),
        torch.sum(w * poses[..., 1], dim=-1),
        torch.atan2(torch.sum(w * torch.sin(poses[..., 2]), dim=-1),
                    torch.sum(w * torch.cos(poses[..., 2]), dim=-1))], dim=-1)

    kt, kr = cfg["keyframe_trans"], cfg["keyframe_rot"]
    mapped = torch.zeros(fire.shape, dtype=torch.bool, device=fire.device)
    if kt > 0.0:
        mapped = mapped | (torch.hypot(mean[..., 0] - st.kf_pose[..., 0],
                                       mean[..., 1] - st.kf_pose[..., 1])
                           >= kt)
    if kr > 0.0:
        mapped = mapped | (torch.abs(wrap(mean[..., 2] - st.kf_pose[..., 2]))
                           >= kr)
    if kt <= 0.0 and kr <= 0.0:
        mapped = torch.ones_like(mapped)
    painted = update_maps(logodds, poses, ranges, mask, angles, cfg, dtype)
    logodds = torch.where(mapped[..., None, None, None], painted, logodds)
    kf_pose = torch.where(mapped[..., None], mean, st.kf_pose)
    new = State(poses=poses, logodds=logodds, weights=w, scores=scores,
                odom=odom, kf_pose=kf_pose, log_evidence=log_evidence)
    return new, Output(pose=mean, ess=ess, resampled=fire, mapped=mapped,
                       poses=poses)


def run(st: State, gen, encs, ranges, mask, angles, cfg: dict,
        dtype=torch.float32):
    """Ticks over encoders [..., T, 2], ranges and mask [..., T, B],
    drawing from `gen`; returns (State, [Output a tick])."""
    batch = st.poses.shape[:-2]
    lead = len(batch)
    outs = []
    for t in range(encs.shape[lead]):
        d = draw(gen, cfg, batch, st.poses.device)
        st, o = tick(st, encs.select(lead, t), ranges.select(lead, t),
                     mask.select(lead, t), angles, cfg, d, dtype)
        outs.append(o)
    return st, outs


def from_program(st) -> State:
    """A reference State (copies) from a program's SLAM state (its field
    names: poses, logodds, weights, scores, odom.{x, y, theta,
    encoder_left, encoder_right}, kf_pose, log_evidence)."""
    o = st.odom
    return State(poses=st.poses.detach().clone(),
                 logodds=st.logodds.detach().clone(),
                 weights=st.weights.detach().clone(),
                 scores=st.scores.detach().clone(),
                 odom=torch.stack([o.x, o.y, o.theta, o.encoder_left,
                                   o.encoder_right], dim=-1).detach(),
                 kf_pose=st.kf_pose.detach().clone(),
                 log_evidence=st.log_evidence.detach().clone())


def field_reach_px(cfg: dict) -> int:
    """The side (pixels) of the window the program's field takes on large
    maps: the scan's reach, the blur's and a 2 px margin; a map whose side
    is under twice it is read whole."""
    reach = (cfg["sensor"]["laser_offset"]
             + cfg["mapping"]["max_trusted_range"]
             + cfg["mapping"]["resolution"])
    half = (int(math.ceil(reach / cfg["mapping"]["resolution"]))
            + cfg["field_radius_px"] + 2)
    return 2 * half + 1

