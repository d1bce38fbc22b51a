"""The MCL filter: state, one tick, and the episode loop.

Torch counterpart of montecarlolocalisation_tpu/models/filter.py.  One
10 Hz tick (monte_carlo.cpp:1025-1098 executeParticleFilter), in the
reference's order:
  1. hysteresis on the PREVIOUS tick's confidence -> events, thresholds
  2. publish the previous best pose (exact + quantized cell pose)
  3. diffDriveModel + sampleMotionModelOdometry (odometry + noise)
  4. updateParticlePos (propagation), then the opt-in gradient
     refinement (models/refine, cfg.refine.iters > 0)
  5. resampleParticles (weights inside; jitter regime = was_lost AFTER 1),
     every tick, or ESS-gated with carried weights
     (cfg.resample.ess_threshold)
  6. k-means confidence with the post-hysteresis thresholds (importance-
     weighted under the ESS gate)

On CUDA, a stage mark (utils/profiling.mark) precedes motion, the
weights, resampling and the cluster, and `emit` follows the cluster: five
empty kernels a tick, which a captured graph replays in stream order, so
a trace attributes every device operation of the tick to its stage.

With `known_map` (a partial learned map: `m` the conservative fit,
`known_map` the same fit with unexplored edges open) the weights come
from sensor.beam_weights_partial, and InitConfig.partial_map_cells may
restrict the fresh draws to explored cells.

A tick's random numbers come from the state's torch.Generator, or from
`draws` (TickDraws), which lets a caller replay another implementation's
exact draws.

A state may hold one filter (particles [N, 3], scalars []) or a batch of
independent episodes (particles [E, N, 3], scalars [E]), the JAX
package's vmap over `mcl_step` written out as a leading dim: the batch
shares one generator and one beam table, and each episode has its own
encoders, observations and every per-filter scalar.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from ..config import FilterConfig
from ..maps.grid import MazeMap, is_valid_pos, world_to_cell
from ..utils import profiling
from ..utils.angles import quantize_orientation
from . import cluster, compiled, motion, refine, resample, sensor

# Wanderer command codes emitted per tick.
WANDERER_NOOP = -1
WANDERER_STOP = 0
WANDERER_START = 1


@dataclasses.dataclass(frozen=True)
class MCLState:
    """Carried filter state on the map's device; the per-filter scalars are
    0-d for one filter and [E] for a batch."""

    particles: torch.Tensor            # [..., N, 3] x, y, theta
    weights: torch.Tensor              # [..., N]
    odom: motion.OdometryState
    inj: resample.InjectionState
    confidence: torch.Tensor           # f32
    was_lost: torch.Tensor             # bool
    cluster_threshold: torch.Tensor    # f32 (dynamic, monte_carlo.cpp:78)
    confident_threshold: torch.Tensor  # f32 (dynamic, :80)
    best_pose: torch.Tensor            # [..., 3] or the (-1,-1,-1) sentinel
    gen: torch.Generator               # the filter's random stream

    @property
    def batch(self) -> tuple:
        """The leading episode shape: () for one filter, (E,) for a
        batch."""
        return tuple(self.particles.shape[:-2])


@dataclasses.dataclass(frozen=True)
class MCLOutput:
    """Per-tick outputs, the stand-in for the reference's ROS topics; each
    field has the state's leading episode dims."""

    exact_pose: torch.Tensor     # [..., 3] (/exact_pose)
    cell_pose: torch.Tensor      # [..., 3] int32 row, col, orientation
    confidence: torch.Tensor
    song: torch.Tensor           # int32: 0 none, 1 lost, 2 recovered
    wanderer_cmd: torch.Tensor   # int32: -1 noop, 0 stop, 1 start
    n_injected: torch.Tensor
    p_inject: torch.Tensor
    total_weight: torch.Tensor   # sum of this tick's beam likelihoods


@dataclasses.dataclass(frozen=True)
class TickDraws:
    """All random numbers of one tick: motion normals ([..., 3], or
    [..., 3, N] with per-particle noise), the resampling draws, and the
    k-means init [..., K] and reseed [..., I, K] particle indices."""

    motion_normals: torch.Tensor
    resample: resample.ResampleDraws
    kmeans_init: torch.Tensor
    kmeans_reseed: torch.Tensor


def injection_cells(m: MazeMap, cfg: FilterConfig,
                    known_map: Optional[MazeMap] = None,
                    modes=("explored",)):
    """The cell mask of the fresh draws: the explored cells on a partial
    map where partial_map_cells is one of `modes`, else None (the tick's
    draws: "explored", filter.py:226-228 of the JAX package; the initial
    cloud's: "explored" or "init-only", :82-84)."""
    if known_map is None or cfg.init.partial_map_cells not in modes:
        return None
    return resample.explored_cells(m)


def draw_tick(gen: torch.Generator, m: MazeMap, n: int,
              cfg: FilterConfig, batch=(), cell_mask=None) -> TickDraws:
    """One tick's draws from `gen`, with leading episode shape `batch`;
    `cell_mask` restricts the fresh particles' cells."""
    normals = motion.draw_motion_normals(gen, n, cfg.motion, m.device,
                                         batch)
    rs = resample.draw_resample(gen, m, n, cfg, batch, cell_mask)
    init, reseed = cluster.draw_kmeans(gen, n, cfg.cluster, m.device, batch)
    return TickDraws(motion_normals=normals, resample=rs, kmeans_init=init,
                     kmeans_reseed=reseed)


def _full(batch, v, dtype, device):
    return torch.full(batch, v, dtype=dtype, device=device)


def init_state(m: MazeMap, cfg: FilterConfig, seed: int = 0,
               batch: Optional[int] = None,
               known_map: Optional[MazeMap] = None) -> MCLState:
    """Startup state (monte_carlo.cpp:1198-1209): uniform particles,
    zeroed odometry/injection accumulators, lost-side thresholds.  With
    `batch`, E independent episodes drawn from one generator: particles
    [E, N, 3] and every scalar [E].  With `known_map` and
    partial_map_cells "explored" or "init-only", the cloud is drawn over
    the explored cells only (filter.py:72-101 of the JAX package)."""
    dev = m.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    b = () if batch is None else (batch,)
    n = cfg.num_particles
    mask = injection_cells(m, cfg, known_map, ("explored", "init-only"))
    particles = resample.sample_uniform_particles(gen, m, n, cfg.init, b,
                                                  mask)
    h = cfg.hysteresis
    f32 = torch.float32
    return MCLState(
        particles=particles,
        weights=_full(b + (n,), cfg.init.init_weight, f32, dev),
        odom=motion.OdometryState.zero(dev, b),
        inj=resample.InjectionState.zero(dev, b),
        confidence=_full(b, 0.0, f32, dev),
        was_lost=_full(b, False, torch.bool, dev),
        cluster_threshold=_full(b, h.init_cluster_threshold, f32, dev),
        confident_threshold=_full(b, h.init_confident_threshold, f32, dev),
        best_pose=_full(b + (3,), -1.0, f32, dev),
        gen=gen)


def init_tracking_state(m: MazeMap, cfg: FilterConfig, pose, seed: int = 0,
                        sigma_xy: float = 0.03, sigma_theta: float = 0.05,
                        batch: Optional[int] = None,
                        normals=None) -> MCLState:
    """Known-pose startup (filter.py:102-126 of the JAX package): a
    Gaussian cloud at `pose` ([3], or [E, 3] with `batch`) and the
    confident-side thresholds.  `normals` [..., 3, N] are the cloud's
    standard normals for x, y and theta; None draws them from the state's
    generator after init_state's draws."""
    st = init_state(m, cfg, seed, batch)
    n = cfg.num_particles
    b = st.batch
    if normals is None:
        normals = torch.randn(b + (3, n), generator=st.gen, device=m.device)
    normals = torch.as_tensor(normals, dtype=torch.float32, device=m.device)
    p = torch.as_tensor(pose, dtype=torch.float32,
                        device=m.device).expand(b + (3,))
    parts = torch.stack([p[..., 0, None] + sigma_xy * normals[..., 0, :],
                         p[..., 1, None] + sigma_xy * normals[..., 1, :],
                         p[..., 2, None] + sigma_theta * normals[..., 2, :]],
                        dim=-1)
    h = cfg.hysteresis
    f32 = torch.float32
    return dataclasses.replace(
        st, particles=parts, confidence=_full(b, 1.0, f32, m.device),
        cluster_threshold=_full(b, h.conf_cluster_threshold, f32, m.device),
        confident_threshold=_full(b, h.conf_confident_threshold, f32,
                                  m.device),
        best_pose=p.clone())


def _hysteresis(state: MCLState, m: MazeMap, cfg: FilterConfig):
    """Lost/recovered state machine (monte_carlo.cpp:1030-1081).
    Returns (was_lost, cluster_thr, conf_thr, song, wanderer_cmd)."""
    h = cfg.hysteresis
    conf = state.confidence
    thr = state.confident_threshold
    lost_cond = conf < thr
    conf_cond = conf > thr
    to_lost = lost_cond & ~state.was_lost
    recovered = conf_cond & state.was_lost
    best_valid = is_valid_pos(m, state.best_pose[..., 0],
                              state.best_pose[..., 1], cfg.valid_pos_offset)
    conf_to_conf = conf_cond & ~state.was_lost & best_valid

    cluster_thr = torch.where(
        to_lost, h.lost_cluster_threshold,
        torch.where(conf_cond, h.conf_cluster_threshold,
                    state.cluster_threshold))
    conf_thr = torch.where(
        to_lost, h.lost_confident_threshold,
        torch.where(conf_cond, h.conf_confident_threshold, thr))
    was_lost = torch.where(to_lost, True,
                           torch.where(recovered, False, state.was_lost))
    song = torch.where(to_lost, h.song_lost,
                       torch.where(recovered, h.song_recovered, 0)
                       ).to(torch.int32)
    wanderer = torch.where(
        to_lost, WANDERER_START,
        torch.where(recovered | conf_to_conf, WANDERER_STOP, WANDERER_NOOP),
    ).to(torch.int32)
    return was_lost, cluster_thr, conf_thr, song, wanderer


def cell_pose_msg(best_pose, cell_meters: float = 0.8):
    """World poses [..., 3] -> (row, col, orientation) int32, with the
    (-1,-1,-1) sentinel (monte_carlo.cpp:958-1008 publishPosMsg)."""
    wx, wy, theta = best_pose[..., 0], best_pose[..., 1], best_pose[..., 2]
    row, col = world_to_cell(wx, wy, cell_meters)
    orient = quantize_orientation(theta)
    invalid = (wx < 0) | (wy < 0)
    return torch.where(invalid[..., None], -1,
                       torch.stack([row, col, orient], dim=-1)
                       ).to(torch.int32)


def mcl_step(
    state: MCLState,
    encoder_left,
    encoder_right,
    scan: sensor.Scan,
    m: MazeMap,
    cfg: FilterConfig,
    draws: Optional[TickDraws] = None,
    known_map: Optional[MazeMap] = None,
) -> Tuple[MCLState, MCLOutput]:
    """One 10 Hz filter tick, of one filter or of every episode of a batch
    (encoders [...], scan ranges and mask [..., B]).  `known_map` switches
    the weights to the partial-map scorer (module docstring)."""
    dev = state.particles.device
    cell_mask = injection_cells(m, cfg, known_map)
    if draws is None:
        draws = draw_tick(state.gen, m, state.particles.shape[-2], cfg,
                          state.batch, cell_mask)

    # 1. Hysteresis on previous confidence.
    was_lost, cluster_thr, conf_thr, song, wanderer = _hysteresis(
        state, m, cfg)

    # 2. Publish previous best pose.
    exact_pose = state.best_pose
    cell_pose = cell_pose_msg(state.best_pose, m.cell_meters)

    # 3-4. Odometry + propagate.  Each stage follows its mark
    # (utils/profiling.mark).
    profiling.mark("motion", dev)
    odom, particles = motion.motion_update(
        state.particles, state.odom, encoder_left, encoder_right,
        cfg.motion, draws.motion_normals)

    # 4b. Opt-in gradient refinement (no reference counterpart), under
    #     marks of its own where it is on (models/refine).
    if cfg.refine.iters > 0:
        profiling.mark("refine", dev)
        particles = refine.refine_particles(m, particles, scan, cfg)

    # 5. Weights + resample (jitter regime = was_lost after hysteresis,
    #    monte_carlo.cpp:1087).
    profiling.mark("weights", dev)
    if known_map is None:
        weights = sensor.beam_weights(m, particles, scan, cfg.sensor,
                                      cfg.valid_pos_offset)
    else:
        weights = sensor.beam_weights_partial(m, known_map, particles, scan,
                                              cfg.sensor,
                                              cfg.valid_pos_offset)
    gated = cfg.resample.ess_threshold is not None
    profiling.mark("resample", dev)
    if gated:
        particles, weights, inj, info = resample.ess_gated_resample(
            particles, weights, state.weights, state.inj, was_lost, m, cfg,
            draws.resample)
    else:
        particles, weights, inj, info = resample.resample(
            particles, weights, state.inj, was_lost, m, cfg, draws.resample)

    # 6. Cluster confidence with the post-hysteresis threshold, importance-
    #    weighted where the gate carries non-uniform weights.
    profiling.mark("cluster", dev)
    confidence, best_pose = cluster.cluster_confidence(
        particles, weights, conf_thr, cfg.cluster, draws.kmeans_init,
        draws.kmeans_reseed, weighted=gated)
    profiling.mark("emit", dev)

    new_state = MCLState(
        particles=particles, weights=weights, odom=odom, inj=inj,
        confidence=confidence, was_lost=was_lost,
        cluster_threshold=cluster_thr, confident_threshold=conf_thr,
        best_pose=best_pose, gen=state.gen)
    out = MCLOutput(
        exact_pose=exact_pose, cell_pose=cell_pose, confidence=confidence,
        song=song, wanderer_cmd=wanderer,
        n_injected=info["n_injected"].to(torch.int32),
        p_inject=info["p_inject"], total_weight=info["total_weight"])
    return new_state, out


def _tick(state: MCLState, x: dict, consts: dict, m: MazeMap,
          cfg: FilterConfig, known_map: Optional[MazeMap]):
    """One mcl_step on a tick's inputs: encoders [..., 2], ranges and mask
    [..., B], angles [B] (in `x` where they change by the tick, else in
    `consts`) and, where given, the tick's draws."""
    angles = x["angles"] if "angles" in x else consts["angles"]
    scan = sensor.Scan(angles=angles, ranges=x["ranges"], mask=x["mask"])
    enc = x["encoders"]
    return mcl_step(state, enc[..., 0], enc[..., 1], scan, m, cfg,
                    x.get("draws"), known_map=known_map)


def run_ticks(state: MCLState, encoders, ranges, mask, angles,
              m: MazeMap, cfg: FilterConfig,
              draws: Optional[TickDraws] = None,
              known_map: Optional[MazeMap] = None):
    """K = encoders.shape[lead] ticks of mcl_step through one graph of
    models/compiled (one replay on CUDA): encoders [..., K, 2], ranges and
    mask [..., K, B], angles [B] or [K, B] (one filter only), `draws` one
    TickDraws whose tensors carry the tick axis after the episode dims.
    Returns (state, outputs [..., K, ...]), both the graph's buffers
    (models/compiled), whose graph comes from compiled.graphs."""
    lead = len(state.batch)
    xs = dict(encoders=encoders, ranges=ranges, mask=mask)
    consts = {}
    if angles.dim() == 2:
        xs["angles"] = angles
    else:
        consts["angles"] = angles
    if draws is not None:
        xs["draws"] = draws
    graph = compiled.cached(None, _tick, state, xs, consts, lead, m=m,
                            cfg=cfg, known_map=known_map)
    return graph(state, xs, consts)


def run_episode(
    state: MCLState,
    encoders,            # [..., T, 2] encoder_left/right (radians)
    scan_ranges,         # [..., T, B]
    scan_angles,         # [B] static beam table, or [T, B] per tick
    m: MazeMap,
    cfg: FilterConfig,
    scan_mask=None,      # [..., T, B] optional
    draws: Optional[Sequence[TickDraws]] = None,   # one per tick
    known_map: Optional[MazeMap] = None,
) -> Tuple[MCLState, MCLOutput]:
    """Run the filter over a recorded episode, or over a batch of episodes
    with the state's leading dims; the outputs are stacked over ticks
    ([..., T, ...]).  A batch shares one static beam table [B].
    `known_map` as in mcl_step.

    The JAX package's lax.scan over mcl_step (filter.py:274-298): the
    ticks run in graphs of compiled.TICKS_PER_GRAPH ticks (run_ticks), one
    replay each on CUDA, and the last graph takes the remainder.  The
    final state and the outputs are the caller's own tensors.

    The call is one span `episode.call` (utils/profiling) whose id the
    spans inside take: `episode.prep` (the inputs' conversions),
    models/compiled's `graph.*` and `episode.copy_out`."""
    with profiling.span("episode.call"):
        with profiling.span("episode.prep"):
            dev = m.device
            encoders = torch.as_tensor(encoders, dtype=torch.float32,
                                       device=dev)
            ranges = torch.as_tensor(scan_ranges, dtype=torch.float32,
                                     device=dev)
            angles = torch.as_tensor(scan_angles, dtype=torch.float32,
                                     device=dev)
            mask = (torch.ones(ranges.shape, dtype=torch.bool, device=dev)
                    if scan_mask is None
                    else torch.as_tensor(scan_mask, device=dev).to(
                        torch.bool))
        lead = len(state.batch)
        if lead and angles.dim() != 1:
            raise ValueError("a batch of episodes shares one beam table "
                             "[B]")
        carry = [state]

        def chunk(t0: int, n: int):
            def part(v):
                return v.narrow(lead, t0, n)

            d = (None if draws is None
                 else compiled.stack_ticks(draws[t0:t0 + n], lead))
            carry[0], ys = run_ticks(
                carry[0], part(encoders), part(ranges), part(mask),
                angles[t0:t0 + n] if angles.dim() == 2 else angles, m, cfg,
                d, known_map)
            return ys

        outs = compiled.run_chunked(chunk, ranges.shape[lead], lead)
        with profiling.span("episode.copy_out"):
            return compiled.detach_state(carry[0]), outs
