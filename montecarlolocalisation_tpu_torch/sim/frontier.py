"""Frontier-driven autonomous exploration under SLAM (closed loop).

Torch counterpart of montecarlolocalisation_tpu/sim/frontier.py (no
reference counterpart: the reference explores with the blind wanderer and
its map is hand-written).  The robot drives toward the nearest cell that
still has unobserved edges, planned by BFS over its own current map,
localized by the SLAM posterior itself.  The JAX package measured the
freer-side wanderer covering more edges a tick than frontier targeting on
every world family it tried, so the slam preset's default explorer stays
the wanderer; frontier exploration buys map quality per explored edge and
deterministic targeting.  Two styles of the JAX package's fifth round:
`novelty_bias` (avoidance turns steer toward unknown mass on the robot's
own consensus map) and `wander_style="wallfollow"` (left-hand wall
following).

Two layers:

* `explore_phase`: the ticks of one phase through models/compiled (CUDA
  graphs of compiled.TICKS_PER_GRAPH ticks, as run_slam_episode runs
  them; the JAX package's jit-compiled lax.scan).  A tick simulates the
  LIDAR from the true pose, runs slam.slam_step, P-drives toward the
  current waypoint on the SLAM estimate (controllers.global_p_drive) with
  the wanderer's halves-compare avoidance turn when the forward sector
  blocks, and integrates the true dynamics with wheel slip while the
  encoders record the commanded arcs.  The padded waypoint slots and
  their count are inputs of the graph, so one graph serves every phase.
* `run_frontier_slam`: the host loop.  After each phase it snaps the best
  particle's map onto the lattice (mapping.fit_walls), lists the frontier
  cells, plans by BFS from the estimated cell to the nearest one and
  hands the next waypoints to the next phase; it ends when no frontier
  remains or the phases run out.

The state holds one robot (batch ()).  A tick's random numbers come from
the state's two generators (the simulator's: scan noise and slip; the
SLAM filter's), or from `draws` (ExploreDraws), which lets a caller
replay the JAX package's draws.  The host loop's own choice among the
nearest frontiers draws from a numpy Generator seeded with `host_seed`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SLAMConfig
from ..control import controllers as C
from ..maps.grid import MazeMap, f32_reciprocal
from ..models import compiled, mapping, sensor, slam
from . import robot as R
from .closed_loop import _waypoint, mission_waypoints


@dataclasses.dataclass(frozen=True)
class ExploreState:
    robot: R.RobotState      # ground truth (+ cumulative encoders), 0-d
    slam: slam.SLAMState     # joint (pose, map) posterior, batch ()
    est: torch.Tensor        # [3] SLAM pose estimate driving the control
    wp_idx: torch.Tensor     # int32 into the padded waypoint slots
    turn_left: torch.Tensor  # int32 avoidance-turn ticks remaining
    turn_sign: torch.Tensor  # f32 +-1
    gen: torch.Generator     # the simulator's stream (scan noise, slip)


@dataclasses.dataclass(frozen=True)
class ExploreDraws:
    """One tick's random numbers: the scan's draws ([B]), the SLAM tick's,
    and the wheel-slip standard normals [2] (None without slip)."""

    scan: sensor.ScanDraws
    slam: slam.SLAMDraws
    slip: Optional[torch.Tensor] = None


def draw_explore(state: ExploreState, num_beams: int, scfg: SLAMConfig,
                 slip_noise: float) -> ExploreDraws:
    """A tick's draws from the state's generators."""
    dev = state.est.device
    return ExploreDraws(
        scan=sensor.draw_scan(state.gen, (num_beams,), dev),
        slam=slam.draw_slam(state.slam.gen, scfg, (), dev),
        slip=(torch.randn(2, generator=state.gen, device=dev)
              if slip_noise else None))


def init_explore(seed: int, start_pose, scfg: SLAMConfig,
                 device="cuda") -> ExploreState:
    """The robot and every SLAM particle at `start_pose`, no waypoint, no
    turn; the simulator and the SLAM filter draw from two seeds derived
    from `seed`."""
    dev = torch.device(device)
    sim_seed, slam_seed = (
        int(v) for v in np.random.SeedSequence(seed).generate_state(2))
    gen = torch.Generator(device=dev)
    gen.manual_seed(sim_seed)
    return ExploreState(
        robot=R.make_robot(*start_pose, batch=None, device=dev),
        slam=slam.init_slam(slam_seed, start_pose, scfg, (), dev),
        est=torch.tensor(start_pose, dtype=torch.float32, device=dev),
        wp_idx=torch.zeros((), dtype=torch.int32, device=dev),
        turn_left=torch.zeros((), dtype=torch.int32, device=dev),
        turn_sign=torch.ones((), dtype=torch.float32, device=dev), gen=gen)


def turn_ticks(scfg: SLAMConfig, turn_speed: float, dt: float) -> int:
    """The pi/3 timed turn at turn_speed (wanderer_try_final.cpp:167-191)
    in ticks: the ceiling of the float32-rounded quotient, as jnp.ceil
    rounds the JAX package's."""
    omega = turn_speed * (scfg.motion.wheel_size / 2.0) / (
        scfg.motion.wheel_space / 2.0)
    return int(np.ceil(np.float32((math.pi / 3.0) / (omega * dt))))


def _explore_tick(state: ExploreState, waypoints, n_wp, m_true: MazeMap,
                  scfg: SLAMConfig, angles, slip_noise: float,
                  scan_noise: float, base_speed: float, turn_speed: float,
                  avoid_thresh: float, arrival_tol: float, dt: float,
                  novelty_bias: float = 0.0, wander_style: str = "freer",
                  draws: Optional[ExploreDraws] = None):
    """One tick (sim/frontier.py:90-228 of the JAX package): waypoints
    [slots, 2] and n_wp (0-d int32) on the device.  Returns (state,
    (true pose [3], SLAM estimate [3]))."""
    angles = torch.as_tensor(angles, dtype=torch.float32,
                             device=state.est.device)
    if draws is None:
        draws = draw_explore(state, angles.shape[0], scfg, slip_noise)
    rb0 = state.robot

    # 1. Sense the true world.
    scan = sensor.simulate_scan(m_true, rb0.pose, angles, scfg.sensor,
                                noise_sigma=scan_noise, draws=draws.scan)

    # 2. SLAM tick: lying encoders in, the joint posterior out.
    new_slam, info = slam.slam_step(
        state.slam, rb0.encoder_left, rb0.encoder_right, scan.ranges,
        angles, torch.ones_like(scan.ranges), scfg, draws=draws.slam)
    est = info["pose"]

    # 3. Behave: waypoint P-drive on the SLAM estimate, the wanderer's
    # halves-compare avoidance when the forward sector blocks (bumping
    # into a wall that the optimistic plan routed through observes it).
    wp = _waypoint(waypoints, state.wp_idx)
    arrived = ((torch.abs(est[0] - wp[0]) <= arrival_tol)
               & (torch.abs(est[1] - wp[1]) <= arrival_tol))
    wp_idx = torch.where(arrived & (state.wp_idx < n_wp), state.wp_idx + 1,
                         state.wp_idx)
    wp_active = wp_idx < n_wp
    wp_next = _waypoint(waypoints, wp_idx)

    r = torch.where(scan.mask, scan.ranges, 9.99)
    blocked = torch.amin(r, dim=-1) <= avoid_thresh
    half = r.shape[-1] // 2
    seen_r = torch.where(scan.mask, scan.ranges, 0.0)
    sum1 = torch.sum(seen_r[:half])
    sum2 = torch.sum(seen_r[half:])
    if novelty_bias > 0.0:
        # Weigh each half-scan by the unknown territory (on the robot's
        # own consensus map) its beam endpoints touch.
        cons = slam.consensus_map(new_slam)[None]            # [1, H, W]
        observed = (torch.abs(cons) > 0.25 * scfg.mapping.l_free
                    ).to(torch.float32)
        theta = est[2]
        sign = -1.0 if scfg.sensor.negate_beam_angle else 1.0
        ray = theta + sign * angles
        ox = est[0] + scfg.sensor.laser_offset * torch.cos(theta)
        oy = est[1] + scfg.sensor.laser_offset * torch.sin(theta)
        ex = (ox + scan.ranges * torch.cos(ray))[None]       # [1, B]
        ey = (oy + scan.ranges * torch.sin(ray))[None]
        unk = 1.0 - slam._bilinear(observed, ex, ey, scfg.mapping)[0]
        nov = novelty_bias * scfg.sensor.max_range
        sum1 = sum1 + nov * torch.sum(unk[:half])
        sum2 = sum2 + nov * torch.sum(unk[half:])
    start_turn = blocked & (state.turn_left == 0)
    if wander_style == "wallfollow":
        # Keep the followed wall on the left (+theta side): every
        # avoidance turn rotates away from it (heading decreases).
        new_sign = torch.full_like(state.turn_sign, -1.0)
    else:
        new_sign = torch.where(sum1 >= sum2, 1.0, -1.0)
    turn_sign = torch.where(start_turn, new_sign, state.turn_sign)
    turn_left = torch.where(start_turn,
                            turn_ticks(scfg, turn_speed, dt),
                            state.turn_left).to(torch.int32)
    turning = turn_left > 0

    gl, gr, _ = C.global_p_drive(est, wp_next, base_speed)
    # Waypoints exhausted: spin in place, so that a frontier cell reached
    # facing away from its unobserved edge observes it; a phase with no
    # waypoints at all (n_wp == 0) wanders forward instead.
    spin = ~wp_active & (n_wp > 0)
    if wander_style == "wallfollow":
        # Left-hand wall following: a gentle differential P-term with a
        # deadband holds the left clearance at 0.45 m (heading increases
        # with the faster left wheel); a blocked front falls through to
        # the timed avoidance turn above.
        off = (-1.0 if scfg.sensor.negate_beam_angle else 1.0) * angles
        left_sector = (off > 0.35) & (off < 1.6) & scan.mask
        left_min = torch.amin(torch.where(left_sector, scan.ranges, 9.99),
                              dim=-1)
        err = left_min - 0.45
        err = torch.where(torch.abs(err) < 0.06, 0.0, err)
        err = torch.clamp(err, -0.2, 0.2)
        wf_l = base_speed * (1.0 + 1.2 * err)
        wf_r = base_speed * (1.0 - 1.2 * err)
        fwd_l = torch.where(spin, turn_speed, wf_l)
        fwd_r = torch.where(spin, -turn_speed, wf_r)
    else:
        fwd_l = torch.where(spin, turn_speed, base_speed)
        fwd_r = torch.where(spin, -turn_speed, base_speed)
    left = torch.where(turning, turn_speed * turn_sign,
                       torch.where(wp_active, gl, fwd_l))
    right = torch.where(turning, -turn_speed * turn_sign,
                        torch.where(wp_active, gr, fwd_r))
    left, right = C.clamp_wheels(left, right)
    turn_left = torch.clamp_min(turn_left - 1, 0)

    # 4. Act: the truth integrates slipped arcs, the encoders record the
    # commanded ones (sim/robot.generate_wander_episode's fault model).
    dl, dr = R.wheel_arcs_from_speeds(left, right, dt, scfg.motion)
    if slip_noise:
        eps = slip_noise * draws.slip
        rb = R.step_dynamics(rb0, dl * (1.0 + eps[0]), dr * (1.0 + eps[1]),
                             scfg.motion)
        inv_tick = f32_reciprocal(scfg.motion.wheel_size * 0.5)
        rb = dataclasses.replace(
            rb, encoder_left=rb0.encoder_left + dl * inv_tick,
            encoder_right=rb0.encoder_right + dr * inv_tick)
    else:
        rb = R.step_dynamics(rb0, dl, dr, scfg.motion)

    new_state = ExploreState(robot=rb, slam=new_slam, est=est,
                             wp_idx=wp_idx, turn_left=turn_left,
                             turn_sign=turn_sign, gen=state.gen)
    return new_state, (rb.pose, est)


@dataclasses.dataclass(frozen=True)
class _Phase:
    """An explore phase's static settings (hashable: a graph's key)."""

    slip_noise: float
    scan_noise: float
    base_speed: float
    turn_speed: float
    avoid_thresh: float
    arrival_tol: float
    dt: float
    novelty_bias: float
    wander_style: str


def _tick(carry: ExploreState, x: dict, consts: dict, m_true: MazeMap,
          scfg: SLAMConfig, ph: _Phase):
    """_explore_tick on a tick's inputs: `x` holds the tick's index and,
    where given, its draws; consts the beam table, the waypoint slots and
    their count."""
    return _explore_tick(
        carry, consts["waypoints"], consts["n_wp"], m_true, scfg,
        consts["angles"], ph.slip_noise, ph.scan_noise, ph.base_speed,
        ph.turn_speed, ph.avoid_thresh, ph.arrival_tol, ph.dt,
        ph.novelty_bias, ph.wander_style, draws=x.get("draws"))


def explore_phase(state: ExploreState, waypoints, n_wp, m_true: MazeMap,
                  scfg: SLAMConfig, angles, num_ticks: int,
                  slip_noise: float = 0.03, scan_noise: float = 0.02,
                  base_speed: float = 8.0, turn_speed: float = 5.0,
                  avoid_thresh: float = 0.25, arrival_tol: float = 0.25,
                  dt: float = 0.1, novelty_bias: float = 0.0,
                  wander_style: str = "freer",
                  draws: Optional[Sequence[ExploreDraws]] = None):
    """One exploration phase of `num_ticks` ticks from `state`: waypoint
    slots [slots, 2] and their count n_wp (the first n_wp are live).  The
    ticks run in graphs of compiled.TICKS_PER_GRAPH ticks, one replay
    each on CUDA, whose inputs include the slots and the count.  `draws`
    holds one ExploreDraws a tick.  (Speeds tuned on the JAX package's
    chip sweeps: faster driving raised coverage but smeared the map.)
    Returns (state, (true poses [T, 3], estimates [T, 3])), the caller's
    own tensors."""
    dev = state.est.device
    consts = dict(
        angles=torch.as_tensor(angles, dtype=torch.float32, device=dev),
        waypoints=torch.as_tensor(waypoints, dtype=torch.float32,
                                  device=dev),
        n_wp=torch.as_tensor(n_wp, dtype=torch.int32, device=dev))
    ph = _Phase(slip_noise=float(slip_noise), scan_noise=float(scan_noise),
                base_speed=float(base_speed), turn_speed=float(turn_speed),
                avoid_thresh=float(avoid_thresh),
                arrival_tol=float(arrival_tol), dt=float(dt),
                novelty_bias=float(novelty_bias), wander_style=wander_style)
    carry = [state]

    def chunk(t0: int, n: int):
        xs = dict(tick=torch.arange(t0, t0 + n, dtype=torch.int32,
                                    device=dev))
        if draws is not None:
            xs["draws"] = compiled.stack_ticks(list(draws[t0:t0 + n]), 0)
        graph = compiled.cached(None, _tick, carry[0], xs, consts, 0,
                                m_true=m_true, scfg=scfg, ph=ph)
        carry[0], ys = graph(carry[0], xs, consts)
        return ys

    outs = compiled.run_chunked(chunk, num_ticks, 0)
    return compiled.detach_state(carry[0]), outs


def frontier_cells(seen: np.ndarray) -> list:
    """Cells with at least one unobserved edge, as (row, col) tuples."""
    unseen = ~np.asarray(seen, bool)
    rs, cs = np.nonzero(unseen.any(axis=-1))
    return list(zip(rs.tolist(), cs.tolist()))


def plan_to_nearest_frontier(walls: np.ndarray, seen: np.ndarray,
                             cur_cell: Tuple[int, int],
                             rng: Optional[np.random.Generator] = None,
                             k_nearest: int = 3) -> list:
    """BFS path over `walls` from cur_cell to a frontier cell; [] when
    none is reachable.  The caller passes the conservative wall graph
    (unexplored = wall) first, so that the robot routes only through
    known-open edges, and the optimistic one only when nothing is
    reachable that way.  With `rng`, the target is drawn among the
    `k_nearest` shortest reachable frontiers, so that a target the
    estimate keeps missing rotates."""
    from ..planning import bfs

    targets = [f for f in frontier_cells(seen) if f != tuple(cur_cell)]
    paths = [p for f in targets
             if (p := bfs.bfs_path(walls, cur_cell, f))]
    if not paths:
        return []
    paths.sort(key=len)
    top = paths[:max(1, k_nearest)]
    if rng is None:
        return top[0]
    return top[int(rng.integers(len(top)))]


def _coverage(state: ExploreState, cell_px: int):
    """(log-odds of the best particle's map [H, W], conservative walls,
    explored edges) on the host."""
    lo = slam.best_map(state.slam).cpu().numpy()
    walls, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                    return_explored=True)
    return lo, walls, seen


def run_frontier_slam(seed: int, m_true: MazeMap, scfg: SLAMConfig, angles,
                      start_pose=(1.25, 1.25, 0.0), phases: int = 12,
                      phase_ticks: int = 120, wp_slots: int = 12,
                      slip_noise: float = 0.03, static_map: bool = False,
                      policy: str = "frontier",
                      hybrid_growth: float = 0.02,
                      host_seed: Optional[int] = None, **phase_kw):
    """The exploration loop on the true maze's device (sim/frontier.py:
    322-439 of the JAX package).  Returns (final ExploreState, dict with
    the coverage before each phase and at the end, and the true and
    estimated poses of every tick, [T, 3] numpy).

    `policy`: "frontier" BFS-targets the nearest frontier every phase;
    "hybrid" wanders while coverage grows by `hybrid_growth` a phase and
    targets frontiers after; "wander" and "wallfollow" only wander
    (pass wander_style="wallfollow" or novelty_bias through `phase_kw`).
    Two phases without coverage growth force a wander phase (a fake wall
    in the fitted map can block every route).  `static_map` is accepted
    for the JAX package's signature and changes nothing: one graph serves
    every phase either way.  `host_seed` seeds the host's choice among
    the nearest frontiers (JAX seeds it from its key's data); by default
    it is derived from `seed`."""
    del static_map
    state = init_explore(seed, start_pose, scfg, m_true.device)
    cell_m = float(m_true.cell_meters)
    cell_px = int(round(cell_m / float(m_true.resolution)))
    if host_seed is None:
        host_seed = int(np.random.SeedSequence(seed).generate_state(3)[2])
    host_rng = np.random.default_rng(host_seed)

    truth_log, est_log, coverage = [], [], []
    for _ in range(phases):
        lo, walls_cons, seen = _coverage(state, cell_px)
        coverage.append(float(np.mean(seen)))
        if not frontier_cells(seen):
            break                     # full coverage: exploration done
        est = state.est.cpu().numpy()
        cur = (int(np.clip(est[1] // cell_m, 0, seen.shape[0] - 1)),
               int(np.clip(est[0] // cell_m, 0, seen.shape[1] - 1)))
        stalled = (len(coverage) >= 3
                   and coverage[-1] <= coverage[-3] + 1e-9)
        if policy == "hybrid":
            grew = (coverage[-1] - coverage[-2]
                    if len(coverage) >= 2 else 1.0)
            want_frontier = (grew < hybrid_growth) and not stalled
        elif policy in ("wander", "wallfollow"):
            want_frontier = False
        else:
            want_frontier = not stalled
        path = ([] if not want_frontier else
                plan_to_nearest_frontier(walls_cons, seen, cur, host_rng))
        if not path and want_frontier:
            walls_opt = mapping.fit_walls(lo, cell_px=cell_px,
                                          unexplored_is_wall=False)
            path = plan_to_nearest_frontier(walls_opt, seen, cur,
                                            host_rng)
        if path:
            # A capped path: a long leg would eat the phase and skip the
            # spin that observes the frontier's edges.
            wps = mission_waypoints(path, cell_m)[1:][:min(3, wp_slots)]
        else:
            wps = np.zeros((0, 2), np.float32)
        pad = np.zeros((wp_slots, 2), np.float32)
        pad[:len(wps)] = wps
        # A fresh waypoint list starts a fresh slot cursor.
        state = dataclasses.replace(state, wp_idx=torch.zeros_like(
            state.wp_idx))
        state, (tp, ep) = explore_phase(
            state, pad, len(wps), m_true, scfg, angles, phase_ticks,
            slip_noise=slip_noise, **phase_kw)
        truth_log.append(tp.cpu().numpy())
        est_log.append(ep.cpu().numpy())
    _, _, seen = _coverage(state, cell_px)
    coverage.append(float(np.mean(seen)))
    return state, dict(
        coverage=coverage,
        truth=np.concatenate(truth_log) if truth_log else np.zeros((0, 3)),
        est=np.concatenate(est_log) if est_log else np.zeros((0, 3)))
