"""Closed-loop episodes: MCL + controllers + plan execution, tick by tick.

Torch counterpart of montecarlolocalisation_tpu/sim/closed_loop.py.  The
reference runs this loop as five ROS processes (sensors -> monte_carlo ->
moveToPosition_server -> PID/wanderer -> diff_drive).  Here the whole
control stack closes through the simulated robot in one tick:

  1. LIDAR scan simulated from the ground-truth pose (shared ray caster)
  2. full MCL tick (models/filter.mcl_step)
  3. behavior: wanderer while delocalized (the filter's wanderer_cmd
     events, monte_carlo.cpp:243-246), waypoint-following P-control on the
     MCL pose estimate when confident (goToTargetGlobal,
     moveToPosition_server.cpp:529-606, 0.2 m arrival tolerance)
  4. wheel commands integrate through the diff-drive dynamics; encoders
     feed back into the next MCL tick.

A state holds one robot (every quantity 0-d, particles [N, 3]) or a batch
of E episodes ([E], particles [E, N, 3]): the batch is the JAX package's
vmap over episode keys, the BASELINE.md closed-loop sweep, and its filter
tick takes the batched kernels.  Episodes run in CUDA graphs of
models/compiled.TICKS_PER_GRAPH ticks, as run_episode does.  A tick's
random numbers come from two generators in the state, the simulator's
(scan noise) and the filter's, or from `draws` (a ScanDraws and a
TickDraws), which lets a caller replay another implementation's exact
draws.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import FilterConfig, WandererConfig
from ..control import controllers as C
from ..maps.grid import MazeMap
from ..models import compiled, sensor
from ..models import filter as mcl
from . import robot as R


@dataclasses.dataclass(frozen=True)
class ClosedLoopState:
    robot: R.RobotState
    filt: mcl.MCLState
    wanderer: C.WandererState
    wanderer_on: torch.Tensor     # bool: latched by the filter's events
    wp_idx: torch.Tensor          # int32 current waypoint
    gen: torch.Generator          # the simulator's stream (scan noise)

    @property
    def batch(self) -> tuple:
        """The leading episode shape: () for one robot, (E,) for a
        batch."""
        return self.filt.batch


@dataclasses.dataclass(frozen=True)
class ClosedLoopOutput:
    """One tick's outputs, with the state's leading episode dims."""

    true_pose: torch.Tensor       # [..., 3]
    est_pose: torch.Tensor        # [..., 3] or the (-1,-1,-1) sentinel
    confidence: torch.Tensor
    wp_idx: torch.Tensor
    wheel_cmd: torch.Tensor       # [..., 2]


def _waypoint(waypoints, idx):
    """waypoints[clip(idx)] for every episode: [..., 2]."""
    i = torch.clamp(idx, 0, waypoints.shape[0] - 1).reshape(-1).long()
    return waypoints.index_select(0, i).reshape(idx.shape + (2,))


def closed_loop_step(
    state: ClosedLoopState, waypoints, m: MazeMap, cfg: FilterConfig,
    scan_angles, wcfg: WandererConfig = WandererConfig(),
    base_speed: float = 10.0, arrival_tol: float = 0.2,
    scan_noise: float = 0.02, sense_m: Optional[MazeMap] = None,
    draws: Optional[Tuple[sensor.ScanDraws, mcl.TickDraws]] = None,
) -> Tuple[ClosedLoopState, ClosedLoopOutput]:
    """One tick of one robot or of every episode of a batch; waypoints
    [n_wp, 2] are shared by the episodes.  `draws` = (scan draws [..., B],
    the filter's tick draws), or None to draw from the state's
    generators."""
    dev = m.device
    angles = torch.as_tensor(scan_angles, dtype=torch.float32, device=dev)
    n_wp = waypoints.shape[0]
    scan_draws, tick_draws = (None, None) if draws is None else draws
    if scan_draws is None:
        scan_draws = sensor.draw_scan(state.gen, state.batch + angles.shape,
                                      dev)

    # 1. Sense.  `sense_m` (default: the filter map `m`) is the TRUE world
    # the LIDAR sees — pass a different map to drive on a LEARNED map
    # (mapping/SLAM autonomy loop: plan+localize on the robot's own map,
    # sense the real maze).
    scan = sensor.simulate_scan(m if sense_m is None else sense_m,
                                state.robot.pose, angles, cfg.sensor,
                                noise_sigma=scan_noise, draws=scan_draws)

    # 2. Localize.
    filt, out = mcl.mcl_step(
        state.filt, state.robot.encoder_left, state.robot.encoder_right,
        scan, m, cfg, draws=tick_draws)
    wanderer_on = torch.where(
        out.wanderer_cmd == mcl.WANDERER_START, True,
        torch.where(out.wanderer_cmd == mcl.WANDERER_STOP, False,
                    state.wanderer_on))

    # 3. Behave.
    wp = _waypoint(waypoints, state.wp_idx)
    est = out.exact_pose
    est_valid = est[..., 0] >= 0
    # Waypoint arrival: |dx|,|dy| <= tol (moveToPosition_server.cpp:581).
    arrived = (est_valid
               & (torch.abs(est[..., 0] - wp[..., 0]) <= arrival_tol)
               & (torch.abs(est[..., 1] - wp[..., 1]) <= arrival_tol))
    wp_idx = torch.where(arrived, torch.clamp(state.wp_idx + 1, max=n_wp),
                         state.wp_idx)
    wp_active = wp_idx < n_wp
    wp_next = _waypoint(waypoints, wp_idx)

    gl, gr, _ = C.global_p_drive(est, wp_next, base_speed)
    wst, (wl, wr) = C.wanderer_tick(state.wanderer, scan.ranges, scan.mask,
                                    wanderer_on, wcfg, cfg.tick_dt)
    use_goal = est_valid & ~wanderer_on & wp_active
    left = torch.where(use_goal, gl, wl)
    right = torch.where(use_goal, gr, wr)
    left, right = C.clamp_wheels(left, right)

    # 4. Act.
    dl, dr = R.wheel_arcs_from_speeds(left, right, cfg.tick_dt, cfg.motion)
    rb = R.step_dynamics(state.robot, dl, dr, cfg.motion)

    new_state = ClosedLoopState(robot=rb, filt=filt, wanderer=wst,
                                wanderer_on=wanderer_on, wp_idx=wp_idx,
                                gen=state.gen)
    out2 = ClosedLoopOutput(
        true_pose=rb.pose, est_pose=est, confidence=out.confidence,
        wp_idx=wp_idx, wheel_cmd=torch.stack([left, right], dim=-1))
    return new_state, out2


def init_closed_loop(m: MazeMap, cfg: FilterConfig,
                     start_pose=(1.25, 1.25, 0.0), known_start: bool = False,
                     seed: int = 0,
                     batch: Optional[int] = None) -> ClosedLoopState:
    """The robot at `start_pose`, the filter from a global uniform cloud,
    or, with `known_start`, TRACKING at start_pose
    (mcl.init_tracking_state) — the post-SLAM deployment mode, with the
    wanderer off since the filter is born confident.  The simulator and
    the filter draw from two seeds derived from `seed`; `batch` episodes
    start from one pose."""
    dev = m.device
    sim_seed, filter_seed = (
        int(v) for v in np.random.SeedSequence(seed).generate_state(2))
    filt = (mcl.init_tracking_state(m, cfg, start_pose, filter_seed,
                                    batch=batch)
            if known_start else mcl.init_state(m, cfg, filter_seed, batch))
    b = filt.batch
    gen = torch.Generator(device=dev)
    gen.manual_seed(sim_seed)
    return ClosedLoopState(
        robot=R.make_robot(*start_pose, batch=batch, device=dev),
        filt=filt, wanderer=C.wanderer_init(b, dev),
        wanderer_on=torch.full(b, not known_start, dtype=torch.bool,
                               device=dev),
        wp_idx=torch.zeros(b, dtype=torch.int32, device=dev), gen=gen)


def _tick(carry: ClosedLoopState, x: dict, consts: dict, m: MazeMap,
          cfg: FilterConfig, sense_m: Optional[MazeMap], **kw):
    """closed_loop_step on a tick's inputs: `x` holds the tick's index
    and, where given, its draws; consts the beam table and waypoints."""
    return closed_loop_step(carry, consts["waypoints"], m, cfg,
                            consts["angles"], sense_m=sense_m,
                            draws=x.get("draws"), **kw)


def rollout(state: ClosedLoopState, waypoints, m: MazeMap, cfg: FilterConfig,
            num_ticks: int, scan_angles,
            draws: Optional[Sequence[tuple]] = None,
            sense_m: Optional[MazeMap] = None,
            **kw) -> Tuple[ClosedLoopState, ClosedLoopOutput]:
    """`num_ticks` closed-loop ticks from `state` (the JAX package's
    lax.scan over closed_loop_step): graphs of compiled.TICKS_PER_GRAPH
    ticks, one replay each on CUDA, the last graph taking the remainder.
    `draws` holds one closed_loop_step draws pair a tick; `kw` are
    closed_loop_step's settings.  Returns the final state and the outputs
    stacked over ticks ([..., T, ...]), both the caller's own tensors."""
    dev = m.device
    lead = len(state.batch)
    consts = dict(
        angles=torch.as_tensor(scan_angles, dtype=torch.float32, device=dev),
        waypoints=torch.as_tensor(waypoints, dtype=torch.float32,
                                  device=dev))
    carry = [state]

    def chunk(t0: int, n: int):
        # The tick's index is the slab's one input when no draws are given.
        xs = dict(tick=torch.arange(t0, t0 + n, dtype=torch.int32,
                                    device=dev).expand(state.batch + (n,)))
        if draws is not None:
            xs["draws"] = compiled.stack_ticks(draws[t0:t0 + n], lead)
        graph = compiled.cached(None, _tick, carry[0], xs, consts, lead,
                                m=m, cfg=cfg, sense_m=sense_m, **kw)
        carry[0], ys = graph(carry[0], xs, consts)
        return ys

    outs = compiled.run_chunked(chunk, num_ticks, lead)
    return compiled.detach_state(carry[0]), outs


def run_closed_loop(
    m: MazeMap, cfg: FilterConfig, waypoints, num_ticks: int, scan_angles,
    start_pose=(1.25, 1.25, 0.0), known_start: bool = False, seed: int = 0,
    batch: Optional[int] = None, **kw,
) -> Tuple[ClosedLoopState, ClosedLoopOutput]:
    """A full closed-loop episode, or `batch` of them from one start
    (init_closed_loop, then rollout; `kw` are closed_loop_step's
    settings)."""
    state = init_closed_loop(m, cfg, start_pose, known_start, seed, batch)
    return rollout(state, waypoints, m, cfg, num_ticks, scan_angles, **kw)


def mission_waypoints(plan_cells, cell_meters: float = 0.8) -> np.ndarray:
    """Cell path -> world waypoint array (x from col, y from row).

    Thin wrapper over planning/executor.waypoint_targets so the cell-center
    convention lives in one place."""
    from ..planning import executor

    return np.asarray(executor.waypoint_targets(plan_cells, cell_meters),
                      dtype=np.float32)
