"""The closed loop in plain torch: a batch of robots, each driven by the
filter that localises it, through a plan of waypoints.

One tick of E episodes, in the order of the port's closed-loop tick:

  1. the LIDAR: each beam cast from the true pose by the configured
     caster (reference/caster.cast), plus scan_noise x a standard normal
     from the simulator's generator, clamped to [0, max_range]; every beam
     valid;
  2. the reference filter tick (reference/filter.tick) on that scan, the
     robot's encoders and the filter's own generator;
  3. the behaviour: the wanderer latched on by the filter's start command
     and off by its stop command; the waypoint index advanced where the
     published estimate is valid and within arrival_tol of the waypoint
     in x and in y (moveToPosition_server.cpp:581); the P-drive to the
     next waypoint on the estimate (goToTargetGlobal,
     moveToPosition_server.cpp:529-554: heading gain 7.0, the linear
     speed base_speed x max(cos(heading error), 0), both zero within 0.1
     m); the wanderer's tick on the scan (wanderer_try_final.cpp:167-245);
     the P-drive's command where the estimate is valid, the wanderer is
     off and a waypoint is left, else the wanderer's; each wheel clamped
     to +-100 (PID_drive.cpp:66-90);
  4. the wheel speeds as arcs (omega x dt x wheel_size / 2), the true
     pose moved by the midpoint diff drive, the encoders advanced by the
     arcs.

A pass starts every robot at the centre of the plan's first cell,
heading 0, with the filter's uniform cloud, the wanderer on and the first
driven waypoint the plan's second cell (`plan`: a breadth-first search
over the maze file's cells, as moveToPosition_server.cpp:185-264 builds
its graph).  The simulator's and the filter's generators are seeded from
the pass's seed (`init`).

Departures from the published description (BASELINE config 5, the ROS
nodes it runs):

  - the five ROS processes (sensors, monte_carlo, moveToPosition_server,
    the drives, diff_drive) are one synchronous tick: the controller acts
    on this tick's published estimate, which is the filter's previous best
    pose, and the robot moves once a tick;
  - the simulated LIDAR casts with the filter's own caster, not the
    physical scanner's geometry, and its only fault is Gaussian range
    noise; the encoders record the arcs exactly (no slip);
  - the wanderer's blocking timed rotation is a countdown of
    ceil(turn_angle / (omega x dt)) ticks, computed in float32;
  - the plan's waypoints are its cells' centres after the first, with no
    path simplification and no final alignment.

`follow` runs these ticks along another loop's published path, one step
at a time (the check, compare.py): each tick starts from that loop's
previous true pose and waypoint index, acts on its published estimate and
moves by its published command, so that each stage is judged on the
inputs the program gave it: on the card a free-running reference splits
from the program within a segment, as K3 rounds the estimate otherwise
than the reference's sums and the P-drive, the pose and the march carry
the difference on (PERF.md).  The filter, the encoders, the wanderer's
latch and its countdown run on as the reference's own.

Floating point: float32 throughout, in the port's order of operations,
with the constant divisions taken as products with float32 reciprocals.
`dtype` runs the filter's move and beam weights, the P-drive and the diff
drive in another precision (the control: bfloat16).
"""
from __future__ import annotations

import collections
import dataclasses
import math

import numpy as np
import torch

from . import caster
from . import filter as ref
from .caster import recip
from .maze import BOTTOM, LEFT, RIGHT, TOP, Maze

# The drive's constants (goToTargetGlobal), and the wheels' clamp.
P_GAIN = 7.0
STOP_DIST = 0.1
WHEEL_LIMIT = 100.0
# The plan's moves, in the order the search tries them: (wall, dr, dc).
MOVES = ((RIGHT, 0, 1), (TOP, -1, 0), (LEFT, 0, -1), (BOTTOM, 1, 0))


@dataclasses.dataclass
class State:
    """A batch of closed-loop episodes: the filters, the robots (x, y,
    theta, encoder_left, encoder_right, [E, 5]), the wanderer's countdown
    and turn side (int32 [E]), its latch (bool [E]) and the waypoint index
    (int32 [E])."""

    filt: ref.State
    robot: torch.Tensor
    turn_ticks_left: torch.Tensor
    turn_dir: torch.Tensor
    wanderer_on: torch.Tensor
    wp_idx: torch.Tensor


@dataclasses.dataclass
class Output:
    """One tick's numbers, [E, ...]: the true pose after the move, the
    filter's published pose (the estimate), the confidence, the waypoint
    index after the arrival test, the clamped wheel commands [E, 2], and
    the filter's Output."""

    true_pose: torch.Tensor
    est_pose: torch.Tensor
    confidence: torch.Tensor
    wp_idx: torch.Tensor
    wheel_cmd: torch.Tensor
    filt: ref.Output


def plan(cells: list, start, goal) -> list:
    """The shortest cell path [(row, col), ...] from `start` to `goal`,
    both included, over a maze file's cells (maze.parse): a move leaves a
    cell where the cell lists no wall on that side and stays on the
    lattice; a short row's missing cells have every wall.  [] where the
    goal cannot be reached."""
    rows = len(cells)
    cols = max(len(r) for r in cells)

    def walls(r, c):
        return cells[r][c] if c < len(cells[r]) else (RIGHT, TOP, LEFT,
                                                      BOTTOM)

    start, goal = tuple(start), tuple(goal)
    if not all(0 <= r < rows and 0 <= c < cols for r, c in (start, goal)):
        return []
    parent = {start: None}
    queue = collections.deque([start])
    while queue:
        cur = queue.popleft()
        if cur == goal:
            break
        r, c = cur
        for wall, dr, dc in MOVES:
            nxt = (r + dr, c + dc)
            if (wall in walls(r, c) or not 0 <= nxt[0] < rows
                    or not 0 <= nxt[1] < cols or nxt in parent):
                continue
            parent[nxt] = cur
            queue.append(nxt)
    if goal not in parent:
        return []
    path = [goal]
    while parent[path[-1]] is not None:
        path.append(parent[path[-1]])
    return path[::-1]


def waypoints(path: list, cell_meters: float):
    """(start pose (x, y, 0.0) at the first cell's centre, the driven
    waypoints [n, 2] float32: the later cells' centres, or the one cell's
    where the path has one)."""
    centres = np.array([(c * cell_meters + 0.5 * cell_meters,
                         r * cell_meters + 0.5 * cell_meters)
                        for r, c in path], dtype=np.float32)
    start = (float(centres[0, 0]), float(centres[0, 1]), 0.0)
    driven = centres[1:] if len(centres) > 1 else centres
    return start, torch.from_numpy(driven)


def seeds(seed: int) -> tuple:
    """(the simulator's seed, the filter's seed) of a pass's seed."""
    sim, filt = np.random.SeedSequence(int(seed)).generate_state(2)
    return int(sim), int(filt)


def init(mz: Maze, cfg: dict, seed: int, episodes: int,
         start_pose) -> tuple:
    """(State, simulator's generator, filter's generator) of `episodes`
    robots at start_pose, each filter from the uniform cloud (known_start
    false), the wanderer on."""
    dev = mz.device
    sim_seed, filter_seed = seeds(seed)
    filt, fgen = ref.init(mz, cfg, filter_seed, episodes)
    sgen = torch.Generator(device=dev)
    sgen.manual_seed(sim_seed)
    e = (episodes,)
    robot = torch.tensor([float(v) for v in start_pose] + [0.0, 0.0],
                         dtype=torch.float32, device=dev).expand(
                             e + (5,)).clone()
    st = State(filt=filt, robot=robot,
               turn_ticks_left=torch.zeros(e, dtype=torch.int32,
                                           device=dev),
               turn_dir=torch.ones(e, dtype=torch.int32, device=dev),
               wanderer_on=torch.ones(e, dtype=torch.bool, device=dev),
               wp_idx=torch.zeros(e, dtype=torch.int32, device=dev))
    return st, sgen, fgen


def scan(mz: Maze, pose, angles, sensor: dict, noise_sigma: float, noise):
    """Ranges [E, B] seen from the true poses [E, 3] with the noise's
    standard normals [E, B]."""
    x, y, th = pose[:, 0], pose[:, 1], pose[:, 2]
    off = sensor["laser_offset"]
    sign = -1.0 if sensor["negate_beam_angle"] else 1.0
    expected = caster.cast(mz, (x + off * torch.cos(th))[:, None],
                           (y + off * torch.sin(th))[:, None],
                           th[:, None] + sign * angles, sensor)
    return torch.clamp(expected + noise_sigma * noise, 0.0,
                       sensor["max_range"])


def wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def p_drive(pose, target, base_speed: float):
    """goToTargetGlobal: (left, right) wheel speeds [E] toward target
    [E, 2] from pose [E, 3]."""
    dx = target[:, 0] - pose[:, 0]
    dy = target[:, 1] - pose[:, 1]
    err = wrap(torch.atan2(dy, dx) - pose[:, 2])
    stop = torch.hypot(dx, dy) < STOP_DIST
    omega = torch.where(stop, 0.0, P_GAIN * err)
    linear = torch.where(stop, 0.0, base_speed * torch.clamp(torch.cos(err),
                                                             min=0.0))
    return linear + omega, linear - omega


def turn_ticks(w: dict, dt: float) -> int:
    """The ticks of one timed rotation (calculate_rotate_time)."""
    omega = w["turn_speed"] * (w["wheel_size"] / 2.0) / (
        w["wheel_space"] / 2.0)
    return int(math.ceil(np.float32(w["turn_angle"] / (omega * dt))))


def wanderer(st: State, ranges, enabled, w: dict, dt: float):
    """The wanderer's tick on ranges [E, B] (every beam valid): (its
    countdown, its turn side, (left, right))."""
    # Each side summed over every lane, the other side's as zeros: the
    # order the port sums in, so that a near tie turns the same way.
    lane = torch.arange(ranges.shape[-1], device=ranges.device)
    half = ranges.shape[-1] // 2
    side1 = torch.sum(torch.where(lane < half, ranges, 0.0), dim=-1)
    side2 = torch.sum(torch.where(lane >= half, ranges, 0.0), dim=-1)
    start_turn = ((torch.amin(ranges, dim=-1) <= w["threshold"])
                  & (st.turn_ticks_left == 0))
    turn_dir = torch.where(start_turn, torch.where(side1 >= side2, 1, -1)
                           .to(torch.int32), st.turn_dir)
    ticks = torch.where(start_turn, turn_ticks(w, dt), st.turn_ticks_left)
    turning = ticks > 0
    left = torch.where(turning, w["turn_speed"] * turn_dir,
                       w["forward_speed"])
    right = torch.where(turning, -w["turn_speed"] * turn_dir,
                        w["forward_speed"])
    left = torch.where(enabled, left, 0.0)
    right = torch.where(enabled, right, 0.0)
    ticks = torch.where(enabled, torch.clamp(ticks - 1, min=0), ticks)
    return ticks, turn_dir, (left, right)


def _at(wps, idx):
    """wps[clamp(idx)], [E, 2]."""
    return wps[torch.clamp(idx, 0, wps.shape[0] - 1).long()]


def tick(st: State, wps, noise, draws: dict, angles, mz: Maze, cfg: dict,
         cl: dict, dtype=torch.float32, given=None):
    """One closed-loop tick of every episode: waypoints [n, 2], the scan's
    normals [E, B], the filter's draws (ref.draw_tick); returns (State,
    Output).  `given` (`follow`'s) holds another loop's published
    estimate `est` [E, 3] and wheel command `cmd` [E, 2] of this tick: the
    controller then acts on that estimate, and the robot moves by that
    command, while the Output's are this tick's own."""
    sensor, mc = cfg["sensor"], cfg["motion"]
    dt = cfg["tick_dt"]
    ranges = scan(mz, st.robot[:, :3], angles, sensor, cl["scan_noise"],
                  noise)
    mask = torch.ones(ranges.shape, dtype=torch.bool, device=ranges.device)
    filt, fo = ref.tick(st.filt, st.robot[:, 3:], ranges, mask, angles, mz,
                        cfg, draws, dtype)
    wanderer_on = torch.where(
        fo.wanderer_cmd == ref.WANDERER_START, True,
        torch.where(fo.wanderer_cmd == ref.WANDERER_STOP, False,
                    st.wanderer_on))
    n_wp = wps.shape[0]
    wp = _at(wps, st.wp_idx)
    est = fo.exact_pose if given is None else given["est"]
    est_valid = est[:, 0] >= 0
    tol = cl["arrival_tol"]
    arrived = (est_valid & (torch.abs(est[:, 0] - wp[:, 0]) <= tol)
               & (torch.abs(est[:, 1] - wp[:, 1]) <= tol))
    wp_idx = torch.where(arrived, torch.clamp(st.wp_idx + 1, max=n_wp),
                         st.wp_idx)
    gl, gr = (v.to(torch.float32) for v in p_drive(
        est.to(dtype), _at(wps, wp_idx).to(dtype), cl["base_speed"]))
    ticks, turn_dir, (wl, wr) = wanderer(st, ranges, wanderer_on,
                                         cl["wanderer"], dt)
    use_goal = est_valid & ~wanderer_on & (wp_idx < n_wp)
    left = torch.clamp(torch.where(use_goal, gl, wl), -WHEEL_LIMIT,
                       WHEEL_LIMIT)
    right = torch.clamp(torch.where(use_goal, gr, wr), -WHEEL_LIMIT,
                        WHEEL_LIMIT)
    k = dt * mc["wheel_size"] * 0.5
    if given is None:
        d_left, d_right = left * k, right * k
    else:
        d_left, d_right = given["cmd"][:, 0] * k, given["cmd"][:, 1] * k
    x, y, th, enc_l, enc_r = st.robot.to(dtype).unbind(-1)
    d_left, d_right = d_left.to(dtype), d_right.to(dtype)
    d_center = 0.5 * (d_left + d_right)
    d_theta = (d_left - d_right) * recip(mc["wheel_space"])
    x = x + d_center * torch.cos(th + 0.5 * d_theta)
    y = y + d_center * torch.sin(th + 0.5 * d_theta)
    th = wrap(th + d_theta)
    inv_tick = recip(mc["wheel_size"] * 0.5)
    robot = torch.stack([x, y, th, enc_l + d_left * inv_tick,
                         enc_r + d_right * inv_tick], dim=-1).to(
                             torch.float32)
    new = State(filt=filt, robot=robot, turn_ticks_left=ticks,
                turn_dir=turn_dir, wanderer_on=wanderer_on, wp_idx=wp_idx)
    return new, Output(true_pose=robot[:, :3], est_pose=fo.exact_pose,
                       confidence=fo.confidence, wp_idx=wp_idx,
                       wheel_cmd=torch.stack([left, right], dim=-1),
                       filt=fo)


def run(st: State, sim_gen, filt_gen, wps, ticks: int, angles, mz: Maze,
        cfg: dict, cl: dict, dtype=torch.float32):
    """`ticks` ticks, each drawing its scan's normals from sim_gen and the
    filter's draws from filt_gen; returns (State, [Output a tick])."""
    e = st.robot.shape[0]
    shape = (e, angles.shape[0])
    outs = []
    for _ in range(ticks):
        noise = torch.randn(shape, generator=sim_gen, device=mz.device)
        d = ref.draw_tick(filt_gen, mz, cfg, e)
        st, o = tick(st, wps, noise, d, angles, mz, cfg, cl, dtype)
        outs.append(o)
    return st, outs


def follow(st: State, sim_gen, filt_gen, wps, path: dict, angles,
           mz: Maze, cfg: dict, cl: dict):
    """The ticks of another loop's path, one step at a time: `path` holds
    its published true poses [E, T, 3], estimates [E, T, 3], waypoint
    indices [E, T] and wheel commands [E, T, 2].  Each tick starts from
    the previous tick's published true pose and waypoint index (the
    first from `st`), its controller acts on the tick's published
    estimate, and the robot moves by the tick's published command; the
    filter, the encoders (moved by the published commands), the
    wanderer's latch and its countdown carry on as this module's own.
    Each Output is what this tick gives from there.  Returns (State,
    [Output a tick])."""
    e = st.robot.shape[0]
    shape = (e, angles.shape[0])
    outs = []
    for t in range(path["true_pose"].shape[1]):
        if t:
            st = dataclasses.replace(
                st, robot=torch.cat([path["true_pose"][:, t - 1],
                                     st.robot[:, 3:]], dim=-1),
                wp_idx=path["wp_idx"][:, t - 1])
        noise = torch.randn(shape, generator=sim_gen, device=mz.device)
        d = ref.draw_tick(filt_gen, mz, cfg, e)
        st, o = tick(st, wps, noise, d, angles, mz, cfg, cl,
                     given=dict(est=path["est_pose"][:, t],
                                cmd=path["wheel_cmd"][:, t]))
        outs.append(o)
    return st, outs


def to(st: State, device) -> State:
    """st with every tensor on `device`."""
    return State(filt=ref.State(**{k: v.to(device)
                                   for k, v in vars(st.filt).items()}),
                 **{k: v.to(device) for k, v in vars(st).items()
                    if k != "filt"})


def from_program(st) -> State:
    """A reference State from a program's closed-loop state (its field
    names: filt (a filter state), robot.{x, y, theta, encoder_left,
    encoder_right}, wanderer.{turn_ticks_left, turn_dir}, wanderer_on,
    wp_idx)."""
    r, w = st.robot, st.wanderer
    return State(filt=ref.from_program(st.filt),
                 robot=torch.stack([r.x, r.y, r.theta, r.encoder_left,
                                    r.encoder_right], dim=-1).detach(),
                 turn_ticks_left=w.turn_ticks_left.detach(),
                 turn_dir=w.turn_dir.detach(),
                 wanderer_on=st.wanderer_on.detach(),
                 wp_idx=st.wp_idx.detach())
