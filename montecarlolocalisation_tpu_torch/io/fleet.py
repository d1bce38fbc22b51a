"""Fleet serving: many live filters in one batched tick.

Torch counterpart of MCLFleetServer in montecarlolocalisation_tpu/io/
fleet.py (fleet.py:65-290).  R robots' filter states live on the device as
one batch ([R, N, 3] particles, [R] scalars), and every fleet frame runs
ONE batched `mcl_step`: on the card, one launch of each batched kernel for
the whole fleet.  As the JAX fleet jits its tick (fleet.py:95, :330), the
tick runs as one replay of a CUDA graph (models/compiled) that also packs
the replies' numbers; the frame is copied into its static frame buffer,
and a reset, a robot's reset or a restore hands the next tick a new state,
which the graph copies into its buffers.  `state` is a copy of the fleet's
state: the live one is the graph's buffers.

Protocol (JSONL; one fleet frame per line, arrays indexed by robot):

  {"encoder_left": [R], "encoder_right": [R], "ranges": [R][B],
   "mask": [R][B]?}
  -> {"tick": t, "exact_pose": [R][3], "theta_quaternion": [R],
      "cell_pose": [R][3], "confidence": [R], "song": [R],
      "wanderer_cmd": [R], "n_injected": [R]}

  Raw LaserScan frames (each robot's filterLaserReadings on the host):
  {"encoder_left": [R], "encoder_right": [R], "raw_scans": [R scan dicts]}

  Commands:
    {"cmd": "reset", "seed": n?}                 whole fleet
    {"cmd": "reset", "robot": i, "seed": n?}     one robot; the others are
                                                 untouched
    {"cmd": "checkpoint"|"restore", "path": p}   the fleet's state (.npz)
    {"cmd": "stats"}                             per-robot confidence
    {"cmd": "telemetry"}                         the process's counters
                                                 and the frames' spans
    {"cmd": "shutdown"}

  The telemetry reply: {"counters": {name: total}, "spans": {name:
  {"n", "p50_ms", "p99_ms"}}}, the counters of utils/profiling's
  recorder (graph builds, hits, capture and instantiation seconds, the
  kernels' launches) and each fleet span's median and 99th percentile
  (nearest rank) over the frames in the recorder's ring.

A line that is not JSON, misses keys or fails gets an {"error": ...}
reply and the session goes on.  A checkpoint (io/logs.save_state) holds
the batched state with its generator and the tick count.

Pipelined mode (`pipeline=True`): each tick enqueues this frame's step on
the card and returns the PREVIOUS tick's reply, whose outputs were copied
to pinned host memory behind an event; waiting on that event does not
wait for the tick just enqueued, so the fetch of tick t-1 overlaps the
card computing tick t.  Replies lag one tick, each carries its own "tick"
index, and `flush()` drains the tick in flight.

Spans (utils/profiling): a `serve` session is one span `fleet.serve`, and
each fleet frame one span `fleet.frame` whose id is the tick it runs,
with six children in order: `fleet.decode` (json.loads), `fleet.stage`
(the frame into the pinned HostFrames buffer), `fleet.launch` (the graph's
lookup, copy-in and replay, models/compiled's `graph.*` spans, and the
replies' copy to the host behind its event), `fleet.wait` (that event),
`fleet.reply` (the reply's rounding) and `fleet.write` (json.dumps, print,
flush).  In pipelined mode the last three answer the tick before, and
carry its id.  Command lines get no frame span.

`SLAMFleetServer` (fleet.py:293-462) serves R SLAM robots as one [R]
SLAMState, one graph replay a fleet frame; robot r draws from its own
generator, seeded seed * R + r, so it runs what a standalone SLAMServer
of that seed runs.  Replies {"tick", "pose" [R][3], "best_pose", "ess"
[R], "mapped" [R]}; `export_map` writes the robots' best maps fused by
log-odds addition.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from typing import IO, Iterable, Optional

import numpy as np
import torch

from ..config import FilterConfig
from ..maps.grid import MazeMap
from ..models import compiled
from ..models import filter as mcl
from ..models import sensor
from ..utils import profiling
from . import logs
from .server import (_serve_loop, _slam_frame_tick, export_learned,
                     raw_to_beams)

# Reply fields and their columns in the packed [R, 10] output.
_COLUMNS = dict(exact_pose=slice(0, 3), cell_pose=slice(3, 6),
                confidence=6, song=7, wanderer_cmd=8, n_injected=9)


def _fleet_tick(state: mcl.MCLState, x: dict, consts, m: MazeMap,
                cfg: FilterConfig, angles):
    """One fleet tick on a frame [R, 2 + 2B] (each robot's encoders,
    ranges and mask): (new state, the replies' numbers [R, 10])."""
    frame = x["frame"]
    nb = angles.shape[0]
    scan = sensor.Scan(angles=angles, ranges=frame[:, 2:2 + nb].contiguous(),
                       mask=frame[:, 2 + nb:] > 0.5)
    state, o = mcl.mcl_step(state, frame[:, 0], frame[:, 1], scan, m, cfg)
    return state, torch.cat([o.exact_pose, o.cell_pose.to(torch.float32),
                             torch.stack([o.confidence,
                                          o.song.to(torch.float32),
                                          o.wanderer_cmd.to(torch.float32),
                                          o.n_injected.to(torch.float32)],
                                         dim=-1)], dim=-1)


def telemetry() -> dict:
    """The `telemetry` command's reply (module docstring)."""
    spans, counters = profiling.recorded()
    ms = {}
    for s in spans:
        if s.name.startswith("fleet.") and s.name != "fleet.serve":
            ms.setdefault(s.name, []).append((s.end - s.start) * 1e-6)
    out = {}
    for name, v in sorted(ms.items()):
        p50, p99 = np.percentile(v, [50, 99], method="inverted_cdf")
        out[name] = dict(n=len(v), p50_ms=float(p50), p99_ms=float(p99))
    return dict(counters=counters, spans=out)


class MCLFleetServer:
    """R device-resident filters; one batched tick per fleet frame."""

    def __init__(self, m: MazeMap, cfg: FilterConfig, angles,
                 n_robots: int, seed: int = 0, pipeline: bool = False):
        if n_robots < 1:
            raise ValueError("n_robots must be >= 1")
        self.m = m
        self.cfg = cfg
        self.n_robots = n_robots
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = torch.as_tensor(self.angles, device=m.device)
        self.pipeline = pipeline
        self._pending = None   # (tick index, staged outputs) in flight
        # [R, 2 + 2B] f32: ONE upload per fleet tick.
        self._frames = compiled.HostFrames(
            (n_robots, 2 + 2 * len(self.angles)), m.device)
        self.tick_count = 0
        self._graphs = compiled.GraphCache()
        # _fleet_tick's static arguments.
        self._tick_args = dict(m=m, cfg=cfg, angles=self._angles_dev)
        self.reset(seed)

    @property
    def state(self) -> mcl.MCLState:
        return compiled.detach_state(self._state)

    @state.setter
    def state(self, state: mcl.MCLState) -> None:
        self._state = state

    # -- lifecycle -----------------------------------------------------------

    def reset(self, seed: int = 0) -> None:
        """Re-init the whole fleet from one generator seeded with `seed`."""
        self._pending = None
        self._state = mcl.init_state(self.m, self.cfg, seed,
                                     batch=self.n_robots)
        self.tick_count = 0

    def reset_robot(self, robot: int, seed: int = 0) -> None:
        """Re-init ONE robot's filter (redeploy/kidnap handling) from a
        generator seeded with (seed, robot); the other robots' states and
        the fleet's generator are untouched."""
        if not 0 <= robot < self.n_robots:
            raise ValueError(f"robot {robot} out of range "
                             f"[0, {self.n_robots})")
        fresh = mcl.init_state(self.m, self.cfg,
                               seed * self.n_robots + robot)

        def put(batch, one):
            if dataclasses.is_dataclass(batch):
                return type(batch)(**{
                    f.name: put(getattr(batch, f.name), getattr(one, f.name))
                    for f in dataclasses.fields(batch)})
            if not isinstance(batch, torch.Tensor):
                return batch          # the fleet's generator
            out = batch.clone()
            out[robot] = one
            return out

        self._state = put(self._state, fresh)

    def checkpoint(self, path: str) -> None:
        """The fleet's state, after the tick in flight."""
        logs.save_state(path, self._state, dict(tick=self.tick_count))

    def restore(self, path: str) -> None:
        state, extra = logs.load_state(path, self.m.device)
        if state.batch != (self.n_robots,):
            raise ValueError(f"the checkpoint holds batch {state.batch}, "
                             f"not {self.n_robots} robots")
        self._pending = None
        self._state = state
        self.tick_count = int(extra.get("tick", self.tick_count))

    # -- ticks ---------------------------------------------------------------

    def tick(self, encoder_left, encoder_right, ranges, mask=None):
        """One fleet update: every robot advances one filter tick.

        Synchronous mode returns this tick's reply.  Pipelined mode returns
        the PREVIOUS tick's reply (None on the first tick); `flush()`
        drains the tick in flight."""
        r, nb = self.n_robots, len(self.angles)
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != (r, nb):
            raise ValueError(
                f"ranges has shape {ranges.shape}; fleet expects "
                f"({r}, {nb}): one row per robot on the beam table")
        tick = self.tick_count + 1
        with profiling.span("fleet.stage", tick):
            frame = self._frames.take()
            f = frame.numpy()
            f[:, 0] = np.asarray(encoder_left, np.float32)
            f[:, 1] = np.asarray(encoder_right, np.float32)
            f[:, 2:2 + nb] = ranges
            f[:, 2 + nb:] = (1.0 if mask is None
                             else np.asarray(mask, np.float32))
        # One host->device copy for the whole fleet frame, into the graph's
        # buffer, queued behind the tick in flight.
        with profiling.span("fleet.launch", tick):
            staged = self._stage(self._run_tick(frame))
            self._frames.sent()
        self.tick_count = tick
        if not self.pipeline:
            return self._reply(self.tick_count, staged)
        prev = self.flush()
        self._pending = (self.tick_count, staged)
        return prev

    def _run_tick(self, frame: torch.Tensor) -> torch.Tensor:
        """One fleet tick on the host frame [R, 2 + 2B] through the
        graph: the replies' numbers [R, 10], on the device."""
        xs = dict(frame=frame[:, None])
        graph = compiled.cached(self._graphs, _fleet_tick, self._state, xs,
                                None, 1, **self._tick_args)
        self._state, ys = graph(self._state, xs)
        return ys[:, 0]

    def tick_raw(self, encoder_left, encoder_right, raws):
        """A fleet update from R raw LaserScan dicts, each filtered onto
        the beam table on the host (fleet.py:181-197 of the JAX
        package)."""
        if len(raws) != self.n_robots:
            raise ValueError(f"got {len(raws)} raw scans for "
                             f"{self.n_robots} robots")
        nb = len(self.angles)
        beams = [raw_to_beams(raw, self.cfg, nb) for raw in raws]
        return self.tick(encoder_left, encoder_right,
                         np.stack([b[0] for b in beams]),
                         np.stack([b[1] for b in beams]))

    def flush(self) -> Optional[dict]:
        """The reply of the tick in flight (pipelined mode); None if none."""
        if self._pending is None:
            return None
        t, staged = self._pending
        self._pending = None
        return self._reply(t, staged)

    def _stage(self, v: torch.Tensor):
        """Start the copy of the replies' numbers [R, 10] (the graph's
        output buffer) to the host; returns (host tensor, event or
        None)."""
        if not v.is_cuda:
            return v.clone(), None
        host = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
        host.copy_(v, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _reply(self, tick: int, staged) -> dict:
        host, event = staged
        with profiling.span("fleet.wait", tick):
            if event is not None:
                event.synchronize()
        with profiling.span("fleet.reply", tick):
            v = host.numpy().astype(np.float64)
            pose = v[:, _COLUMNS["exact_pose"]]

            def ints(key):
                return v[:, _COLUMNS[key]].astype(int).tolist()

            return dict(
                tick=tick,
                exact_pose=np.round(pose, 6).tolist(),
                # ExactPose.thetaQuaternion analog per robot.
                theta_quaternion=np.round(np.sin(0.5 * pose[:, 2]),
                                          6).tolist(),
                cell_pose=ints("cell_pose"),
                confidence=np.round(v[:, _COLUMNS["confidence"]],
                                    6).tolist(),
                song=ints("song"), wanderer_cmd=ints("wanderer_cmd"),
                n_injected=ints("n_injected"))

    # -- stream loop ---------------------------------------------------------

    def serve(self, lines: Iterable[str],
              out_stream: Optional[IO[str]] = None) -> int:
        """Drain a JSONL stream; returns the number of fleet ticks run.
        Records the spans of the module docstring."""
        with profiling.span("fleet.serve"):
            return self._serve(lines, out_stream or sys.stdout)

    def _serve(self, lines: Iterable[str], out_stream: IO[str]) -> int:
        def reply(obj):
            if obj is not None:
                print(json.dumps(obj), file=out_stream, flush=True)

        def write(obj):
            """A tick's reply, under the span `fleet.write`."""
            if obj is not None:
                with profiling.span("fleet.write", obj["tick"]):
                    reply(obj)

        for line in lines:
            line = line.strip()
            if not line:
                continue
            t0 = time.time_ns()
            try:
                msg = json.loads(line)
            except json.JSONDecodeError as e:
                reply(dict(error=f"bad json: {e}"))
                continue
            t1 = time.time_ns()
            try:
                if "cmd" in msg:
                    # Drain the tick in flight first, so replies stay in
                    # order across commands.
                    write(self.flush())
                    if self._handle_cmd(msg, reply):
                        return self.tick_count
                    continue
                with profiling.span("fleet.frame", self.tick_count + 1,
                                    start=t0):
                    profiling.record("fleet.decode", t0, t1)
                    if "raw_scans" in msg:
                        rep = self.tick_raw(msg["encoder_left"],
                                            msg["encoder_right"],
                                            msg["raw_scans"])
                    else:
                        rep = self.tick(msg["encoder_left"],
                                        msg["encoder_right"], msg["ranges"],
                                        msg.get("mask"))
                    write(rep)
            except Exception as e:  # noqa: BLE001 — a long-lived server
                # must survive any bad line: reply with the error instead.
                reply(dict(error=f"{type(e).__name__}: {e}"))
        write(self.flush())
        return self.tick_count

    def _handle_cmd(self, msg: dict, reply) -> bool:
        cmd = msg["cmd"]
        if cmd == "reset":
            if "robot" in msg:
                self.reset_robot(int(msg["robot"]), int(msg.get("seed", 0)))
            else:
                self.reset(int(msg.get("seed", 0)))
        elif cmd == "checkpoint":
            self.checkpoint(msg["path"])
        elif cmd == "restore":
            self.restore(msg["path"])
        elif cmd == "stats":
            reply(dict(tick=self.tick_count, n_robots=self.n_robots,
                       confidence=np.round(
                           self._state.confidence.cpu().numpy().astype(
                               np.float64), 6).tolist()))
            return False
        elif cmd == "telemetry":
            reply(telemetry())
            return False
        elif cmd == "shutdown":
            reply(dict(ok=True))
            return True
        else:
            reply(dict(error=f"unknown cmd {cmd!r}"))
            return False
        reply(dict(ok=True))
        return False


class SLAMFleetServer:
    """R live SLAM robots in one batched tick (module docstring).  The
    robots share a world frame through their known start poses, as the
    offline multi-robot mapper does; `reset_robot` redeploys one.  The
    frame is copied into the graph's input from pinned host memory, one
    buffer of two at a time, so a frame is never overwritten while the
    card may still read it."""

    def __init__(self, cfg, angles, start_poses, seed: int = 0,
                 device="cuda"):
        self.cfg = cfg                      # SLAMConfig
        self.device = torch.device(device)
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = torch.as_tensor(self.angles, device=self.device)
        self.start_poses = np.asarray(start_poses, np.float32)
        if self.start_poses.ndim != 2 or self.start_poses.shape[1] != 3:
            raise ValueError("start_poses must be [R, 3] (x, y, theta)")
        self.n_robots = self.start_poses.shape[0]
        self.tick_count = 0
        self._graphs = compiled.GraphCache()
        self._frames = compiled.HostFrames(
            (1, self.n_robots, 2 + 2 * len(self.angles)), self.device)
        self.reset(seed)

    @property
    def state(self):
        return compiled.detach_state(self._carry["state"])

    def _gen(self, seed: int, robot: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed * self.n_robots + robot)
        return gen

    def reset(self, seed: int = 0) -> None:
        """Every robot anew at its start pose; robot r's stream seeded
        seed * R + r."""
        from ..models import slam

        state = slam.init_slam(seed, self.start_poses, self.cfg,
                               (self.n_robots,), self.device)
        self._carry = dict(state=state, gens=tuple(
            self._gen(seed, r) for r in range(self.n_robots)))
        self.tick_count = 0

    def reset_robot(self, robot: int, seed: int = 0) -> None:
        """Redeploy ONE robot (its start pose, an empty map, its stream
        seeded seed * R + robot); the others are untouched."""
        from ..models import slam

        if not 0 <= robot < self.n_robots:
            raise ValueError(f"robot {robot} out of range "
                             f"[0, {self.n_robots})")
        fresh = slam.init_slam(0, self.start_poses[robot], self.cfg, (),
                               self.device)

        def put(batch, one):
            if isinstance(batch, torch.Generator):
                return batch            # the fleet state's own, unused
            out = batch.clone()
            out[robot] = one
            return out

        gens = list(self._carry["gens"])
        gens[robot] = self._gen(seed, robot)
        self._carry = dict(
            state=compiled.tree_map(put, self._carry["state"], fresh),
            gens=tuple(gens))

    def checkpoint(self, path: str) -> None:
        logs.save_tree(path, self._carry, dict(tick=self.tick_count))

    def restore(self, path: str) -> None:
        self._carry, extra = logs.load_tree(path, self._carry, self.device)
        self.tick_count = int(extra.get("tick", self.tick_count))

    def tick(self, encoder_left, encoder_right, ranges, mask=None) -> dict:
        r, nb = self.n_robots, len(self.angles)
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != (r, nb):
            raise ValueError(
                f"ranges has shape {ranges.shape}; fleet expects "
                f"({r}, {nb})")
        frame = self._frames.take()
        f = frame.numpy()[0]
        f[:, 0] = np.asarray(encoder_left, np.float32)
        f[:, 1] = np.asarray(encoder_right, np.float32)
        f[:, 2:2 + nb] = ranges
        f[:, 2 + nb:] = (1.0 if mask is None
                         else np.asarray(mask, np.float32))
        xs = dict(frame=frame)
        graph = compiled.cached(self._graphs, _slam_frame_tick, self._carry,
                                xs, None, 0, cfg=self.cfg,
                                angles=self._angles_dev,
                                robot_streams=True)
        self._carry, ys = graph(self._carry, xs)
        self._frames.sent()
        v = ys[0].cpu().numpy().astype(np.float64)
        self.tick_count += 1
        return dict(tick=self.tick_count,
                    pose=np.round(v[:, 0:3], 6).tolist(),
                    best_pose=np.round(v[:, 3:6], 6).tolist(),
                    ess=np.round(v[:, 6], 2).tolist(),
                    mapped=[bool(x) for x in v[:, 7]])

    def tick_raw(self, encoder_left, encoder_right, raws) -> dict:
        """A fleet frame from R raw LaserScan dicts."""
        if len(raws) != self.n_robots:
            raise ValueError(f"got {len(raws)} raw scans for "
                             f"{self.n_robots} robots")
        nb = len(self.angles)
        beams = [raw_to_beams(raw, self.cfg, nb) for raw in raws]
        return self.tick(encoder_left, encoder_right,
                         np.stack([b[0] for b in beams]),
                         np.stack([b[1] for b in beams]))

    def fused_logodds(self) -> np.ndarray:
        """Each robot's best-particle map, fused by log-odds addition."""
        from ..models import mapping, slam

        return mapping.fuse_maps(
            slam.best_map(self._carry["state"])).cpu().numpy()

    def export_map(self, path: str) -> dict:
        return export_learned(self.fused_logodds(), self.cfg, path)

    def serve(self, lines: Iterable[str],
              out_stream: Optional[IO[str]] = None) -> int:
        """Drain a JSONL stream; returns the number of fleet frames run."""
        return _serve_loop(self, lines, out_stream or sys.stdout,
                           raw_key="raw_scans")

    def _stats(self) -> dict:
        return dict(tick=self.tick_count, robots=self.n_robots)
