"""Online serving: the reference's live filter loop as a JSONL stream.

Torch counterpart of MCLServer in montecarlolocalisation_tpu/io/server.py
(server.py:54-333).  The filter state lives on the map's device and each
sensor line runs one `mcl_step`, with one host-to-device copy for the
frame and one device-to-host copy for the reply.  As the JAX server jits
its tick (server.py:121, the KLD target riding the same program,
:113-119), the tick runs as one replay of a CUDA graph
(models/compiled): one graph a particle count, which holds the tick, the
KLD target and the packing of the reply's numbers, and one a resize
between two counts (:122).  The frame is copied into the graph's static
frame buffer; a reset, a restore or a resize hands the next tick a new
state, which the graph copies into its buffers.

Protocol, one JSON object per line in and out:

  Sensor tick, pre-filtered (ranges aligned to the server's beam table):
    {"encoder_left": rad, "encoder_right": rad, "ranges": [...],
     "mask": [...]?}
  Sensor tick, raw LaserScan (filterLaserReadings on the host):
    {"encoder_left": rad, "encoder_right": rad,
     "raw_scan": {"ranges": [...], "angle_min": a, "angle_increment": d,
                  "range_min": lo?, "range_max": hi?}}
  -> {"tick": i, "exact_pose": [x, y, th], "theta_quaternion": q,
      "cell_pose": [row, col, o], "confidence": c, "song": s,
      "wanderer_cmd": w, "n_injected": k,
      "particles": n (with adapt), "kld_target": t (adapt_mode "kld")}
     (the poses are the PREVIOUS tick's estimate: the reference publishes,
      then updates, monte_carlo.cpp:1082-1083; "particles" is the count
      the tick ran with.)

  Commands:
    {"cmd": "reset", "seed": n?}            -> {"ok": true}
    {"cmd": "checkpoint", "path": "..."}    -> {"ok": true}
    {"cmd": "restore", "path": "..."}       -> {"ok": true}
    {"cmd": "stats"}                        -> {"tick": i, "confidence": c}
    {"cmd": "shutdown"}                     -> {"ok": true} and the loop
                                               exits

A checkpoint (io/logs.save_state) holds the filter state with its
generator, the tick count and the adapt policy's counter, so a restored
server repeats the replies of the uninterrupted session exactly.  A line
that is not JSON, misses keys or fails gets an {"error": ...} reply and the
session goes on.

`SLAMServer` (server.py:336-523) serves robots without a map: the same
frames, one SLAM tick (models/slam) a frame, replies
{"tick", "pose", "best_pose", "ess", "mapped"} (with replicas also
"replica" and "log_evidence"), and the command
{"cmd": "export_map", "path": p}, which writes the learned map.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from typing import IO, Iterable, Optional

import numpy as np
import torch

from ..config import FilterConfig, KLDConfig
from ..maps.grid import MazeMap
from ..models import compiled
from ..models import filter as mcl
from ..models import kld as kldmod
from ..models import resample, sensor
from ..utils.angles import yaw_to_quaternion_z
from . import logs


def raw_to_beams(raw: dict, cfg: FilterConfig, nb: int):
    """A raw LaserScan dict -> (ranges [nb], mask [nb]) on the server's beam
    table (sensor.filter_scan, padded to nb lanes).  The surviving beams'
    angles can drift from the table (a dropped beam shifts the comb); the
    filter evaluates at the table, as the JAX server does
    (server.py:237-250)."""
    _, radii, mask = sensor.filter_scan(
        np.asarray(raw["ranges"], np.float64), float(raw["angle_min"]),
        float(raw["angle_increment"]), float(raw.get("range_min", 0.0)),
        float(raw.get("range_max", cfg.sensor.max_range)), cfg.sensor,
        pad_to=nb)
    return radii, mask


def _serve_tick(state: mcl.MCLState, x: dict, consts, m: MazeMap,
                cfg: FilterConfig, angles, kld: Optional[KLDConfig]):
    """One server tick on a frame [2 + 2B] (the encoders, the ranges and
    the mask): (new state, the reply's numbers [10], with the KLD target
    [11])."""
    frame = x["frame"]
    nb = angles.shape[0]
    scan = sensor.Scan(angles=angles, ranges=frame[2:2 + nb],
                       mask=frame[2 + nb:] > 0.5)
    state, o = mcl.mcl_step(state, frame[0], frame[1], scan, m, cfg)
    extra = ([] if kld is None else
             [kldmod.particle_target(state.particles, m, kld).to(
                 torch.float32)])
    return state, torch.cat([o.exact_pose, o.cell_pose.to(torch.float32),
                             torch.stack([o.confidence,
                                          o.song.to(torch.float32),
                                          o.wanderer_cmd.to(torch.float32),
                                          o.n_injected.to(torch.float32),
                                          *extra])])


def _resize_tick(carry: dict, x: dict, consts, n_new: int):
    """The elastic budget's redraw of the posterior x["particles"] [N, 3],
    x["weights"] [N] at n_new particles, its offset drawn from
    carry["gen"]."""
    u0 = resample.draw_resize(carry["gen"], x["particles"].device)
    parts, w = resample.resize_particles(x["particles"], x["weights"],
                                         n_new, u0)
    return carry, dict(particles=parts, weights=w)


class MCLServer:
    """A live filter: device-resident state, one tick per sensor frame.
    The beam table is fixed at construction, as the reference fixes its
    LIDAR; raw scans are filtered onto it.

    `adapt=(n_min, n_max)` is the elastic particle budget (no reference
    counterpart; its N = 1500 is a constant, monte_carlo.cpp:84): in
    "patience" mode the count halves after every `adapt_patience`
    consecutive confident ticks, down to n_min; in "kld" mode every tick
    also computes Fox's KLD-sampling count (models/kld, `kld`), and the
    budget snaps to the smallest halving of n_max that covers it, growing
    at once and shrinking one halving after `adapt_patience` agreeing
    ticks.  In both modes the lost song snaps it back to n_max.  A resize
    is a systematic redraw of the current posterior
    (resample.resize_particles) with an offset from the state's
    generator.

    `state` is a copy of the filter state: the live one is the graphs'
    buffers, which the next tick overwrites."""

    def __init__(self, m: MazeMap, cfg: FilterConfig, angles, seed: int = 0,
                 adapt=None, adapt_patience: int = 20,
                 adapt_mode: str = "patience",
                 kld: Optional[KLDConfig] = None):
        self.m = m
        self.cfg = cfg
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = torch.as_tensor(self.angles, device=m.device)
        self.tick_count = 0
        self.adapt = None if adapt is None else (int(adapt[0]),
                                                 int(adapt[1]))
        if self.adapt is not None and not 1 <= self.adapt[0] <= self.adapt[1]:
            raise ValueError("adapt=(n_min, n_max) needs 1 <= n_min <= "
                             "n_max")
        if adapt_mode not in ("patience", "kld"):
            raise ValueError(f"unknown adapt_mode {adapt_mode!r}")
        self.adapt_patience = adapt_patience
        self.adapt_mode = adapt_mode
        self.kld = kld or KLDConfig()
        self._kld_on = self.adapt is not None and adapt_mode == "kld"
        self._confident_run = 0
        self._graphs = compiled.GraphCache()
        self._frames = compiled.HostFrames((2 + 2 * len(self.angles),),
                                           m.device)
        # _serve_tick's static arguments.
        self._tick_args = dict(m=m, cfg=cfg, angles=self._angles_dev,
                               kld=self.kld if self._kld_on else None)
        self.reset(seed)

    @property
    def state(self) -> mcl.MCLState:
        return compiled.detach_state(self._state)

    @state.setter
    def state(self, state: mcl.MCLState) -> None:
        self._state = state

    @property
    def num_particles(self) -> int:
        return int(self._state.particles.shape[0])

    # -- the elastic budget --------------------------------------------------

    def _set_particle_count(self, n_new: int) -> None:
        """Redraw the live posterior at n_new particles."""
        if n_new == self.num_particles:
            return
        parts, w = self._resize(n_new)
        self._state = dataclasses.replace(self._state, particles=parts,
                                          weights=w)

    def _resize(self, n_new: int):
        """The resize graph from this count to n_new: (particles, weights),
        copies the server keeps."""
        st = self._state
        carry = dict(gen=st.gen)
        xs = dict(particles=st.particles[None], weights=st.weights[None])
        graph = compiled.cached(self._graphs, _resize_tick, carry, xs, None,
                                0, n_new=n_new)
        _, ys = graph(carry, xs)
        return ys["particles"][0].clone(), ys["weights"][0].clone()

    def _run_tick(self, frame: torch.Tensor) -> torch.Tensor:
        """One tick on the host frame [2 + 2B] through the graph of this
        particle count: the reply's numbers, on the device."""
        xs = dict(frame=frame[None])
        graph = compiled.cached(self._graphs, _serve_tick, self._state, xs,
                                None, 0, **self._tick_args)
        self._state, ys = graph(self._state, xs)
        return ys[0]

    def _lattice_size(self, target: float) -> int:
        """The smallest halving of n_max that covers `target`, clamped to
        the adapt bounds (server.py:149-157)."""
        n_min, n_max = self.adapt
        t = min(max(target, float(n_min)), float(n_max))
        size = n_max
        while size // 2 >= t and size // 2 >= n_min:
            size //= 2
        return size

    def _maybe_adapt(self, out: dict, kld_target: float = 0.0) -> None:
        """The adapt policy after a tick's reply (server.py:159-190)."""
        if self.adapt is None:
            return
        n_min, n_max = self.adapt
        n = self.num_particles
        if out["song"] == self.cfg.hysteresis.song_lost:
            # Lost (the kidnap detector): full budget to re-localize.
            self._confident_run = 0
            if n < n_max:
                self._set_particle_count(n_max)
            return
        if self.adapt_mode == "kld":
            want = self._lattice_size(kld_target)
            if want > n:
                self._confident_run = 0
                self._set_particle_count(want)
            elif want < n:
                # One halving after adapt_patience agreeing ticks: no
                # flapping on bin-count noise.
                self._confident_run += 1
                if self._confident_run >= self.adapt_patience:
                    self._set_particle_count(n // 2)
                    self._confident_run = 0
            else:
                self._confident_run = 0
            return
        confident = (out["confidence"]
                     >= self.cfg.hysteresis.conf_confident_threshold)
        self._confident_run = self._confident_run + 1 if confident else 0
        if self._confident_run >= self.adapt_patience and n > n_min:
            self._set_particle_count(max(n // 2, n_min))
            self._confident_run = 0

    # -- lifecycle -----------------------------------------------------------

    def reset(self, seed: int = 0) -> None:
        self._state = mcl.init_state(self.m, self.cfg, seed)
        self.tick_count = 0
        self._confident_run = 0
        if self.adapt is not None:
            # Global localization starts at the full budget.
            self._set_particle_count(self.adapt[1])

    def checkpoint(self, path: str) -> None:
        logs.save_state(path, self._state, dict(
            tick=self.tick_count, confident_run=self._confident_run))

    def restore(self, path: str) -> None:
        state, extra = logs.load_state(path, self.m.device)
        if state.batch:
            raise ValueError("the checkpoint holds a batch of filters")
        self._state = state
        self.tick_count = int(extra.get("tick", self.tick_count))
        self._confident_run = int(extra.get("confident_run", 0))

    # -- ticks ---------------------------------------------------------------

    def tick(self, encoder_left: float, encoder_right: float, ranges,
             mask=None) -> dict:
        """One filter update from a PRE-FILTERED scan on the beam table."""
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != self.angles.shape:
            raise ValueError(
                f"ranges has shape {ranges.shape}, beam table has "
                f"{self.angles.shape}: pass a raw_scan or match the table")
        mask = (np.ones(self.angles.shape, bool) if mask is None
                else np.asarray(mask, np.float32) > 0.5)
        # One host->device copy for the frame, into the graph's buffer.
        nb = len(self.angles)
        frame = self._frames.take()
        f = frame.numpy()
        f[:2] = (encoder_left, encoder_right)
        f[2:2 + nb] = ranges
        f[2 + nb:] = mask
        n_used = self.num_particles
        reply = self._run_tick(frame)
        self._frames.sent()
        self.tick_count += 1
        d, tgt = self._out_dict(reply)
        if self.adapt is not None:
            d["particles"] = n_used
        if self._kld_on:
            d["kld_target"] = round(tgt, 1)
        self._maybe_adapt(d, kld_target=tgt)
        return d

    def tick_raw(self, encoder_left: float, encoder_right: float,
                 raw: dict) -> dict:
        """One filter update from a raw LaserScan message dict."""
        radii, mask = raw_to_beams(raw, self.cfg, len(self.angles))
        return self.tick(encoder_left, encoder_right, radii, mask)

    def _out_dict(self, reply: torch.Tensor):
        """(reply, KLD target or 0.0) from one device->host copy of all the
        reply's numbers, the KLD target among them (_serve_tick)."""
        v = reply.cpu().numpy().astype(np.float64)
        return dict(
            tick=self.tick_count,
            exact_pose=[round(float(x), 6) for x in v[0:3]],
            # ExactPose.thetaQuaternion analog (msg/ExactPose.msg).
            theta_quaternion=round(yaw_to_quaternion_z(float(v[2])), 6),
            cell_pose=[int(x) for x in v[3:6]],
            confidence=round(float(v[6]), 6),
            song=int(v[7]),
            wanderer_cmd=int(v[8]),
            n_injected=int(v[9]),
        ), (float(v[10]) if self._kld_on else 0.0)

    def serve(self, lines: Iterable[str],
              out_stream: Optional[IO[str]] = None) -> int:
        """Drain a JSONL stream; returns the number of sensor ticks run."""
        out_stream = out_stream or sys.stdout

        def reply(obj):
            print(json.dumps(obj), file=out_stream, flush=True)

        for line in lines:
            line = line.strip()
            if not line:
                continue
            try:
                msg = json.loads(line)
            except json.JSONDecodeError as e:
                reply(dict(error=f"bad json: {e}"))
                continue
            try:
                if "cmd" in msg:
                    if self._handle_cmd(msg, reply):
                        break
                elif "raw_scan" in msg:
                    reply(self.tick_raw(msg["encoder_left"],
                                        msg["encoder_right"],
                                        msg["raw_scan"]))
                else:
                    reply(self.tick(msg["encoder_left"],
                                    msg["encoder_right"], msg["ranges"],
                                    msg.get("mask")))
            except Exception as e:  # noqa: BLE001 — a long-lived server
                # must survive any bad line (missing keys, shape errors,
                # unreadable checkpoints): reply with the error instead of
                # dropping the session.
                reply(dict(error=f"{type(e).__name__}: {e}"))
        return self.tick_count

    def _handle_cmd(self, msg: dict, reply) -> bool:
        cmd = msg["cmd"]
        if cmd == "reset":
            self.reset(int(msg.get("seed", 0)))
        elif cmd == "checkpoint":
            self.checkpoint(msg["path"])
        elif cmd == "restore":
            self.restore(msg["path"])
        elif cmd == "stats":
            reply(dict(tick=self.tick_count,
                       confidence=round(float(self._state.confidence), 6)))
            return False
        elif cmd == "shutdown":
            reply(dict(ok=True))
            return True
        else:
            reply(dict(error=f"unknown cmd {cmd!r}"))
            return False
        reply(dict(ok=True))
        return False


def _slam_frame_tick(state, x: dict, consts, cfg, angles,
                     robot_streams: bool = False):
    """One SLAM tick on a frame [..., 2 + 2B] (each filter's encoders,
    ranges and mask): (new state, the replies' numbers [..., 9]: pose,
    best pose, ESS, mapped, log evidence).  With `robot_streams` the carry
    is dict(state=, gens=), and filter r draws from gens[r] (a fleet of
    robots, each its own stream)."""
    from ..models import slam

    gens = None
    if robot_streams:
        state, gens = state["state"], state["gens"]
    frame = x["frame"]
    nb = angles.shape[0]
    draws = None
    if gens is not None:
        per = [slam.draw_slam(g, cfg, (), frame.device) for g in gens]
        draws = slam.SLAMDraws(
            normals=torch.stack([d.normals for d in per]),
            gumbel=(None if per[0].gumbel is None
                    else torch.stack([d.gumbel for d in per])),
            u0=torch.stack([d.u0 for d in per]))
    new, info = slam.slam_step(state, frame[..., 0], frame[..., 1],
                               frame[..., 2:2 + nb], angles,
                               frame[..., 2 + nb:], cfg, draws)
    reply = torch.cat([info["pose"], info["best_pose"],
                       torch.stack([info["ess"],
                                    info["mapped"].to(torch.float32),
                                    info["log_evidence"]], dim=-1)], dim=-1)
    if gens is not None:
        new = dict(state=new, gens=gens)
    return new, reply


def export_learned(lo, cfg, path: str) -> dict:
    """Write a learned log-odds grid (host numpy) as a map_server PGM +
    YAML and return the reply: its YAML path and the fitted wall tensor
    as map.txt rows (server.py:467-483 of the JAX package)."""
    from ..models import mapping

    base = path[:-5] if path.endswith(".yaml") else path
    mapping.export_learned_map(lo, cfg.mapping, base + ".pgm",
                               base + ".yaml")
    cell_px = int(round(0.8 / cfg.mapping.resolution))
    walls = mapping.fit_walls(lo, cell_px=cell_px)
    tensor = [[[e for e in range(4) if walls[r, c, e]]
               for c in range(walls.shape[1])]
              for r in range(walls.shape[0])]
    return dict(ok=True, yaml=base + ".yaml", walls=tensor)


class SLAMServer:
    """Live SLAM for a robot without a map: a device-resident SLAMState,
    one tick a frame, each one replay of this server's CUDA graph with the
    frame copied from pinned host memory (as MCLServer's).

    `replicas` > 1: K independent filters advance on every frame as one
    [K] state, and the replies report the replica with the highest
    accumulated log evidence (slam.run_slam_replicas' live form).
    `state` is a copy of the live state, which the graph's buffers hold."""

    def __init__(self, cfg, angles, start_pose=(1.25, 1.25, 0.0),
                 seed: int = 0, replicas: int = 1, device="cuda"):
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.cfg = cfg                     # SLAMConfig
        self.device = torch.device(device)
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = torch.as_tensor(self.angles, device=self.device)
        self.start_pose = tuple(float(v) for v in start_pose)
        self.replicas = int(replicas)
        self.tick_count = 0
        self._graphs = compiled.GraphCache()
        self._frames = compiled.HostFrames((1, 2 + 2 * len(self.angles)),
                                           self.device)
        self.reset(seed)

    @property
    def state(self):
        return compiled.detach_state(self._state)

    def reset(self, seed: int = 0) -> None:
        from ..models import slam

        batch = () if self.replicas == 1 else (self.replicas,)
        self._state = slam.init_slam(seed, self.start_pose, self.cfg, batch,
                                     self.device)
        self.tick_count = 0

    def checkpoint(self, path: str) -> None:
        logs.save_tree(path, self._state, dict(tick=self.tick_count))

    def restore(self, path: str) -> None:
        self._state, extra = logs.load_tree(path, self._state, self.device)
        self.tick_count = int(extra.get("tick", self.tick_count))

    def _run_tick(self, frame: torch.Tensor) -> np.ndarray:
        xs = dict(frame=frame)
        graph = compiled.cached(self._graphs, _slam_frame_tick, self._state,
                                xs, None, 0, cfg=self.cfg,
                                angles=self._angles_dev)
        self._state, ys = graph(self._state, xs)
        return ys[0].cpu().numpy().astype(np.float64)

    def tick(self, encoder_left: float, encoder_right: float, ranges,
             mask=None) -> dict:
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != self.angles.shape:
            raise ValueError(
                f"ranges has shape {ranges.shape}, beam table has "
                f"{self.angles.shape}")
        nb = len(self.angles)
        frame = self._frames.take()
        f = frame.numpy()
        f[0, :2] = (encoder_left, encoder_right)
        f[0, 2:2 + nb] = ranges
        f[0, 2 + nb:] = 1.0 if mask is None else np.asarray(mask, np.float32)
        v = self._run_tick(frame)
        self._frames.sent()
        self.tick_count += 1
        if self.replicas > 1:
            pick = int(np.argmax(v[:, 8]))
            return dict(tick=self.tick_count,
                        pose=[round(float(x), 6) for x in v[pick, 0:3]],
                        best_pose=[round(float(x), 6)
                                   for x in v[pick, 3:6]],
                        ess=round(float(v[pick, 6]), 2),
                        mapped=bool(v[pick, 7]), replica=pick,
                        log_evidence=[round(float(e), 2) for e in v[:, 8]])
        return dict(tick=self.tick_count,
                    pose=[round(float(x), 6) for x in v[0:3]],
                    best_pose=[round(float(x), 6) for x in v[3:6]],
                    ess=round(float(v[6]), 2), mapped=bool(v[7]))

    def tick_raw(self, encoder_left: float, encoder_right: float,
                 raw: dict) -> dict:
        """One SLAM tick from a raw LaserScan message dict."""
        radii, mask = raw_to_beams(raw, self.cfg, len(self.angles))
        return self.tick(encoder_left, encoder_right, radii, mask)

    def export_map(self, path: str) -> dict:
        """Write the best particle's map (of the replica with the most
        evidence) as a map_server PGM + YAML; the reply holds the fitted
        wall tensor as map.txt rows."""
        from ..models import slam

        lo = slam.best_map(self._state)
        if self.replicas > 1:
            lo = lo[torch.argmax(self._state.log_evidence)]
        return export_learned(lo.cpu().numpy(), self.cfg, path)

    def serve(self, lines: Iterable[str],
              out_stream: Optional[IO[str]] = None) -> int:
        """Drain a JSONL stream; returns the number of frames run."""
        return _serve_loop(self, lines, out_stream or sys.stdout,
                           raw_key="raw_scan")

    def _stats(self) -> dict:
        # The state's leading size, as the JAX server replies: the
        # particles of one filter, the replicas K in replica mode.
        return dict(tick=self.tick_count,
                    particles=int(self._state.poses.shape[0]))


def _serve_loop(server, lines, out_stream, raw_key: str) -> int:
    """The SLAM servers' JSONL loop: frames, and the commands reset
    (with "robot" on a fleet), checkpoint, restore, export_map, stats and
    shutdown.  A bad line gets an {"error": ...} reply."""
    def reply(obj):
        print(json.dumps(obj), file=out_stream, flush=True)

    for line in lines:
        line = line.strip()
        if not line:
            continue
        try:
            msg = json.loads(line)
        except json.JSONDecodeError as e:
            reply(dict(error=f"bad json: {e}"))
            continue
        try:
            if "cmd" not in msg:
                if raw_key in msg:
                    reply(server.tick_raw(msg["encoder_left"],
                                          msg["encoder_right"],
                                          msg[raw_key]))
                else:
                    reply(server.tick(msg["encoder_left"],
                                      msg["encoder_right"], msg["ranges"],
                                      msg.get("mask")))
                continue
            cmd = msg["cmd"]
            if cmd == "reset":
                if "robot" in msg and hasattr(server, "reset_robot"):
                    server.reset_robot(int(msg["robot"]),
                                       int(msg.get("seed", 0)))
                else:
                    server.reset(int(msg.get("seed", 0)))
                reply(dict(ok=True))
            elif cmd == "checkpoint":
                server.checkpoint(msg["path"])
                reply(dict(ok=True))
            elif cmd == "restore":
                server.restore(msg["path"])
                reply(dict(ok=True))
            elif cmd == "export_map":
                reply(server.export_map(msg["path"]))
            elif cmd == "stats":
                reply(server._stats())
            elif cmd == "shutdown":
                reply(dict(ok=True))
                break
            else:
                reply(dict(error=f"unknown cmd {cmd!r}"))
        except Exception as e:  # noqa: BLE001 — a long-lived server must
            # survive any bad line: reply with the error instead.
            reply(dict(error=f"{type(e).__name__}: {e}"))
    return server.tick_count
