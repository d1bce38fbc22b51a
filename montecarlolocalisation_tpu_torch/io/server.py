"""Online serving: the reference's live filter loop as a JSONL stream.

Torch counterpart of the core of montecarlolocalisation_tpu/io/server.py
(MCLServer, server.py:54-333).  The filter state lives on the map's device
and each input line runs one `mcl_step`.

Protocol, one JSON object per line in and out:

  Sensor tick, pre-filtered (ranges aligned to the server's beam table):
    {"encoder_left": rad, "encoder_right": rad, "ranges": [...],
     "mask": [...]?}
  -> {"tick": i, "exact_pose": [x, y, th], "theta_quaternion": q,
      "cell_pose": [row, col, o], "confidence": c, "song": s,
      "wanderer_cmd": w, "n_injected": k}
     (the poses are the PREVIOUS tick's estimate: the reference publishes,
      then updates, monte_carlo.cpp:1082-1083.)

  Commands:
    {"cmd": "reset", "seed": n?}  -> {"ok": true}
    {"cmd": "stats"}              -> {"tick": i, "confidence": c}
    {"cmd": "shutdown"}           -> {"ok": true} and the loop exits

A line that is not JSON, misses keys or fails gets an {"error": ...}
reply and the session goes on.  Raw LaserScan frames, checkpoints and the
elastic particle budget are not ported yet.
"""
from __future__ import annotations

import json
import math
import sys
from typing import IO, Iterable, Optional

import numpy as np
import torch

from ..config import FilterConfig
from ..maps.grid import MazeMap
from ..models import filter as mcl
from ..models import sensor


class MCLServer:
    """A live filter: device-resident state, one tick per sensor frame.
    The beam table is fixed at construction, as the reference fixes its
    LIDAR."""

    def __init__(self, m: MazeMap, cfg: FilterConfig, angles, seed: int = 0):
        self.m = m
        self.cfg = cfg
        self.angles = np.asarray(angles, np.float32)
        self._angles_dev = torch.as_tensor(self.angles, device=m.device)
        self.tick_count = 0
        self.reset(seed)

    @property
    def num_particles(self) -> int:
        return int(self.state.particles.shape[0])

    def reset(self, seed: int = 0) -> None:
        self.state = mcl.init_state(self.m, self.cfg, seed)
        self.tick_count = 0

    def tick(self, encoder_left: float, encoder_right: float, ranges,
             mask=None) -> dict:
        """One filter update from a PRE-FILTERED scan on the beam table."""
        ranges = np.asarray(ranges, np.float32)
        if ranges.shape != self.angles.shape:
            raise ValueError(
                f"ranges has shape {ranges.shape}, beam table has "
                f"{self.angles.shape}")
        mask = (np.ones(self.angles.shape, bool) if mask is None
                else np.asarray(mask, np.float32) > 0.5)
        # One host->device copy for the frame.
        frame = torch.as_tensor(np.concatenate(
            [np.float32([encoder_left, encoder_right]), ranges,
             mask.astype(np.float32)]), device=self.m.device)
        nb = len(self.angles)
        scan = sensor.Scan(angles=self._angles_dev, ranges=frame[2:2 + nb],
                           mask=frame[2 + nb:] > 0.5)
        self.state, out = mcl.mcl_step(self.state, frame[0], frame[1], scan,
                                       self.m, self.cfg)
        self.tick_count += 1
        return self._out_dict(out)

    def _out_dict(self, o: mcl.MCLOutput) -> dict:
        # One device->host copy for all of the reply's numbers.
        v = torch.cat([o.exact_pose, o.cell_pose.to(torch.float32),
                       torch.stack([o.confidence,
                                    o.song.to(torch.float32),
                                    o.wanderer_cmd.to(torch.float32),
                                    o.n_injected.to(torch.float32)])]
                      ).cpu().numpy().astype(np.float64)
        return dict(
            tick=self.tick_count,
            exact_pose=[round(float(x), 6) for x in v[0:3]],
            # ExactPose.thetaQuaternion analog (msg/ExactPose.msg).
            theta_quaternion=round(math.sin(0.5 * float(v[2])), 6),
            cell_pose=[int(x) for x in v[3:6]],
            confidence=round(float(v[6]), 6),
            song=int(v[7]),
            wanderer_cmd=int(v[8]),
            n_injected=int(v[9]),
        )

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
                    raise NotImplementedError(
                        "raw_scan frames are not ported; send pre-filtered "
                        "ranges on the beam table")
                else:
                    reply(self.tick(msg["encoder_left"],
                                    msg["encoder_right"], msg["ranges"],
                                    msg.get("mask")))
            except Exception as e:  # noqa: BLE001 — a long-lived server
                # must survive any bad line (missing keys, shape errors):
                # reply with the error instead of dropping the session.
                reply(dict(error=f"{type(e).__name__}: {e}"))
        return self.tick_count

    def _handle_cmd(self, msg: dict, reply) -> bool:
        cmd = msg["cmd"]
        if cmd == "reset":
            self.reset(int(msg.get("seed", 0)))
        elif cmd == "stats":
            reply(dict(tick=self.tick_count,
                       confidence=round(float(self.state.confidence), 6)))
            return False
        elif cmd == "shutdown":
            reply(dict(ok=True))
            return True
        else:
            reply(dict(error=f"unknown cmd {cmd!r}"))
            return False
        reply(dict(ok=True))
        return False
