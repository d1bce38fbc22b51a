"""The control: the plain reference put in the program's place, computed
in the nearest precision below the configuration's (float32): the
particles' move and the beam weights in bfloat16 (for SLAM: the move,
the likelihood field, the scan likelihood and the maps' sums; for the
closed loop: the move, the beam weights, the P-drive and the diff
drive).  Its runs
have to come out as not correct; the limits lie between the program's
readings and the control's.

    python3 -m mclbench.control --workload NAME --seeds 1,2,3 --seconds S
        [--which program,control]

runs the cell once a seed with the port and with the control, in one
process, and prints one JSON line a run with every compared number and
diagnostic.  The benchmark's own runs never run it.
"""
from __future__ import annotations

import argparse
import io
import json
import os
import sys

import torch

from .reference import closed_loop as ref_cl
from .reference import filter as ref
from .reference import slam as ref_slam

CONTROL_DTYPE = torch.bfloat16


def _ref_state(st):
    """A copy of a reference State (the filter's or SLAM's)."""
    return type(st)(**{k: v.clone() for k, v in vars(st).items()})


class RefFleetServer:
    """The fleet server's JSONL protocol on the reference tick."""

    def __init__(self, world, robots: int, seed: int, dtype):
        self.world = world
        self.dtype = dtype
        self.state, self.gen = ref.init(world.mz, world.filter, seed, robots)
        self.tick_count = 0

    def serve(self, lines, out) -> int:
        w = self.world
        for line in lines:
            msg = json.loads(line)
            dev = w.device
            enc = torch.tensor([msg["encoder_left"], msg["encoder_right"]],
                               dtype=torch.float32, device=dev).T
            ranges = torch.tensor(msg["ranges"], dtype=torch.float32,
                                  device=dev)
            mask = torch.tensor(msg["mask"], device=dev).to(torch.bool)
            d = ref.draw_tick(self.gen, w.mz, w.filter, enc.shape[0])
            self.state, o = ref.tick(self.state, enc, ranges, mask,
                                     w.angles, w.mz, w.filter, d,
                                     self.dtype)
            self.tick_count += 1
            print(json.dumps(dict(
                tick=self.tick_count,
                exact_pose=[[round(float(v), 6) for v in p]
                            for p in o.exact_pose.cpu()],
                cell_pose=o.cell_pose.cpu().tolist(),
                confidence=[round(float(v), 6) for v in o.confidence.cpu()],
                song=o.song.cpu().tolist())), file=out, flush=True)
        return self.tick_count


class FleetControl:
    def __init__(self, world, robots: int, seed: int,
                 dtype=CONTROL_DTYPE):
        self.server = RefFleetServer(world, robots, seed, dtype)

    def snapshot(self):
        s = self.server
        return _ref_state(s.state), s.gen.get_state()


class _RefState:
    def __init__(self, st, gen):
        self.st, self.gen = st, gen


class ReplayControl:
    """run_episode / run_episode_batch on the reference tick."""

    def __init__(self, world, entry: str, episodes: int,
                 dtype=CONTROL_DTYPE):
        self.world, self.e, self.dtype = world, episodes, dtype

    def segment(self, state, seed: int, enc, ranges):
        w = self.world
        if state is None:
            state = _RefState(*ref.init(w.mz, w.filter, seed, self.e))
        mask = torch.ones(ranges.shape, dtype=torch.bool, device=w.device)
        st, outs = ref.run(state.st, state.gen, enc, ranges, mask,
                           w.angles, w.mz, w.filter, self.dtype)
        return _RefState(st, state.gen), outs

    def snapshot(self, state):
        return _ref_state(state.st), state.gen.get_state()

    def answers(self, outs) -> dict:
        return dict(
            exact_pose=torch.stack([o.exact_pose for o in outs], dim=1),
            confidence=torch.stack([o.confidence for o in outs], dim=1),
            song=torch.stack([o.song for o in outs], dim=1))


class SLAMControl:
    """run_slam_episode over [E, K] filters on the reference tick."""

    def __init__(self, world, episodes: int, replicas: int,
                 dtype=CONTROL_DTYPE):
        self.world, self.dtype = world, dtype
        self.batch = (episodes, replicas)

    def segment(self, state, seed: int, start, enc, ranges):
        w = self.world
        if state is None:
            state = _RefState(*ref_slam.init(
                w.slam, seed, start[:, None, :], self.batch))
        shape = self.batch + enc.shape[1:2]
        en = enc[:, None].expand(shape + (2,))
        rg = ranges[:, None].expand(shape + ranges.shape[-1:])
        mask = torch.ones(rg.shape, dtype=torch.bool, device=rg.device)
        st, outs = ref_slam.run(state.st, state.gen, en, rg, mask, w.angles,
                                w.slam, self.dtype)
        return (_RefState(st, state.gen),
                torch.stack([o.pose for o in outs], dim=2))

    @staticmethod
    def winners(state):
        return torch.argmax(state.st.log_evidence, dim=-1)

    @staticmethod
    def snapshot(state):
        return _ref_state(state.st), state.gen.get_state()


class _RefLoop:
    def __init__(self, st, sim_gen, filt_gen):
        self.st, self.sim_gen, self.filt_gen = st, sim_gen, filt_gen


class ClosedLoopControl:
    """init_closed_loop and rollout on the reference's closed-loop
    tick."""

    def __init__(self, world, episodes: int, waypoints, start_pose,
                 dtype=CONTROL_DTYPE):
        self.world, self.e, self.dtype = world, episodes, dtype
        self.waypoints, self.start = waypoints, start_pose

    def segment(self, state, seed: int, n: int):
        w = self.world
        if state is None:
            state = _RefLoop(*ref_cl.init(w.mz, w.filter, seed, self.e,
                                          self.start))
        st, outs = ref_cl.run(state.st, state.sim_gen, state.filt_gen,
                              self.waypoints, n, w.angles, w.mz, w.filter,
                              w.closed_loop, self.dtype)
        return _RefLoop(st, state.sim_gen, state.filt_gen), outs

    @staticmethod
    def snapshot(state):
        st = state.st
        return (ref_cl.State(filt=_ref_state(st.filt), **{
            k: v.clone() for k, v in vars(st).items() if k != "filt"}),
                (state.sim_gen.get_state(), state.filt_gen.get_state()))

    @staticmethod
    def answers(outs) -> dict:
        return {f: torch.stack([getattr(o, f) for o in outs], dim=1)
                for f in ("true_pose", "est_pose", "confidence", "wp_idx",
                          "wheel_cmd")}

    @staticmethod
    def progress(state):
        return state.st.wp_idx.clone()


def factory(driver: str):
    return dict(fleet=FleetControl, slam=SLAMControl,
                closed_loop=ClosedLoopControl).get(driver, ReplayControl)


def main(argv=None) -> int:
    from . import harness

    ap = argparse.ArgumentParser(prog="mclbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--which", default="program,control")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = os.getcwd()
    cell = harness.load_cell(root, args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for which in args.which.split(","):
            prog = None if which == "program" else factory(
                cell.traffic["driver"])
            res = harness.run_cell(root, args.workload, seed, args.seconds,
                                   False, args.device, program=prog,
                                   out=io.StringIO(), err=io.StringIO())
            print(json.dumps(dict(workload=args.workload, seed=seed,
                                  which=which, correct=res["correct"],
                                  numbers=res["diagnostics"],
                                  metrics=res["metrics"])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
