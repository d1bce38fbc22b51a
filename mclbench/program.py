"""The system under test: the port's entry points, as the drivers call
them.  Only this module imports the port.

Each adapter also reads the port's filter, SLAM or closed-loop state back
(`snapshot`) and the answers of a replay or a closed loop (`answers`) in
the reference's form, for the check that follows the window.
"""
from __future__ import annotations

import dataclasses

import torch

from .reference import closed_loop as ref_cl
from .reference import filter as ref
from .reference import slam as ref_slam


def _build(cls, values: dict):
    """cls from a dict of its fields (nested dataclasses from nested
    dicts); keys that are no field of cls are left out."""
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            continue
        v = values[f.name]
        if dataclasses.is_dataclass(f.default):
            v = _build(type(f.default), v)
        kw[f.name] = v
    return cls(**kw)


def filter_config(d: dict):
    """The port's FilterConfig from a configuration's `filter` dict."""
    from montecarlolocalisation_tpu_torch import config as pc

    return _build(pc.FilterConfig, d)


def slam_config(d: dict):
    """The port's SLAMConfig from a configuration's `slam` dict."""
    from montecarlolocalisation_tpu_torch import config as pc

    return _build(pc.SLAMConfig, d)


class PortWorld:
    """The port's map, config and beam table for a World."""

    def __init__(self, world):
        from montecarlolocalisation_tpu_torch import maps

        self.m = maps.from_map_file(world.map_path, device=world.device)
        self.cfg = filter_config(world.filter)
        self.angles = world.angles.cpu().numpy()
        self.angles_dev = world.angles


def snapshot(state):
    """(reference State, generator state) of a port MCLState."""
    return ref.from_program(state), state.gen.get_state()


class FleetProgram:
    """MCLFleetServer as `serve --robots R` starts it: synchronous
    replies."""

    def __init__(self, world, robots: int, seed: int):
        from montecarlolocalisation_tpu_torch.io.fleet import MCLFleetServer

        pw = PortWorld(world)
        self.server = MCLFleetServer(pw.m, pw.cfg, pw.angles,
                                     n_robots=robots, seed=seed,
                                     pipeline=False)

    def snapshot(self):
        return snapshot(self.server.state)


class ReplayProgram:
    """models.filter.run_episode (one filter, `episodes` 1) or
    parallel.episodes.run_episode_batch over a log, one call a segment."""

    def __init__(self, world, entry: str, episodes: int):
        from montecarlolocalisation_tpu_torch.models import filter as mcl
        from montecarlolocalisation_tpu_torch.parallel import episodes as ep

        if entry == "run_episode" and episodes != 1:
            raise ValueError("run_episode replays one filter's log")
        if entry not in ("run_episode", "run_episode_batch"):
            raise ValueError(f"unknown replay entry {entry!r}")
        self.pw = PortWorld(world)
        self.entry = entry
        self._mcl, self._ep = mcl, ep

    def segment(self, state, seed: int, enc, ranges):
        """The next ticks of a pass: enc [E, n, 2], ranges [E, n, B];
        `state` None starts the pass from the filter seed `seed`.
        Returns (state, outputs)."""
        pw = self.pw
        if self.entry == "run_episode":
            if state is None:
                state = self._mcl.init_state(pw.m, pw.cfg, seed)
            return self._mcl.run_episode(state, enc[0], ranges[0],
                                         pw.angles_dev, pw.m, pw.cfg)
        return self._ep.run_episode_batch(seed, pw.m, pw.cfg, enc, ranges,
                                          pw.angles_dev, state=state)

    def snapshot(self, state):
        return snapshot(state)

    def answers(self, outs) -> dict:
        """The published numbers [E, n, ...]."""
        one = self.entry == "run_episode"

        def lead(v):
            return v[None] if one else v

        return dict(exact_pose=lead(outs.exact_pose),
                    confidence=lead(outs.confidence), song=lead(outs.song))

    def free(self) -> None:
        """Drop the graphs this program's calls captured, and their memory
        pools."""
        from montecarlolocalisation_tpu_torch.models import compiled

        compiled.graphs.clear()


class SLAMProgram:
    """models.slam.run_slam_episode over [E, K] filters: E episodes, K
    replicas of each racing on evidence, one call a segment of a log; a
    pass's winners are the replicas' argmax of the log evidence, as
    run_slam_replicas picks them."""

    def __init__(self, world, episodes: int, replicas: int):
        from montecarlolocalisation_tpu_torch.models import slam

        self._slam = slam
        self.cfg = slam_config(world.slam)
        self.angles = world.angles
        self.batch = (episodes, replicas)

    def segment(self, state, seed: int, start, enc, ranges):
        """The next ticks of a pass: enc [E, n, 2], ranges [E, n, B], each
        episode's log shared by its replicas; `state` None starts the pass
        from the filter seed `seed` at the start poses [E, 3].  Returns
        (state, weighted-mean poses [E, K, n, 3])."""
        return self._slam.run_slam_episode(
            seed, enc[:, None], ranges[:, None], self.angles, self.cfg,
            start[:, None, :], state0=state, batch=self.batch,
            device=enc.device)

    @staticmethod
    def winners(state):
        """[E] each episode's replica with the most log evidence."""
        return torch.argmax(state.log_evidence, dim=-1)

    @staticmethod
    def snapshot(state):
        """(reference SLAM State, generator state), copies."""
        return ref_slam.from_program(state), state.gen.get_state()

    def free(self) -> None:
        from montecarlolocalisation_tpu_torch.models import compiled

        compiled.graphs.clear()


class ClosedLoopProgram:
    """sim/closed_loop over E episodes, each filter driving its own robot
    through the waypoints [n, 2] from start_pose: init_closed_loop at a
    pass's start, then rollout, one call a segment."""

    def __init__(self, world, episodes: int, waypoints, start_pose):
        from montecarlolocalisation_tpu_torch import config as pc
        from montecarlolocalisation_tpu_torch.sim import closed_loop

        self._cl = closed_loop
        self.pw = PortWorld(world)
        c = world.closed_loop
        self.kw = dict(wcfg=_build(pc.WandererConfig, c["wanderer"]),
                       base_speed=c["base_speed"],
                       arrival_tol=c["arrival_tol"],
                       scan_noise=c["scan_noise"])
        self.known_start = c["known_start"]
        self.waypoints = waypoints
        self.start = start_pose
        self.e = episodes

    def segment(self, state, seed: int, n: int):
        """The next n ticks of a pass; `state` None starts the pass from
        the seed `seed`.  Returns (state, outputs [E, n, ...])."""
        pw = self.pw
        if state is None:
            state = self._cl.init_closed_loop(pw.m, pw.cfg, self.start,
                                              self.known_start, seed,
                                              batch=self.e)
        return self._cl.rollout(state, self.waypoints, pw.m, pw.cfg, n,
                                pw.angles_dev, **self.kw)

    @staticmethod
    def snapshot(state):
        """(reference closed-loop State, (the simulator's, the filter's
        generator state))."""
        return ref_cl.from_program(state), (state.gen.get_state(),
                                            state.filt.gen.get_state())

    @staticmethod
    def answers(outs) -> dict:
        """The published numbers [E, n, ...]."""
        return {f: getattr(outs, f) for f in ("true_pose", "est_pose",
                                              "confidence", "wp_idx",
                                              "wheel_cmd")}

    @staticmethod
    def progress(state):
        """[E] each episode's waypoint index (a copy)."""
        return state.wp_idx.clone()

    def free(self) -> None:
        from montecarlolocalisation_tpu_torch.models import compiled

        compiled.graphs.clear()
