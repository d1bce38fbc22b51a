"""Moving configs, maps and filter states between the JAX package and the
port.

Everything crosses as numpy arrays or plain values: `config_from`,
`maze_from_numpy`, `state_from_numpy`, `slam_state_from_numpy` and
`explore_state_from_numpy` read the fields of the JAX package's configs,
MazeMap, MCLState, SLAMState and ExploreState
(any object with those attribute names, so this module never imports the
JAX package) into the port's dataclasses; `state_to_numpy` goes back.  A
state batched over episodes (the JAX package's vmap-ed MCLState) crosses
the same way and keeps its leading [E] on every field.  The JAX PRNG key cannot become a torch
stream; it seeds the state's torch.Generator instead.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import config as _config
from .maps.grid import MazeMap, is_gridline_structured
from .models import motion, resample
from .models.filter import MCLState


def config_from(src):
    """The port's config of the same class name as `src`, rebuilt field by
    field from `src`'s attributes; nested configs are rebuilt likewise."""
    cls = getattr(_config, type(src).__name__, None)
    if cls is None or not dataclasses.is_dataclass(cls):
        raise TypeError(f"no port config named {type(src).__name__!r}")
    values = {}
    for f in dataclasses.fields(cls):
        v = getattr(src, f.name)
        values[f.name] = (config_from(v) if dataclasses.is_dataclass(v)
                          else v)
    return cls(**values)


def _t(a, dtype, device):
    return torch.as_tensor(np.array(a), dtype=dtype, device=device)


def maze_from_numpy(src, device="cpu") -> MazeMap:
    """The port's MazeMap of a JAX MazeMap: one map, or a stacked one
    (generator.generate_map_batch), which becomes a map stack."""
    occ = np.asarray(src.occ).astype(bool)
    return MazeMap(
        occ=_t(occ, torch.bool, device),
        occ_dilated=_t(src.occ_dilated, torch.bool, device),
        walls=_t(src.walls, torch.bool, device),
        row_lengths=_t(src.row_lengths, torch.int32, device),
        resolution=float(src.resolution), origin_x=float(src.origin_x),
        origin_y=float(src.origin_y), cell_meters=float(src.cell_meters),
        gridline=all(is_gridline_structured(o)
                     for o in occ.reshape(-1, *occ.shape[-2:])))


def key_to_seed(key) -> int:
    """A 64-bit generator seed from raw uint32 PRNG key words ([2], or
    [E, 2] for a batch: the last two words)."""
    words = np.asarray(key).astype(np.uint64).reshape(-1)
    seed = 0
    for w in words:
        seed = ((seed << 32) | int(w)) & (2**64 - 1)
    return seed


def state_from_numpy(src, device="cpu") -> MCLState:
    f32 = torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(key_to_seed(src.key))
    o = src.odom
    return MCLState(
        particles=_t(src.particles, f32, device),
        weights=_t(src.weights, f32, device),
        odom=motion.OdometryState(
            x=_t(o.x, f32, device), y=_t(o.y, f32, device),
            theta=_t(o.theta, f32, device),
            encoder_left=_t(o.encoder_left, f32, device),
            encoder_right=_t(o.encoder_right, f32, device)),
        inj=resample.InjectionState(w_slow=_t(src.inj.w_slow, f32, device),
                                    w_fast=_t(src.inj.w_fast, f32, device)),
        confidence=_t(src.confidence, f32, device),
        was_lost=_t(src.was_lost, torch.bool, device),
        cluster_threshold=_t(src.cluster_threshold, f32, device),
        confident_threshold=_t(src.confident_threshold, f32, device),
        best_pose=_t(src.best_pose, f32, device),
        gen=gen)


def state_to_numpy(state: MCLState) -> dict:
    """The state's tensors as numpy arrays, nested like the JAX MCLState
    (odom and inj as dicts); `seed` is the generator's initial seed."""
    def n(t):
        return t.detach().cpu().numpy()

    o = state.odom
    return dict(
        particles=n(state.particles), weights=n(state.weights),
        odom=dict(x=n(o.x), y=n(o.y), theta=n(o.theta),
                  encoder_left=n(o.encoder_left),
                  encoder_right=n(o.encoder_right)),
        inj=dict(w_slow=n(state.inj.w_slow), w_fast=n(state.inj.w_fast)),
        confidence=n(state.confidence), was_lost=n(state.was_lost),
        cluster_threshold=n(state.cluster_threshold),
        confident_threshold=n(state.confident_threshold),
        best_pose=n(state.best_pose), seed=state.gen.initial_seed())


def slam_state_from_numpy(src, device="cpu"):
    """The port's SLAMState of a JAX SLAMState (one filter or a vmapped
    batch, the leading dims kept); the PRNG key seeds the generator."""
    from .models.slam import SLAMState

    f32 = torch.float32
    gen = torch.Generator(device=device)
    gen.manual_seed(key_to_seed(src.key))
    o = src.odom
    return SLAMState(
        poses=_t(src.poses, f32, device),
        logodds=_t(src.logodds, f32, device),
        weights=_t(src.weights, f32, device),
        scores=_t(src.scores, f32, device),
        odom=motion.OdometryState(
            x=_t(o.x, f32, device), y=_t(o.y, f32, device),
            theta=_t(o.theta, f32, device),
            encoder_left=_t(o.encoder_left, f32, device),
            encoder_right=_t(o.encoder_right, f32, device)),
        gen=gen, kf_pose=_t(src.kf_pose, f32, device),
        closure_cool=_t(src.closure_cool, torch.int32, device),
        log_evidence=_t(src.log_evidence, f32, device))


def explore_state_from_numpy(src, seed: int = 0, device="cpu"):
    """The port's ExploreState of a JAX ExploreState (sim/frontier): the
    robot, the SLAM state (slam_state_from_numpy) and the control fields;
    the JAX state holds no key for the simulator, whose generator `seed`
    seeds."""
    from .sim.frontier import ExploreState
    from .sim.robot import RobotState

    f32 = torch.float32
    r = src.robot
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    return ExploreState(
        robot=RobotState(**{k: _t(getattr(r, k), f32, device) for k in (
            "x", "y", "theta", "encoder_left", "encoder_right")}),
        slam=slam_state_from_numpy(src.slam, device),
        est=_t(src.est, f32, device),
        wp_idx=_t(src.wp_idx, torch.int32, device),
        turn_left=_t(src.turn_left, torch.int32, device),
        turn_sign=_t(src.turn_sign, f32, device), gen=gen)
