"""Episode logs and filter checkpoints.

Torch counterpart of montecarlolocalisation_tpu/io/logs.py.  The
reference persists nothing (its filter state lives in memory):

- `EpisodeLog`: the replay schema, per-tick encoder readings and filtered
  scans plus optional ground truth, saved as .npz (the JAX package's
  format, field for field).
- `save_state` / `load_state`: an `MCLState` (one filter or a batch) as
  .npz, every tensor and the state of its torch.Generator, so a filter
  restored from a checkpoint repeats the uninterrupted run bit for bit.
  `extra` carries the caller's own integers (a server's tick count).  The
  format is the port's own; the JAX package's checkpoints hold a PRNG key,
  not a generator state.
- `save_tree` / `load_tree`: any tree of dataclasses, dicts and tuples of
  tensors and generators (a SLAMState, a SLAM fleet's state and per-robot
  generators) in the same form, read back into the shape of a template,
  as the JAX package's save_pytree / load_pytree do; `save_pytree` /
  `load_pytree` are those two with the JAX package's signatures.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models import motion, resample
from ..models.filter import MCLState


@dataclasses.dataclass
class EpisodeLog:
    """Recorded (or simulated) sensor log of one episode."""

    encoders: np.ndarray          # [T, 2] cumulative wheel radians
    scan_ranges: np.ndarray       # [T, B]
    scan_angles: np.ndarray       # [B] static beam table
    scan_mask: Optional[np.ndarray] = None   # [T, B] bool
    true_poses: Optional[np.ndarray] = None  # [T, 3] ground truth if known
    meta: Optional[Dict[str, Any]] = None

    @property
    def num_ticks(self) -> int:
        return self.encoders.shape[0]

    def save(self, path: str) -> None:
        arrays = dict(encoders=np.asarray(self.encoders),
                      scan_ranges=np.asarray(self.scan_ranges),
                      scan_angles=np.asarray(self.scan_angles))
        if self.scan_mask is not None:
            arrays["scan_mask"] = np.asarray(self.scan_mask)
        if self.true_poses is not None:
            arrays["true_poses"] = np.asarray(self.true_poses)
        arrays["meta_json"] = np.frombuffer(
            json.dumps(self.meta or {}).encode(), dtype=np.uint8)
        np.savez_compressed(path, **arrays)

    @staticmethod
    def load(path: str) -> "EpisodeLog":
        z = np.load(path)
        meta = (json.loads(bytes(z["meta_json"]).decode())
                if "meta_json" in z else {})
        return EpisodeLog(encoders=z["encoders"],
                          scan_ranges=z["scan_ranges"],
                          scan_angles=z["scan_angles"],
                          scan_mask=z.get("scan_mask"),
                          true_poses=z.get("true_poses"), meta=meta)


# MCLState's tensors by checkpoint name; odom and inj nest one level.
_ODOM = [f.name for f in dataclasses.fields(motion.OdometryState)]
_INJ = [f.name for f in dataclasses.fields(resample.InjectionState)]
_TOP = [f.name for f in dataclasses.fields(MCLState)
        if f.name not in ("odom", "inj", "gen")]


def save_state(path: str, state: MCLState,
               extra: Optional[Dict[str, int]] = None) -> None:
    """Write `state` (and the integers of `extra`) to an .npz at `path`."""
    def n(t):
        return t.detach().cpu().numpy()

    arrays = {name: n(getattr(state, name)) for name in _TOP}
    arrays.update({f"odom.{k}": n(getattr(state.odom, k)) for k in _ODOM})
    arrays.update({f"inj.{k}": n(getattr(state.inj, k)) for k in _INJ})
    arrays["gen_state"] = state.gen.get_state().numpy()
    arrays["gen_device"] = np.frombuffer(
        state.gen.device.type.encode(), dtype=np.uint8)
    arrays["extra_json"] = np.frombuffer(
        json.dumps(extra or {}).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_state(path: str, device) -> Tuple[MCLState, Dict[str, int]]:
    """Read a save_state checkpoint onto `device`: (state, extra).  The
    generator must be of the device type it was saved from (a CPU
    generator's state is not a CUDA generator's)."""
    z = np.load(path)
    device = torch.device(device)
    saved = bytes(z["gen_device"]).decode()
    if saved != device.type:
        raise ValueError(f"the checkpoint holds a {saved} generator, not a "
                         f"{device.type} one")

    def t(name):
        return torch.as_tensor(z[name], device=device)

    gen = torch.Generator(device=device)
    gen.set_state(torch.as_tensor(z["gen_state"], dtype=torch.uint8))
    state = MCLState(
        **{name: t(name) for name in _TOP},
        odom=motion.OdometryState(**{k: t(f"odom.{k}") for k in _ODOM}),
        inj=resample.InjectionState(**{k: t(f"inj.{k}") for k in _INJ}),
        gen=gen)
    return state, json.loads(bytes(z["extra_json"]).decode())


def _join(name: str, key) -> str:
    return f"{name}.{key}" if name else str(key)


def _flat(tree, name: str, out: dict) -> None:
    """`tree`'s tensors and generators by dotted name."""
    if isinstance(tree, (torch.Tensor, torch.Generator)):
        out[name] = tree
    elif dataclasses.is_dataclass(tree):
        for f in dataclasses.fields(tree):
            _flat(getattr(tree, f.name), _join(name, f.name), out)
    elif isinstance(tree, dict):
        for k, v in tree.items():
            _flat(v, _join(name, k), out)
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            _flat(v, _join(name, i), out)


def save_tree(path: str, tree,
              extra: Optional[Dict[str, int]] = None) -> None:
    """Write every tensor and generator state of `tree` (and the integers
    of `extra`) to an .npz at `path`."""
    leaves: dict = {}
    _flat(tree, "", leaves)
    arrays = {}
    for name, v in leaves.items():
        if isinstance(v, torch.Generator):
            arrays[name + ".gen_state"] = v.get_state().numpy()
            arrays[name + ".gen_device"] = np.frombuffer(
                v.device.type.encode(), dtype=np.uint8)
        else:
            arrays[name] = v.detach().cpu().numpy()
    arrays["extra_json"] = np.frombuffer(
        json.dumps(extra or {}).encode(), dtype=np.uint8)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)


def load_tree(path: str, like, device) -> Tuple[Any, Dict[str, int]]:
    """Read a save_tree checkpoint onto `device` in the structure of
    `like` (whose shapes it must have): (tree, extra).  Its generators
    are new ones of `device`'s type, which must be the saved one."""
    z = np.load(path)
    device = torch.device(device)

    def load(v, name):
        if isinstance(v, torch.Generator):
            saved = bytes(z[name + ".gen_device"]).decode()
            if saved != device.type:
                raise ValueError(f"the checkpoint holds a {saved} generator,"
                                 f" not a {device.type} one")
            gen = torch.Generator(device=device)
            gen.set_state(torch.as_tensor(z[name + ".gen_state"],
                                          dtype=torch.uint8))
            return gen
        t = torch.as_tensor(z[name], device=device)
        if t.shape != v.shape or t.dtype != v.dtype:
            raise ValueError(f"{name}: the checkpoint holds {t.dtype} "
                             f"{tuple(t.shape)}, not {v.dtype} "
                             f"{tuple(v.shape)}")
        return t

    def walk(tree, name):
        if isinstance(tree, (torch.Tensor, torch.Generator)):
            return load(tree, name)
        if dataclasses.is_dataclass(tree):
            return dataclasses.replace(tree, **{
                f.name: walk(getattr(tree, f.name), _join(name, f.name))
                for f in dataclasses.fields(tree)})
        if isinstance(tree, dict):
            return {k: walk(v, _join(name, k)) for k, v in tree.items()}
        if isinstance(tree, (tuple, list)):
            return type(tree)(walk(v, _join(name, i))
                              for i, v in enumerate(tree))
        return tree

    return walk(like, ""), json.loads(bytes(z["extra_json"]).decode())


def _device_of(tree):
    """The device of the first tensor of `tree` (the CPU if none)."""
    leaves: dict = {}
    _flat(tree, "", leaves)
    for v in leaves.values():
        if isinstance(v, torch.Tensor):
            return v.device
    return torch.device("cpu")


def save_pytree(path: str, tree: Any) -> None:
    """Checkpoint any tree of tensors and generators (an MCLState, a
    SLAMState) to .npz: save_tree without extras, the JAX package's
    signature (logs.py:65).  The format is the port's (save_tree's)."""
    save_tree(path, tree)


def load_pytree(path: str, like: Any) -> Any:
    """Restore a save_pytree checkpoint into the structure of `like` (the
    same shapes), on like's device (load_tree; logs.py:74 of the JAX
    package)."""
    return load_tree(path, like, _device_of(like))[0]
