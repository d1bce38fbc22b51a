"""A configuration as the harness and the reference read it: the filter's
settings (a `filter` section, with a `closed_loop` section where the
filter drives its robot) or RBPF SLAM's (a `slam` section), the reference
maze and the beam table, on one device."""
from __future__ import annotations

import os

import torch

from .reference import filter as ref
from .reference import maze
from .reference import slam as ref_slam

# What the reference implements; a configuration outside it needs the
# reference extended first.
SUPPORTED = {
    ("sensor", "ray_mode"): ("fixed", "analytic"),
    ("sensor", "beam_combine"): ("sum",),
    ("sensor", "lookup_mode"): ("auto",),
    ("sensor", "quantize_ray_deg"): (False,),
    ("motion", "shared_noise"): (True,),
    ("resample", "method"): ("multinomial", "systematic"),
    ("resample", "ess_threshold"): (None, 0.5),
    ("refine", "iters"): (0, 1, 2),
    ("refine", "ray_mode"): ("dda",),
    ("cluster", "impl"): ("auto",),
    ("init", "partial_map_cells"): ("uniform",),
    ("dtype",): ("float32",),
    ("valid_pos_offset",): (0.1,),
}

# What the SLAM reference implements (reference/slam.py), by field of the
# `slam` section; a tuple of fields is checked as one setting.
SUPPORTED_SLAM = {
    "proposal_candidates": (1,),
    "refine_iters": (0,),
    "closure": (False,),
    "ess_threshold": (0.7,),
    ("keyframe_trans", "keyframe_rot"): ((0.0, 0.0), (0.15, 0.5)),
    "dtype": ("float32",),
}


# What the closed-loop reference implements (reference/closed_loop.py), by
# field of the `closed_loop` section; the section holds these fields and
# no others, `wanderer` with every field of WANDERER_FIELDS, and the
# reference takes every other number as it is.
SUPPORTED_CLOSED_LOOP = {
    "known_start": (False,),
}
CLOSED_LOOP_FIELDS = ("base_speed", "arrival_tol", "scan_noise",
                      "known_start", "wanderer")
WANDERER_FIELDS = ("threshold", "forward_speed", "turn_speed", "turn_angle",
                   "wheel_space", "wheel_size")


def _check(name: str, settings: dict) -> None:
    """Raise where a setting ({label: (value, allowed)}) is outside what
    the reference implements."""
    for label, (v, allowed) in settings.items():
        if v not in allowed:
            raise ValueError(f"{name}: {label} = {v!r}; the reference "
                             f"implements {allowed}")


def _filter_settings(f: dict) -> dict:
    out = {}
    for path, allowed in SUPPORTED.items():
        v = f
        for k in path:
            v = v[k]
        out[".".join(path)] = (v, allowed)
    return out


def _slam_settings(s: dict) -> dict:
    return {", ".join(key) if isinstance(key, tuple) else key: (
        tuple(s[k] for k in key) if isinstance(key, tuple) else s[key],
        allowed) for key, allowed in SUPPORTED_SLAM.items()}


def _check_closed_loop(name: str, cl: dict) -> None:
    """Raise where the `closed_loop` section's fields are not exactly
    CLOSED_LOOP_FIELDS (its wanderer's WANDERER_FIELDS), or a setting is
    outside SUPPORTED_CLOSED_LOOP."""
    for what, got, want in (("closed_loop", cl, CLOSED_LOOP_FIELDS),
                            ("closed_loop.wanderer", cl.get("wanderer", {}),
                             WANDERER_FIELDS)):
        if set(got) != set(want):
            raise ValueError(f"{name}: {what} has {sorted(got)}; the "
                             f"reference reads {sorted(want)}")
    _check(name, {k: (cl[k], allowed)
                  for k, allowed in SUPPORTED_CLOSED_LOOP.items()})


class World:
    def __init__(self, root: str, config: dict, device):
        self.config = config
        self.filter = config.get("filter")
        self.slam = config.get("slam")
        self.closed_loop = config.get("closed_loop")
        if (self.filter is None) == (self.slam is None):
            raise ValueError(f"{config['name']}: a configuration has a "
                             f"`filter` or a `slam` section, one of them")
        if self.closed_loop is not None and self.filter is None:
            raise ValueError(f"{config['name']}: a `closed_loop` section "
                             f"drives a `filter`")
        if self.closed_loop is not None:
            _check_closed_loop(config["name"], self.closed_loop)
        if self.filter is not None:
            _check(config["name"], _filter_settings(self.filter))
        else:
            _check(config["name"], _slam_settings(self.slam))
            mp = self.slam["mapping"]
            if 2 * ref_slam.field_reach_px(self.slam) <= min(
                    mp["height"], mp["width"]):
                raise ValueError(
                    f"{config['name']}: a {mp['height']} x {mp['width']} "
                    f"map is read in windows by the program; the reference "
                    f"reads maps under twice "
                    f"{ref_slam.field_reach_px(self.slam)} px whole")
        self.device = torch.device(device)
        self.map_path = os.path.join(root, "mclbench", config["map"])
        self.mz = maze.load(self.map_path, self.device)
        self.angles = ref.beam_table(config["beams"]).to(self.device)

    @property
    def section(self) -> dict:
        """The configuration's `filter` or `slam` section."""
        return self.filter if self.filter is not None else self.slam

    @property
    def sensor(self) -> dict:
        return self.section["sensor"]

    @property
    def motion(self) -> dict:
        return self.section["motion"]

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
