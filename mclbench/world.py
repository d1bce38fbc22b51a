"""A configuration as the harness and the reference read it: the filter's
settings, the reference maze and the beam table, on one device."""
from __future__ import annotations

import os

import torch

from .reference import filter as ref
from .reference import maze

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


class World:
    def __init__(self, root: str, config: dict, device):
        self.config = config
        self.filter = config["filter"]
        for path, allowed in SUPPORTED.items():
            v = self.filter
            for k in path:
                v = v[k]
            if v not in allowed:
                raise ValueError(f"{config['name']}: {'.'.join(path)} = "
                                 f"{v!r}; the reference implements "
                                 f"{allowed}")
        self.device = torch.device(device)
        self.map_path = os.path.join(root, "mclbench", config["map"])
        self.mz = maze.load(self.map_path, self.device)
        self.angles = ref.beam_table(config["beams"]).to(self.device)

    @property
    def sensor(self) -> dict:
        return self.filter["sensor"]

    @property
    def motion(self) -> dict:
        return self.filter["motion"]

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
