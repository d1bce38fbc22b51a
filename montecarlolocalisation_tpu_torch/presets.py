"""World construction for the CLI presets (the JAX package's
presets.make_world, presets.py:46-72)."""
from __future__ import annotations

import dataclasses
import os.path as osp

import numpy as np
import torch

from .config import (
    FilterConfig, ResampleConfig, SensorModelConfig,
)
from .maps import MazeMap, from_map_file

# The default maze ships with the JAX package; read by path, not imported.
DEFAULT_MAP = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "montecarlolocalisation_tpu", "maps",
                       "default_map.txt")


@dataclasses.dataclass
class World:
    maze: MazeMap
    walls: torch.Tensor
    cfg: FilterConfig
    angles: np.ndarray


def make_world(map_path: str = DEFAULT_MAP, num_particles: int = 1500,
               num_beams: int = 24, ray_mode: str = "fixed",
               resample_method: str = "multinomial",
               device="cpu") -> World:
    """World from a reference map.txt wall list: the maze on `device`, the
    filter config and an evenly spread beam table over +-118 degrees."""
    maze = from_map_file(map_path, device=device)
    cfg = FilterConfig(num_particles=num_particles,
                       sensor=SensorModelConfig(ray_mode=ray_mode),
                       resample=ResampleConfig(method=resample_method))
    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, num_beams)).astype(np.float32)
    return World(maze=maze, walls=maze.walls, cfg=cfg, angles=angles)
