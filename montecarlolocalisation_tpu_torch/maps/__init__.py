"""Maze parsing, rasterization, generation, map_server import and the torch
map container (single maps and map stacks)."""
from .grid import (
    MazeMap, from_map_file, from_raster, from_walls, repeat_maps,
    select_maps, stack_maps,
)
from .pgm import from_pgm

__all__ = ["MazeMap", "from_map_file", "from_raster", "from_walls",
           "from_pgm", "repeat_maps", "select_maps", "stack_maps"]
