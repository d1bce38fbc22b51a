"""Maze parsing, rasterization and the torch map container."""
from .grid import MazeMap, from_map_file, from_walls

__all__ = ["MazeMap", "from_map_file", "from_walls"]
