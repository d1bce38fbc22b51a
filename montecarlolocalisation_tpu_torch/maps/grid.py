"""Map container and world<->grid transforms on torch tensors.

The torch counterpart of montecarlolocalisation_tpu/maps/grid.py, with the
reference MCL node's coordinate conventions:
  * worldToMap (monte_carlo.cpp:298-315): pixel = trunc((w - origin)/res),
    C++ truncation toward zero included (world coords in (-res, 0) land on
    pixel 0 and count as in-bounds).
  * getCell (monte_carlo.cpp:317-321): data[row=my][col=mx].
  * isInsideMap (monte_carlo.cpp:685-692): world-extent bounds.
  * isValidPos (monte_carlo.cpp:331-349): 9-point stencil, +-0.1 m offsets,
    which at one pixel of offset is one lookup in the 3x3-dilated raster.

Division by a map constant is written as multiplication by its float32
reciprocal: that is what the JAX package computes under jit (XLA rewrites
x / c into x * (1/c)), and what torch computes on CUDA for a Python-scalar
divisor, so CPU and CUDA tensors round the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from ..config import GridConfig
from . import maze, raster


def f32_reciprocal(c: float) -> float:
    """1/c rounded as float32 arithmetic rounds it."""
    return float(np.float32(1.0) / np.float32(c))


@dataclasses.dataclass(frozen=True)
class MazeMap:
    """Occupancy map.  `occ` is a bool [H, W] raster (True = wall)."""

    occ: torch.Tensor            # [H, W] bool, row-major (y, x)
    occ_dilated: torch.Tensor    # [H, W] bool 3x3 dilation (validity)
    walls: torch.Tensor          # [R, C, 4] bool wall tensor
    row_lengths: torch.Tensor    # [R] int32 (ragged-row accounting)
    resolution: float = 0.1
    origin_x: float = 0.0
    origin_y: float = 0.0
    cell_meters: float = 0.8
    gridline: bool = False       # walls only on the 8-px gridlines

    @property
    def device(self) -> torch.device:
        return self.occ.device

    @property
    def height(self) -> int:
        return self.occ.shape[0]

    @property
    def width(self) -> int:
        return self.occ.shape[1]

    @property
    def n_rows(self) -> int:
        return self.walls.shape[0]

    @property
    def n_cols(self) -> int:
        return self.walls.shape[1]

    @property
    def extent_x(self) -> float:
        return self.origin_x + self.width * self.resolution

    @property
    def extent_y(self) -> float:
        return self.origin_y + self.height * self.resolution

    @property
    def inv_resolution(self) -> float:
        return f32_reciprocal(self.resolution)

    def to(self, device) -> "MazeMap":
        return dataclasses.replace(
            self, occ=self.occ.to(device),
            occ_dilated=self.occ_dilated.to(device),
            walls=self.walls.to(device),
            row_lengths=self.row_lengths.to(device))


def is_gridline_structured(occ: np.ndarray, cell_px: int = 8) -> bool:
    """True when wall pixels only sit on multiple-of-cell_px rows/cols:
    the rasters the closed-form caster (ops/analytic) handles."""
    occ = np.asarray(occ).astype(bool)
    h, w = occ.shape
    rows = np.arange(h) % cell_px == 0
    cols = np.arange(w) % cell_px == 0
    return not (occ & ~rows[:, None] & ~cols[None, :]).any()


def dilate3x3(occ: np.ndarray) -> np.ndarray:
    """3x3 dilation with out-of-map pixels free (the isValidPos stencil at
    one pixel of offset, border clipping included)."""
    dil = np.zeros_like(occ)
    h, w = occ.shape
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ys = slice(max(0, dy), h + min(0, dy))
            xs = slice(max(0, dx), w + min(0, dx))
            yd = slice(max(0, -dy), h + min(0, -dy))
            xd = slice(max(0, -dx), w + min(0, -dx))
            dil[yd, xd] |= occ[ys, xs]
    return dil


def from_walls(
    walls: Sequence[Sequence[Sequence[int]]],
    grid: GridConfig = GridConfig(),
    device="cuda",
) -> MazeMap:
    occ = raster.rasterize_walls(walls, grid) > grid.occupied_threshold
    return MazeMap(
        occ=torch.from_numpy(occ).to(device),
        occ_dilated=torch.from_numpy(dilate3x3(occ)).to(device),
        walls=torch.from_numpy(maze.walls_to_tensor(walls)).to(device),
        row_lengths=torch.from_numpy(maze.row_lengths(walls)).to(device),
        resolution=grid.resolution, origin_x=grid.origin_x,
        origin_y=grid.origin_y, cell_meters=grid.cell_meters,
        gridline=is_gridline_structured(occ, grid.cell_px))


def from_map_file(path: str, grid: GridConfig = GridConfig(),
                  device="cuda") -> MazeMap:
    return from_walls(maze.load_map_file(path), grid, device)


def world_to_map(m: MazeMap, wx, wy):
    """World -> pixel indices + in-bounds mask (monte_carlo.cpp:298-315),
    truncating toward zero like C++ static_cast<int>."""
    inv = m.inv_resolution
    mx = ((wx - m.origin_x) * inv).to(torch.int32)
    my = ((wy - m.origin_y) * inv).to(torch.int32)
    inb = (mx >= 0) & (my >= 0) & (mx < m.width) & (my < m.height)
    return mx, my, inb


def lookup(table: torch.Tensor, mx, my):
    """table[my, mx] with out-of-range pixels reading False."""
    h, w = table.shape
    inb = (mx >= 0) & (my >= 0) & (mx < w) & (my < h)
    flat = my.clamp(0, h - 1).long() * w + mx.clamp(0, w - 1).long()
    return inb & table.reshape(-1)[flat]


def is_occupied(m: MazeMap, wx, wy):
    """True when the pixel under (wx, wy) is a wall; False out of map
    (monte_carlo.cpp:322-329)."""
    mx, my, _ = world_to_map(m, wx, wy)
    return lookup(m.occ, mx, my)


def is_inside_map(m: MazeMap, wx, wy):
    """World-extent bounds check (monte_carlo.cpp:685-692)."""
    return ((wx >= m.origin_x) & (wx < m.extent_x)
            & (wy >= m.origin_y) & (wy < m.extent_y))


_STENCIL = ((0, 0), (1, 0), (0, 1), (-1, 0), (0, -1),
            (1, 1), (1, -1), (-1, 1), (-1, -1))


def is_valid_pos(m: MazeMap, wx, wy, offset: float = 0.1):
    """Free-space check: inside the map and no wall within the +-offset
    9-point stencil (monte_carlo.cpp:331-349).  At one pixel of offset (the
    reference's 0.1 m at 0.1 m/px) the stencil is one lookup in the dilated
    raster."""
    if abs(offset - m.resolution) <= 1e-9:
        mx, my, _ = world_to_map(m, wx, wy)
        hit = lookup(m.occ_dilated, mx, my)
    else:
        hit = torch.zeros_like(wx, dtype=torch.bool)
        for sx, sy in _STENCIL:
            hit = hit | is_occupied(m, wx + offset * sx, wy + offset * sy)
    return is_inside_map(m, wx, wy) & ~hit


def world_to_cell(wx, wy, cell_meters: float = 0.8):
    """World (x, y) -> maze (row, col) (monte_carlo.cpp:975-979):
    col = floor((wx - 0.4)/0.8 + 0.5), row likewise from wy."""
    inv = f32_reciprocal(cell_meters)
    col = torch.floor((wx - 0.5 * cell_meters) * inv + 0.5).to(torch.int32)
    row = torch.floor((wy - 0.5 * cell_meters) * inv + 0.5).to(torch.int32)
    return row, col


def cell_center(row, col, cell_meters: float = 0.8):
    """Maze (row, col) -> world center (monte_carlo.cpp:394-407 to_cell)."""
    return (col * cell_meters + 0.5 * cell_meters,
            row * cell_meters + 0.5 * cell_meters)
