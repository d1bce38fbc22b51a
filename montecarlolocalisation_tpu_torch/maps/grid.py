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

A map stack (the JAX package's stacked MazeMap, generator.py:158-168) holds
M maps of one geometry: `occ`, `occ_dilated`, `walls` and `row_lengths`
carry a leading [M], and `index` [E] (int32) names the map each episode of
a batch reads; without it episode e reads map e.  Stacks enter the
batched tick with this index instead of rasters repeated per episode
(`repeat_maps`).  Every lookup of a stack reads the leading [E] of its
coordinates as the episode axis, so a stack needs a batch of episodes.

Division by a map constant is written as multiplication by its float32
reciprocal: that is what the JAX package computes under jit (XLA rewrites
x / c into x * (1/c)), and what torch computes on CUDA for a Python-scalar
divisor, so CPU and CUDA tensors round the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from ..config import (
    WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP, GridConfig,
)
from . import maze, raster


def f32_reciprocal(c: float) -> float:
    """1/c rounded as float32 arithmetic rounds it."""
    return float(np.float32(1.0) / np.float32(c))


@dataclasses.dataclass(frozen=True)
class MazeMap:
    """Occupancy map.  `occ` is a bool [H, W] raster (True = wall), or
    [M, H, W] for a map stack (module docstring)."""

    occ: torch.Tensor            # [(M,) H, W] bool, row-major (y, x)
    occ_dilated: torch.Tensor    # [(M,) H, W] bool 3x3 dilation (validity)
    walls: torch.Tensor          # [(M,) R, C, 4] bool wall tensor
    row_lengths: torch.Tensor    # [(M,) R] int32 (ragged-row accounting)
    resolution: float = 0.1
    origin_x: float = 0.0
    origin_y: float = 0.0
    cell_meters: float = 0.8
    gridline: bool = False       # walls only on the 8-px gridlines (for a
    #                              stack, on every map)
    index: Optional[torch.Tensor] = None   # a stack's [E] int32 map of
    #                                        each episode

    @property
    def device(self) -> torch.device:
        return self.occ.device

    @property
    def is_stack(self) -> bool:
        return self.occ.dim() == 3

    @property
    def maps(self) -> int:
        """The number of maps: 1 for a single map."""
        return self.occ.shape[0] if self.is_stack else 1

    @property
    def episode_maps(self) -> Optional[torch.Tensor]:
        """A stack's map of each episode ([E] int32), None for one map."""
        if not self.is_stack:
            return None
        if self.index is not None:
            return self.index
        return torch.arange(self.maps, dtype=torch.int32, device=self.device)

    @property
    def height(self) -> int:
        return self.occ.shape[-2]

    @property
    def width(self) -> int:
        return self.occ.shape[-1]

    @property
    def n_rows(self) -> int:
        return self.walls.shape[-3]

    @property
    def n_cols(self) -> int:
        return self.walls.shape[-2]

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
            row_lengths=self.row_lengths.to(device),
            index=None if self.index is None else self.index.to(device))

    def map_at(self, i: int) -> "MazeMap":
        """Map i of a stack, as a single map."""
        return dataclasses.replace(
            self, occ=self.occ[i], occ_dilated=self.occ_dilated[i],
            walls=self.walls[i], row_lengths=self.row_lengths[i],
            gridline=is_gridline_structured(self.occ[i].cpu().numpy()),
            index=None)


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


def stack_maps(maps: Sequence[MazeMap]) -> MazeMap:
    """A map stack of single maps that share their geometry (raster and
    lattice shapes, resolution, origin and cell size); episode e reads map
    e until an index is set (`repeat_maps`, `select_maps`)."""
    first = maps[0]

    def geometry(m):
        return (tuple(m.occ.shape), tuple(m.walls.shape), m.resolution,
                m.origin_x, m.origin_y, m.cell_meters)

    if any(m.is_stack or geometry(m) != geometry(first) for m in maps):
        raise ValueError("a map stack needs single maps of one geometry")
    return dataclasses.replace(
        first, occ=torch.stack([m.occ for m in maps]),
        occ_dilated=torch.stack([m.occ_dilated for m in maps]),
        walls=torch.stack([m.walls for m in maps]),
        row_lengths=torch.stack([m.row_lengths for m in maps]),
        gridline=all(m.gridline for m in maps), index=None)


def select_maps(stack: MazeMap, index) -> MazeMap:
    """The stack with episode e reading map index[e]; the values are
    checked here, on the host, so no launch needs to."""
    idx = torch.as_tensor(index, dtype=torch.int32).cpu()
    if not stack.is_stack or idx.dim() != 1:
        raise ValueError("select_maps takes a map stack and an index [E]")
    if idx.numel() and not (0 <= int(idx.min())
                            and int(idx.max()) < stack.maps):
        raise ValueError(f"map index outside [0, {stack.maps})")
    return dataclasses.replace(stack, index=idx.to(stack.device))


def repeat_maps(stack: MazeMap, episodes_per_map: int) -> MazeMap:
    """Each map of the stack for `episodes_per_map` consecutive episodes,
    as the JAX package repeats the stack's arrays (episodes.py:141-142),
    without copying a raster."""
    if episodes_per_map < 1:
        raise ValueError("episodes_per_map must be >= 1")
    return select_maps(stack, stack.episode_maps.cpu().repeat_interleave(
        episodes_per_map))


def synthesize_walls(occ: np.ndarray, cell_px: int) -> np.ndarray:
    """Wall tensor [R, C, 4] of an arbitrary occupancy raster
    (grid.py:125 of the JAX package): the reference's cell lattice laid
    over the raster, and a wall on an edge whose open band (its pixels
    without the two corner pixels, which perpendicular walls share) holds
    an occupied pixel or leaves the raster.  A cell whose interior holds
    one is walled on all four edges, and walls are marked on both cells of
    an edge."""
    occ = np.asarray(occ).astype(bool)
    h, w = occ.shape
    n_rows = max(1, (h - 1) // cell_px)
    n_cols = max(1, (w - 1) // cell_px)
    t = np.zeros((n_rows, n_cols, 4), dtype=bool)

    def band_any(r0, r1, c0, c1):
        if r0 >= h or c0 >= w or r1 > h or c1 > w:
            return True
        return bool(occ[r0:r1, c0:c1].any())

    for r in range(n_rows):
        for c in range(n_cols):
            r0, c0 = r * cell_px, c * cell_px
            t[r, c, WALL_TOP] = band_any(r0, r0 + 1, c0 + 1, c0 + cell_px)
            t[r, c, WALL_BOTTOM] = band_any(
                r0 + cell_px, r0 + cell_px + 1, c0 + 1, c0 + cell_px)
            t[r, c, WALL_LEFT] = band_any(r0 + 1, r0 + cell_px, c0, c0 + 1)
            t[r, c, WALL_RIGHT] = band_any(
                r0 + 1, r0 + cell_px, c0 + cell_px, c0 + cell_px + 1)
            interior = occ[r0 + 1: min(r0 + cell_px, h),
                           c0 + 1: min(c0 + cell_px, w)]
            if interior.size == 0 or interior.any():
                t[r, c, :] = True
    return t


def from_raster(occ: np.ndarray, resolution: float = 0.1,
                origin_x: float = 0.0, origin_y: float = 0.0,
                cell_meters: float = 0.8, device="cuda") -> MazeMap:
    """MazeMap of an arbitrary boolean occupancy raster (True = wall;
    grid.py:169 of the JAX package), the entry point of imported maps
    (maps/pgm).  The filter reads the raster; the cell layer (the uniform
    sampler) reads its `synthesize_walls` overlay.  A raster that is not
    gridline-structured takes the dense DDA path for the analytic cast,
    and a large one the beam weight kernels' device-memory form."""
    occ = np.asarray(occ).astype(bool)
    cell_px = max(1, int(round(cell_meters / resolution)))
    walls_t = synthesize_walls(occ, cell_px)
    return MazeMap(
        occ=torch.from_numpy(occ.copy()).to(device),
        occ_dilated=torch.from_numpy(dilate3x3(occ)).to(device),
        walls=torch.from_numpy(walls_t).to(device),
        row_lengths=torch.full((walls_t.shape[0],), walls_t.shape[1],
                               dtype=torch.int32).to(device),
        resolution=float(resolution), origin_x=float(origin_x),
        origin_y=float(origin_y), cell_meters=float(cell_meters),
        gridline=is_gridline_structured(occ))


def world_to_map(m: MazeMap, wx, wy):
    """World -> pixel indices + in-bounds mask (monte_carlo.cpp:298-315),
    truncating toward zero like C++ static_cast<int>."""
    inv = m.inv_resolution
    mx = ((wx - m.origin_x) * inv).to(torch.int32)
    my = ((wy - m.origin_y) * inv).to(torch.int32)
    inb = (mx >= 0) & (my >= 0) & (mx < m.width) & (my < m.height)
    return mx, my, inb


def lookup(table: torch.Tensor, mx, my, maps=None):
    """table[my, mx] with out-of-range pixels reading False.  For a stack's
    table [M, H, W], `maps` [E] names the map of each episode, and element
    (e, ...) of the coordinates reads table[maps[e], my, mx]: flat index
    maps[e] * H * W + my * W + mx, in int64."""
    h, w = table.shape[-2:]
    inb = (mx >= 0) & (my >= 0) & (mx < w) & (my < h)
    flat = my.clamp(0, h - 1).long() * w + mx.clamp(0, w - 1).long()
    if maps is not None:
        lead = tuple(maps.shape)
        if tuple(flat.shape[:len(lead)]) != lead:
            raise ValueError(f"a map stack of {lead} episodes read at "
                             f"coordinates {tuple(flat.shape)}")
        flat = flat + (maps.long() * (h * w)).reshape(
            lead + (1,) * (flat.dim() - len(lead)))
    # take, not indexing: a 0-d index (one filter's best pose) would be
    # read on the host, a synchronization that no CUDA graph can hold.
    return inb & torch.take(table, flat)


def get_cell(m: MazeMap, mx, my):
    """Occupancy at pixel (mx, my) of one map, clamped to the raster
    (getCell, monte_carlo.cpp:317-321; the caller masks out-of-bounds
    pixels)."""
    mx = torch.clamp(torch.as_tensor(mx, device=m.device), 0,
                     m.width - 1).long()
    my = torch.clamp(torch.as_tensor(my, device=m.device), 0,
                     m.height - 1).long()
    return m.occ[my, mx]


def is_occupied(m: MazeMap, wx, wy):
    """True when the pixel under (wx, wy) is a wall; False out of map
    (monte_carlo.cpp:322-329)."""
    mx, my, _ = world_to_map(m, wx, wy)
    return lookup(m.occ, mx, my, m.episode_maps)


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
    if abs(offset - m.resolution) > 1e-9:
        return is_valid_pos_stencil(m, wx, wy, offset)
    mx, my, _ = world_to_map(m, wx, wy)
    hit = lookup(m.occ_dilated, mx, my, m.episode_maps)
    return is_inside_map(m, wx, wy) & ~hit


def is_valid_pos_stencil(m: MazeMap, wx, wy, offset: float = 0.1):
    """The reference's 9-point stencil, one lookup a point (grid.py:236 of
    the JAX package); is_valid_pos takes it where the offset is not one
    pixel."""
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
