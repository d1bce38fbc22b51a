"""Wall tensor -> occupancy raster, reproducing createOccupancyGrid exactly.

Reference: src/publish_map_rviz.cpp:306-437.  Pixel layout is row-major
[pixel_row, pixel_col]; pixel_row runs with the maze row index (world y) and
pixel_col with the maze column index (world x).  The raster is
(rows*8+1, cols*8+1) pixels at 0.1 m/px with origin (0, 0)
(publish_map_rviz.cpp:330-331,425-430).

Per-cell drawing rules (the reference avoids duplicate walls):
  * top (T=1):    row r0,        cols c0 .. c0+8 (inclusive, 9 px)
  * left (L=2):   rows r0..r0+8 (inclusive),     col c0
  * right (R=0):  only when the cell is last in its row: rows r0..r0+7, col c0+8
  * bottom (B=3): only on the last row, or when the next row is shorter than
                  this column: row r0+8, cols c0+1 .. c0+8
  * ragged rows:  cells missing vs. the widest row are filled occupied over
                  rows r0..r0+7, cols c0..c0+8.

Host-side, one-time map preprocessing in numpy; the result is moved to the
device once (maps/grid.py).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..config import (
    WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP, GridConfig,
)


def rasterize_walls(
    walls: Sequence[Sequence[Sequence[int]]],
    grid: GridConfig = GridConfig(),
) -> np.ndarray:
    """Nested wall lists (possibly ragged) -> uint8 occupancy raster [H, W]."""
    cs = grid.cell_px
    n_rows = len(walls)
    n_cols = max((len(r) for r in walls), default=0)
    height = n_rows * cs + 1
    width = n_cols * cs + 1
    data = np.full((height, width), grid.free_space, dtype=np.uint8)
    occ = grid.wall_occupied

    for cell_y, row in enumerate(walls):
        row_width = len(row)
        for cell_x, cell_walls in enumerate(row):
            r0 = cell_y * cs
            c0 = cell_x * cs
            for w in cell_walls:
                if w == WALL_TOP:
                    data[r0, c0 : c0 + cs + 1] = occ
                elif w == WALL_LEFT:
                    data[r0 : r0 + cs + 1, c0] = occ
                elif w == WALL_RIGHT:
                    if cell_x == row_width - 1:
                        data[r0 : r0 + cs, c0 + cs] = occ
                elif w == WALL_BOTTOM:
                    draw = cell_y == n_rows - 1 or (
                        cell_y + 1 < n_rows and not cell_x < len(walls[cell_y + 1])
                    )
                    if draw:
                        data[r0 + cs, c0 + 1 : c0 + cs + 1] = occ
        # Ragged rows: pad missing cells as occupied blocks
        # (publish_map_rviz.cpp:399-416).
        for pad_x in range(row_width, n_cols):
            r0 = cell_y * cs
            c0 = pad_x * cs
            data[r0 : r0 + cs, c0 : c0 + cs + 1] = occ

    return data
