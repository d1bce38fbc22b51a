"""The reference maze: a map.txt wall list to an occupancy raster, in
numpy and plain torch.

The map file is the reference robot's `map.txt`: a nested list of cells,
each a list of wall letters (T, L, R, B).  The raster is the one the
reference node draws (`publish_map_rviz.cpp` createOccupancyGrid):
(rows * 8 + 1) x (cols * 8 + 1) pixels at 0.1 m, walls on the multiple-of-8
gridlines, a ragged row's missing cells filled.  `Maze` holds what the
reference filter reads: the raster, its 3 x 3 dilation (the validity
stencil at one pixel of offset), the cell lattice's shape and the map
geometry.
"""
from __future__ import annotations

import ast
import dataclasses

import numpy as np
import torch

CELL_PX = 8
RESOLUTION = 0.1
CELL_METERS = 0.8
# Cell.msg's wall codes.
RIGHT, TOP, LEFT, BOTTOM = 0, 1, 2, 3
_LETTERS = {"R": RIGHT, "T": TOP, "L": LEFT, "B": BOTTOM}


def parse(text: str) -> list:
    """map.txt -> nested lists of wall codes, [row][col][walls]."""
    def conv(node):
        if isinstance(node, ast.List):
            return [conv(e) for e in node.elts]
        if isinstance(node, ast.Name) and node.id in _LETTERS:
            return _LETTERS[node.id]
        raise ValueError(f"unexpected element in a map file: "
                         f"{ast.dump(node)}")

    rows = conv(ast.parse(text.strip(), mode="eval").body)
    if not rows or not all(isinstance(r, list) for r in rows):
        raise ValueError("a map file is a list of rows")
    return rows


def raster(walls: list) -> np.ndarray:
    """Occupancy [H, W] bool of a wall list, drawn as the reference node
    draws it: a cell's top and left walls always; its right wall only as
    the last cell of its row; its bottom wall only on the last row or
    where the next row is shorter; short rows padded with walls."""
    n_rows = len(walls)
    n_cols = max(len(r) for r in walls)
    occ = np.zeros((n_rows * CELL_PX + 1, n_cols * CELL_PX + 1), bool)
    for r, row in enumerate(walls):
        r0 = r * CELL_PX
        for c, cell in enumerate(row):
            c0 = c * CELL_PX
            for w in cell:
                if w == TOP:
                    occ[r0, c0:c0 + CELL_PX + 1] = True
                elif w == LEFT:
                    occ[r0:r0 + CELL_PX + 1, c0] = True
                elif w == RIGHT and c == len(row) - 1:
                    occ[r0:r0 + CELL_PX, c0 + CELL_PX] = True
                elif w == BOTTOM and (r == n_rows - 1
                                      or c >= len(walls[r + 1])):
                    occ[r0 + CELL_PX, c0 + 1:c0 + CELL_PX + 1] = True
        for c in range(len(row), n_cols):
            c0 = c * CELL_PX
            occ[r0:r0 + CELL_PX, c0:c0 + CELL_PX + 1] = True
    return occ


def dilate(occ: np.ndarray) -> np.ndarray:
    """3 x 3 dilation, pixels off the raster free."""
    padded = np.pad(occ, 1)
    h, w = occ.shape
    out = np.zeros_like(occ)
    for dy in range(3):
        for dx in range(3):
            out |= padded[dy:dy + h, dx:dx + w]
    return out


@dataclasses.dataclass(frozen=True)
class Maze:
    """What the reference filter reads of a map, on one device."""

    occ: torch.Tensor          # [H, W] bool
    occ_dilated: torch.Tensor  # [H, W] bool
    n_rows: int                # cell lattice
    n_cols: int
    resolution: float = RESOLUTION
    cell_meters: float = CELL_METERS

    @property
    def height(self) -> int:
        return self.occ.shape[0]

    @property
    def width(self) -> int:
        return self.occ.shape[1]

    @property
    def device(self):
        return self.occ.device


def load(path: str, device="cpu") -> Maze:
    with open(path) as f:
        walls = parse(f.read())
    occ = raster(walls)
    return Maze(occ=torch.from_numpy(occ).to(device),
                occ_dilated=torch.from_numpy(dilate(occ)).to(device),
                n_rows=len(walls), n_cols=max(len(r) for r in walls))
