"""Maze map parsing: map.txt wall-list text -> wall tensor [R, C, 4].

Reference format (pink_fundamentals/map.txt + src/publish_map.py:6-17): a
Python-literal nested list; each cell is a list of wall letters T/L/R/B which
publish_map.py maps onto Cell.msg constants RIGHT=0, TOP=1, LEFT=2, BOTTOM=3.
Rows may be ragged; the rasterizer pads short rows as occupied
(publish_map_rviz.cpp:399-416).
"""
from __future__ import annotations

import ast
from typing import List, Sequence

import numpy as np

from ..config import WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP

_LETTER = {"R": WALL_RIGHT, "T": WALL_TOP, "L": WALL_LEFT, "B": WALL_BOTTOM}


def parse_map_text(text: str) -> List[List[List[int]]]:
    """Parse map.txt content into nested wall-code lists.

    The reference `exec`s the file with T/L/R/B bound to ints
    (publish_map.py:8-17); we parse safely by substituting the letters and
    using ast.literal_eval.
    """
    tree = ast.parse(text.strip(), mode="eval")

    def conv(node):
        if isinstance(node, ast.List):
            return [conv(e) for e in node.elts]
        if isinstance(node, ast.Name):
            return _LETTER[node.id]
        if isinstance(node, ast.Constant):
            return int(node.value)
        raise ValueError(f"unexpected node in map text: {ast.dump(node)}")

    out = conv(tree.body)
    if not (isinstance(out, list) and all(isinstance(r, list) for r in out)):
        raise ValueError("map text must be a list of rows")
    return out


def load_map_file(path: str) -> List[List[List[int]]]:
    with open(path) as f:
        return parse_map_text(f.read())


def walls_to_tensor(walls: Sequence[Sequence[Sequence[int]]]) -> np.ndarray:
    """Nested wall lists -> dense bool tensor [rows, max_cols, 4].

    wall_tensor[r, c, d] is True when cell (r, c) lists wall d
    (d in {RIGHT=0, TOP=1, LEFT=2, BOTTOM=3}).  Ragged short rows are padded
    with ALL-WALLS cells: the rasterizer marks those pixels occupied
    (publish_map_rviz.cpp:399-416), so the planner must treat them as
    unreachable too.  (The reference planner indexes missing cells out of
    bounds — undefined behavior, buildGraphFromWallArray
    moveToPosition_server.cpp:237-264.)
    """
    rows = len(walls)
    cols = max((len(r) for r in walls), default=0)
    t = np.zeros((rows, cols, 4), dtype=bool)
    for i, row in enumerate(walls):
        for j, cell in enumerate(row):
            for w in cell:
                t[i, j, int(w)] = True
        t[i, len(row):, :] = True  # padded non-cells: fully walled
    return t


def row_lengths(walls: Sequence[Sequence[Sequence[int]]]) -> np.ndarray:
    """Per-row cell counts (needed for ragged-row raster/graph rules)."""
    return np.array([len(r) for r in walls], dtype=np.int32)
