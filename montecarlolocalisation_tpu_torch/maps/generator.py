"""Random maze generation for sweeps over randomized maps.

A numpy copy of montecarlolocalisation_tpu/maps/generator.py: perfect
mazes (spanning-tree corridors, every cell reachable) with optional extra
openings, and BSP office layouts, in the nested wall-list format of
map.txt (both neighbours list their shared wall).  For the same seed,
style and extra_openings the wall lists equal the JAX package's, so the two
packages' sweeps run on the same worlds.  `generate_map_batch` returns a
map stack (maps/grid.py) for `parallel/episodes.run_multimap_sweep`.
"""
from __future__ import annotations

from typing import List

import numpy as np

from ..config import WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP

_OPP = {WALL_RIGHT: WALL_LEFT, WALL_LEFT: WALL_RIGHT,
        WALL_TOP: WALL_BOTTOM, WALL_BOTTOM: WALL_TOP}
_DELTA = {WALL_RIGHT: (0, 1), WALL_TOP: (-1, 0), WALL_LEFT: (0, -1),
          WALL_BOTTOM: (1, 0)}
STYLES = ("maze", "rooms", "mixed")


def generate_maze(rows: int = 6, cols: int = 6, seed: int = 0,
                  extra_openings: int = 0) -> List[List[List[int]]]:
    """Random perfect maze (recursive-backtracker spanning tree) -> nested
    wall lists; `extra_openings` removes that many more internal walls to
    make loops (generator.py:24 of the JAX package)."""
    rng = np.random.default_rng(seed)
    walls = [[{WALL_RIGHT, WALL_TOP, WALL_LEFT, WALL_BOTTOM}
              for _ in range(cols)] for _ in range(rows)]

    def carve(r0, c0, d):
        r1, c1 = r0 + _DELTA[d][0], c0 + _DELTA[d][1]
        walls[r0][c0].discard(d)
        walls[r1][c1].discard(_OPP[d])

    visited = np.zeros((rows, cols), dtype=bool)
    stack = [(rng.integers(rows), rng.integers(cols))]
    visited[stack[0]] = True
    while stack:
        r, c = stack[-1]
        options = [d for d, (dr, dc) in _DELTA.items()
                   if 0 <= r + dr < rows and 0 <= c + dc < cols
                   and not visited[r + dr, c + dc]]
        if not options:
            stack.pop()
            continue
        d = options[rng.integers(len(options))]
        carve(r, c, d)
        nr, nc = r + _DELTA[d][0], c + _DELTA[d][1]
        visited[nr, nc] = True
        stack.append((nr, nc))

    for _ in range(extra_openings):
        for _attempt in range(64):
            r = int(rng.integers(rows))
            c = int(rng.integers(cols))
            internal = [d for d in walls[r][c]
                        if 0 <= r + _DELTA[d][0] < rows
                        and 0 <= c + _DELTA[d][1] < cols]
            if internal:
                carve(r, c, internal[rng.integers(len(internal))])
                break

    return [[sorted(walls[r][c]) for c in range(cols)] for r in range(rows)]


def generate_rooms(rows: int = 6, cols: int = 6, seed: int = 0,
                   min_room: int = 2) -> List[List[List[int]]]:
    """Office layout: rectangular rooms from recursive binary splits (no
    side under `min_room` cells), one door cell in every partition
    (generator.py:76 of the JAX package)."""
    rng = np.random.default_rng(seed)
    walls = [[set() for _ in range(cols)] for _ in range(rows)]
    for c in range(cols):
        walls[0][c].add(WALL_TOP)
        walls[rows - 1][c].add(WALL_BOTTOM)
    for r in range(rows):
        walls[r][0].add(WALL_LEFT)
        walls[r][cols - 1].add(WALL_RIGHT)

    def split(r0, c0, r1, c1):
        """Half-open cell rectangle [r0, r1) x [c0, c1)."""
        h, w = r1 - r0, c1 - c0
        can_v = w >= 2 * min_room
        can_h = h >= 2 * min_room
        if not can_v and not can_h:
            return
        if can_v and (not can_h or w >= h):
            c_split = int(rng.integers(c0 + min_room, c1 - min_room + 1))
            door = int(rng.integers(r0, r1))
            for r in range(r0, r1):
                if r != door:
                    walls[r][c_split - 1].add(WALL_RIGHT)
                    walls[r][c_split].add(WALL_LEFT)
            split(r0, c0, r1, c_split)
            split(r0, c_split, r1, c1)
        else:
            r_split = int(rng.integers(r0 + min_room, r1 - min_room + 1))
            door = int(rng.integers(c0, c1))
            for c in range(c0, c1):
                if c != door:
                    walls[r_split - 1][c].add(WALL_BOTTOM)
                    walls[r_split][c].add(WALL_TOP)
            split(r0, c0, r_split, c1)
            split(r_split, c0, r1, c1)

    split(0, 0, rows, cols)
    return [[sorted(walls[r][c]) for c in range(cols)] for r in range(rows)]


def map_walls(i: int, rows: int = 6, cols: int = 6, seed: int = 0,
              extra_openings: int = 0, style: str = "maze"):
    """The wall list of map i of a batch: style "maze", "rooms", or
    "mixed" (mazes at even i, rooms at odd i), seeded seed + i."""
    if style not in STYLES:
        raise ValueError(f"unknown style {style!r}")
    if style == "rooms" or (style == "mixed" and i % 2 == 1):
        return generate_rooms(rows, cols, seed + i)
    return generate_maze(rows, cols, seed + i, extra_openings)


def generate_map_batch(n_maps: int, rows: int = 6, cols: int = 6,
                       seed: int = 0, extra_openings: int = 0,
                       style: str = "maze", device="cuda"):
    """A stack of n_maps generated maps (generator.py:136 of the JAX
    package): one MazeMap whose rasters and wall tensors carry a leading
    [n_maps] axis, with shared geometry, on `device`."""
    from .grid import from_walls, stack_maps

    if style not in STYLES:
        raise ValueError(f"unknown style {style!r}")
    return stack_maps([from_walls(map_walls(i, rows, cols, seed,
                                            extra_openings, style),
                                  device="cpu")
                       for i in range(n_maps)]).to(device)
