"""BFS planning over the maze wall graph.

Torch-port copy of montecarlolocalisation_tpu/planning/bfs.py's
pure-Python path (`bfs_path_py`), which the JAX suite holds equal to its
native planner.  Reference: moveToPosition_server.cpp:185-264 (bfs +
buildGraphFromWallArray).  Direction deltas (:32-37): RIGHT=(0,+1),
TOP=(-1,0), LEFT=(0,-1), BOTTOM=(+1,0); an edge exists when the direction
code is absent from the cell's wall list.  Paths include the start cell;
`distance` is the node count (DistanceToNode semantics — the TSP layer
subtracts 1 for edges, executeChallenge.cpp:174).  `walls` is a [rows,
cols, 4] wall tensor, as numpy or torch (on any device).
"""
from __future__ import annotations

from collections import deque
from typing import List, Optional, Tuple

import numpy as np
import torch

_DIRS = ((0, 1), (-1, 0), (0, -1), (1, 0))  # RIGHT, TOP, LEFT, BOTTOM


def _walls_numpy(walls) -> np.ndarray:
    """A wall tensor as a host numpy array."""
    if isinstance(walls, torch.Tensor):
        return walls.cpu().numpy()
    return np.asarray(walls)


def bfs_path(walls, start, goal) -> List[Tuple[int, int]]:
    """Shortest cell path [(row, col), ...] incl. start; [] if unreachable."""
    w = _walls_numpy(walls)
    rows, cols = w.shape[:2]
    start = (int(start[0]), int(start[1]))
    goal = (int(goal[0]), int(goal[1]))
    sr, sc = start
    gr, gc = goal
    if not (0 <= sr < rows and 0 <= sc < cols and 0 <= gr < rows
            and 0 <= gc < cols):
        return []
    parent = {start: None}
    q = deque([start])
    while q:
        cur = q.popleft()
        if cur == goal:
            break
        r, c = cur
        for d, (dr, dc) in enumerate(_DIRS):
            if w[r, c, d]:
                continue
            nr, nc = r + dr, c + dc
            if not (0 <= nr < rows and 0 <= nc < cols):
                continue
            if (nr, nc) in parent:
                continue
            parent[(nr, nc)] = cur
            q.append((nr, nc))
    if goal not in parent:
        return []
    path: List[Tuple[int, int]] = []
    node: Optional[Tuple[int, int]] = goal
    while node is not None:
        path.append(node)
        node = parent[node]
    return path[::-1]



# The JAX package's name of its pure-Python path, of which this module is
# the copy.
bfs_path_py = bfs_path


def bfs_distance(walls, start, goal) -> int:
    """Node count of the shortest path (0 = unreachable)."""
    return len(bfs_path(walls, start, goal))


def all_pairs_distances(walls, nodes) -> np.ndarray:
    """[n, n] node-count distance matrix over the given cells."""
    w = _walls_numpy(walls)
    nodes = np.asarray(nodes, dtype=np.int32)
    return np.array([[bfs_distance(w, a, b) for b in nodes] for a in nodes],
                    dtype=np.int32).reshape(len(nodes), len(nodes))


def simplify_path(walls, path):
    """Collapse path nodes whose skip-connection stays adjacent
    (moveToPosition_server.cpp:287-312 simplifyPath; unused in the reference
    executor but part of the API surface)."""
    if len(path) <= 2:
        return list(path)
    w = _walls_numpy(walls)

    def adjacent(a, b):
        dr, dc = b[0] - a[0], b[1] - a[1]
        for d, (er, ec) in enumerate(_DIRS):
            if (dr, dc) == (er, ec) and not w[a[0], a[1], d]:
                return True
        return False

    simplified = [path[0]]
    anchor = 0
    for i in range(2, len(path)):
        if not adjacent(path[anchor], path[i]):
            simplified.append(path[i - 1])
            anchor = i - 1
    simplified.append(path[-1])
    return simplified
