"""Exact Held-Karp TSP.

Torch-port copy of montecarlolocalisation_tpu/planning/tsp.py's
pure-Python path (`held_karp_py`), which the JAX suite holds equal to its
native solver.  Reference: executeChallenge.cpp:190-247 (tsp_held_karp):
open tour starting at node 0, final node selected by dp cost PLUS the
distance back to node 0 (a reference quirk preserved — it biases the
winner but the returned path does not include the return leg).
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from . import bfs


def held_karp(dist) -> Tuple[int, List[int]]:
    """Returns (open-tour cost, visiting order starting at node 0)."""
    dist = np.asarray(dist)
    n = len(dist)
    if n == 1:
        return 0, [0]
    INF = float("inf")
    full = 1 << n
    dp = np.full((full, n), INF)
    parent = np.full((full, n), -1, dtype=np.int64)
    dp[1][0] = 0.0
    for mask in range(1, full):
        for u in range(n):
            if not (mask & (1 << u)) or dp[mask][u] >= INF:
                continue
            for v in range(n):
                if mask & (1 << v):
                    continue
                nxt = mask | (1 << v)
                cost = dp[mask][u] + dist[u][v]
                if cost < dp[nxt][v]:
                    dp[nxt][v] = cost
                    parent[nxt][v] = u
    best, last = INF, -1
    for i in range(1, n):
        cost = dp[full - 1][i] + dist[i][0]
        if cost < best:
            best, last = cost, i
    order = []
    mask, cur = full - 1, last
    while cur != 0:
        order.append(cur)
        prev = int(parent[mask][cur])
        mask ^= 1 << cur
        cur = prev
    return int(best - dist[last][0]), [0] + order[::-1]



# The JAX package's name of its pure-Python path, of which this module is
# the copy.
held_karp_py = held_karp


def plan_tour(walls, start_cell, waypoints: Sequence[Tuple[int, int]]):
    """generateTSPGraph + tsp_held_karp (executeChallenge.cpp:148-247).

    Builds the complete distance graph over [start] + waypoints with BFS
    node counts minus 1 (edge counts, :174), solves exactly, and returns
    the waypoint visiting order as cells (start excluded).
    """
    nodes = [tuple(map(int, start_cell))] + [tuple(map(int, w))
                                             for w in waypoints]
    raw = bfs.all_pairs_distances(walls, nodes)
    d = np.maximum(raw - 1, 0)
    # Unreachable pairs (BFS node count 0) must not look like free moves.
    d = np.where(raw == 0, np.int32(10**6), d).astype(np.int32)
    cost, order = held_karp(d)
    return cost, [nodes[i] for i in order[1:]]
