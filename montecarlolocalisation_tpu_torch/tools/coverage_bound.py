"""Physical coverage budget per world family: the counterpart of the root
tools/coverage_bound.py, with its flags and lines.

How much of a maze can any explorer cover in T ticks at wander speed?  A
perfect maze's cell graph is a tree: a walk visiting all n cells traverses
at least 2 (n - 1) - ecc edges (ecc, the farthest cell's BFS distance from
the start cell).  Room worlds (BSP) are not trees, and the bound is a
lower bound on their travel.  Numpy on the host over the port's copy of
maps/generator: it has no device, and its numbers equal the JAX tool's.

  python -m montecarlolocalisation_tpu_torch.tools.coverage_bound \\
      --ticks 2400
"""
from __future__ import annotations

import argparse
from collections import deque

import numpy as np

from ..config import WALL_BOTTOM, WALL_LEFT, WALL_RIGHT, WALL_TOP

FAMILIES = (("rooms", 6, 6), ("rooms", 8, 8), ("maze", 10, 10))


def bfs_dists(walls, start):
    """BFS cell distances [R, C] from `start` through open edges (-1 for
    cells out of reach)."""
    R, C = walls.shape[:2]
    dist = -np.ones((R, C), int)
    dist[start] = 0
    q = deque([start])
    step = {WALL_RIGHT: (0, 1), WALL_TOP: (-1, 0), WALL_LEFT: (0, -1),
            WALL_BOTTOM: (1, 0)}
    while q:
        r, c = q.popleft()
        for e, (dr, dc) in step.items():
            if walls[r, c, e]:
                continue
            nr, nc = r + dr, c + dc
            if 0 <= nr < R and 0 <= nc < C and dist[nr, nc] < 0:
                dist[nr, nc] = dist[r, c] + 1
                q.append((nr, nc))
    return dist


def family_line(style: str, rows: int, cols: int, maps: int, ticks: int,
                speed: float) -> str:
    """The line of one world family: the spanning-walk bound over `maps`
    generated worlds (seeds 1000, 1001, ...)."""
    from ..maps import from_walls, generator

    budget_m = ticks * speed
    gen = (generator.generate_rooms if style == "rooms"
           else generator.generate_maze)
    walks, eccs, frac = [], [], []
    for i in range(maps):
        walls = from_walls(gen(rows, cols, seed=1000 + i),
                           device="cpu").walls.numpy().astype(bool)
        n = rows * cols
        d = bfs_dists(walls, (1, 1))
        ecc = int(d.max())
        walk_m = (2 * (n - 1) - ecc) * 0.8
        walks.append(walk_m)
        eccs.append(ecc)
        frac.append(min(1.0, budget_m / walk_m))
    return (f"{style} {rows}x{cols}: cells {rows*cols}, spanning-walk "
            f"bound {np.mean(walks):.0f} m (ecc {np.mean(eccs):.0f}) -> "
            f"min ticks for FULL visit {np.mean(walks)/speed:.0f}; "
            f"travel-bounded coverage at {ticks} ticks <= "
            f"{np.mean(frac):.2f}")


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.coverage_bound")
    ap.add_argument("--ticks", type=int, default=1200)
    ap.add_argument("--speed", type=float, default=0.04,
                    help="m/tick straight-line (the scripted wanderer's "
                         "measured rate; frontier base_speed 8 ~ 0.033)")
    ap.add_argument("--maps", type=int, default=8)
    return ap


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    print(f"budget: {args.ticks} ticks x {args.speed} m/tick = "
          f"{args.ticks * args.speed:.0f} m of travel; cell edge 0.8 m")
    for style, rows, cols in FAMILIES:
        print(family_line(style, rows, cols, args.maps, args.ticks,
                          args.speed))


if __name__ == "__main__":
    main()
