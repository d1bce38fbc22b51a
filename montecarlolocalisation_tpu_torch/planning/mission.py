"""Mission layer: gold/pickup waypoint files + TSP tour + visit plan.

Torch-port copy of montecarlolocalisation_tpu/planning/mission.py (plain
Python over the port's planners).

Reference: executeChallenge.cpp — parse `[[r,c], ...]` waypoint files
(getPlan :66-96), build the all-pairs BFS distance graph over
[current] + goals (generateTSPGraph :148-186), solve Held-Karp
(:190-247), then visit each node via /move_to_position, playing song 4 per
gold and song 5 + driver shutdown at pickup (:249-363).

Here the mission compiles to a data structure (MissionPlan) that the
closed-loop simulator or a real executor consumes; songs/shutdown become
events, mirroring the filter's event outputs.
"""
from __future__ import annotations

import ast
import dataclasses
import re
from typing import List, Sequence, Tuple

from . import bfs, tsp

SONG_GOLD = 4      # songs_lib.cpp waypoint jingle
SONG_PICKUP = 5


def parse_waypoints(text: str) -> List[Tuple[int, int]]:
    """Parse a gold.txt/pickup.txt literal like [[0,2], [2,3]]."""
    text = text.strip()
    if not text:
        return []
    value = ast.literal_eval(re.sub(r"\s+", "", text))
    return [(int(r), int(c)) for r, c in value]


def load_waypoints(path: str) -> List[Tuple[int, int]]:
    with open(path) as f:
        return parse_waypoints(f.read())


@dataclasses.dataclass(frozen=True)
class MissionLeg:
    goal: Tuple[int, int]
    path: Tuple[Tuple[int, int], ...]
    song: int
    shutdown_after: bool = False


@dataclasses.dataclass(frozen=True)
class MissionPlan:
    legs: Tuple[MissionLeg, ...]
    gold_cost: int

    @property
    def cells(self) -> List[Tuple[int, int]]:
        return [leg.goal for leg in self.legs]


def plan_mission(walls, start_cell: Tuple[int, int],
                 gold: Sequence[Tuple[int, int]],
                 pickup: Sequence[Tuple[int, int]]) -> MissionPlan:
    """TSP-order the gold cells from the start, then append the nearest
    pickup; BFS paths for every leg.

    The reference runs the gold list through Held-Karp, visits in order,
    then handles the pickup list the same way (executeChallenge.cpp:318-358);
    the final pickup triggers song 5 + /shutdown_driver.
    """
    legs: List[MissionLeg] = []
    cur = tuple(map(int, start_cell))
    gold_cost = 0
    if gold:
        gold_cost, order = tsp.plan_tour(walls, cur, gold)
        for cell in order:
            path = bfs.bfs_path(walls, cur, cell)
            legs.append(MissionLeg(goal=cell, path=tuple(path),
                                   song=SONG_GOLD))
            cur = cell
    if pickup:
        _, p_order = tsp.plan_tour(walls, cur, pickup)
        # The reference stops at the first reached pickup (:344-355).
        first = p_order[0]
        path = bfs.bfs_path(walls, cur, first)
        legs.append(MissionLeg(goal=first, path=tuple(path),
                               song=SONG_PICKUP, shutdown_after=True))
    return MissionPlan(legs=tuple(legs), gold_cost=gold_cost)
