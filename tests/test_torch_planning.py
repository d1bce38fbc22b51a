"""The port's planners (planning/bfs, tsp, executor, mission) against the
JAX package's, exactly: every cell pair's BFS path, the all-pairs
distances, simplify_path, Held-Karp (random graphs and the reference's
selection quirk), the TSP tour, the executor's actions, targets, subgoals
and step commands, and the gold/pickup mission, on the default maze and
on mazes and room maps from the port's maps/generator.  The port's
planners are its own pure-Python copies: the JAX planners load a native
library (the JAX suite holds the two equal)."""
import dataclasses

import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.maps import maze as jmaze
from montecarlolocalisation_tpu.planning import bfs as jbfs
from montecarlolocalisation_tpu.planning import executor as jexec
from montecarlolocalisation_tpu.planning import mission as jmission
from montecarlolocalisation_tpu.planning import tsp as jtsp
from montecarlolocalisation_tpu_torch import presets as tpresets
from montecarlolocalisation_tpu_torch.config import (
    DIR_DOWN, DIR_LEFT, DIR_RIGHT, DIR_UP,
)
from montecarlolocalisation_tpu_torch.maps import generator as tgen
from montecarlolocalisation_tpu_torch.maps import maze as tmaze
from montecarlolocalisation_tpu_torch.planning import bfs as tbfs
from montecarlolocalisation_tpu_torch.planning import executor as texec
from montecarlolocalisation_tpu_torch.planning import mission as tmission
from montecarlolocalisation_tpu_torch.planning import tsp as ttsp

torch.set_num_threads(1)

DEFAULT = jmaze.walls_to_tensor(jmaze.load_map_file(tpresets.DEFAULT_MAP))


def _walls(name):
    if name == "default":
        return DEFAULT
    style, seed = name.split("-")
    return tmaze.walls_to_tensor(tgen.map_walls(0, 6, 6, int(seed),
                                                style=style))


MAPS = ["default", "maze-1", "maze-5", "rooms-2", "rooms-7"]


@pytest.mark.parametrize("name", MAPS)
def test_bfs_equals_jax(name):
    w = _walls(name)
    cells = [(r, c) for r in range(w.shape[0]) for c in range(w.shape[1])]
    # The port takes the wall tensor as numpy or torch.
    for walls in (w, torch.as_tensor(w)):
        for a in cells[::3]:
            for b in cells:
                assert tbfs.bfs_path(walls, a, b) == jbfs.bfs_path(w, a, b)
    assert tbfs.bfs_path(w, (0, 0), (9, 9)) == jbfs.bfs_path(w, (0, 0),
                                                            (9, 9)) == []
    nodes = cells[::5]
    np.testing.assert_array_equal(tbfs.all_pairs_distances(w, nodes),
                                  jbfs.all_pairs_distances(w, nodes))
    for b in cells[::4]:
        assert tbfs.bfs_distance(w, (0, 0), b) == jbfs.bfs_distance(
            w, (0, 0), b)
        path = jbfs.bfs_path(w, (0, 0), b)
        assert tbfs.simplify_path(w, path) == jbfs.simplify_path(w, path)


def test_held_karp_reference_selection_quirk():
    # Line graph 0-1-2-3: all closed costs tie at 6, so the first
    # candidate (end at 1, open tour 0->3->2->1, cost 5) wins
    # (executeChallenge.cpp:219-226), as in the JAX package.
    d = np.array([[0, 1, 2, 3], [1, 0, 1, 2], [2, 1, 0, 1], [3, 2, 1, 0]])
    assert ttsp.held_karp(d) == jtsp.held_karp(d) == (5, [0, 3, 2, 1])


@pytest.mark.parametrize("n", [1, 2, 3, 5, 7, 9])
def test_held_karp_equals_jax(n):
    rng = np.random.default_rng(n)
    for _ in range(5):
        # Few distinct costs: ties, where the selection rule shows.
        d = rng.integers(1, 4, (n, n)).astype(np.int32)
        np.fill_diagonal(d, 0)
        assert ttsp.held_karp(d) == jtsp.held_karp(d)


@pytest.mark.parametrize("name", MAPS)
def test_tour_and_mission_equal_jax(name):
    w = _walls(name)
    gold = jmission.load_waypoints(tpresets.DEFAULT_GOLD)
    pickup = jmission.load_waypoints(tpresets.DEFAULT_PICKUP)
    assert tmission.load_waypoints(tpresets.DEFAULT_GOLD) == gold
    for start in [(5, 0), (0, 0), (3, 3)]:
        assert ttsp.plan_tour(w, start, gold) == jtsp.plan_tour(w, start,
                                                                gold)
        got = tmission.plan_mission(torch.as_tensor(w), start, gold, pickup)
        want = jmission.plan_mission(w, start, gold, pickup)
        assert got.gold_cost == want.gold_cost
        assert got.cells == want.cells
        assert [(l.goal, l.path, l.song, l.shutdown_after)
                for l in got.legs] == [(l.goal, l.path, l.song,
                                        l.shutdown_after) for l in want.legs]
    assert tmission.parse_waypoints(" [[0, 2],\n [2,3]] ") == \
        jmission.parse_waypoints(" [[0, 2],\n [2,3]] ")
    assert tmission.parse_waypoints("") == jmission.parse_waypoints("") == []


def test_executor_equals_jax():
    path = jbfs.bfs_path(DEFAULT, (5, 0), (0, 5))
    assert texec.path_to_actions(path) == jexec.path_to_actions(path)
    assert texec.waypoint_targets(path) == jexec.waypoint_targets(path)
    with pytest.raises(ValueError):
        texec.path_to_actions([(0, 0), (2, 2)])
    plans = [[DIR_RIGHT] * 4, [DIR_RIGHT, DIR_DOWN, DIR_DOWN],
             [DIR_UP, DIR_DOWN, DIR_LEFT, DIR_LEFT, DIR_UP], []]
    for plan in plans:
        assert texec.generate_subgoals((0.4, 2.0), plan) == \
            jexec.generate_subgoals((0.4, 2.0), plan)
    rng = np.random.default_rng(8)
    for _ in range(40):
        x, y = rng.uniform(0, 4.8, 2)
        if rng.uniform() < 0.5:
            x, y = 0.4 * rng.integers(1, 12, 2)
        th = float(rng.uniform(-4, 4))
        cur, nxt = (int(v) for v in rng.integers(0, 4, 2))
        assert dataclasses.asdict(texec.vector_to_next_cell(x, y, nxt)) == \
            dataclasses.asdict(jexec.vector_to_next_cell(x, y, nxt))
        assert texec.plan_step_command(x, y, th, cur, nxt) == \
            jexec.plan_step_command(x, y, th, cur, nxt)
        assert texec.rotate_to_dir(nxt, th) == jexec.rotate_to_dir(nxt, th)
        assert texec.world_to_local(x, y, th) == jexec.world_to_local(x, y,
                                                                      th)
    assert texec.cell_center(3, 4) == jexec.cell_center(3, 4)
