"""A checkout of the benchmark at a size the CPU runs in seconds: the same
manifest, cells and files, with few particles, robots, episodes, replicas
and ticks, under a temporary root."""
from __future__ import annotations

import json
import os
import shutil

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
ROOT = os.path.dirname(BENCH)


def shrink_config(cfg: dict, particles: int = 64, particles_1m: int = 256,
                  slam_particles: int = 8) -> dict:
    """A configuration with few particles: a filter's, or a SLAM one's."""
    if "slam" in cfg:
        cfg["slam"]["num_particles"] = slam_particles
        return cfg
    big = cfg["filter"]["num_particles"] > 100_000
    cfg["filter"]["num_particles"] = particles_1m if big else particles
    return cfg


def shrink_traffic(t: dict, robots: int = 2, episodes: int = 3,
                   ticks: int = 20, slam_episodes: int = 2,
                   slam_replicas: int = 2) -> dict:
    """A traffic mix with few robots, episodes, replicas and ticks."""
    if t["driver"] == "fleet":
        t.update(robots=robots, period_ms=50)
    elif t["driver"] == "slam":
        t.update(episodes=slam_episodes, replicas=slam_replicas,
                 ticks=ticks)
    elif t["driver"] == "closed_loop":
        t.update(episodes=episodes, ticks=ticks,
                 segment_ticks=min(t["segment_ticks"], 8))
    else:
        t["ticks"] = ticks
        if t["entry"] == "run_episode_batch":
            t["episodes"] = episodes
    return t


def make_root(tmp: str, particles: int = 64, robots: int = 2,
              episodes: int = 3, ticks: int = 20,
              particles_1m: int = 256) -> str:
    for d in ("metrics", "data"):
        shutil.copytree(os.path.join(BENCH, d),
                        os.path.join(tmp, "mclbench", d),
                        dirs_exist_ok=True)
    for d in ("traffic", "configs"):
        os.makedirs(os.path.join(tmp, "mclbench", d), exist_ok=True)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = shrink_config(json.load(f), particles, particles_1m)
        with open(os.path.join(tmp, c["file"]), "w") as f:
            json.dump(cfg, f)
    for w in man["workloads"]:
        name = os.path.join("mclbench", "traffic", w["traffic"] + ".json")
        with open(os.path.join(ROOT, name)) as f:
            t = shrink_traffic(json.load(f), robots, episodes, ticks)
        with open(os.path.join(tmp, name), "w") as f:
            json.dump(t, f)
    with open(os.path.join(tmp, "BENCHMARK.json"), "w") as f:
        json.dump(man, f)
    return tmp


def cells() -> list:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
