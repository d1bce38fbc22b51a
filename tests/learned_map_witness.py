"""Whether the slam preset's relocalization, tracking and mission read the
learned map of an exploration correctly: presets._on_learned_map (the
port's run_slam from the best particle's log-odds on) on the JAX
package's learned maps, and the port's own frontier preset, at the
CLI's defaults (1000 ticks, 128 particles, 3 % slip, the mission on).

  python tests/learned_map_witness.py jax DIR     # the JAX package on
      # the CPU: its frontier preset at seeds 0 to 2, one JSON line
      # each, and the learned log-odds saved as DIR/jax_lo_seed<s>.npy
  python tests/learned_map_witness.py port DIR    # the port on the card:
      # _on_learned_map on each of those maps at seeds 0 to 2, then the
      # port's frontier preset at seeds 0 to 2

Relocalization and tracking drive 8 episodes each from the SLAM start,
and without slip their true paths are one and the same route: whether
the learned map covers that route decides all 8 at once.
"""
import json
import os
import sys

# Run as a script from anywhere: the packages sit at the repo's root.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEEDS = (0, 1, 2)
PRESET = dict(num_ticks=1000, num_particles=128, slip_noise=0.03,
              mission=True, explore_mode="frontier")
KEYS = ("explored_edge_frac", "reloc_converged_frac", "reloc_in_coverage_n",
        "track_on_learned_frac", "track_in_coverage_n",
        "track_to_coverage_edge_frac", "mission_waypoints_reached",
        "mission_waypoints_total")


def say(**row) -> None:
    print(json.dumps(row), flush=True)


def jax_maps(out_dir: str) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from montecarlolocalisation_tpu import presets
    from montecarlolocalisation_tpu.models import slam

    best_map, maps = slam.best_map, []

    def recording(state):
        lo = best_map(state)
        maps.append(np.asarray(lo))
        return lo

    slam.best_map = recording
    os.makedirs(out_dir, exist_ok=True)
    world = presets.make_world(num_particles=1500)
    for seed in SEEDS:
        out = presets.run_slam(world, seed=seed, **PRESET)
        np.save(os.path.join(out_dir, f"jax_lo_seed{seed}.npy"), maps[-1])
        say(package="jax", seed=seed, **{k: out.get(k) for k in KEYS})


def port(maps_dir: str) -> None:
    import numpy as np
    import torch

    from montecarlolocalisation_tpu_torch import presets
    from montecarlolocalisation_tpu_torch.models import mapping

    world = presets.make_world(device="cuda")
    m = world.maze
    cell_px = int(round(m.cell_meters / m.resolution))
    ticks = 960                 # the frontier preset's 8 phases of 120
    for name in sorted(os.listdir(maps_dir)):
        lo = np.load(os.path.join(maps_dir, name))
        _, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                    return_explored=True)
        for seed in SEEDS:
            out = dict(explored_edge_frac=float(np.mean(seen)),
                       **presets._on_learned_map(lo, world, ticks, seed,
                                                 mission=True))
            say(package="port", map=name, seed=seed,
                **{k: out.get(k) for k in KEYS})
    for seed in SEEDS:
        out = presets.run_slam(world, seed=seed, **PRESET)
        say(package="port", preset="frontier", seed=seed,
            **{k: out.get(k) for k in KEYS})
    torch.cuda.synchronize()


if __name__ == "__main__":
    what, where = sys.argv[1:3]
    {"jax": jax_maps, "port": port}[what](where)
