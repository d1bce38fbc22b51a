"""Exploration sweep: the frontier explorer against the blind wanderer at
equal tick budgets on generated worlds; the counterpart of the root
tools/explore_sweep.py, with its flags and output lines.

For each generated world and seed every arm gets the same tick budget and
the same slip and scan noise; the sweep records edge coverage against
ticks (the share of (cell, edge) slots observed, mapping.fit_walls' seen
mask) at every --chunk ticks, the ticks to reach --cov-thresh, and the
final explored-edge wall F1.  Every arm runs the same RBPF SLAM
(models/slam, keyframe gating on):

  * wander: the scripted freer-side wanderer (sim/robot, explore=True),
    SLAM folded over its log --chunk ticks at a time;
  * frontier, hybrid, nwander, nhybrid, wallfollow: closed-loop
    exploration steered by the SLAM posterior
    (sim/frontier.run_frontier_slam, phase_ticks = --chunk).

The JAX tool compiles once for all same-shape worlds by passing the maze
as a traced argument.  Here every world is copied into the tensors of one
map (`load_world`) that the CUDA graphs read, so each program is captured
once for the sweep, not once a world; the last line gains `captures`, the
graphs built.

  python -m montecarlolocalisation_tpu_torch.tools.explore_sweep \\
      --maps 8 --seeds-per-map 2 --rows 6 --cols 6 --ticks 2400 --slip 0.03
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from . import tool_device

START = (1.25, 1.25, 0.0)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.explore_sweep")
    ap.add_argument("--maps", type=int, default=8)
    ap.add_argument("--seeds-per-map", type=int, default=2)
    ap.add_argument("--rows", type=int, default=6)
    ap.add_argument("--cols", type=int, default=6)
    ap.add_argument("--style", choices=["rooms", "maze"], default="rooms")
    ap.add_argument("--ticks", type=int, default=2400)
    ap.add_argument("--chunk", type=int, default=120,
                    help="coverage checkpoint interval == frontier phase")
    ap.add_argument("--slip", type=float, default=0.03)
    ap.add_argument("--beams", type=int, default=24)
    ap.add_argument("--particles", type=int, default=64)
    ap.add_argument("--cov-thresh", type=float, default=0.9)
    ap.add_argument("--frontier-speed", type=float, default=8.0,
                    help="frontier base wheel speed (the wanderer's 0.04 "
                         "m/tick straight-line ~= 12)")
    ap.add_argument("--frontier-turn", type=float, default=5.0)
    ap.add_argument("--arms", nargs="+",
                    default=["wander", "frontier", "hybrid"],
                    choices=["wander", "frontier", "hybrid", "nwander",
                             "nhybrid", "wallfollow"],
                    help="behaviors to sweep; 'hybrid' wanders while "
                         "coverage grows, frontier-targets pockets after "
                         "it saturates (sim/frontier policy='hybrid')")
    ap.add_argument("--kf-trans", type=float, default=0.10)
    ap.add_argument("--kf-rot", type=float, default=0.35)
    ap.add_argument("--seed0", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on")
    return ap


# A map's tensors, and the fields that must agree for two maps to share
# the graphs that read one of them.
_TENSORS = ("occ", "occ_dilated", "walls", "row_lengths")
_STATIC = ("resolution", "origin_x", "origin_y", "cell_meters", "gridline")


def load_world(slot, m) -> None:
    """Copy the world `m`'s rasters into the tensors of the map `slot`,
    which must have m's shapes and static fields.  The graphs
    (models/compiled) key a map by its identity and read its tensors at
    every replay, so the worlds of a sweep loaded into one slot in turn
    replay the graphs captured on the first."""
    for name in _STATIC:
        if getattr(m, name) != getattr(slot, name):
            raise ValueError(f"world differs from the slot in {name}")
    for name in _TENSORS:
        dst, src = getattr(slot, name), getattr(m, name)
        if dst.shape != src.shape:
            raise ValueError(f"world's {name} has shape {tuple(src.shape)}, "
                             f"the slot's {tuple(dst.shape)}")
        dst.copy_(src)


def coverage_f1(lo: np.ndarray, true_walls: np.ndarray, cell_px: int):
    """(explored-edge share, explored-edge F1) of log-odds lo [H, W]."""
    from ..models import mapping

    walls, seen = mapping.fit_walls(lo, cell_px=cell_px,
                                    return_explored=True)
    f1 = mapping.wall_metrics(walls, true_walls, mask=seen)["f1"]
    return float(np.mean(seen)), f1


def coverage_curve_wander(m, true_walls, scfg, fcfg, angles, cell_px: int,
                          seed: int, args, phases: int):
    """The blind wanderer's arm: the scripted walk (a generator seeded
    `seed`), SLAM over its log (seeded seed + 1) --chunk ticks at a time,
    coverage at each chunk boundary.  Returns (coverage [phases + 1],
    final F1)."""
    from ..models import slam
    from ..sim import robot

    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    enc, scans, _ = robot.generate_wander_episode(
        gen, m, fcfg, angles, args.ticks, start_pose=START,
        slip_noise=args.slip, explore=True)
    state = slam.init_slam(seed + 1, START, scfg, device=m.device)
    cov = [0.0]
    for i in range(phases):
        sl = slice(i * args.chunk, (i + 1) * args.chunk)
        state, _ = slam.run_slam_episode(None, enc[0, sl], scans[0, sl],
                                         angles, scfg, START, state0=state)
        cov.append(coverage_f1(slam.best_map(state).cpu().numpy(),
                               true_walls, cell_px)[0])
    f1 = coverage_f1(slam.best_map(state).cpu().numpy(), true_walls,
                     cell_px)[1]
    return np.asarray(cov), f1


def coverage_curve_frontier(m, true_walls, scfg, angles, cell_px: int,
                            seed: int, args, phases: int,
                            policy="frontier", novelty=0.0, style_kw=None):
    """A closed-loop arm (sim/frontier.run_frontier_slam): coverage before
    each phase and at the end, an early full-coverage stop held to the
    horizon.  Returns (coverage [phases + 1], final F1)."""
    from ..models import slam
    from ..sim import frontier

    fst, finfo = frontier.run_frontier_slam(
        seed, m, scfg, angles, start_pose=START, phases=phases,
        phase_ticks=args.chunk, slip_noise=args.slip, policy=policy,
        base_speed=args.frontier_speed, turn_speed=args.frontier_turn,
        novelty_bias=novelty, **(style_kw or {}))
    n_ckpt = phases + 1
    cov = np.asarray(finfo["coverage"], np.float64)
    if len(cov) < n_ckpt:
        cov = np.concatenate([cov, np.full(n_ckpt - len(cov), cov[-1])])
    f1 = coverage_f1(slam.best_map(fst.slam).cpu().numpy(), true_walls,
                     cell_px)[1]
    return cov[:n_ckpt], f1


def summarize(curves: dict, f1s: dict, arms, phases: int, chunk: int,
              cov_thresh: float, n_eps: int) -> dict:
    """The JAX tool's summary of the arms' coverage curves [E, phases + 1]
    and F1s: the mean coverage at a quarter, half and all of the budget,
    the final minimum, the share of episodes reaching cov_thresh and the
    median ticks to it (budget + chunk where never), the mean F1, and
    each arm's final-coverage wins over the wanderer."""
    out = {}
    ckpts = sorted({max(phases // 4, 1), max(phases // 2, 1), phases})
    for arm in arms:
        cv = np.stack(curves[arm])
        for p in ckpts:
            out[f"{arm}_cov@{p * chunk}"] = round(float(cv[:, p].mean()), 4)
        out[f"{arm}_cov_final_min"] = round(float(cv[:, -1].min()), 4)
        reach = np.argmax(cv >= cov_thresh, axis=1).astype(float)
        never = ~(cv >= cov_thresh).any(axis=1)
        reach[never] = phases + 1
        out[f"{arm}_reach{cov_thresh}_frac"] = round(
            float((~never).mean()), 4)
        out[f"{arm}_reach{cov_thresh}_ticks_med"] = round(
            float(np.median(reach) * chunk), 1)
        out[f"{arm}_f1"] = round(float(np.mean(f1s[arm])), 4)
    if "wander" in curves:
        for arm in arms:
            if arm == "wander":
                continue
            wins = sum(cf[-1] > cw[-1] for cw, cf in
                       zip(curves["wander"], curves[arm]))
            out[f"{arm}_wins_final_cov"] = f"{wins}/{n_eps}"
    return out


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = tool_device(args.device)
    from ..config import FilterConfig, MappingConfig, SLAMConfig
    from ..maps import from_walls, generator
    from ..models import compiled

    angles = np.deg2rad(
        np.linspace(-118.0, 118.0, args.beams)).astype(np.float32)
    fcfg = FilterConfig(num_particles=args.particles)
    gen = (generator.generate_rooms if args.style == "rooms"
           else generator.generate_maze)
    phases = max(args.ticks // args.chunk, 1)

    def world(mi: int):
        return from_walls(gen(args.rows, args.cols,
                              seed=args.seed0 + 1000 + mi), device=dev)

    slot = first = world(0)
    mc = MappingConfig(height=first.height, width=first.width,
                       resolution=float(first.resolution),
                       origin_x=float(first.origin_x),
                       origin_y=float(first.origin_y))
    scfg = SLAMConfig(num_particles=args.particles, mapping=mc,
                      sensor=fcfg.sensor, motion=fcfg.motion,
                      keyframe_trans=args.kf_trans,
                      keyframe_rot=args.kf_rot)
    cell_px = int(round(first.cell_meters / first.resolution))
    builds = compiled.graphs.builds

    curves = {a: [] for a in args.arms}
    f1s = {a: [] for a in args.arms}
    t0 = time.perf_counter()
    n_eps = 0
    for mi in range(args.maps):
        if mi:
            load_world(slot, world(mi))
        true_walls = slot.walls.cpu().numpy()
        for si in range(args.seeds_per_map):
            seed = args.seed0 + 7919 * mi + 37 * si
            msg = []
            for arm in args.arms:
                if arm == "wander":
                    cv, f1 = coverage_curve_wander(
                        slot, true_walls, scfg, fcfg, angles, cell_px,
                        seed, args, phases)
                else:
                    policy = {"nwander": "wander",
                              "nhybrid": "hybrid"}.get(arm, arm)
                    cv, f1 = coverage_curve_frontier(
                        slot, true_walls, scfg, angles, cell_px, seed,
                        args, phases, policy=policy,
                        novelty=1.0 if arm.startswith("n") else 0.0,
                        style_kw=(dict(wander_style="wallfollow")
                                  if arm == "wallfollow" else None))
                curves[arm].append(cv)
                f1s[arm].append(f1)
                msg.append(f"{arm} cov {cv[-1]:.3f} F1 {f1:.3f}")
            n_eps += 1
            print(f"map {mi} seed {si}: " + " | ".join(msg)
                  + f"  [{time.perf_counter() - t0:.0f}s]", flush=True)

    out = dict(style=args.style, rows=args.rows, cols=args.cols,
               maps=args.maps, episodes=n_eps, ticks=args.ticks,
               chunk=args.chunk, slip=args.slip,
               particles=args.particles,
               wall_s=round(time.perf_counter() - t0, 1))
    out.update(summarize(curves, f1s, args.arms, phases, args.chunk,
                         args.cov_thresh, n_eps))
    out["captures"] = compiled.graphs.builds - builds
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
