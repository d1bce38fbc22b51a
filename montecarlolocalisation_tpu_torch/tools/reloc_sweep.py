"""Partial-map relocalization sweep: the counterpart of the root
tools/reloc_sweep.py, with its flags and output lines.

A synthetic half-explored default maze (the right half never explored):
fresh wander episodes sense the TRUE maze, and the filter runs on the
conservative learned fit with the unknown-aware scorer (known_map).
--replicas K runs every episode K times as one batch of K x --batch
episodes (parallel/episodes.run_episode_replicas) and keeps, per episode,
the replica with the highest accumulated log total weight.  --cpu means
--device cpu; --tick-chunk is accepted and changes nothing (the ticks run
in graphs of a few ticks either way).

  python -m montecarlolocalisation_tpu_torch.tools.reloc_sweep \\
      --ticks 300 --batch 16 --seeds 7 11 23 31 47 59 \\
      --credit-mode interval --replicas 8
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np

from . import tool_device


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="montecarlolocalisation_tpu_torch.tools.reloc_sweep")
    ap.add_argument("--ticks", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--credit", type=float, default=None)
    ap.add_argument("--credit-mode", default=None)
    ap.add_argument("--inject-mode", default=None,
                    choices=["explored", "uniform", "init-only"])
    ap.add_argument("--seeds", type=int, nargs="+", default=None)
    ap.add_argument("--ess", type=float, default=None)
    ap.add_argument("--refine", type=int, default=0)
    ap.add_argument("--method", default=None,
                    choices=["systematic", "multinomial"])
    ap.add_argument("--particles", type=int, default=1500)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--tick-chunk", type=int, default=None,
                    help="accepted; changes nothing")
    ap.add_argument("--cpu", action="store_true",
                    help="the same as --device cpu")
    ap.add_argument("--device", default="cuda",
                    help="torch device the sweep runs on")
    return ap


def half_explored(m, device):
    """The half-explored default maze of the JAX tool: log-odds `lo`
    [H, W] (walls +6, free -6, the right half 0), its conservative fit
    `cons` (unexplored edges walls) and `known` (unexplored edges open) as
    MazeMaps on `device`, and the explored pixels `ex` [H, W]."""
    from ..models import mapping
    from ..presets import _maze_from_wall_tensor

    occ = m.occ.cpu().numpy()
    lo = np.where(occ, 6.0, -6.0).astype(np.float32)
    lo[:, occ.shape[1] // 2:] = 0.0          # right half never explored
    cell_px = int(round(m.cell_meters / m.resolution))
    cons = _maze_from_wall_tensor(mapping.fit_walls(lo, cell_px=cell_px),
                                  device)
    known = _maze_from_wall_tensor(
        mapping.fit_walls(lo, cell_px=cell_px, unexplored_is_wall=False),
        device)
    return lo, cons, known, np.abs(lo) > 0.5


def score(best, conf, truth, m, ex) -> dict:
    """The JAX tool's scoring of one seed's batch, on host arrays: best
    poses [E, 3] (x < 0 where not confident), confidences [E], true poses
    [E, T, 3], explored pixels `ex` [H, W].  Returns the final error, hit
    (confident within 0.4 m), the share of ticks on explored pixels
    (in_cov), the final true pose, best and conf."""
    best = np.asarray(best)
    tpa = np.asarray(truth)
    tp = tpa[:, -1]
    err = np.hypot(best[:, 0] - tp[:, 0], best[:, 1] - tp[:, 1])
    hit = (best[:, 0] >= 0) & (err < 0.4)
    rows = np.clip((tpa[..., 1] - float(m.origin_y)) / float(m.resolution),
                   0, ex.shape[0] - 1).astype(int)
    cols = np.clip((tpa[..., 0] - float(m.origin_x)) / float(m.resolution),
                   0, ex.shape[1] - 1).astype(int)
    in_cov = ex[rows, cols].mean(axis=1)
    return dict(err=err, hit=hit, in_cov=in_cov, tp=tp, best=best,
                conf=np.asarray(conf))


def seed_lines(s: dict, batch: int, per_episode: bool) -> list:
    """The JAX tool's lines for one seed: the converged count and median
    error, then one line an episode when `per_episode`."""
    hit, err = s["hit"], s["err"]
    lines = [f"converged {int(hit.sum())}/{batch}  median_err(hit) "
             f"{np.median(err[hit]) if hit.any() else float('nan'):.3f}"]
    best, tp, conf, in_cov = s["best"], s["tp"], s["conf"], s["in_cov"]
    for b in (range(batch) if per_episode else []):
        lines.append(
            f"ep{b:02d} hit={int(hit[b])} conf={conf[b]:.2f} "
            f"err={err[b]:.2f} best=({best[b,0]:.2f},{best[b,1]:.2f}) "
            f"true=({tp[b,0]:.2f},{tp[b,1]:.2f}) in_cov={in_cov[b]:.2f}")
    return lines


def make_world(args: argparse.Namespace, dev):
    """The JAX tool's world: 24 beams, --particles, --refine, --ess and
    --method, and the sensor's and init's overrides."""
    from .. import presets

    world = presets.make_world(
        num_particles=args.particles, num_beams=24,
        resample_method=args.method or "multinomial",
        refine_iters=args.refine, ess_threshold=args.ess, device=dev)
    scfg = world.cfg.sensor
    icfg = world.cfg.init
    if args.credit is not None:
        scfg = dataclasses.replace(scfg, unknown_credit=args.credit)
    if args.credit_mode is not None:
        scfg = dataclasses.replace(scfg, unknown_credit_mode=args.credit_mode)
    if args.inject_mode is not None:
        icfg = dataclasses.replace(icfg, partial_map_cells=args.inject_mode)
    return dataclasses.replace(
        world, cfg=dataclasses.replace(world.cfg, sensor=scfg, init=icfg))


def run_seed(seed: int, world, cons, known, args: argparse.Namespace):
    """One seed's batch: the wander episodes from (1.25, 1.25, 0) on the
    true maze, then the filter (or K replicas of it) on `cons` with
    `known`.  Returns (best poses [E, 3], confidences [E], true poses
    [E, T, 3]) on the host."""
    from ..parallel import episodes
    from ..presets import _gen, _seeds

    m = world.maze
    sim_seed, filter_seed = _seeds(seed)
    enc, scans, truth = episodes.simulate_episode_batch(
        _gen(sim_seed, m.device), m, world.cfg, world.angles, args.ticks,
        batch=args.batch, start_pose=(1.25, 1.25, 0.0))
    if args.replicas > 1:
        final, _, _ = episodes.run_episode_replicas(
            filter_seed, cons, world.cfg, enc, scans, world.angles,
            replicas=args.replicas, known_map=known)
    else:
        final, _ = episodes.run_episode_batch(
            filter_seed, cons, world.cfg, enc, scans, world.angles,
            known_map=known)
    return (final.best_pose.cpu().numpy(), final.confidence.cpu().numpy(),
            truth.cpu().numpy())


def main(argv=None) -> None:
    args = parser().parse_args(argv)
    dev = tool_device("cpu" if args.cpu else args.device)
    world = make_world(args, dev)
    _, cons, known, ex = half_explored(world.maze, dev)
    for seed in (args.seeds or [args.seed]):
        best, conf, truth = run_seed(seed, world, cons, known, args)
        s = score(best, conf, truth, world.maze, ex)
        for line in seed_lines(s, args.batch, not args.seeds):
            print(line, flush=True)


if __name__ == "__main__":
    main()
