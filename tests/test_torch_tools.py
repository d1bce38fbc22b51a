"""The port's study tools (montecarlolocalisation_tpu_torch/tools/) against
the root tools/ scripts of the same names, on the CPU.

- Flags: every option string of each JAX script's add_argument calls
  (read with ast) is accepted by the port tool's parser with the same
  default.
- Scoring, on the same arrays: slam_sweep's per-episode errors and F1
  against the JAX package's dead_reckon_poses, fit_walls and
  wall_metrics; reloc_sweep's half-explored maze bit for bit against the
  JAX package's fit and raster, its replica pick and its hit and in_cov
  against the JAX script's own lines; explore_sweep's summary against the
  JAX script's own lines; coverage_bound's output equal to the JAX
  script's.
- Each tool's main at a tiny size with --device cpu: its lines and keys,
  and its numbers equal to the port modules it drives on the same seeds.
"""
import ast
import contextlib
import dataclasses
import importlib
import io
import json
import os.path as osp
import re
import sys
import textwrap
import time
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import montecarlolocalisation_tpu.presets as jpresets
from montecarlolocalisation_tpu.config import FilterConfig as JFilterConfig
from montecarlolocalisation_tpu.models import mapping as jmapping
from montecarlolocalisation_tpu_torch import interop, presets
from montecarlolocalisation_tpu_torch.config import FilterConfig
from montecarlolocalisation_tpu_torch.models import mapping, slam
from montecarlolocalisation_tpu_torch.parallel import episodes
from montecarlolocalisation_tpu_torch.tools import (
    bench_fleet, bench_mapping, bench_matrix, bench_slam, convergence_study,
    coverage_bound, explore_sweep, reloc_sweep, slam_scale, slam_sweep,
)

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TOOLS = osp.join(ROOT, "tools")
PORTED = {
    "convergence_study": convergence_study, "reloc_sweep": reloc_sweep,
    "slam_sweep": slam_sweep, "coverage_bound": coverage_bound,
    "explore_sweep": explore_sweep, "bench_fleet": bench_fleet,
    "bench_slam": bench_slam, "bench_mapping": bench_mapping,
    "slam_scale": slam_scale, "bench_matrix": bench_matrix,
}


def run_main(mod, argv) -> list:
    """The lines mod.main(argv) prints."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        mod.main(argv)
    return out.getvalue().splitlines()


def jax_source(name: str) -> str:
    with open(osp.join(TOOLS, f"{name}.py")) as f:
        return f.read()


def jax_block(name: str, first: str, last: str) -> str:
    """The JAX script's lines from the one that starts with `first` through
    the one that starts with `last` (stripped), dedented: the script's own
    code, run by the tests on given arrays."""
    lines = jax_source(name).splitlines()
    i = next(k for k, v in enumerate(lines) if v.strip().startswith(first))
    j = next(k for k in range(i, len(lines))
             if lines[k].strip().startswith(last))
    return textwrap.dedent("\n".join(lines[i:j + 1]))


# -- flags -----------------------------------------------------------------


def jax_flags(name: str) -> dict:
    """{option string: default} of the JAX script's add_argument calls."""
    flags = {}
    for node in ast.walk(ast.parse(jax_source(name))):
        if not (isinstance(node, ast.Call)
                and getattr(node.func, "attr", None) == "add_argument"):
            continue
        kw = {k.arg: k.value for k in node.keywords}
        if "default" in kw:
            default = ast.literal_eval(kw["default"])
        else:
            action = kw.get("action")
            default = (action is not None
                       and ast.literal_eval(action) == "store_false")
            default = None if action is None else default
        for arg in node.args:
            flags[ast.literal_eval(arg)] = default
    return flags


@pytest.mark.parametrize("name", sorted(PORTED))
def test_tool_accepts_every_jax_flag_with_its_default(name):
    ap = PORTED[name].parser()
    ours = {opt: act.default for act in ap._actions
            for opt in act.option_strings}
    want = jax_flags(name)
    missing = sorted(set(want) - set(ours))
    assert not missing, missing
    for opt, default in want.items():
        assert ours[opt] == default, (opt, ours[opt], default)
    # Every tool with a device adds --device, default cuda.
    if name != "coverage_bound":
        assert ours["--device"] == "cuda"


def test_tool_parsers_take_the_jax_example_commands():
    # The published rows' commands (README.md), TPU workaround flags
    # included.
    cases = dict(
        convergence_study="--batch 32 --ticks 200 --particles 250 "
                          "--refine-iters 2",
        reloc_sweep="--ticks 300 --batch 16 --seeds 7 11 23 31 47 59 "
                    "--credit-mode interval --replicas 8 --tick-chunk 50",
        slam_sweep="--episodes 16 --ticks 1000 --particles 128 --slip 0.08 "
                   "--keyframe-trans 0.15 --keyframe-rot 0.5 --replicas 4 "
                   "--world rooms8x8:5 --tick-chunk 100",
        explore_sweep="--maps 8 --seeds-per-map 2 --ticks 2400 --slip 0.03 "
                      "--style maze --rows 10 --cols 10 --frontier-speed 12")
    for name, line in cases.items():
        args = PORTED[name].parser().parse_args(line.split())
        assert args.device == "cuda"
    assert reloc_sweep.parser().parse_args(["--cpu"]).cpu


# -- slam_sweep's scoring --------------------------------------------------


def _slam_arrays(seed: int, n_ep: int = 3, ticks: int = 40):
    """Estimates, truths, cumulative encoders and log-odds maps [E, H, W]
    (the default maze with noise and unexplored patches) from a numpy
    seed; and the maze's true walls."""
    jm = jpresets.make_world().maze
    rng = np.random.default_rng(seed)
    enc = np.cumsum(rng.uniform(0.0, 0.6, (n_ep, ticks, 2)), axis=1
                    ).astype(np.float32)
    truth = np.stack([np.linspace([1.25, 1.25, 0.0], [2.5, 1.4, 1.0], ticks)
                      + rng.normal(0, 0.02, (ticks, 3))
                      for _ in range(n_ep)]).astype(np.float32)
    est = (truth + rng.normal(0, 0.05, truth.shape)).astype(np.float32)
    occ = np.asarray(jm.occ)
    maps = []
    for _ in range(n_ep):
        lo = np.where(occ, 3.0, -3.0) + rng.normal(0, 1.5, occ.shape)
        r0, c0 = rng.integers(0, occ.shape[0] - 16, 2)
        lo[r0:r0 + 16, c0:c0 + 20] = 0.0
        # A missed wall and a phantom one.
        lo[occ & (rng.uniform(size=occ.shape) < 0.3)] = -3.0
        lo[8 * rng.integers(1, 5), 2:30] = 3.0
        maps.append(lo.astype(np.float32))
    return est, truth, enc, np.stack(maps), np.asarray(jm.walls)


def test_slam_sweep_scoring_matches_jax():
    est, truth, enc, maps, walls = _slam_arrays(3)
    tail = max(truth.shape[1] // 4, 1)
    start = slam_sweep.START
    jmotion = JFilterConfig().motion
    slam_err, dr_err, f1s = slam_sweep.episode_scores(
        est, truth, enc, maps, walls, interop.config_from(jmotion), 8, tail)
    for ep in range(est.shape[0]):
        # The JAX tool's lines (tools/slam_sweep.py:200-218).
        se = np.hypot(est[ep, :, 0] - truth[ep, :, 0],
                      est[ep, :, 1] - truth[ep, :, 1])[-tail:].mean()
        dr = np.asarray(jmapping.dead_reckon_poses(
            jnp.asarray(enc[ep]), start, jmotion))
        de = np.hypot(dr[:, 0] - truth[ep, :, 0],
                      dr[:, 1] - truth[ep, :, 1])[-tail:].mean()
        jw, seen = jmapping.fit_walls(maps[ep], cell_px=8,
                                      return_explored=True)
        f1 = jmapping.wall_metrics(jw, walls, mask=seen)["f1"]
        assert abs(slam_err[ep] - se) <= 1e-6
        assert abs(dr_err[ep] - de) <= 1e-6
        assert f1s[ep] == f1
    jbeats = sum(int(s < d) for s, d in zip(slam_err, dr_err))
    assert int((slam_err < dr_err).sum()) == jbeats
    assert 0.0 < f1s.min() < 1.0        # the maps are imperfect


def test_slam_sweep_map_estimates_match_the_jax_lines():
    rng = np.random.default_rng(5)
    lo = rng.normal(0, 2, (2, 4, 9, 7)).astype(np.float32)
    w = rng.dirichlet(np.ones(4), 2).astype(np.float32)
    scores = rng.uniform(size=(2, 4)).astype(np.float32)
    final = types.SimpleNamespace(logodds=torch.tensor(lo),
                                  weights=torch.tensor(w),
                                  scores=torch.tensor(scores))
    best = slam_sweep.map_estimates("best", final, None, None, None, None)
    cons = slam_sweep.map_estimates("consensus", final, None, None, None,
                                    None)
    for ep in range(2):
        np.testing.assert_array_equal(
            best[ep], lo[ep][int(np.argmax(scores[ep]))])
        np.testing.assert_array_equal(
            cons[ep], np.einsum("p,phw->hw", w[ep], lo[ep]))


# -- reloc_sweep ------------------------------------------------------------


def test_reloc_half_explored_maze_matches_jax():
    jm = jpresets.make_world().maze
    lo, cons, known, ex = reloc_sweep.half_explored(
        presets.make_world(device="cpu").maze, "cpu")
    # The JAX tool's lines (tools/reloc_sweep.py:63-71).
    occ = np.asarray(jm.occ)
    jlo = np.where(occ, 6.0, -6.0).astype(np.float32)
    jlo[:, occ.shape[1] // 2:] = 0.0
    jcons = jpresets._maze_from_wall_tensor(jmapping.fit_walls(jlo,
                                                               cell_px=8))
    jknown = jpresets._maze_from_wall_tensor(
        jmapping.fit_walls(jlo, cell_px=8, unexplored_is_wall=False))
    np.testing.assert_array_equal(lo, jlo)
    np.testing.assert_array_equal(ex, np.abs(jlo) > 0.5)
    for ours, theirs in ((cons, jcons), (known, jknown)):
        np.testing.assert_array_equal(ours.walls.numpy(),
                                      np.asarray(theirs.walls))
        np.testing.assert_array_equal(ours.occ.numpy(),
                                      np.asarray(theirs.occ))
        np.testing.assert_array_equal(ours.occ_dilated.numpy(),
                                      np.asarray(theirs.occ_dilated))
    assert not np.array_equal(cons.walls.numpy(), known.walls.numpy())


def test_reloc_replica_pick_matches_the_jax_evidence_argmax():
    k, b, ticks = 4, 3, 5
    world = presets.make_world(num_particles=32, device="cpu")
    enc = torch.zeros(k * b, ticks, 2)
    scans = torch.ones(k * b, ticks, 24)
    final, outs = episodes.run_episode_batch(1, world.maze, world.cfg, enc,
                                             scans, world.angles)
    rng = np.random.default_rng(9)
    tw = rng.uniform(1e-3, 2.0, (k, b, ticks)).astype(np.float32)
    tw[1, 0, 2] = 0.0                 # floored at 1e-30
    tw[2, 1] = tw[0, 1] * np.float32(1.0001)
    outs = dataclasses.replace(outs, total_weight=torch.tensor(
        tw.reshape(k * b, ticks)))
    picked, _, info = episodes.pick_replicas(final, outs, k)
    # The JAX tool's lines (tools/reloc_sweep.py:84-93).
    evs = np.stack([np.log(np.maximum(np.asarray(tw[r], np.float64),
                                      1e-30)).sum(1) for r in range(k)])
    pick = np.argmax(evs, axis=0)
    np.testing.assert_array_equal(info["chosen"], pick)
    np.testing.assert_array_equal(info["log_evidence"], evs)
    rows = pick * b + np.arange(b)
    np.testing.assert_array_equal(picked.best_pose.numpy(),
                                  final.best_pose.numpy()[rows])


def test_reloc_scoring_matches_the_jax_lines():
    jm = jpresets.make_world().maze
    m = presets.make_world(device="cpu").maze
    _, _, _, ex = reloc_sweep.half_explored(m, "cpu")
    rng = np.random.default_rng(4)
    truth = np.stack([np.linspace([0.5, 0.5, 0.0], rng.uniform(0.3, 4.6, 3),
                                  30) for _ in range(12)]).astype(np.float32)
    best = (truth[:, -1] + rng.normal(0, 0.3, (12, 3))).astype(np.float32)
    best[::4] = -1.0                  # not confident
    s = reloc_sweep.score(best, np.zeros(12), truth, m, ex)
    ns = dict(np=np, truth=truth, best=best, m=jm, ex=ex)
    exec(jax_block("reloc_sweep", "tpa = np.asarray(truth)",
                   "in_cov = ex[rows, cols]"), ns)
    np.testing.assert_array_equal(s["hit"], ns["hit"])
    np.testing.assert_array_equal(s["in_cov"], ns["in_cov"])
    np.testing.assert_array_equal(s["err"], ns["err"])
    assert 0 < s["hit"].sum() < 12 and 0 < s["in_cov"].min() < 1


# -- explore_sweep's summary -------------------------------------------------


def test_explore_summary_matches_the_jax_lines():
    rng = np.random.default_rng(2)
    arms = ["wander", "frontier", "hybrid"]
    phases, n_eps = 20, 6
    curves = {a: [np.minimum(np.cumsum(rng.uniform(0, 0.08, phases + 1)),
                             1.0) for _ in range(n_eps)] for a in arms}
    for c in curves["frontier"][:2]:
        c[-3:] = 0.95                 # reaches the threshold
    f1s = {a: list(rng.uniform(0.6, 1.0, n_eps)) for a in arms}
    args = types.SimpleNamespace(
        style="rooms", rows=6, cols=6, maps=3, ticks=2400, chunk=120,
        slip=0.03, particles=64, arms=arms, cov_thresh=0.9)
    ns = dict(np=np, json=json, time=time, args=args, curves=curves,
              f1s=f1s, phases=phases, n_eps=n_eps, t0=time.perf_counter())
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        exec(jax_block("explore_sweep", "wall_s = time.perf_counter()",
                       "print(json.dumps(out)"), ns)
    want = json.loads(out.getvalue())
    got = explore_sweep.summarize(curves, f1s, arms, phases, args.chunk,
                                  args.cov_thresh, n_eps)
    header = {"style", "rows", "cols", "maps", "episodes", "ticks", "chunk",
              "slip", "particles", "wall_s"}
    assert {k: v for k, v in want.items() if k not in header} == got
    assert got["frontier_reach0.9_frac"] > 0


# -- coverage_bound -----------------------------------------------------------


@pytest.fixture(scope="module")
def jax_coverage_bound():
    sys.path.insert(0, TOOLS)
    try:
        mod = importlib.import_module("coverage_bound")
    finally:
        sys.path.remove(TOOLS)
    return mod


@pytest.mark.parametrize("ticks", [1200, 2400])
def test_coverage_bound_equals_the_jax_script(jax_coverage_bound, ticks,
                                              monkeypatch):
    argv = ["--maps", "3", "--ticks", str(ticks)]
    monkeypatch.setattr(sys, "argv", ["coverage_bound.py", *argv])
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        jax_coverage_bound.main()
    want = out.getvalue().splitlines()
    assert run_main(coverage_bound, argv) == want
    assert len(want) == 4


# -- each tool's main on the CPU ------------------------------------------


def test_convergence_study_line_equals_run_sweep():
    lines = run_main(convergence_study, [
        "--device", "cpu", "--batch", "2", "--ticks", "6", "--particles",
        "32", "64", "--tick-chunk", "3"])
    assert len(lines) == 2
    for n, line in zip((32, 64), lines):
        got = json.loads(line)
        world = presets.make_world(num_particles=n,
                                   resample_method="systematic",
                                   device="cpu")
        want = presets.run_sweep(world, batch=2, num_ticks=6, seed=0)
        keys = list(got)
        assert keys[:7] == ["particles", "batch", "ticks", "method",
                            "refine", "ess", "wall_s"]
        assert keys[7:-2] == list(want) and keys[-2:] == ["ms_per_tick",
                                                          "device"]
        assert got["particles"] == n and got["device"] == "cpu"
        for k, v in want.items():
            v = round(float(v), 4)
            assert got[k] == v or (v != v and got[k] != got[k]), k


def test_convergence_study_refine_and_ess_set_the_filter(monkeypatch):
    seen = []

    def fake_sweep(world, batch, num_ticks, seed, tick_chunk):
        seen.append(world.cfg)
        return dict(converged_frac=1.0)

    monkeypatch.setattr(presets, "run_sweep", fake_sweep)
    line = json.loads(run_main(convergence_study, [
        "--device", "cpu", "--particles", "250", "--refine-iters", "2",
        "--ess", "0.5", "--method", "multinomial", "--ray-mode", "dda"])[0])
    cfg = seen[0]
    assert (cfg.refine.iters, cfg.resample.ess_threshold,
            cfg.resample.method, cfg.sensor.ray_mode,
            cfg.num_particles) == (2, 0.5, "multinomial", "dda", 250)
    assert (line["refine"], line["ess"], line["method"]) == (
        2, 0.5, "multinomial")


def test_reloc_sweep_lines_equal_the_episodes_they_drive():
    argv = ["--cpu", "--batch", "3", "--ticks", "8", "--particles", "32",
            "--seed", "11"]
    for reps in ("1", "2"):
        lines = run_main(reloc_sweep, argv + ["--replicas", reps])
        assert len(lines) == 4
        world = presets.make_world(num_particles=32, device="cpu")
        _, cons, known, ex = reloc_sweep.half_explored(world.maze, "cpu")
        sim_seed, filter_seed = presets._seeds(11)
        enc, scans, truth = episodes.simulate_episode_batch(
            presets._gen(sim_seed, "cpu"), world.maze, world.cfg,
            world.angles, 8, 3, start_pose=(1.25, 1.25, 0.0))
        if reps == "2":
            final = episodes.run_episode_replicas(
                filter_seed, cons, world.cfg, enc, scans, world.angles,
                replicas=2, known_map=known)[0]
        else:
            final = episodes.run_episode_batch(
                filter_seed, cons, world.cfg, enc, scans, world.angles,
                known_map=known)[0]
        best = final.best_pose.numpy()
        tp = truth.numpy()[:, -1]
        for b in range(3):
            err = np.hypot(best[b, 0] - tp[b, 0], best[b, 1] - tp[b, 1])
            assert f"err={err:.2f} best=({best[b, 0]:.2f}," in lines[1 + b]
            assert lines[1 + b].startswith(f"ep{b:02d} hit=")
        assert re.fullmatch(r"converged \d/3  median_err\(hit\) \S+",
                            lines[0])
    seeds = run_main(reloc_sweep, argv + ["--seeds", "7", "11"])
    assert len(seeds) == 2 and all(s.startswith("converged") for s in seeds)


def test_slam_sweep_lines_equal_the_slam_they_drive():
    argv = ["--device", "cpu", "--episodes", "2", "--ticks", "16",
            "--particles", "8", "--slip", "0.08", "--replicas", "2",
            "--keyframe-trans", "0.15", "--keyframe-rot", "0.5",
            "--per-episode", "--seed0", "500", "--tick-chunk", "4"]
    lines = run_main(slam_sweep, argv)
    assert len(lines) == 3
    args = slam_sweep.parser().parse_args(argv)
    world, m = slam_sweep.sweep_world(args, "cpu")
    cfg = slam_sweep.slam_config(args, m, world)
    enc, scans, truth = slam_sweep.episodes_at(0.08, args, m, world)
    final, est, _ = slam.run_slam_replicas(600, enc, scans, world.angles,
                                           cfg, slam_sweep.START,
                                           replicas=2)
    maps = slam.best_map(final).numpy()
    se, de, f1 = slam_sweep.episode_scores(
        est.numpy(), truth.numpy(), enc, maps, m.walls.numpy(),
        world.cfg.motion, 8, 4)
    for ep in range(2):
        assert lines[ep] == (f"  ep{ep:02d}: slam {se[ep]:.3f} dr "
                             f"{de[ep]:.3f} F1 {f1[ep]:.3f}")
    assert lines[2].startswith(
        "slip=0.08 world=default K=1 reps=2 closure=off kf=(0.15,0.5) "
        "P=8 T=16: slam ")
    assert f"| beats {int((se < de).sum())}/2 |" in lines[2]


def test_slam_sweep_batch_equals_its_episodes_one_by_one():
    # The episodes wander as one batch on each episode's own draws: the
    # same as each episode alone from its generator.
    args = slam_sweep.parser().parse_args(
        ["--device", "cpu", "--episodes", "3", "--ticks", "24"])
    world, m = slam_sweep.sweep_world(args, "cpu")
    enc, scans, truth = slam_sweep.episodes_at(0.08, args, m, world)
    from montecarlolocalisation_tpu_torch.sim import robot

    for ep in range(3):
        gen = torch.Generator()
        gen.manual_seed(7919 * ep + 13)
        one = robot.generate_wander_episode(
            gen, m, world.cfg, world.angles, 24, start_pose=slam_sweep.START,
            slip_noise=0.08, explore=True)
        for got, want in zip((enc, scans, truth), one):
            assert torch.equal(got[ep], want[0])


@pytest.mark.parametrize("extra", [
    ["--world", "rooms4x4:3", "--map-est", "rerender"],
    ["--map-est", "consensus", "--closure", "--candidates", "2"]])
def test_slam_sweep_worlds_and_map_estimates(extra):
    lines = run_main(slam_sweep, [
        "--device", "cpu", "--episodes", "2", "--ticks", "12",
        "--particles", "8", "--slip", "0.03", *extra])
    assert len(lines) == 1
    m = re.search(r"F1 (\S+) \(min (\S+)\)", lines[0])
    assert 0.0 <= float(m.group(2)) <= float(m.group(1)) <= 1.0
    assert ("world=rooms4x4:3" in lines[0]) == ("--world" in extra)


def test_slam_sweep_rejects_a_malformed_world():
    with pytest.raises(SystemExit):
        slam_sweep.main(["--device", "cpu", "--world", "rooms6x6"])


def test_explore_sweep_slot_replays_each_world_as_a_fresh_map():
    argv = ["--device", "cpu", "--maps", "2", "--seeds-per-map", "1",
            "--ticks", "32", "--chunk", "16", "--particles", "8", "--rows",
            "4", "--cols", "4", "--arms", "wander", "frontier"]
    lines = run_main(explore_sweep, argv)
    assert len(lines) == 3
    out = json.loads(lines[-1])
    # One wander, one SLAM and one explore graph for both worlds.
    assert out["captures"] == 3
    assert {"wander_cov@16", "wander_cov@32", "frontier_f1",
            "frontier_wins_final_cov", "wander_reach0.9_ticks_med"} <= set(out)
    # World 1 on a map of its own gives the line the slot gave.
    args = explore_sweep.parser().parse_args(argv)
    from montecarlolocalisation_tpu_torch.config import (MappingConfig,
                                                         SLAMConfig)
    from montecarlolocalisation_tpu_torch.maps import from_walls, generator

    m = from_walls(generator.generate_rooms(4, 4, seed=1001), device="cpu")
    fcfg = FilterConfig(num_particles=8)
    scfg = SLAMConfig(num_particles=8, mapping=MappingConfig(
        height=m.height, width=m.width), sensor=fcfg.sensor,
        motion=fcfg.motion, keyframe_trans=0.10, keyframe_rot=0.35)
    angles = np.deg2rad(np.linspace(-118.0, 118.0, 24)).astype(np.float32)
    walls = m.walls.numpy()
    wcv, wf1 = explore_sweep.coverage_curve_wander(
        m, walls, scfg, fcfg, angles, 8, 7919, args, 2)
    fcv, ff1 = explore_sweep.coverage_curve_frontier(
        m, walls, scfg, angles, 8, 7919, args, 2)
    assert lines[1].startswith(
        f"map 1 seed 0: wander cov {wcv[-1]:.3f} F1 {wf1:.3f} | "
        f"frontier cov {fcv[-1]:.3f} F1 {ff1:.3f}  [")


def test_load_world_refuses_another_shape():
    from montecarlolocalisation_tpu_torch.maps import from_walls, generator

    slot = from_walls(generator.generate_maze(4, 4, seed=1), device="cpu")
    other = from_walls(generator.generate_maze(5, 4, seed=1), device="cpu")
    with pytest.raises(ValueError, match="shape"):
        explore_sweep.load_world(slot, other)
    same = from_walls(generator.generate_maze(4, 4, seed=2), device="cpu")
    explore_sweep.load_world(slot, same)
    assert torch.equal(slot.walls, same.walls)
    assert torch.equal(slot.occ_dilated, same.occ_dilated)


def test_bench_fleet_lines():
    lines = run_main(bench_fleet, ["--device", "cpu", "--robots", "1", "2",
                                   "--particles", "64", "--ticks", "2",
                                   "--pipeline"])
    rows = [json.loads(v) for v in lines]
    jax_keys = ["robots", "particles", "beams", "pipeline", "tick_ms",
                "fleet_rate_hz", "robot_ticks_per_sec", "serves_10hz"]
    for r, row in zip((1, 2), rows):
        assert list(row)[:8] == jax_keys
        assert (row["robots"], row["particles"], row["beams"],
                row["pipeline"]) == (r, 64, 34, True)
        assert row["device_ms"] is None and row["device"] == "cpu"


def test_bench_slam_lines():
    lines = run_main(bench_slam, ["--device", "cpu", "--particles", "8",
                                  "--ticks", "8", "--fleet", "2",
                                  "--iters", "1"])
    assert re.fullmatch(r"P=   8 49x49px map: 8 ticks in \S+s -> \S+ SLAM "
                        r"ticks/s \(compile\+first \S+s\)", lines[0])
    assert re.fullmatch(r"fleet 2 x P=64 49x49px: 16 robot-ticks in \S+s "
                        r"-> \S+ SLAM robot-ticks/s \(compile\+first \S+s\)",
                        lines[1])
    big = run_main(bench_slam, ["--device", "cpu", "--particles", "8",
                                "--ticks", "8", "--fleet", "0", "--iters",
                                "1", "--map-px", "57", "61"])
    assert len(big) == 1 and "57x61px" in big[0]


def test_bench_mapping_explored_share_equals_map_episode():
    lines = run_main(bench_mapping, ["--device", "cpu", "--episodes", "2",
                                     "--ticks", "8", "--iters", "1"])
    assert len(lines) == 3 and lines[0].startswith("sim ")
    cfg = FilterConfig(num_particles=64)
    angles = np.deg2rad(np.linspace(-118, 118, 34)).astype(np.float32)
    m = presets.make_world(device="cpu").maze
    enc, scans, poses = episodes.simulate_episode_batch(
        presets._gen(0, "cpu"), m, cfg, angles, 8, 2,
        start_pose=(2.05, 2.05, 0.0))
    from montecarlolocalisation_tpu_torch.config import MappingConfig

    lo = mapping.map_episode(poses, scans, angles, MappingConfig(),
                             cfg.sensor)
    share = float(torch.mean((torch.abs(mapping.fuse_maps(lo)) > 0.5
                              ).float()))
    assert lines[1].startswith("2 mappers x 8 ticks x 34 beams: ")
    assert lines[1].endswith(f"explored_frac={share:.3f}")
    assert lines[2].startswith("graphs built 1, pool ")
    assert lines[2].endswith("max_memory_allocated n/a")


def test_slam_scale_lines():
    lines = run_main(slam_scale, ["--device", "cpu", "--particles", "8",
                                  "--worlds", "6x6", "8x6", "--iters", "1",
                                  "--ticks-per-dispatch", "2"])
    assert len(lines) == 2
    assert re.fullmatch(r"world 6x6 \(49x49px\) P=   8: +\S+ ms/tick \| "
                        r"maps +0\.1 MiB \| n/a \| field windowed=False "
                        r"\(\d+px\)", lines[0])
    assert lines[1].startswith("world 8x6 (65x49px) P=   8:")


def test_bench_matrix_runs_each_config_through_the_port_bench(monkeypatch):
    tiny = [("tiny fixed", ["--particles", "64", "--beams", "8", "--iters",
                            "1", "--scan-chunk", "1", "--ray-mode",
                            "fixed"]),
            ("tiny log", ["--particles", "32", "--beams", "6", "--iters",
                          "1", "--scan-chunk", "2", "--beam-combine",
                          "log"])]
    monkeypatch.setattr(bench_matrix, "CONFIGS", tiny)
    lines = run_main(bench_matrix, ["--device", "cpu"])
    assert len(lines) == 2 + 2 + 2
    for (name, args), line in zip(tiny, lines):
        assert line.startswith(f"{name}: ")
        row = json.loads(line[len(name) + 2:])
        assert row["metric"].endswith("_cpu") and row["device"] == "cpu"
        assert row["particles"] == int(args[1])
    assert lines[2] == "| Config | Args | Result | Wall (s, incl. compile) |"
    assert lines[4].startswith("| tiny fixed | `--particles 64 ")
    # The eight configurations are the JAX tool's.
    sys.path.insert(0, TOOLS)
    try:
        jax_matrix = importlib.import_module("bench_matrix")
    finally:
        sys.path.remove(TOOLS)
    assert bench_matrix.table([("a", "b", "c", 1.0)]).splitlines()[-1] == \
        "| a | `b` | `c` | 1.0 |"
    monkeypatch.undo()
    assert bench_matrix.CONFIGS == jax_matrix.CONFIGS
