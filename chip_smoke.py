#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

Builds the port's hand-written kernels from montecarlolocalisation_tpu_torch/
csrc, holds each against its plain PyTorch version on the card, then drives
the filter through the entry points a user calls:

- one filter: the JSONL server (MCLServer) at 1,048,576 particles x 34
  beams with the closed-form caster and systematic resampling, and
  run_episode at 65,536 x 12 with the fixed march and multinomial
  resampling;
- a batch of episodes: the sweep preset (presets.run_sweep) at 1024
  episodes x 500 particles x 24 beams x 300 ticks, fixed march, systematic
  resampling, and the fleet server (MCLFleetServer) at 64 robots x 1500 x
  34 for 20 frames;
- the layout A/B of the two episode-batched beam weight kernels (K1
  batched against K4) in device time, the port's counterpart of
  tools/ab_beamsub.py;
- the production schedule: (a) the sweep at 512 x 500 x 24 x 300 with
  the ESS gate at 0.5 and 2 rounds of gradient refinement (raises below
  0.95 converged or alias-converged, or above 0.15 m alias RMSE); (b) the
  elastic server, MCLServer with the KLD budget on [1024, 65,536], the
  ESS gate and refinement over 96 wander frames with a kidnap at frame 64,
  every other frame a raw LaserScan, and a checkpoint whose restore must
  repeat the next 10 replies exactly; (c) the server at 1,048,576 x 34
  under the ESS gate;
- sweeps over randomized maps (parallel/episodes.run_multimap_sweep, each
  episode on its own map of a stack, K1 batched reading one raster per
  episode): the published JAX row, 64 mixed maps x 2 episodes x 150
  ticks at 500 x 24 (converged 0.6016 on the TPU; raises below 0.47), and
  the full width, 512 mixed maps x 2 episodes = 1024 x 500 x 24 x 300,
  fixed, systematic, where K1 batched's map-stack form, K2 batched and K3
  batched must launch once a tick;
- an imported map: a generated 32 x 32-cell maze exported as a
  map_server YAML + PGM, reloaded through presets.make_world and
  localised by the localisation preset at 1500 x 24 (its raster in the
  device-memory form), then tracked with its origin kept (keep_origin);
- the CLI's localisation, moving, planning, challenge, mapping and slam
  presets, each line well-formed and finite; and the port's copy of the
  replay fixture replayed by 64 replicas of 500 particles with the DDA
  caster (raises if no replica ends confident within 0.2 m of the truth);
- the control stack (sim/closed_loop, the planners, the simulators): (a)
  the published closed-loop row, 64 episodes x 400 ticks x 500 x 24,
  fixed, multinomial, along the planning preset's 4-waypoint BFS plan
  (median 4/4 and 70 % complete on the TPU; raises below 50 % complete);
  (b) the same at 1024 episodes, where K1 batched and K3 batched must
  replay once a tick and, by the profiler's count, launch once a tick in
  one replay, an eager closed-loop tick must not synchronize with the
  host, and 16 ticks through the graphs must equal the same ticks run
  eagerly bit for bit (states, both generators, every output); (c)
  presets.run_planning (1500 x 24, 800 ticks) and run_challenge (2000
  ticks, 17 driven waypoints), K1 and K3 replayed once a tick (one
  episode is chaotic: only a malformed or non-finite result raises); (d)
  the host-driven simulators on the card with the JAX suite's checks
  (execute_plan's square loop, one drive for a straight subgoal plan,
  run_align centring the robot); each run's device busy share over one
  graph replay;
- mapping and RBPF SLAM (models/mapping, models/slam, their presets,
  servers and the render tool): (a) the published SLAM row, 16 wander
  episodes x 4 replicas x 128 particles x 1000 ticks at 24 beams, 8 %
  slip, keyframes 0.15 m / 0.5 rad, as one [16, 4] state (explored-edge
  F1 0.798 to 0.853 and 12 to 15 of 16 episodes beating dead reckoning on
  the TPU; raises below a mean F1 of 0.75 or 10 of 16, or unless the
  inverse sensor model's kernel (csrc/ism.cu) replayed once a tick), the
  ISM's share of its tick, and at the row's shape the kernel equal to
  the plain torch form bit for bit with every map painted and the
  keyframe gate mixed and closed, its input untouched, and timed against
  it; (b) a [4] x 128 state with K = 3 candidates, keyframes and the
  closure: 16 ticks through the graphs equal to the same ticks eager bit
  for bit, no host sync in an eager tick, the beam-accumulated map
  update equal to the one-shot form and to the kernel; (c)
  run_mapping (8 x 600 from true poses, raises below F1 0.95; and from
  dead-reckoned poses at 3 % slip) and run_slam at the CLI's defaults
  with the mission, K3 batched replayed once a reloc and track tick and
  K1 and K3 once a mission tick, each audited with the profiler; (d)
  SLAMServer over 200 frames equal to run_slam_episode bit for bit, with
  3 replicas, export_map read back, and a 4-robot SLAMFleetServer whose
  robots equal their standalone servers bit for bit; (e) the CLI's
  mapping and slam lines and `serve --slam-serve` (one robot and two),
  the replica server's `stats` counting its replicas and `--particles 16`
  serving 128 SLAM particles, as the JAX CLI does;
  (f) the render tool on its three sources;
- calibration, frontier exploration and profiling: (a) the calibrate
  preset (raises unless the wheel constants are within 2 % and 5 % and
  sigma within 15 %, or unless its 500 and 400 epochs ran as CUDA graph
  replays, none eagerly); (b) the slam preset with the frontier explorer
  at the CLI's defaults and the mission (raises if the coverage ever
  falls or does not grow, unless one explore graph served every phase,
  or unless K3 batched replayed once a reloc and track tick), the
  hybrid explorer at 1920 ticks and the mission on its map (raises
  unless a mission is planned and K1 and K3 replayed once a mission
  tick), then the hybrid policy and the wall follower at 3 phases; (c)
  the stage knockout of the filter tick at 1,048,576 x 34 and 65,536 x
  12 (raises unless K1, K2 where the resampler is systematic, and K3
  replayed once a replay of every variant that keeps their stage), and
  a profiler trace of one replay;
- multi-GPU (parallel/distributed, parallel/multihost) at world size 1
  under NCCL, every collective a real NCCL call captured in the graphs:
  (a) make_sharded_step at 1,048,576 x 34 (analytic, systematic, sum) in
  8-tick graphs against mcl_step's on the same draws (>= 99.9 % of rows
  within 1e-5, confidence and best pose within 1e-4, n_injected equal),
  K1 replayed once a tick and audited, and the ms a tick of both; (b)
  make_sharded_step_batched at 1024 x 500 x 24 (fixed, systematic) for 16
  ticks against run_episode_batch, K1 batched once a tick; (c)
  slam_step_sharded at 128 particles x 49 x 49 px for 16 ticks against
  slam_step, the ISM kernel once a tick; (d) run_multihost_episode_batch at 1024 x 500 x 24 x 300
  from its own draws, bit for bit equal to run_episode_batch from the
  same seed (raises below 0.65 converged), K1, K2 and K3 batched
  replayed once a tick; (e) the production configuration (ESS
  0.5, one round of refinement) through (a)'s step for 8 ticks;
- the study tools (montecarlolocalisation_tpu_torch/tools/, the root
  tools/ scripts' counterparts), each tool's main once at full width and
  small depth: convergence_study (64 x 500 x 60, and 8 episodes with 2
  rounds of refinement), reloc_sweep (16 episodes x 8 replicas x 1500 on
  the half-explored maze), slam_sweep (2 episodes x 4 replicas x 128 x
  200), explore_sweep (2 worlds, 480 ticks, every world in one map's
  buffers: 3 graphs built), bench_fleet (64 robots), bench_slam,
  bench_mapping, slam_scale and coverage_bound; every number they print
  finite, each kernel family audited against the profiler on the first
  run that launches it, the SLAM and mapping tools the ISM kernel alone;
  then
  bench_matrix's 10k x 360 analytic and 4M x
  34 rows, one dispatch each, after K1 at 360 beams (0.0 max-abs error),
  K2 at 4,000,000 rows (bit-exact) and K3 at 4,000,000 points (centers
  within 1e-4) are held against their plain versions;
- the compiled tick (models/compiled, CUDA graphs of mcl_step), graph
  against eager: every entry point above runs its ticks as graph replays,
  and the graphs phase runs each configuration from one state and one
  generator state through eager ticks (the same buffers, the ticks
  called eagerly) and through the graphs, and raises unless the two agree
  bit for bit (states, weights, every output, the generator) or reply for
  reply: 1M x 34 analytic systematic, and under the ESS gate
  (run_episode, checked against mcl_step called tick by tick too, and
  the server), 65,536 x 12 fixed multinomial, the CLI serve at 1500 x 24,
  the fleet at 64 x 1500 x 34 synchronous and pipelined, the sweep and
  the full-width multimap sweep at 1024 x 500 x 24 (wander and filter
  timed apart), path (a) and path (b).  It times each eager against
  graph, profiles one replay of each episode graph (its kernels, its
  device time against its wall time), runs the bench at --scan-chunk 1
  and 8, and raises if one eager tick of the 1M, 65,536, sweep or path
  (a) configuration synchronizes with the host.  In every configuration
  it runs the graphs once more under torch.profiler and raises unless
  the port's kernels that the card ran, family by family, equal the
  launches the wrappers' and the C entries' counters claim (a replay
  adds its capture's counts: this holds them against the card), and it
  raises if a second multimap sweep on the same stack builds a graph.

Every phase prints one JSON line; any failure raises, so the exit code is
non-zero and no result line appears.  It needs one CUDA card and fails
without one.

The kernel checks hold K1, K1 batched and K4 to 0.0 max-abs error (also on
rays parallel to the gridlines, bands across a 32-bit word boundary, a
241 x 241 px maze and, for K1, a 4 m range; K4 with 5 to 34 beams on 1
to 1024 episodes of 1 to 1500 particles, where its plan takes each of 1,
2, 4 and 8 threads a particle, and with every one of them forced, to the
same bits), K3 and K3 batched to 1e-4 on
the centers at odd sizes on both of their paths, as one device launch a
call that repeats itself bit for bit, with a batch equal to its episodes
run one by one, and K2 and K2 batched bit for bit, on CDFs glitched one
ulp non-monotone, short, overshooting, owned by one source or with a long
run of sources without offspring, on both of their paths (one device launch a call in one
block an episode, two over source tiles), with a batch equal to its
episodes.

F1: K1, K1 batched and K4 also hold 0.0 max-abs error on random mazes
whose rasters do not fit a block's shared memory (the smallest such
square maze for each ray mode, and one twice its side), where they read
the raster's bit words from a device buffer; the two raster forms give
the same bits on rasters that fit both, and their device times set the
size at which ops/weights switches forms.  F2: K1 batched, K4, K2
batched and K3 batched at 65,543 episodes, past one grid's 65,535 along y,
equal their plain versions.  K1 batched's map-stack form holds 0.0
max-abs error and equals single-map launches map by map: stacks of 1, 64
and 512 mixed maps at E = 2 M, both ray modes, combines and raster forms,
random mazes past shared memory, and E = 65,543 with the map index
changing across the chunk boundary.

Output, in order: the card (nvidia-smi name and power limit), the build,
the kernel checks (F1 and F2 among them), the serve phase, the entry
config, the kernel-vs-plain tick, the kernel times, the sweep, the two
randomized-map sweeps, paths (a), (b) and (c), the fleet, the imported
map, the CLI, the replay, the control stack, mapping and SLAM,
calibration, exploration and profiling, the graphs phase, the multi-GPU
phase, the study tools, a device profile of one
filter's eager tick at the serve's shapes and of one batched eager tick at
the sweep's and the fleet's, the
layout A/B, the batched kernels' times (the map-stack form's against
single-map K1 batched in device time), the two raster forms' device
times, a {"kernels": [...]} line, the card again, and last {"ok": true,
"device": {...}}.  In the kernels line, "launches" counts every launch on
the kernel's main path (a graph's warm-up tick and its replays),
"replayed" the launches inside CUDA graph replays,
"distributed_launches" the launches of the multi-GPU phase's paths and
"tools_launches" those of the study tools' runs.

Usage: python3 chip_smoke.py
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

from montecarlolocalisation_tpu_torch import bench, presets
from montecarlolocalisation_tpu_torch.bench import card
from montecarlolocalisation_tpu_torch.config import (
    DIR_DOWN, DIR_LEFT, DIR_RIGHT, DIR_UP, WALL_LEFT, WALL_TOP, FilterConfig,
    ResampleConfig, SensorModelConfig, SLAMConfig,
)
from montecarlolocalisation_tpu_torch.io.fleet import (
    MCLFleetServer, SLAMFleetServer,
)
from montecarlolocalisation_tpu_torch.io.logs import EpisodeLog
from montecarlolocalisation_tpu_torch.io.server import MCLServer, SLAMServer
from montecarlolocalisation_tpu_torch.maps import (
    from_walls, generator, pgm, repeat_maps, select_maps, stack_maps,
)
from montecarlolocalisation_tpu_torch.maps.grid import (
    cell_center, is_valid_pos, lookup, world_to_map,
)
from montecarlolocalisation_tpu_torch.models import filter as mcl
from montecarlolocalisation_tpu_torch.models import (
    calibrate, compiled, mapping, motion, raycast, refine, resample, sensor,
    slam,
)
from montecarlolocalisation_tpu_torch.models.raycast import march_steps
from montecarlolocalisation_tpu_torch.ops import analytic, build, expand
from montecarlolocalisation_tpu_torch.ops import ism, kmeans, weights
from montecarlolocalisation_tpu_torch.ops import refine as refine_kernels
from montecarlolocalisation_tpu_torch.parallel import episodes
from montecarlolocalisation_tpu_torch.planning import bfs
from montecarlolocalisation_tpu_torch.sim import (
    align_sim, closed_loop, frontier, plan_exec, robot,
)
from montecarlolocalisation_tpu_torch.utils import profiling
from montecarlolocalisation_tpu_torch.utils.profiling import device_ms

SERVE_N, SERVE_B, SERVE_TICKS = 1_048_576, 34, 20
ENTRY_N, ENTRY_B, ENTRY_TICKS = 65_536, 12, 50
SWEEP_E, SWEEP_N, SWEEP_B, SWEEP_T = 1024, 500, 24, 300
# Path (a)'s episodes: half the sweep's 1024 since the SLAM phases joined
# the run (its published cell's shares do not depend on the count).
PROD_E = 512
FLEET_R, FLEET_N, FLEET_B, FLEET_TICKS = 64, 1500, 34, 20
AB_E, AB_SIZES, AB_B = 64, (500, 768, 2000), 24
# The layout A/B's other shapes: the fleet's, and the CLI serve's one filter.
AB_MORE = ((FLEET_R, FLEET_N, FLEET_B), (1, 1500, 24))
K4_TIME_N = 768               # K4's time in the kernels line: an A/B shape
K4_BIG_E = 1024               # K4's second time shape, 1024 x 768 x 24
# K4's own checks: every T of its plan is taken somewhere in this grid.
K4_EPISODES, K4_SIZES, K4_BEAMS = (1, 64, 1024), (1, 127, 768, 1500), (5, 24,
                                                                      34)
# The kernels of one filter's tick, and the batched checks' grids.
SINGLE = ("beam_weights", "systematic_expand", "kmeans")
CHECK_EPISODES, CHECK_SIZES, CHECK_BEAMS = (1, 64, 1024), (1, 500, 1500,
                                                          2000), (24, 34)
# F1: the beam weight kernels on rasters past shared memory; F2: batches
# past one grid's 65,535 episodes along y.
F1_BEAMS = (12, 34)
F2_E = 65_543
# Path (c): the bench config under the ESS gate.  Path (b): the elastic
# server, its frames, the kidnap, the checkpoint and the replayed frames.
ESS = 0.5
ELASTIC = (1024, 65_536)
ELASTIC_FRAMES, KIDNAP_AT, CHECKPOINT_AT, REPLAYED = 96, 64, 20, 10
ELASTIC_PATIENCE = 3
ELASTIC_START = (2.05, 2.05, 0.0)   # the sweep's start
# F1's timing: square random mazes (cells a side) from the default maze's
# size to the largest that fits a block's shared memory.
F1_TIME_CELLS = dict(fixed=(12, 18, 30, 60, 120), analytic=(30, 60, 120,
                                                              240))
# K1 batched's map-stack form: stacks of mixed maps at E = 2 M, and of
# random mazes past shared memory.  The sweeps over randomized maps: the
# published JAX row (maps, episodes a map, ticks) and the full width's
# maps (2 episodes a map).  The imported map, the CLI runs and the replay.
STACK_MAPS, STACK_BIG_MAPS = (1, 64, 512), 2
MULTIMAP_ROW = (64, 2, 150)
MULTIMAP_MAPS = 512
IMPORT_CELLS, IMPORT_N, IMPORT_TICKS = 32, 1500, 200
IMPORT_ORIGIN = (3.2, 1.6)
CLI_RUNS = (
    (["localisation", "--particles", "500", "--ticks", "200"],
     {"preset", "confidence", "best_pose", "true_pose", "position_error_m",
      "songs"}),
    (["moving"], {"preset", "ticks", "distance_m", "final_pose"}),
    (["planning"], {"preset", "plan", "waypoints_reached", "waypoints_total",
                    "final_confidence"}),
    (["challenge"], {"preset", "tsp_gold_cost", "legs",
                     "waypoints_reached"}),
    (["mapping", "--ticks", "200"],
     {"preset", "robots", "ticks_per_robot", "explored_frac", "precision",
      "recall", "f1", "reloc_converged_frac", "reloc_median_error_m",
      "reloc_in_coverage_n", "reloc_in_coverage_frac"}),
    (["slam", "--ticks", "300", "--slam-replicas", "2"],
     {"preset", "particles", "ticks", "slip_noise", "explore_mode",
      "slam_final_err_m", "explored_edge_frac", "precision_explored",
      "recall_explored", "f1_explored", "precision", "recall", "f1",
      "dead_reckon_final_err_m", "reloc_converged_frac",
      "reloc_median_error_m", "reloc_in_coverage_n",
      "reloc_in_coverage_frac", "track_on_learned_frac",
      "track_median_error_m", "track_in_coverage_n",
      "track_in_coverage_frac", "track_to_coverage_edge_frac"}))
# Values that a line writes as null where no episode qualifies (the JAX
# CLI's NaN), and the string-valued keys.
CLI_NULLABLE = {"reloc_median_error_m", "reloc_in_coverage_frac",
                "track_in_coverage_frac", "track_to_coverage_edge_frac"}
CLI_TEXT = {"preset", "songs", "explore_mode"}
REPLAY_REPLICAS = 64
PKG = "montecarlolocalisation_tpu_torch"
# The port's own copy of the replay fixture.
FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), PKG,
                       "data", "replay_6x6.npz")
START = (1.25, 1.25, 0.0)     # the bench's pose, a free spot of the maze
WHEELS = (0.5, 0.45)          # encoder step per tick (rad): a gentle arc
TPU = "montecarlolocalisation_tpu/ops"
# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit): device
# memory rate and float32 outside the tensor cores.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
KERNELS = {
    "beam_weights": dict(
        fn=weights.beam_weights_cuda, source=f"{PKG}/csrc/weights.cu",
        replaces=f"{TPU}/weights_pallas.py:277"),
    "beam_weights_batched": dict(
        fn=weights.beam_weights_batched_cuda,
        source=f"{PKG}/csrc/weights.cu",
        replaces=f"{TPU}/weights_pallas.py:371"),
    "beam_weights_stack": dict(
        fn=weights.beam_weights_stack_cuda,
        source=f"{PKG}/csrc/weights.cu",
        replaces=f"{TPU}/weights_pallas.py:371"),
    "systematic_expand": dict(
        fn=expand.systematic_expand_cuda, source=f"{PKG}/csrc/expand.cu",
        replaces=f"{TPU}/expand_pallas.py:220"),
    "systematic_expand_batched": dict(
        fn=expand.systematic_expand_batched_cuda,
        source=f"{PKG}/csrc/expand.cu",
        replaces=f"{TPU}/expand_pallas.py:220"),
    "kmeans": dict(
        fn=kmeans.kmeans_cuda, source=f"{PKG}/csrc/kmeans.cu",
        replaces=f"{TPU}/kmeans_pallas.py:133"),
    "kmeans_batched": dict(
        fn=kmeans.kmeans_batched_cuda, source=f"{PKG}/csrc/kmeans.cu",
        replaces=f"{TPU}/kmeans_pallas.py:133"),
    "beam_weights_beamsub": dict(
        fn=weights.beamsub_cuda, source=f"{PKG}/csrc/weights.cu",
        replaces=f"{TPU}/weights_pallas.py:576"),
    # Refinement's kernels replace none: the JAX package runs jax.grad on
    # XLA there (montecarlolocalisation_tpu/models/refine.py).
    "refine_grad": dict(
        fn=refine_kernels.refine_grad_cuda, source=f"{PKG}/csrc/refine.cu",
        replaces="none: jax.grad on XLA"),
    "refine_score": dict(
        fn=refine_kernels.refine_score_cuda,
        source=f"{PKG}/csrc/refine.cu", replaces="none: jax.grad on XLA"),
    # The ISM's replaces none: XLA fuses the JAX package's _ism_delta.
    "ism_update": dict(
        fn=ism.ism_update_cuda, source=f"{PKG}/csrc/ism.cu",
        replaces="none: XLA-fused _ism_delta "
                 "(montecarlolocalisation_tpu/models/mapping.py:61)"),
}


def _finite(v):
    return None if isinstance(v, float) and not math.isfinite(v) else v


def say(phase: str, **fields) -> None:
    print(json.dumps(dict(phase=phase, **{k: _finite(v)
                                          for k, v in fields.items()})),
          flush=True)


def reset_counts() -> None:
    for k in KERNELS.values():
        k["fn"].launches = 0
    for name in compiled.replayed:
        compiled.replayed[name] = 0


def counts() -> dict:
    return {name: k["fn"].launches for name, k in KERNELS.items()}


def replay_counts() -> dict:
    """The launches of counts() that ran inside CUDA graph replays."""
    return {name: compiled.replayed[k["fn"].__name__]
            for name, k in KERNELS.items()}


def drive(n_ticks: int):
    """Encoder readings [T, 2] and true poses [T, 3] of a short drive from
    START; the truth follows the encoders through diff_drive_update."""
    cfg = FilterConfig().motion
    f32 = torch.float32
    odom = motion.OdometryState(
        x=torch.tensor(START[0], dtype=f32), y=torch.tensor(START[1], dtype=f32),
        theta=torch.tensor(START[2], dtype=f32),
        encoder_left=torch.tensor(0.0), encoder_right=torch.tensor(0.0))
    enc, truth = [], []
    for t in range(1, n_ticks + 1):
        e = (WHEELS[0] * t, WHEELS[1] * t)
        odom = motion.diff_drive_update(odom, e[0], e[1], cfg)[0]
        enc.append(e)
        truth.append([float(odom.x), float(odom.y), float(odom.theta)])
    return np.float32(enc), np.float32(truth)


def scans(m, truth, angles, cfg: SensorModelConfig, seed: int):
    """Noisy scans [T, B] from the true poses (port's simulate_scan)."""
    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    return torch.stack([sensor.simulate_scan(m, p, angles, cfg, gen=gen,
                                             noise_sigma=0.02).ranges
                        for p in truth])


def cuda_ms(fn, reps: int = 10) -> float:
    """Median over `reps` CUDA-event timings of fn(), after one warm-up."""
    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


# -- phase 3: each kernel against its plain version ------------------------

def steer(parts, kind: str, m, gen):
    """Particles [..., N, 3] set up in place for one of the casts' hard
    cases.  "parallel": headings 0, pi/2, pi, -pi/2 in turn, so that with
    beams at 0 and +-pi/2 some rays run exactly along a gridline axis (the
    |du| < eps branch) and others nearly so.  "word_boundary": origins in
    or beside a gridline at a multiple of 32 px along it, heading nearly
    along it, so the band crosses from one 32-bit word to the next."""
    if kind == "uniform":
        return parts
    n = parts.shape[-2]
    dev = parts.device
    if kind == "parallel":
        turns = torch.tensor([0.0, math.pi / 2, math.pi, -math.pi / 2],
                             device=dev)
        parts[..., 2] = turns[torch.arange(n, device=dev) % 4]
        return parts
    u = lambda: torch.rand(parts.shape[:-1], generator=gen, device=dev)
    span = min(m.height, m.width)
    seams = max(1, (span - 1) // 32)
    cross = (8 * torch.floor(u() * ((span - 1) // 8 + 1)) + 1.5 * u()) \
        * m.resolution
    seam = (32 * torch.floor(1 + u() * seams) + 8 * (u() - 0.5)) \
        * m.resolution
    vertical = u() < 0.5
    parts[..., 0] = torch.where(vertical, cross, seam) + m.origin_x
    parts[..., 1] = torch.where(vertical, seam, cross) + m.origin_y
    parts[..., 2] = (torch.where(vertical, math.pi / 2, 0.0)
                     + torch.where(u() < 0.5, 0.0, math.pi)
                     + 0.6 * (u() - 0.5))
    return parts


def k1_inputs(m, n, nb, cfg, gen, kind: str = "uniform"):
    parts = steer(resample.sample_uniform_particles(gen, m, n), kind, m, gen)
    angles = np.deg2rad(np.linspace(-118.0, 118.0, nb)).astype(np.float32)
    if kind == "parallel":
        angles[:4] = np.float32([0.0, math.pi / 2, -math.pi / 2, math.pi])
    scan = sensor.simulate_scan(m, START, angles, cfg)
    # Two dead lanes: the mask must scale the terms away.
    mask = torch.ones(nb, dtype=torch.bool, device=m.device)
    mask[[1, nb // 2]] = False
    return parts, sensor.Scan(angles=scan.angles, ranges=scan.ranges,
                              mask=mask)


def big_maze(dev):
    """A random 30 x 30-cell maze.  Its 241 x 241 px gridlines take 8
    32-bit words each in the beam weight kernel (the default maze's 49 px
    take 2), and its one-bit raster 7.3 KB."""
    rng = np.random.default_rng(7)
    walls = [[[w for w in (WALL_TOP, WALL_LEFT) if rng.random() < 0.4]
              for _ in range(30)] for _ in range(30)]
    return from_walls(walls, device=dev)


def check_k1(m, gen) -> dict:
    """0.0 max-abs error in every case: the kernel repeats the plain
    version's float operations in its order (-fmad=false), and its bit-word
    search returns the pixel loop's row.  Cases: both maze sizes, both ray
    modes and both combines, uniform particles, rays parallel to the
    gridlines, bands across a 32-bit word boundary, and a 4 m range, whose
    bands of up to 42 px the kernel searches word by word."""
    cases = [(m, n, nb, mode, comb, "uniform", 1.0)
             for n in (1000, 65_536, 1_048_576) for nb in (12, 34)
             for mode in ("fixed", "analytic") for comb in ("sum", "log")]
    big = big_maze(m.device)
    cases += [(big, 65_536, 34, mode, comb, "uniform", 1.0)
              for mode in ("fixed", "analytic") for comb in ("sum", "log")]
    cases += [(maze, 65_536, 34, mode, comb, kind, 1.0)
              for maze in (m, big) for kind in ("parallel", "word_boundary")
              for mode in ("fixed", "analytic") for comb in ("sum", "log")]
    cases += [(maze, 65_536, 34, mode, comb, "uniform", 4.0)
              for maze in (m, big) for mode in ("fixed", "analytic")
              for comb in ("sum", "log")]
    worst = 0.0
    for maze, n, nb, mode, comb, kind, max_range in cases:
        cfg = SensorModelConfig(ray_mode=mode, beam_combine=comb,
                                max_range=max_range)
        parts, scan = k1_inputs(maze, n, nb, cfg, gen, kind)
        got = weights.beam_weights_cuda(maze, parts, scan, cfg)
        want = weights.beam_weights_plain(maze, parts, scan, cfg)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        worst = max(worst, err)
        say("check", kernel="beam_weights", raster=list(maze.occ.shape),
            n=n, beams=nb, ray_mode=mode, combine=comb, particles=kind,
            max_range=max_range, max_abs_err=err,
            share_close=_close_share(got, want, comb))
        if not (err == 0.0 and torch.isfinite(got).all()):
            raise AssertionError(f"K1 {mode}/{comb} {kind} n={n} b={nb} "
                                 f"max_range={max_range} "
                                 f"raster {tuple(maze.occ.shape)}: "
                                 f"max-abs error {err}")
    return dict(max_abs_err=worst)


def skewed_cdf(n, gen, dev, batch=()):
    """Heavily skewed CDFs [*batch, n], half the weights zero, accumulated
    in float64 as the filter accumulates them."""
    shape = tuple(batch) + (n,)
    w = torch.rand(shape, generator=gen, device=dev) ** 8
    w[torch.rand(shape, generator=gen, device=dev) < 0.5] = 0.0
    total = w.sum(-1, keepdim=True)
    w = torch.where(total > 0, w / total, 1.0 / n)
    return torch.cumsum(w.double(), -1).float()


# K2's sizes: odd ones, both sides of one filter's one-block limit, and the
# serve and bench sizes; its cdf kinds and offsets.  "on_integers" (n a power of
# two) lands every n * cdf - u0 on an integer, so each threshold ties.
K2_SIZES = (1, 2, 255, 1000, expand.SMALL_N, expand.SMALL_N + 1, 65_536,
            1_048_576, 4_194_304)
K2_KINDS = ("uniform", "skewed", "glitched", "short", "overshoot",
            "one_source", "zero_prefix", "zero_run")
K2_U0 = (0.0, 0.5, 0.99999994)
# K2 batched: the sweep's and the fleet's shapes, one block an episode at
# the limit, and two launches past it and at 8 x 65,536.
K2_BATCHED_SHAPES = ((SWEEP_E, SWEEP_N), (FLEET_R, FLEET_N),
                     (64, expand.SMALL_N), (64, expand.SMALL_N + 1),
                     (8, 65_536))


def offspring(x, n, u0):
    """The offspring count of cdf values x, as both versions compute it."""
    return torch.clamp(torch.floor(n * x - u0).to(torch.int32) + 1, 0, n)


def count_edge(x, n, u0):
    """The smallest float32 y <= x (x >= 0) with x's count, elementwise: a
    binary search on the bit patterns, which order like the floats."""
    want = offspring(x, n, u0)
    lo = torch.zeros_like(x, dtype=torch.int32)
    hi = x.contiguous().view(torch.int32).clone()
    for _ in range(32):
        mid = (lo + hi) // 2
        same = offspring(mid.view(torch.float32), n, u0) == want
        hi, lo = torch.where(same, mid, hi), torch.where(same, lo, mid + 1)
    return hi.view(torch.float32)


def k2_cdf(kind, n, u0, gen, dev, batch=()):
    """CDFs [*batch, n] of one kind for offsets u0 [*batch]: "glitched" is
    one ulp non-monotone at about one position in 1000, and at the first
    step of the counts from the middle on: where the count steps up at i,
    cdf_i moves down to the float where it steps and cdf_{i+1} to one ulp
    below that, so the counts fall there until the cummax guard lifts
    them; "short" sums
    to 0.97; "overshoot" ends a few ulps past 1; "one_source" gives every
    draw to source n // 3; "zero_prefix" gives none to the first 60 %, and
    "zero_run" none to the middle 60 % (at 1M, a run that no output's
    window of sources may span without the kernel searching instead)."""
    shape = tuple(batch) + (n,)
    rand = lambda: torch.rand(shape, generator=gen, device=dev)
    cum = lambda w: torch.cumsum(
        (w / w.sum(-1, keepdim=True)).double(), -1).float()
    if kind == "skewed":
        return skewed_cdf(n, gen, dev, batch)
    if kind == "one_source":
        cdf = torch.zeros(shape, device=dev)
        cdf[..., n // 3:] = 1.0
        return cdf
    if kind in ("zero_prefix", "zero_run"):
        w = rand()
        lo = 0 if kind == "zero_prefix" else n // 5
        w[..., lo: lo + 3 * n // 5] = 0.0
        return cum(w)
    cdf = cum(rand())
    if kind == "uniform":
        return cdf
    if kind == "short":
        return cdf * 0.97
    if kind == "overshoot":
        tail = min(n, 8)
        cdf[..., -tail:] = 1.0 + torch.arange(1, tail + 1, device=dev) \
            * 2.0 ** -23
        return cdf
    if kind == "glitched":
        uu = torch.as_tensor(u0, dtype=torch.float32, device=dev)[..., None]
        c = offspring(cdf, n, uu)
        steps = (c > torch.nn.functional.pad(c[..., :-1], (1, 0))) & (c >= 1)
        steps[..., -1] = False
        i = torch.arange(n, device=dev)
        first = torch.argmax((steps & (i >= n // 2)).int(), -1, keepdim=True)
        at = steps & ((rand() < 1e-3) | (i == first))
        at[..., 1:] &= ~at[..., :-1]
        edge = count_edge(cdf, n, uu)
        out = torch.where(at, edge, cdf)
        below = torch.nextafter(edge, torch.zeros_like(edge))
        out[..., 1:] = torch.where(at[..., :-1], below[..., :-1],
                                   out[..., 1:])
        return out
    raise ValueError(kind)


def integer_cdf(n, u0, gen, dev):
    """For n a power of two: cdf_i = (m_i + u0) / n with m sorted, so n *
    cdf - u0 is the integer m_i exactly and each threshold ties."""
    m = torch.sort(torch.randint(0, n, (n,), generator=gen,
                                 device=dev)).values
    m[-1] = n - 1
    return (m.float() + u0) / n


def k2_rows(shape, gen, dev):
    """Particles whose first column is their own index, so a wrong draw
    names its source."""
    parts = torch.randn(tuple(shape) + (3,), generator=gen, device=dev)
    parts[..., 0] = torch.arange(shape[-1], device=dev, dtype=torch.float32)
    return parts


def run_k2(fn, parts, cdf, u0) -> tuple:
    """One K2 call, run twice: (output, device launches a call), checked to
    repeat itself bit for bit and to launch as its plan says."""
    before = expand.device_launches()
    out = fn(parts, cdf, u0)
    launched = expand.device_launches() - before
    again = fn(parts, cdf, u0)
    torch.cuda.synchronize()
    plan = expand.launch_plan(parts.shape[-2], parts.numel() // parts.shape[
        -2] // parts.shape[-1])
    if launched != plan.device_launches:
        raise AssertionError(f"K2 n={parts.shape[-2]}: {launched} device "
                             f"launches, plan {plan}")
    if not torch.equal(out, again):
        raise AssertionError(f"K2 n={parts.shape[-2]}: two runs differ")
    return out, launched


def k2_mismatch(got, want) -> str:
    bad = (got != want).any(-1).reshape(-1).nonzero()
    k = int(bad[0])
    g, w = got.reshape(-1, 3)[k], want.reshape(-1, 3)[k]
    return (f"first wrong output {k}: source {g[0].item()} instead of "
            f"{w[0].item()}, {int(bad.numel())} wrong")


def check_k2(dev, gen) -> dict:
    """Bit-exact against the plain version (the expansion only copies
    rows): every size of K2_SIZES, every cdf kind and offset, and the
    integer-landing cdfs; one device launch a call in one block an
    episode, two otherwise; each call repeats itself."""
    for n in K2_SIZES:
        parts = k2_rows((n,), gen, dev)
        cases = [(kind, u0) for kind in K2_KINDS for u0 in K2_U0]
        if n & (n - 1) == 0:
            cases += [("on_integers", u0) for u0 in (0.0, 0.25, 0.5)]
        pinned = 0
        for kind, u0 in cases:
            uu = torch.tensor(u0, dtype=torch.float32, device=dev)
            cdf = integer_cdf(n, u0, gen, dev) if kind == "on_integers" \
                else k2_cdf(kind, n, uu, gen, dev)
            falls = bool((offspring(cdf[1:], n, uu)
                          < offspring(cdf[:-1], n, uu)).any())
            pinned += falls
            if kind == "glitched" and n >= 255 and not falls:
                raise AssertionError(f"K2 n={n}: the glitch moved no count")
            got, launched = run_k2(expand.systematic_expand_cuda, parts, cdf,
                                   uu)
            want = expand.systematic_expand_plain(parts, cdf, uu)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K2 n={n} {kind} u0={u0}: not "
                                     f"bit-exact; {k2_mismatch(got, want)}")
        say("check", kernel="systematic_expand", n=n, cases=len(cases),
            kinds=sorted({k for k, _ in cases}), u0=list(K2_U0),
            bit_exact=True, repeats=True, device_launches_per_call=launched,
            one_block=expand.launch_plan(n).one_block,
            cases_with_falling_counts=pinned)
    return dict(max_abs_err=0.0)


def check_k2_strided(dev, gen) -> None:
    """K2 and K2 batched through systematic_expand on a cdf that is a
    strided view and a scalar u0, which the dispatcher broadcasts with
    stride 0 to a batch: the wrapper copies both before its launch, and
    each copy must live until the kernel has read it.  Bit-exact against
    the plain version on contiguous copies."""
    for lead, n in (((), 1000), ((), expand.SMALL_N + 1), ((4,), 1000),
                    ((4,), expand.SMALL_N + 1)):
        parts = k2_rows(lead + (n,), gen, dev)
        wide = torch.stack([skewed_cdf(n, gen, dev, lead),
                            torch.zeros(lead + (n,), device=dev)], -1)
        cdf = wide[..., 0]
        u0 = torch.tensor(0.5, device=dev)
        got = expand.systematic_expand(parts, cdf, u0)
        want = expand.systematic_expand_plain(parts, cdf.contiguous(), u0)
        torch.cuda.synchronize()
        if cdf.is_contiguous() or not torch.equal(got, want):
            raise AssertionError(f"K2 strided {lead} x {n}: not bit-exact; "
                                 f"{k2_mismatch(got, want)}")
        say("check", kernel="systematic_expand", shape=list(parts.shape),
            cdf_stride=list(cdf.stride()), u0="scalar", bit_exact=True)


def blobs(n, gen, dev):
    """Three Gaussian blobs in the maze (a multimodal particle cloud)."""
    centers = torch.tensor([[1.2, 1.2], [3.6, 2.0], [2.0, 4.0]], device=dev)
    pick = torch.randint(0, 3, (n,), generator=gen, device=dev)
    return centers[pick] + 0.3 * torch.randn((n, 2), generator=gen,
                                             device=dev)


def run_k3(fn, xy, c0, rs):
    """One K3 call, checked to be one device launch and to repeat itself
    bit for bit: (centers, assignments)."""
    before = kmeans.device_launches()
    c1, a1 = fn(xy, c0, rs)
    launched = kmeans.device_launches() - before
    c2, a2 = fn(xy, c0, rs)
    torch.cuda.synchronize()
    if launched != 1:
        raise AssertionError(f"K3: {launched} device launches in one call")
    if not (torch.equal(c1, c2) and torch.equal(a1, a2)):
        raise AssertionError("K3: two runs of one call differ")
    return c1, a1


def k3_against_plain(fn, xy, c0, rs, **case) -> float:
    """Centers within 1e-4; > 99.9 % of assignments equal (float sums in
    another order can move a point that sits on a boundary)."""
    c1, a1 = run_k3(fn, xy, c0, rs)
    c2, a2 = kmeans.kmeans_plain(xy, c0, rs)
    torch.cuda.synchronize()
    err = (c1 - c2).abs().max().item()
    share = (a1 == a2).float().mean().item()
    plan = kmeans.launch_plan(xy.shape[-2], xy.shape[0] if xy.dim() == 3
                              else 1)
    say("check", kernel=fn.__name__.replace("_cuda", ""), **case,
        one_block=plan.one_block, device_launches=1, repeats=True,
        max_abs_err=err, share_close=share)
    if not (err <= 1e-4 and share > 0.999):
        raise AssertionError(f"K3 {case}: centers {err}, assign {share}")
    return err


# K3 sizes: odd ones, both sides of the one-block limit, and the serve and
# bench sizes; xy is the [:, :2] view of [n, 3] rows, as the filter passes.
K3_SIZES = (1, 255, 1000, kmeans.BLOCK_MAX_N, kmeans.BLOCK_MAX_N + 1, 65_536,
            1_048_576, 4_194_304)


def check_k3(dev, gen) -> tuple:
    """K3 and K3 batched (one episode) at every size of K3_SIZES, the latch
    firing at iteration 0, and the empty-cluster reseed, on both paths."""
    worst = dict(kmeans=0.0, kmeans_batched=0.0)
    for n in K3_SIZES:
        rows = torch.cat([blobs(n, gen, dev),
                          torch.randn((n, 1), generator=gen, device=dev)], 1)
        xy = rows[:, :2]
        c0 = xy[torch.randint(0, n, (3,), generator=gen, device=dev)]
        rs = xy[torch.randint(0, n, (20, 3), generator=gen, device=dev)]
        worst["kmeans"] = max(worst["kmeans"], k3_against_plain(
            kmeans.kmeans_cuda, xy, c0, rs, n=n))
        worst["kmeans_batched"] = max(worst["kmeans_batched"],
                                      k3_against_plain(
            kmeans.kmeans_batched_cuda, xy[None], c0[None], rs[None],
            episodes=1, n=n))
    for n in (4096, 100_000):
        xy = blobs(n, gen, dev)
        rs = xy[torch.randint(0, n, (20, 3), generator=gen, device=dev)]
        # Every point is nearest center 0, as the zeroed assignments say:
        # nothing changes in iteration 0 and the centers stay as given.
        c0 = torch.tensor([[2.0, 2.0], [100.0, 100.0], [-100.0, 50.0]],
                          device=dev)
        for fn, lead in ((kmeans.kmeans_cuda, ()),
                         (kmeans.kmeans_batched_cuda, (1,))):
            c1, _ = run_k3(fn, xy.reshape(lead + xy.shape),
                           c0.reshape(lead + c0.shape),
                           rs.reshape(lead + rs.shape))
            if not torch.equal(c1.reshape(c0.shape), c0):
                raise AssertionError(f"K3 n={n}: the latch did not fire at "
                                     "iteration 0")
        # An empty cluster takes its reseed candidate: a center far from
        # every point owns nothing in the first iteration.
        c0 = torch.tensor([[1.2, 1.2], [3.6, 2.0], [90.0, 90.0]], device=dev)
        for fn, lead in ((kmeans.kmeans_cuda, ()),
                         (kmeans.kmeans_batched_cuda, (1,))):
            c1, _ = run_k3(fn, xy.reshape(lead + xy.shape),
                           c0.reshape(lead + c0.shape),
                           rs.reshape(lead + rs.shape))
            c2, _ = kmeans.kmeans_plain(xy, c0, rs)
            c1 = c1.reshape(c0.shape)
            if (c1 - c2).abs().max().item() > 1e-4 or c1[2, 0].item() > 50.0:
                raise AssertionError(f"K3 n={n}: empty-cluster reseed "
                                     "differs")
        say("check", kernel="kmeans+kmeans_batched", n=n,
            latch_at_iteration_0=True, empty_cluster_reseeded=True)
    return (dict(max_abs_err=worst["kmeans"]),
            dict(max_abs_err=worst["kmeans_batched"]))


# -- phase 4: the server at full size --------------------------------------

class Replies:
    """A text stream that keeps each reply line and the time it arrived."""

    def __init__(self):
        self.lines, self.times, self._buf = [], [], ""

    def write(self, s: str) -> int:
        self._buf += s
        while "\n" in self._buf:
            line, self._buf = self._buf.split("\n", 1)
            self.lines.append(line)
            self.times.append(time.perf_counter())
        return len(s)

    def flush(self) -> None:
        pass


def serve_phase(dev, ess=None):
    """The JSONL server at the bench config, every tick resampled, or
    (path (c)) under the ESS gate."""
    what = "serve" if ess is None else "serve_ess"
    world = presets.make_world(num_particles=SERVE_N, num_beams=SERVE_B,
                               ray_mode="analytic",
                               resample_method="systematic",
                               ess_threshold=ess, device=dev)
    enc, truth = drive(SERVE_TICKS)
    ranges = scans(world.maze, truth, world.angles, world.cfg.sensor,
                   seed=1).cpu().numpy()
    lines = [json.dumps(dict(encoder_left=float(e[0]),
                             encoder_right=float(e[1]),
                             ranges=[float(r) for r in z]))
             for e, z in zip(enc, ranges)]
    lines += [json.dumps(dict(cmd="stats")), json.dumps(dict(cmd="shutdown"))]
    out = Replies()
    torch.cuda.synchronize()
    reset_counts()
    k2_before = expand.device_launches()
    server = MCLServer(world.maze, world.cfg, world.angles, seed=0)
    t0 = time.perf_counter()
    ticks = server.serve(lines, out_stream=out)
    torch.cuda.synchronize()
    launched, replayed = counts(), replay_counts()
    k2_device = expand.device_launches() - k2_before
    check_k2_device_launches(what, k2_device,
                             launched["systematic_expand"], SERVE_N)
    replies = [json.loads(s) for s in out.lines]
    errors = [r for r in replies if "error" in r]
    tick_replies = [r for r in replies if "exact_pose" in r]
    if errors or ticks != SERVE_TICKS or len(tick_replies) != SERVE_TICKS:
        raise AssertionError(f"{what}: ticks={ticks}, errors={errors[:3]}")
    for r in tick_replies:
        if not all(math.isfinite(v) for v in r["exact_pose"]
                   + [r["confidence"]]):
            raise AssertionError(f"{what}: non-finite reply {r}")
    if replies[-2].get("tick") != SERVE_TICKS or replies[-1] != {"ok": True}:
        raise AssertionError(f"{what}: stats/shutdown replies "
                             f"{replies[-2:]}")
    short = {k: launched[k] for k in SINGLE if launched[k] < SERVE_TICKS}
    if short:
        raise AssertionError(f"{what}: kernels launched < {SERVE_TICKS} "
                             f"times: {short}")
    lat = np.diff(np.array([t0] + out.times[:SERVE_TICKS])) * 1e3
    best = np.array(tick_replies[-1]["exact_pose"][:2])
    err_m = (float(np.hypot(*(best - truth[-2, :2])))
             if best[0] >= 0 else None)
    say(what, particles=SERVE_N, beams=SERVE_B, ray_mode="analytic",
        resample="systematic", ess=ess, ticks=ticks, error_replies=0,
        launches=launched, replayed=replayed, k2_device_launches=k2_device,
        tick_ms_median=float(np.median(lat)),
        tick_ms_p90=float(np.percentile(lat, 90)),
        tick_ms_first=float(lat[0]),
        updates_per_sec=SERVE_N * SERVE_B / (float(np.median(lat)) / 1e3),
        final_confidence=tick_replies[-1]["confidence"],
        position_error_m=err_m)
    short = {k: replayed[k] for k in SINGLE if replayed[k] < SERVE_TICKS}
    if short:
        raise AssertionError(f"{what}: kernels replayed < {SERVE_TICKS} "
                             f"times: {short}")
    return world, server, launched, replayed


def check_k2_device_launches(what, device, calls, n, episodes=1) -> None:
    """K2's device launches on a path: its plan's count a call."""
    want = calls * expand.launch_plan(n, episodes).device_launches
    if device != want:
        raise AssertionError(f"{what}: K2 made {device} device launches in "
                             f"{calls} calls, not {want}")


# -- phase 5: the entry config ---------------------------------------------

def entry_phase(dev):
    world = presets.make_world(num_particles=ENTRY_N, num_beams=ENTRY_B,
                               ray_mode="fixed",
                               resample_method="multinomial", device=dev)
    m = world.maze
    enc, truth = drive(ENTRY_TICKS)
    ranges = scans(m, truth, world.angles, world.cfg.sensor, seed=2)
    state = mcl.init_state(m, world.cfg, seed=3)
    before = counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, outs = mcl.run_episode(state, enc, ranges, world.angles, m,
                                  world.cfg)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    rose = {k: v - before[k] for k, v in counts().items()}
    if rose["beam_weights"] < ENTRY_TICKS or rose["kmeans"] < ENTRY_TICKS:
        raise AssertionError(f"entry: kernel launches {rose}")
    if not (torch.isfinite(final.particles).all()
            and outs.confidence.shape == (ENTRY_TICKS,)):
        raise AssertionError("entry: non-finite state or bad output shape")
    say("entry", particles=ENTRY_N, beams=ENTRY_B, ray_mode="fixed",
        resample="multinomial", ticks=ENTRY_TICKS, launches=rose,
        ticks_per_sec=ENTRY_TICKS / dt,
        updates_per_sec=ENTRY_TICKS * ENTRY_N * ENTRY_B / dt,
        final_confidence=float(outs.confidence[-1]))


# -- phase 6: one tick through the kernels and through the plain versions --

def plain_config(cfg):
    """The same filter with every kernel's plain version: the config values
    under which the JAX package, too, runs XLA instead of its kernels."""
    return dataclasses.replace(
        cfg, sensor=dataclasses.replace(cfg.sensor, lookup_mode="gather"),
        resample=dataclasses.replace(cfg.resample, expand="xla"),
        cluster=dataclasses.replace(cfg.cluster, impl="dense"))


def tick_phase(world, state):
    """Tolerances of the CPU slice test: >= 99.9 % of particle rows within
    atol 1e-5 (a summation ulp can move a rare draw across a CDF
    boundary); confidence and best pose within 1e-3; song, wanderer and
    n_injected equal."""
    m, cfg = world.maze, world.cfg
    gen = torch.Generator(device=m.device)
    gen.manual_seed(4)
    enc, truth = drive(SERVE_TICKS + 1)
    scan = sensor.Scan(
        angles=torch.as_tensor(world.angles, device=m.device),
        ranges=scans(m, truth[-1:], world.angles, cfg.sensor, seed=5)[0],
        mask=torch.ones(SERVE_B, dtype=torch.bool, device=m.device))
    draws = mcl.draw_tick(gen, m, SERVE_N, cfg)
    el, er = float(enc[-1, 0]), float(enc[-1, 1])
    before = counts()
    k_state, k_out = mcl.mcl_step(state, el, er, scan, m, cfg, draws=draws)
    mid = counts()
    p_state, p_out = mcl.mcl_step(state, el, er, scan, m, plain_config(cfg),
                                  draws=draws)
    torch.cuda.synchronize()
    after = counts()
    again, _ = mcl.mcl_step(state, el, er, scan, m, cfg, draws=draws)
    repeat = (again.particles == k_state.particles).all(1).float().mean()
    if after != mid or any(mid[k] <= before[k] for k in SINGLE):
        raise AssertionError(f"tick: launches {before} -> {mid} -> {after}")
    rows = ((k_state.particles - p_state.particles).abs() <= 1e-5).all(1)
    share = rows.float().mean().item()
    conf_err = abs(float(k_out.confidence) - float(p_out.confidence))
    pose_err = (k_state.best_pose - p_state.best_pose).abs().max().item()
    same = all(int(getattr(k_out, f)) == int(getattr(p_out, f))
               for f in ("song", "wanderer_cmd", "n_injected"))
    say("tick_vs_plain", particles=SERVE_N, beams=SERVE_B,
        rows_close_share=share, repeat_rows_equal_share=repeat.item(),
        confidence_err=conf_err,
        best_pose_err=pose_err, discrete_outputs_equal=same)
    if not (share >= 0.999 and conf_err <= 1e-3 and pose_err <= 1e-3
            and same):
        raise AssertionError("tick: kernel and plain ticks disagree")


# -- phase 7: times at the main path's shapes ------------------------------

def time_phase(world, state, gen) -> dict:
    m, cfg = world.maze, world.cfg
    dev = m.device
    parts = state.particles
    scan = sensor.Scan(
        angles=torch.as_tensor(world.angles, device=dev),
        ranges=sensor.simulate_scan(m, START, world.angles,
                                    cfg.sensor).ranges,
        mask=torch.ones(SERVE_B, dtype=torch.bool, device=dev))
    cdf = skewed_cdf(SERVE_N, gen, dev)
    u0 = torch.rand((), generator=gen, device=dev)
    xy = parts[:, :2]            # the strided view the tick passes
    c0 = xy[torch.randint(0, SERVE_N, (3,), generator=gen, device=dev)]
    rs = xy[torch.randint(0, SERVE_N, (20, 3), generator=gen, device=dev)]
    pairs = {
        "beam_weights": (
            lambda: weights.beam_weights_cuda(m, parts, scan, cfg.sensor),
            lambda: weights.beam_weights_plain(m, parts, scan, cfg.sensor)),
        "systematic_expand": (
            lambda: expand.systematic_expand_cuda(parts, cdf, u0),
            lambda: expand.systematic_expand_plain(parts, cdf, u0)),
        "kmeans": (lambda: kmeans.kmeans_cuda(xy, c0, rs),
                   lambda: kmeans.kmeans_plain(xy, c0, rs)),
    }
    bounds = {
        "beam_weights": dict(**k1_bound(m, parts, scan.angles, cfg.sensor),
                             library_ms=None),
        "systematic_expand": k2_extras(parts, cdf, u0),
        "kmeans": dict(**k3_bound(xy, c0, rs), library_ms=None),
    }
    times = {}
    for name, (kernel, plain) in pairs.items():
        times[name] = dict(**turns(kernel, plain), **bounds[name])
        say("time", kernel=name, particles=SERVE_N, beams=SERVE_B,
            **times[name])
    tick_cfg = (cfg, plain_config(cfg))
    tick_ms = [cuda_ms(lambda c=c: mcl.mcl_step(state, 0.1, 0.1, scan, m, c))
               for c in tick_cfg]
    say("time", what="mcl_step", particles=SERVE_N, beams=SERVE_B,
        kernels_ms=tick_ms[0], plain_ms=tick_ms[1])
    return times


# -- bounds: the least time the card could take for a call's work -------

def bound(n_bytes: float, flops: float) -> dict:
    """The larger of bytes over the memory rate and float32 operations
    over the peak float32 rate, in ms, and which of the two it is."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_PER_S * 1e3
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


# Float operations each beam weight needs whatever the cast: the ray angle,
# its cosine and sine, and the likelihood tail (difference, Gaussian with
# its exp, the max-range term, the masked accumulate); and each particle:
# the laser origin and its pixel coordinates, and the validity gate.
BEAM_FLOPS, PARTICLE_FLOPS = 15, 16
MARCH_SAMPLE_FLOPS = 8     # a sample's world point and its pixel
SLAB_FLOPS = 10            # one candidate slab of one axis (analytic)


def march_samples(m, parts, angles, cfg) -> int:
    """March samples the data needs: every beam samples up to its first
    hit, or its first sample off the map, or num_ray_steps."""
    x, y, th = parts[..., 0], parts[..., 1], parts[..., 2]
    ox = (x + cfg.laser_offset * torch.cos(th))[..., None]
    oy = (y + cfg.laser_offset * torch.sin(th))[..., None]
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    ray = th[..., None] + sign * angles
    dx, dy = torch.cos(ray), torch.sin(ray)
    alive = torch.ones(ray.shape, dtype=torch.bool, device=parts.device)
    count = torch.zeros(ray.shape, dtype=torch.int32, device=parts.device)
    for r in march_steps(cfg):
        count += alive.to(torch.int32)
        mx, my, inb = world_to_map(m, ox + r * dx, oy + r * dy)
        alive = alive & inb & ~lookup(m.occ, mx, my, m.episode_maps)
    return int(count.sum())


def slab_candidates(m, parts, angles, cfg) -> int:
    """Candidate slabs the analytic casts of this data need: per beam and
    axis, the slabs in ray order up to the first hit, all ceil(smax/8)+1
    where there is none, one where the ray runs along the axis's lines,
    and none where the origin is off the map or on an occupied gridline
    pixel (ops/analytic._axis_hits, restated to count)."""
    smax, n_cand, span = analytic.cast_constants(m, cfg.max_range)
    x, y, th = parts[..., 0], parts[..., 1], parts[..., 2]
    gx = (x + cfg.laser_offset * torch.cos(th) - m.origin_x) \
        * m.inv_resolution
    gy = (y + cfg.laser_offset * torch.sin(th) - m.origin_y) \
        * m.inv_resolution
    inb = (gx >= 0.0) & (gy >= 0.0) & (gx < float(m.width)) & (
        gy < float(m.height))
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    ray = th[..., None] + sign * angles
    dx, dy = torch.cos(ray), torch.sin(ray)
    total = 0
    for vertical, gu, gv, du, dv in ((True, gx, gy, dx, dy),
                                     (False, gy, gx, dy, dx)):
        ax = analytic._Axis(m, vertical)
        k0, inside0, origin0 = (v[..., None] for v in
                                analytic._axis_prepare(gu, gv, ax))
        gu, gv = gu[..., None], gv[..., None]
        small = torch.abs(du) < analytic.EPS
        inv_du = 1.0 / torch.where(small, analytic.EPS, du)
        sgn = torch.where(du >= 0, 1, -1).to(torch.int32)
        fwd = dv >= 0
        inv_dv = 1.0 / torch.where(torch.abs(dv) < analytic.EPS,
                                   analytic.EPS, dv)
        done = ~inb[..., None] | origin0
        for c in range(n_cand):
            total += int((~done).sum())
            k = k0 + sgn * c
            line_u = (k * analytic.CELL_PX).to(torch.float32)
            t_near, t_far = (line_u - gu) * inv_du, (line_u + 1.0 - gu) \
                * inv_du
            t_in = torch.clamp(torch.minimum(t_near, t_far), min=0.0)
            t_out = torch.clamp(torch.maximum(t_near, t_far), max=smax)
            if c == 0:
                t_in = torch.where(small, torch.where(inside0, 0.0, 3e38),
                                   t_in)
                t_out = torch.where(small, torch.where(inside0, smax, -3e38),
                                    t_out)
            r_in = torch.floor(gv + t_in * dv).to(torch.int32)
            r_out = torch.floor(gv + t_out * dv).to(torch.int32)
            hit, rr = analytic._band_scan(ax, k, torch.minimum(r_in, r_out),
                                          torch.maximum(r_in, r_out), fwd,
                                          span)
            edge = torch.where(fwd, rr, rr + 1).to(torch.float32)
            s_hit = torch.maximum(t_in, (edge - gv) * inv_dv)
            ok = (t_in < t_out) & (k >= 0) & (k < ax.n_lines) & hit & (
                s_hit < smax)
            done = done | ok | small | (t_in >= smax)
    return total


def k1_bound(m, parts, angles, cfg) -> dict:
    """K1 (and K1 batched, its map-stack form, K4: the same function): each
    input read once (a stack's every raster and its map index), each
    output written once; operations per beam and per particle, the
    cast counted by what this data needs: march samples, or the analytic
    cast's slab candidates up to each axis's first hit.  bound_ms_all_slabs
    counts every candidate slab of both axes for every beam instead, the
    most the data could need."""
    n = parts.numel() // 3
    nb = angles.shape[-1]
    n_ep = n // parts.shape[-2]
    n_bytes = (12 * n + 4 * n + 4 * nb + 8 * n_ep * nb
               + 2 * m.maps * m.height * m.width
               + (4 * n_ep if m.is_stack else 0))
    base = n * nb * BEAM_FLOPS + n * PARTICLE_FLOPS
    if cfg.ray_mode == "fixed":
        return bound(n_bytes, base + MARCH_SAMPLE_FLOPS
                     * march_samples(m, parts, angles, cfg))
    n_cand = analytic.cast_constants(m, cfg.max_range)[1]
    every = bound(n_bytes, base + n * nb * 2 * n_cand * SLAB_FLOPS)
    return dict(**bound(n_bytes, base + SLAB_FLOPS * slab_candidates(
        m, parts, angles, cfg)), bound_ms_all_slabs=every["bound_ms"])


def k2_bound(parts, counts_, u0) -> dict:
    """K2: read the float32 cdf and u0, read the row of each source this
    run's data gives offspring (where the cumulative count steps up, or
    source 0 in an episode where none has any), and write every output row.
    The counts, their scan and the spread are integer work on data already
    read; rows are counted in bytes, not in the 32-byte sectors the card
    moves, so the bound is the least it could be."""
    d = parts.shape[-1]
    rows = parts.numel() // d
    prev = torch.nn.functional.pad(counts_[..., :-1], (1, 0))
    read = int((counts_ > prev).sum()) + int((counts_[..., -1] == 0).sum())
    return dict(**bound(rows * 4 + u0.numel() * 4 + read * 4 * d
                        + rows * 4 * d, 0.0), source_rows_read=read)


def k2_extras(parts, cdf, u0) -> dict:
    """K2's bound, its library call (repeat_interleave of the rows by the
    offspring counts, computed beforehand), and the card's time for the
    torch counts alone (offspring_counts: the work the kernel took in)."""
    counts_ = expand.offspring_counts(cdf, u0)
    return dict(**k2_bound(parts, counts_, u0), library_ms=cuda_ms(
        repeat_rows(parts, counts_)), offspring_counts_ms=cuda_ms(
        lambda: expand.offspring_counts(cdf, u0)))


KMEANS_POINT_FLOPS = 26    # a point's K=3 distances, argmin and sums


def kmeans_iterations(xy, c0, rs) -> int:
    """Lloyd iterations the early-exit latch lets run, summed over
    episodes (a restatement of the dense loop that counts)."""
    k = c0.shape[-2]
    centers = c0
    assign = torch.zeros(xy.shape[:-1], dtype=torch.long, device=xy.device)
    done = torch.zeros(xy.shape[:-2], dtype=torch.bool, device=xy.device)
    runs = torch.zeros_like(done, dtype=torch.int64)
    for t in range(rs.shape[-3]):
        runs += (~done).to(torch.int64)
        d2 = ((xy[..., None, :] - centers[..., None, :, :]) ** 2).sum(-1)
        new = torch.argmin(d2, dim=-1)
        changed = (new != assign).any(-1)
        upd = changed & ~done
        onehot = torch.nn.functional.one_hot(new, k).to(xy.dtype)
        cnt = onehot.sum(-2)
        means = (onehot[..., None] * xy[..., None, :]).sum(-3) \
            / torch.clamp(cnt, min=1.0)[..., None]
        means = torch.where((cnt > 0)[..., None], means, rs[..., t, :, :])
        centers = torch.where(upd[..., None, None], means, centers)
        assign = torch.where(upd[..., None], new, assign)
        done = done | ~changed
    return int(runs.sum())


def k3_bound(xy, c0, rs) -> dict:
    """K3: read xy, the start centers and the reseed candidates once,
    write the assignments and centers; operations per point and
    iteration that the latch lets run."""
    n = xy.numel() // 2
    n_bytes = 8 * n + 4 * n + 2 * c0.numel() * 4 + rs.numel() * 4
    return bound(n_bytes,
                 KMEANS_POINT_FLOPS * xy.shape[-2]
                 * kmeans_iterations(xy, c0, rs))


def repeat_rows(parts, counts):
    """The one PyTorch call that computes K2's function (library_ms):
    torch.repeat_interleave of the flattened rows by each source's
    offspring count (differences of the cumulative counts)."""
    prev = torch.nn.functional.pad(counts[..., :-1], (1, 0))
    per_source = (counts - prev).reshape(-1)
    flat = parts.reshape(-1, parts.shape[-1])
    return lambda: torch.repeat_interleave(flat, per_source, dim=0)


# -- phase 3b: the batched kernels against their plain versions -----------

def batched_inputs(m, n_ep, n, nb, cfg, gen, kind: str = "uniform"):
    """Episodes [E, n, 3] of particles (uniform, or steered to a hard case
    of the casts), one beam table, and each episode's scan from its own
    true pose, with dead lanes: lane 1 in every episode and lane e mod B in
    episode e."""
    dev = m.device
    parts = steer(resample.sample_uniform_particles(gen, m, n,
                                                    batch=(n_ep,)),
                  kind, m, gen)
    truth = resample.sample_uniform_particles(gen, m, n_ep)
    angles = np.deg2rad(np.linspace(-118.0, 118.0, nb)).astype(np.float32)
    if kind == "parallel":
        angles[:4] = np.float32([0.0, math.pi / 2, -math.pi / 2, math.pi])
    scan = sensor.simulate_scan(m, truth, angles, cfg)
    mask = torch.ones((n_ep, nb), dtype=torch.bool, device=dev)
    mask[:, 1] = False
    mask[torch.arange(n_ep, device=dev),
         torch.arange(n_ep, device=dev) % nb] = False
    return parts, sensor.Scan(angles=scan.angles, ranges=scan.ranges,
                              mask=mask)


def _close_share(got, want, comb):
    rtol = 1e-4 if comb == "log" else 1e-5
    return torch.isclose(got, want, rtol=rtol, atol=1e-6).float().mean(
        ).item()


def batched_cases(m):
    """(maze, E, n, B, ray mode, combine, particles) of the batched checks:
    the grid of episodes, sizes, beams, modes and combines on uniform
    particles, then the casts' hard cases on both maze sizes."""
    for n_ep in CHECK_EPISODES:
        for n in CHECK_SIZES:
            for nb in CHECK_BEAMS:
                for mode in ("fixed", "analytic"):
                    for comb in ("sum", "log"):
                        yield m, n_ep, n, nb, mode, comb, "uniform"
    for maze in (m, big_maze(m.device)):
        for kind in ("parallel", "word_boundary"):
            for mode in ("fixed", "analytic"):
                for comb in ("sum", "log"):
                    yield maze, 64, 500, 24, mode, comb, kind


def forced_plan(parts, t: int) -> tuple:
    """K4's C entry arguments (threads a particle, particles a block) with
    T = t forced on particles [E, n, 3]."""
    plan = weights.BeamsubPlan.for_threads(parts.shape[0], parts.shape[1], t)
    return plan.threads, plan.per_block


def check_k4(maze, parts, scan, cfg) -> tuple:
    """K4 against beamsub_plain, and K4 with each T of 1, 2, 4 and 8
    threads a particle forced (through the C entry, not counted) against
    the plan's K4 bit for bit: (K4's weights, max-abs error, the plan's T,
    whether every forced T gave the same bits)."""
    sub = weights.beamsub_cuda(maze, parts, scan, cfg)
    threads = weights.beamsub_cuda.last_plan.threads
    want = weights.beamsub_plain(maze, parts, scan, cfg)
    forced = [weights._batched_launch(
        "mcl_beam_weights_beamsub", maze, parts, scan, cfg,
        *forced_plan(parts, t)) for t in (1, 2, 4, 8)]
    torch.cuda.synchronize()
    same = all(torch.equal(f, sub) for f in forced)
    if not (torch.isfinite(sub).all() and same):
        raise AssertionError(f"K4 {tuple(parts.shape)} {cfg.ray_mode}/"
                             f"{cfg.beam_combine}: forced T equal {same}")
    return sub, (sub - want).abs().max().item(), threads, same


def k4_cases(m):
    """K4's grid: episodes, sizes and beam counts (B < 8 leaves lanes
    dead) over which its plan takes each T, both modes and combines."""
    for n_ep in K4_EPISODES:
        for n in K4_SIZES:
            for nb in K4_BEAMS:
                for mode in ("fixed", "analytic"):
                    for comb in ("sum", "log"):
                        yield m, n_ep, n, nb, mode, comb


def check_batched_weights(m, gen) -> tuple:
    """K1 batched and K4 against their plain versions at 0.0 max-abs error
    in every case, K1 batched against K1 on each episode bit for bit, K4's
    max relative difference from K1 batched, which sums the beams in
    another order, and K4 at every T forced equal to its plan's bit for
    bit; then K4 alone on its grid, where its plan must take every T."""
    worst = dict(beam_weights_batched=0.0, beam_weights_beamsub=0.0)
    rel_k4 = 0.0
    taken = set()
    for maze, n_ep, n, nb, mode, comb, kind in batched_cases(m):
        cfg = SensorModelConfig(ray_mode=mode, beam_combine=comb)
        parts, scan = batched_inputs(maze, n_ep, n, nb, cfg, gen, kind)
        got = weights.beam_weights_batched_cuda(maze, parts, scan, cfg)
        want = weights.beam_weights_plain(maze, parts, scan, cfg)
        single = torch.stack([weights.beam_weights_cuda(
            maze, parts[e], sensor.Scan(scan.angles, scan.ranges[e],
                                        scan.mask[e]), cfg)
            for e in range(n_ep)])
        sub, k4_err, threads, _ = check_k4(maze, parts, scan, cfg)
        taken.add(threads)
        torch.cuda.synchronize()
        errs = dict(beam_weights_batched=(got - want).abs().max().item(),
                    beam_weights_beamsub=k4_err)
        for name, err in errs.items():
            worst[name] = max(worst[name], err)
        same = torch.equal(got, single)
        # Raw log-sums sit near 0 where every beam fits, so log mode is
        # relative to max(|w|, 1).
        floor = 1.0 if comb == "log" else 1e-6
        rel = ((sub - got).abs() / torch.clamp(got.abs(), min=floor)).max(
            ).item()
        rel_k4 = max(rel_k4, rel)
        say("check", kernel="beam_weights_batched+beamsub",
            raster=list(maze.occ.shape), episodes=n_ep, n=n, beams=nb,
            ray_mode=mode, combine=comb, particles=kind,
            max_abs_err=errs["beam_weights_batched"],
            share_close=_close_share(got, want, comb),
            equals_single_k1=same,
            k4_max_abs_err=errs["beam_weights_beamsub"], k4_threads=threads,
            k4_max_rel_diff_from_k1_batched=rel)
        finite = bool(torch.isfinite(got).all())
        if not (same and finite and max(errs.values()) == 0.0):
            raise AssertionError(
                f"K1 batched / K4 E={n_ep} n={n} b={nb} {mode}/{comb} "
                f"{kind}: {errs}, same={same}")
    for maze, n_ep, n, nb, mode, comb in k4_cases(m):
        cfg = SensorModelConfig(ray_mode=mode, beam_combine=comb)
        parts, scan = batched_inputs(maze, n_ep, n, nb, cfg, gen)
        _, err, threads, same = check_k4(maze, parts, scan, cfg)
        taken.add(threads)
        worst["beam_weights_beamsub"] = max(worst["beam_weights_beamsub"],
                                            err)
        say("check", kernel="beam_weights_beamsub", episodes=n_ep, n=n,
            beams=nb, ray_mode=mode, combine=comb, threads=threads,
            max_abs_err=err, forced_threads_equal=same)
        if err != 0.0:
            raise AssertionError(f"K4 E={n_ep} n={n} b={nb} {mode}/{comb}"
                                 f" T={threads}: max-abs error {err}")
    if taken != {1, 2, 4, 8}:
        raise AssertionError(f"K4's plan took T in {sorted(taken)}, not "
                             "each of 1, 2, 4 and 8")
    return (dict(max_abs_err=worst["beam_weights_batched"]),
            dict(max_abs_err=worst["beam_weights_beamsub"],
                 max_rel_diff_from_k1_batched=rel_k4,
                 threads_taken=sorted(taken)))


def k2_batch(n_ep, n, gen, dev):
    """Episodes [E, n] of every cdf kind in turn, with offsets cycling
    through K2_U0 and a random one."""
    u0 = torch.rand(n_ep, generator=gen, device=dev)
    fixed = torch.tensor(K2_U0, device=dev)
    e = torch.arange(n_ep, device=dev)
    u0 = torch.where(e % 4 < 3, fixed[e % 4 % 3], u0)
    kinds = torch.stack([k2_cdf(kind, n, u0, gen, dev, (n_ep,))
                         for kind in K2_KINDS])
    return kinds[e % len(K2_KINDS), e], u0


def check_k2_batched(dev, gen) -> dict:
    """Bit-exact against the plain version and against K2 per episode at
    K2_BATCHED_SHAPES, the episodes mixing every cdf kind and offset."""
    for n_ep, n in K2_BATCHED_SHAPES:
        parts = k2_rows((n_ep, n), gen, dev)
        cdf, u0 = k2_batch(n_ep, n, gen, dev)
        got, launched = run_k2(expand.systematic_expand_batched_cuda, parts,
                               cdf, u0)
        want = expand.systematic_expand_plain(parts, cdf, u0)
        single = torch.stack([expand.systematic_expand_cuda(
            parts[e], cdf[e], u0[e]) for e in range(n_ep)])
        torch.cuda.synchronize()
        exact = torch.equal(got, want)
        same = torch.equal(got, single)
        say("check", kernel="systematic_expand_batched", episodes=n_ep,
            n=n, kinds=list(K2_KINDS), bit_exact=exact, equals_single_k2=same,
            device_launches_per_call=launched)
        if not (exact and same):
            raise AssertionError(f"K2 batched E={n_ep} n={n}: exact={exact}, "
                                 f"equal to K2 per episode={same}; "
                                 f"{k2_mismatch(got, want if not exact else single)}")
    return dict(max_abs_err=0.0)


def batched_blobs(n_ep, n, gen, dev):
    """Per-episode three-blob clouds [E, n, 2], each episode's blobs
    shifted by its own offset."""
    shift = 2.0 * torch.rand((n_ep, 1, 2), generator=gen, device=dev)
    return blobs(n_ep * n, gen, dev).reshape(n_ep, n, 2) + shift


def kmeans_inputs(xy, gen):
    n_ep, n = xy.shape[0], xy.shape[1]
    dev = xy.device
    init = torch.randint(0, n, (n_ep, 3), generator=gen, device=dev)
    reseed = torch.randint(0, n, (n_ep, 20, 3), generator=gen, device=dev)
    c0 = torch.take_along_dim(xy, init[..., None], dim=-2)
    rs = torch.take_along_dim(xy, reseed.reshape(n_ep, -1)[..., None],
                              dim=-2).reshape(n_ep, 20, 3, 2)
    return c0, rs


K3_BATCHED_SHAPES = ((SWEEP_E, SWEEP_N), (FLEET_R, FLEET_N), (4, 65_536))


def check_k3_batched(dev, gen) -> float:
    """At the sweep's and the fleet's shapes and at 4 x 65,536 (the grid
    path): against the plain version, and equal to K3 on each episode, bit
    for bit.  Returns the worst center error."""
    worst = 0.0
    for n_ep, n in K3_BATCHED_SHAPES:
        rows = torch.cat([batched_blobs(n_ep, n, gen, dev),
                          torch.randn((n_ep, n, 1), generator=gen,
                                      device=dev)], -1)
        xy = rows[..., :2]
        c0, rs = kmeans_inputs(xy, gen)
        worst = max(worst, k3_against_plain(
            kmeans.kmeans_batched_cuda, xy, c0, rs, episodes=n_ep, n=n))
        c1, a1 = kmeans.kmeans_batched_cuda(xy, c0, rs)
        singles = [kmeans.kmeans_cuda(xy[e], c0[e], rs[e])
                   for e in range(n_ep)]
        torch.cuda.synchronize()
        same = (torch.equal(c1, torch.stack([c for c, _ in singles]))
                and torch.equal(a1, torch.stack([a for _, a in singles])))
        say("check", kernel="kmeans_batched", episodes=n_ep, n=n,
            equals_single_k3=same)
        if not same:
            raise AssertionError(f"K3 batched E={n_ep} n={n}: differs from "
                                 "K3 per episode")
    return worst


# -- phase 8: the sweep preset at full size ---------------------------------

def sweep_phase(dev) -> dict:
    """The convergence row of BENCH_DETAILS.md:211-218 (500 particles:
    76.7 % converged, 72.8 % alias-converged on the TPU); a broken filter
    lands far below the floors 0.65 and 0.60."""
    world = presets.make_world(num_particles=SWEEP_N, num_beams=SWEEP_B,
                               ray_mode="fixed",
                               resample_method="systematic", device=dev)
    torch.cuda.synchronize()
    reset_counts()
    k2_before = expand.device_launches()
    t0 = time.perf_counter()
    metrics = presets.run_sweep(world, batch=SWEEP_E, num_ticks=SWEEP_T,
                                seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, replayed = counts(), replay_counts()
    k2_device = expand.device_launches() - k2_before
    check_k2_device_launches("sweep", k2_device,
                             launched["systematic_expand_batched"], SWEEP_N,
                             SWEEP_E)
    short = {k: replayed[k] for k in ("beam_weights_batched",
                                      "systematic_expand_batched",
                                      "kmeans_batched")
             if replayed[k] != SWEEP_T}
    say("sweep", episodes=SWEEP_E, particles=SWEEP_N, beams=SWEEP_B,
        ticks=SWEEP_T, ray_mode="fixed", resample="systematic",
        launches=launched, replayed=replayed, k2_device_launches=k2_device,
        wall_s=wall,
        ticks_per_sec=SWEEP_T / wall,
        updates_per_sec=SWEEP_E * SWEEP_N * SWEEP_B * SWEEP_T / wall,
        **metrics)
    if short:
        raise AssertionError(f"sweep: kernels not replayed once a tick: "
                             f"{short}")
    if not (metrics["converged_frac"] >= 0.65
            and metrics["alias_converged_frac"] >= 0.60):
        raise AssertionError(f"sweep: convergence below the floors: "
                             f"{metrics}")
    return launched, replayed


# -- phase 9: the fleet server at full size ---------------------------------

def fleet_lines(world, ticks: int, seed: int) -> list:
    """Fleet frames of FLEET_R wandering robots."""
    gen = torch.Generator(device=world.maze.device)
    gen.manual_seed(seed)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, ticks, batch=FLEET_R,
        start_pose=START)
    enc, ranges = enc.cpu().numpy(), ranges.cpu().numpy()
    return [json.dumps(dict(encoder_left=enc[:, t, 0].tolist(),
                            encoder_right=enc[:, t, 1].tolist(),
                            ranges=ranges[:, t].tolist()))
            for t in range(ticks)]


def fleet_phase(dev) -> dict:
    world = presets.make_world(num_particles=FLEET_N, num_beams=FLEET_B,
                               ray_mode="fixed",
                               resample_method="multinomial", device=dev)
    lines = fleet_lines(world, FLEET_TICKS, seed=6)
    lines += [json.dumps(dict(cmd="stats")), json.dumps(dict(cmd="shutdown"))]
    out = Replies()
    torch.cuda.synchronize()
    reset_counts()
    server = MCLFleetServer(world.maze, world.cfg, world.angles,
                            n_robots=FLEET_R, seed=0)
    t0 = time.perf_counter()
    ticks = server.serve(lines, out_stream=out)
    torch.cuda.synchronize()
    launched = counts()
    replies = [json.loads(s) for s in out.lines]
    errors = [r for r in replies if "error" in r]
    tick_replies = [r for r in replies if "exact_pose" in r]
    if errors or ticks != FLEET_TICKS or len(tick_replies) != FLEET_TICKS:
        raise AssertionError(f"fleet: ticks={ticks}, errors={errors[:3]}")
    for r in tick_replies:
        vals = sum(r["exact_pose"], []) + r["confidence"]
        if len(r["confidence"]) != FLEET_R or not all(
                math.isfinite(v) for v in vals):
            raise AssertionError(f"fleet: bad reply at tick {r['tick']}")
    if replies[-2].get("tick") != FLEET_TICKS or replies[-1] != {"ok": True}:
        raise AssertionError(f"fleet: stats/shutdown replies "
                             f"{str(replies[-2:])[:200]}")
    short = {k: launched[k] for k in ("beam_weights_batched",
                                      "kmeans_batched")
             if launched[k] < FLEET_TICKS}
    if short:
        raise AssertionError(f"fleet: kernels launched < {FLEET_TICKS} "
                             f"times: {short}")
    lat = np.diff(np.array([t0] + out.times[:FLEET_TICKS])) * 1e3
    conf = np.array(tick_replies[-1]["confidence"])
    say("fleet", robots=FLEET_R, particles=FLEET_N, beams=FLEET_B,
        ray_mode="fixed", resample="multinomial", ticks=ticks,
        error_replies=0, launches=launched,
        tick_ms_median=float(np.median(lat)),
        tick_ms_p90=float(np.percentile(lat, 90)),
        tick_ms_first=float(lat[0]),
        robot_ticks_per_sec=FLEET_R / (float(np.median(lat)) / 1e3),
        mean_final_confidence=float(conf.mean()))
    return launched


# -- phase 9b: where a batched tick's time goes ----------------------------

# The CUDA runtime's and driver's calls that enqueue a kernel, that wait
# for the device, and that copy (a copy to the host waits, as `.item()`
# does; one from the host does not).
HOST_CALLS = dict(
    launch=("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
            "cuLaunchKernelEx", "cudaLaunchCooperativeKernel"),
    sync=("cudaStreamSynchronize", "cudaDeviceSynchronize",
          "cudaEventSynchronize"),
    copy=("cudaMemcpy", "cudaMemcpyAsync"))


def device_profile(fn, ticks: int) -> dict:
    """torch.profiler over `ticks` calls of fn, per tick: host wall ms;
    the device time summed over the kernels and copies it ran, its share
    of the wall time (the profiler's own host cost lowers it), the five
    largest device consumers by name and the count of kernels and copies.
    On the host: the kernel launches enqueued, the synchronize calls (the
    loop's last included) and the copies, each with their ms; the host
    time of all recorded operators and calls, and the five with the most
    host time of their own (the profiler's cost included).  The wall time
    beyond the recorded host time is Python's."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / ticks
    rows, host, device_ops = [], [], 0
    calls = {what: [0, 0.0] for what in HOST_CALLS}
    averages = prof.key_averages()
    names = {ev.key for ev in averages}
    for ev in averages:
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            cpu_ms = ev.self_cpu_time_total / 1e3 / ticks
            host.append((cpu_ms, ev.count / ticks, ev.key))
            for what, keys in HOST_CALLS.items():
                if ev.key in keys:
                    calls[what][0] += ev.count
                    calls[what][1] += cpu_ms
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((us / 1e3 / ticks, ev.key))
        device_ops += ev.count
    rows.sort(reverse=True)
    host.sort(reverse=True)
    dev_ms = sum(ms for ms, _ in rows)
    return dict(wall_ms_per_tick=wall_ms, device_ms_per_tick=dev_ms,
                device_busy_share=dev_ms / wall_ms,
                top=[[name[:60], ms] for ms, name in rows[:5]],
                device_ops_per_tick=device_ops / ticks,
                **{f"host_{what}_calls_per_tick": n / ticks
                   for what, (n, _) in calls.items()},
                **{f"host_{what}_ms_per_tick": ms
                   for what, (_, ms) in calls.items()},
                host_self_ms_per_tick=sum(ms for ms, _, _ in host),
                host_top=[[name[:60], ms, n] for ms, n, name in host[:5]],
                names=names)


# Names under which a cummax would show in a profile: torch's operator,
# and its CUDA scan kernel.
CUMMAX_NAMES = ("cummax", "scan_innermost_dim_with_indices",
                "scan_outer_dim_with_indices")


def serve_tick_profile(dev) -> None:
    """One filter's tick at the serve's shapes (1M x 34, analytic,
    systematic), 20 ticks; no cummax may run in it, since K2 takes the
    offspring counts in, so a profiler that fails here fails the run."""
    world = presets.make_world(num_particles=SERVE_N, num_beams=SERVE_B,
                               ray_mode="analytic",
                               resample_method="systematic", device=dev)
    m, cfg = world.maze, world.cfg
    enc, truth = drive(2)
    scan = sensor.Scan(angles=torch.as_tensor(world.angles, device=dev),
                       ranges=scans(m, truth[-1:], world.angles, cfg.sensor,
                                    seed=10)[0],
                       mask=torch.ones(SERVE_B, dtype=torch.bool, device=dev))
    holder = [mcl.init_state(m, cfg, seed=11)]

    def tick():
        holder[0], _ = mcl.mcl_step(holder[0], float(enc[-1, 0]),
                                    float(enc[-1, 1]), scan, m, cfg)

    prof = device_profile(tick, 20)
    names = prof.pop("names")
    cummax = sorted(k for k in names if any(c in k for c in CUMMAX_NAMES))
    say("profile", what="serve_tick", particles=SERVE_N, beams=SERVE_B,
        ray_mode="analytic", resample="systematic", cummax_ops=cummax,
        **prof)
    if cummax:
        raise AssertionError(f"serve tick: a cummax ran: {cummax}")


def profile_phase(dev) -> None:
    """One filter's tick at the serve's shapes, then one batched filter
    tick at the sweep's shapes (the wander already simulated, as the sweep
    feeds it) and at the fleet's, 20 ticks each."""
    serve_tick_profile(dev)
    for what, n_ep, n, nb, method in (
            ("sweep_tick", SWEEP_E, SWEEP_N, SWEEP_B, "systematic"),
            ("fleet_tick", FLEET_R, FLEET_N, FLEET_B, "multinomial")):
        world = presets.make_world(num_particles=n, num_beams=nb,
                                   ray_mode="fixed", resample_method=method,
                                   device=dev)
        m, cfg = world.maze, world.cfg
        gen = torch.Generator(device=dev)
        gen.manual_seed(8)
        enc, ranges, _ = robot.generate_wander_episode(
            gen, m, cfg, world.angles, 2, batch=n_ep, start_pose=START)
        scan = sensor.Scan(angles=torch.as_tensor(world.angles, device=dev),
                           ranges=ranges[:, -1].contiguous(),
                           mask=torch.ones((n_ep, nb), dtype=torch.bool,
                                           device=dev))
        holder = [mcl.init_state(m, cfg, seed=9, batch=n_ep)]

        def tick():
            holder[0], _ = mcl.mcl_step(holder[0], enc[:, -1, 0],
                                        enc[:, -1, 1], scan, m, cfg)

        try:
            prof = device_profile(tick, 20)
            prof.pop("names")
        except RuntimeError as e:    # a profiler the sandbox refuses
            prof = dict(not_measured=f"{type(e).__name__}: {e}")
        say("profile", what=what, episodes=n_ep, particles=n, beams=nb,
            resample=method, **prof)


# -- phase 10: layout A/B of the two batched beam weight kernels -----------

def ab_phase(m, gen) -> dict:
    """K1 batched (one thread a particle) against K4 (its plan's T threads
    a particle) in device time, the profiler's per call (utils/profiling's
    device_ms), timed in turns (row, beamsub, beamsub, row): at E = 64, n
    in AB_SIZES, B = 24, at the fleet's 64 x 1500 x 34 and at the CLI
    serve's 1 x 1500 x 24, analytic and fixed.  K4 runs only here: the
    filter never dispatches it."""
    torch.cuda.synchronize()
    reset_counts()
    shapes = [(AB_E, n, AB_B) for n in AB_SIZES] + list(AB_MORE)
    for mode in ("analytic", "fixed"):
        cfg = SensorModelConfig(ray_mode=mode)
        for n_ep, n, nb in shapes:
            parts, scan = batched_inputs(m, n_ep, n, nb, cfg, gen)
            row = lambda: weights.beam_weights_batched_cuda(m, parts, scan,
                                                            cfg)
            sub = lambda: weights.beamsub_cuda(m, parts, scan, cfg)
            r1, s1, s2, r2 = (device_ms(row), device_ms(sub),
                              device_ms(sub), device_ms(row))
            a, b = row(), sub()
            rel = ((b - a).abs() / torch.clamp(a.abs(), min=1e-6)).max(
                ).item()
            say("layout_ab", episodes=n_ep, n=n, beams=nb, ray_mode=mode,
                k4_threads=weights.beamsub_cuda.last_plan.threads,
                row_device_ms=[r1, r2], beamsub_device_ms=[s1, s2],
                beamsub_over_row=float(np.median([s1, s2])
                                       / np.median([r1, r2])),
                max_rel_diff=rel)
    torch.cuda.synchronize()
    return counts()


# -- phase 11: the batched kernels' times ------------------------------------

def turns(kernel, plain) -> dict:
    """plain, kernel, kernel, plain: the two sides share the card's
    state."""
    p1, k1, k2, p2 = (cuda_ms(plain), cuda_ms(kernel), cuda_ms(kernel),
                      cuda_ms(plain))
    return dict(ms=float(np.median([k1, k2])),
                plain_ms=float(np.median([p1, p2])), ms_sides=[k1, k2],
                plain_ms_sides=[p1, p2])


def batched_time_phase(m, gen) -> dict:
    """At the sweep's shapes (E = 1024, n = 500, B = 24, fixed, sum) for
    K1, K2 and K3 batched, and at E = 64, n = 768, B = 24, analytic for
    K4."""
    dev = m.device
    times = {}
    cfg = SensorModelConfig(ray_mode="fixed")
    parts, scan = batched_inputs(m, SWEEP_E, SWEEP_N, SWEEP_B, cfg, gen)
    times["beam_weights_batched"] = dict(
        **turns(lambda: weights.beam_weights_batched_cuda(m, parts, scan,
                                                          cfg),
                lambda: weights.beam_weights_plain(m, parts, scan, cfg)),
        **k1_bound(m, parts, scan.angles, cfg), library_ms=None,
        shape=[SWEEP_E, SWEEP_N, SWEEP_B])
    cdf = skewed_cdf(SWEEP_N, gen, dev, (SWEEP_E,))
    u0 = torch.rand(SWEEP_E, generator=gen, device=dev)
    times["systematic_expand_batched"] = dict(
        **turns(lambda: expand.systematic_expand_batched_cuda(parts, cdf, u0),
                lambda: expand.systematic_expand_plain(parts, cdf, u0)),
        **k2_extras(parts, cdf, u0), shape=[SWEEP_E, SWEEP_N, 3])
    xy = parts[..., :2]
    c0, rs = kmeans_inputs(xy, gen)
    times["kmeans_batched"] = dict(
        **turns(lambda: kmeans.kmeans_batched_cuda(xy, c0, rs),
                lambda: kmeans.kmeans_plain(xy, c0, rs)),
        **k3_bound(xy, c0, rs), library_ms=None, shape=[SWEEP_E, SWEEP_N])
    acfg = SensorModelConfig(ray_mode="analytic")
    aparts, ascan = batched_inputs(m, AB_E, K4_TIME_N, AB_B, acfg, gen)
    k4 = lambda: weights.beamsub_cuda(m, aparts, ascan, acfg)
    times["beam_weights_beamsub"] = dict(
        **turns(k4, lambda: weights.beamsub_plain(m, aparts, ascan, acfg)),
        device_ms=device_ms(k4),
        threads=weights.beamsub_cuda.last_plan.threads,
        **k1_bound(m, aparts, ascan.angles, acfg), library_ms=None,
        shape=[AB_E, K4_TIME_N, AB_B])
    for name, t in times.items():
        say("time", kernel=name, **t)
    # K4 where the work, not the launch, sets the time, beside K1 batched.
    for mode in ("analytic", "fixed"):
        cfg = SensorModelConfig(ray_mode=mode)
        parts, scan = batched_inputs(m, K4_BIG_E, K4_TIME_N, AB_B, cfg, gen)
        k4 = lambda: weights.beamsub_cuda(m, parts, scan, cfg)
        row = lambda: weights.beam_weights_batched_cuda(m, parts, scan, cfg)
        say("time", kernel="beam_weights_beamsub", ray_mode=mode,
            shape=[K4_BIG_E, K4_TIME_N, AB_B],
            **turns(k4, lambda: weights.beamsub_plain(m, parts, scan, cfg)),
            device_ms=device_ms(k4),
            threads=weights.beamsub_cuda.last_plan.threads,
            k1_batched_device_ms=device_ms(row),
            **k1_bound(m, parts, scan.angles, cfg))
    return times


# -- R1 and R2: refinement's kernels at the production shapes -------------

# Float operations of refinement beyond K1's count (BEAM_FLOPS a beam,
# PARTICLE_FLOPS a particle): a ray's DDA set-up and each DDA step, a hit
# beam's closed-form derivative, and a particle's gradient sums, step and
# angle wrap.
DDA_SETUP_FLOPS, DDA_STEP_FLOPS = 12, 4
HIT_GRAD_FLOPS, PARTICLE_STEP_FLOPS = 25, 20
REFINE_SEED = 8


def refine_inputs(dev):
    """The production cell's shapes (SWEEP_E x SWEEP_N x SWEEP_B, fixed
    march, 2 rounds): in each episode a cloud about a free pose, the scan
    from that pose with a dead lane (lane 1), and the configuration."""
    world = presets.make_world(num_particles=SWEEP_N, num_beams=SWEEP_B,
                               ray_mode="fixed",
                               resample_method="systematic",
                               refine_iters=2, ess_threshold=ESS, device=dev)
    m, cfg = world.maze, world.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(REFINE_SEED)
    truth = resample.sample_uniform_particles(gen, m, SWEEP_E)
    spread = torch.tensor([0.15, 0.15, 0.2], device=dev)
    parts = truth[:, None, :] + spread * torch.randn(
        (SWEEP_E, SWEEP_N, 3), generator=gen, device=dev)
    scan = sensor.simulate_scan(m, truth, world.angles, cfg.sensor, gen=gen,
                                noise_sigma=0.02)
    mask = torch.ones((SWEEP_E, SWEEP_B), dtype=torch.bool, device=dev)
    mask[:, 1] = False
    return m, parts, sensor.Scan(angles=scan.angles, ranges=scan.ranges,
                                 mask=mask), cfg


def refine_plain(m, parts, scan, cfg):
    """What R1 and R2 compute, in plain torch: (the proposals of
    models/refine.closed_form_grad and propose, the likelihood of the
    particles by beam_weights_dense, the acceptance's rows and
    likelihood by torch.where and torch.maximum)."""
    acc = dataclasses.replace(cfg.sensor, lookup_mode="auto")
    off = cfg.valid_pos_offset
    _, g = refine.closed_form_grad(m, parts, scan, cfg.sensor, cfg.refine,
                                   off)
    prop = refine.propose(parts, g, cfg.refine)
    w = sensor.beam_weights_dense(m, parts, scan, acc, off)
    w_prop = sensor.beam_weights_dense(m, prop, scan, acc, off)
    return (prop, w, torch.where((w_prop > w)[..., None], prop, parts),
            torch.maximum(w_prop, w))


def check_refine(dev) -> dict:
    """R1's proposals and R2's likelihood and acceptance in place against
    refine_plain on the same inputs: bit for bit (max-abs error 0), or a
    raise."""
    m, parts, scan, cfg = refine_inputs(dev)
    want_prop, want_w, want_p, want_w2 = refine_plain(m, parts, scan, cfg)
    p, ang, ranges, mask = refine_kernels.beam_inputs(parts, scan, cfg)
    w = refine_kernels.refine_score_cuda(m, p, ang, ranges, mask, cfg)
    err_w = (w - want_w).abs().max().item()
    prop = refine_kernels.refine_grad_cuda(m, p, ang, ranges, mask, cfg)
    err_prop = (prop - want_prop).abs().max().item()
    refine_kernels.refine_score_cuda(m, p, ang, ranges, mask, cfg, w, prop)
    err_accept = max((p - want_p).abs().max().item(),
                     (w - want_w2).abs().max().item())
    moved = (p != parts).any(-1).float().mean().item()
    say("check", kernel="refine", shape=[SWEEP_E, SWEEP_N, SWEEP_B],
        grad_max_abs_err=err_prop, score_max_abs_err=err_w,
        accept_max_abs_err=err_accept, accepted_share=moved,
        scored_share=(want_w > 0).float().mean().item())
    if err_prop or err_w or err_accept or not 0.0 < moved < 1.0:
        raise AssertionError(f"refinement's kernels: proposals {err_prop}, "
                             f"likelihood {err_w}, acceptance {err_accept} "
                             f"from the plain versions; accepted {moved}")
    return dict(refine_grad=dict(max_abs_err=err_prop),
                refine_score=dict(max_abs_err=max(err_w, err_accept)))


def dda_steps(m, parts, angles, cfg) -> tuple:
    """(DDA steps, hit rays) the data needs: every ray steps until it
    enters a wall pixel, leaves the map or passes max_range (raycast's
    traversal, restated to count), and hits where a step entered a wall
    pixel."""
    x, y, th = parts[..., 0], parts[..., 1], parts[..., 2]
    ox = (x + cfg.laser_offset * torch.cos(th))[..., None]
    oy = (y + cfg.laser_offset * torch.sin(th))[..., None]
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    ox, oy, ray = torch.broadcast_tensors(ox, oy, th[..., None]
                                          + sign * angles)
    walk = raycast.dda_walk(m, ox, oy, ray, cfg)
    ix = torch.floor((ox - m.origin_x) * m.inv_resolution).to(torch.int32)
    iy = torch.floor((oy - m.origin_y) * m.inv_resolution).to(torch.int32)
    sx = torch.where(walk.dx >= 0, 1, -1).to(torch.int32)
    sy = torch.where(walk.dy >= 0, 1, -1).to(torch.int32)
    tx, ty = walk.lead_x * walk.inv_dx, walk.lead_y * walk.inv_dy
    inb = lambda a, b: (a >= 0) & (b >= 0) & (a < m.width) & (b < m.height)
    done = lookup(m.occ, ix, iy, m.episode_maps) | ~inb(ix, iy)
    steps = 0
    for _ in range(raycast.dda_iters(m, cfg)):
        steps += int((~done).sum())
        take = tx < ty
        t = torch.where(take, tx, ty)
        nix = torch.where(take, ix + sx, ix)
        niy = torch.where(take, iy, iy + sy)
        done = done | ~inb(nix, niy) | (t >= cfg.max_range) | lookup(
            m.occ, nix, niy, m.episode_maps)
        ix, iy = torch.where(done, ix, nix), torch.where(done, iy, niy)
        tx = torch.where(done | ~take, tx, tx + m.resolution * walk.inv_dx)
        ty = torch.where(done | take, ty, ty + m.resolution * walk.inv_dy)
    return steps, int(walk.hit.sum())


def refine_bounds(m, parts, angles, cfg) -> dict:
    """R1 and R2: the particles, the scan and both rasters read once, the
    outputs written once (R1 the proposals; R2 reads the proposals and
    the likelihood too, and writes both back); operations as K1's a beam
    and a particle, R1's DDA steps and hit derivatives as these inputs
    need them and a particle's step, R2's march samples as K1's."""
    n = parts.numel() // 3
    rays = n * angles.shape[-1]
    n_ep = parts.shape[0]
    common = 8 * n_ep * angles.shape[-1] + 2 * m.height * m.width
    base = rays * BEAM_FLOPS + n * PARTICLE_FLOPS
    steps, hits = dda_steps(m, parts, angles, cfg.sensor)
    grad = bound(24 * n + common, base + rays * DDA_SETUP_FLOPS
                 + DDA_STEP_FLOPS * steps + HIT_GRAD_FLOPS * hits
                 + PARTICLE_STEP_FLOPS * n)
    score = bound(32 * n + common, base + MARCH_SAMPLE_FLOPS
                  * march_samples(m, parts, angles, cfg.sensor))
    return dict(refine_grad=dict(grad, dda_steps_per_ray=steps / rays,
                                 hit_share=hits / rays),
                refine_score=score)


def refine_time(dev) -> dict:
    """R1 and R2 at the production shapes against refine_plain's parts on
    the card (turns), with their bounds: R2 timed as a round's scoring
    and acceptance (the proposals are accepted by the first call, so
    later calls score them and write nothing)."""
    m, parts, scan, cfg = refine_inputs(dev)
    p, ang, ranges, mask = refine_kernels.beam_inputs(parts, scan, cfg)
    w = refine_kernels.refine_score_cuda(m, p, ang, ranges, mask, cfg)
    prop = refine_kernels.refine_grad_cuda(m, p, ang, ranges, mask, cfg)
    acc = dataclasses.replace(cfg.sensor, lookup_mode="auto")
    off = cfg.valid_pos_offset
    shaped = prop.reshape(parts.shape)
    pc, wc = p.clone(), w.clone()

    def grad_plain():
        _, g = refine.closed_form_grad(m, parts, scan, cfg.sensor,
                                       cfg.refine, off)
        return refine.propose(parts, g, cfg.refine)

    def score_plain():
        w_prop = sensor.beam_weights_dense(m, shaped, scan, acc, off)
        return (torch.where((w_prop > w)[..., None], shaped, parts),
                torch.maximum(w_prop, w))

    bounds = refine_bounds(m, parts, scan.angles, cfg)
    times = dict(
        refine_grad=dict(**turns(lambda: refine_kernels.refine_grad_cuda(
            m, p, ang, ranges, mask, cfg), grad_plain)),
        refine_score=dict(**turns(lambda: refine_kernels.refine_score_cuda(
            m, pc, ang, ranges, mask, cfg, wc, prop), score_plain)))
    for name, t in times.items():
        t.update(bounds[name], library_ms=None,
                 shape=[SWEEP_E, SWEEP_N, SWEEP_B])
        say("time", kernel=name, **t)
    return times


# -- phase 3c: F1, the beam weight kernels on rasters past shared memory --

def random_maze(rows, cols, dev, seed):
    """A random maze of rows x cols cells, each top and left wall present
    with probability 0.4."""
    rng = np.random.default_rng(seed)
    walls = [[[w for w in (WALL_TOP, WALL_LEFT) if rng.random() < 0.4]
              for _ in range(cols)] for _ in range(rows)]
    return from_walls(walls, device=dev)


def fits_shared(cells: int, mode: str, nb: int) -> bool:
    """Whether a square maze of `cells` a side fits a K1 block's shared
    memory with its raster at nb beams (ops/weights.smem_bytes)."""
    side = types.SimpleNamespace(height=8 * cells + 1, width=8 * cells + 1)
    return weights.smem_bytes(side, SensorModelConfig(ray_mode=mode),
                              nb) <= weights.SMEM_MAX


def device_form_cells(mode: str) -> int:
    """The fewest cells a side of a square maze whose raster does not fit a
    K1 block's shared memory at any beam count of F1_BEAMS: only the
    device-memory form can take it."""
    cells = 1
    while any(fits_shared(cells, mode, nb) for nb in F1_BEAMS):
        cells += 1
    return cells


def largest_shared_cells(mode: str, nb: int) -> int:
    """The most cells a side of a square maze whose raster still fits a K1
    block's shared memory at nb beams: both forms can take it."""
    cells = 1
    while fits_shared(cells + 1, mode, nb):
        cells += 1
    return cells


def check_f1(gen) -> dict:
    """K1, K1 batched and K4 at 0.0 max-abs error from their plain versions
    on the smallest random maze past shared memory and one twice its side,
    for each ray mode (K1 also on bands across 32-bit words and at a 4 m
    range), every call in the device-memory form."""
    dev = torch.device("cuda")
    worst = dict(beam_weights=0.0, beam_weights_batched=0.0,
                 beam_weights_beamsub=0.0)
    for mode in ("fixed", "analytic"):
        cells = device_form_cells(mode)
        for side in (cells, 2 * cells):
            t0 = time.perf_counter()
            m = random_maze(side, side, dev, seed=side)
            built = time.perf_counter() - t0
            errs = dict(worst)
            for comb in ("sum", "log"):
                for kind, max_range in (("uniform", 1.0),
                                        ("word_boundary", 1.0),
                                        ("uniform", 4.0)):
                    cfg = SensorModelConfig(ray_mode=mode, beam_combine=comb,
                                            max_range=max_range)
                    parts, scan = k1_inputs(m, 65_536, 34, cfg, gen, kind)
                    form = weights.raster_form(m, cfg)
                    got = weights.beam_weights_cuda(m, parts, scan, cfg)
                    want = weights.beam_weights_plain(m, parts, scan, cfg)
                    errs["beam_weights"] = max(
                        errs["beam_weights"], (got - want).abs().max().item())
                    if form != "device" or not torch.isfinite(got).all():
                        raise AssertionError(f"F1 K1 {mode} {side} cells: "
                                             f"form {form}")
                cfg = SensorModelConfig(ray_mode=mode, beam_combine=comb)
                parts, scan = batched_inputs(m, 64, 500, 24, cfg, gen)
                got = weights.beam_weights_batched_cuda(m, parts, scan, cfg)
                want = weights.beam_weights_plain(m, parts, scan, cfg)
                errs["beam_weights_batched"] = max(
                    errs["beam_weights_batched"],
                    (got - want).abs().max().item())
                parts, scan = batched_inputs(m, 64, 768, 24, cfg, gen)
                got = weights.beamsub_cuda(m, parts, scan, cfg)
                want = weights.beamsub_plain(m, parts, scan, cfg)
                errs["beam_weights_beamsub"] = max(
                    errs["beam_weights_beamsub"],
                    (got - want).abs().max().item())
            torch.cuda.synchronize()
            say("check", kernel="F1: beam_weights, batched, beamsub",
                ray_mode=mode, cells=side, raster=list(m.occ.shape),
                raster_words=weights.raster_words(
                    m, SensorModelConfig(ray_mode=mode)),
                smem_bytes_k1=weights.smem_bytes(
                    m, SensorModelConfig(ray_mode=mode), 34),
                smem_max=weights.SMEM_MAX, form="device",
                maze_build_s=built, **{f"{k}_max_abs_err": v
                                       for k, v in errs.items()})
            if any(v != 0.0 for v in errs.values()):
                raise AssertionError(f"F1 {mode} {side} cells: {errs}")
            worst = errs
    return worst


def f1_time(gen) -> None:
    """The device-memory form against the shared-memory form in device time
    (profiling.device_ms, in turns shared, device, device, shared) on the
    default maze, on random square mazes of F1_TIME_CELLS and on the
    largest that fits both forms: K1 at 1M x 34 and K1 batched at the
    sweep's 1024 x 500 x 24."""
    dev = torch.device("cuda")
    mazes = [("default", mode, presets.make_world(device=dev).maze)
             for mode in ("fixed", "analytic")]
    for mode in ("fixed", "analytic"):
        largest = largest_shared_cells(mode, max(SERVE_B, SWEEP_B))
        for side in F1_TIME_CELLS[mode] + (largest,):
            mazes.append((f"{side} cells", mode,
                          random_maze(side, side, dev, seed=side)))
    for name, mode, m in mazes:
        cfg = SensorModelConfig(ray_mode=mode)
        parts, scan = k1_inputs(m, SERVE_N, SERVE_B, cfg, gen)
        bparts, bscan = batched_inputs(m, SWEEP_E, SWEEP_N, SWEEP_B, cfg,
                                       gen)
        calls = {
            "beam_weights": lambda f: weights._launch_k1(
                m, parts, scan, cfg, form=f),
            "beam_weights_batched": lambda f: weights._batched_launch(
                "mcl_beam_weights_batched", m, bparts, bscan, cfg,
                form=f)}
        for kernel, call in calls.items():
            same = torch.equal(call("shared"), call("device"))
            s1, d1, d2, s2 = (device_ms(lambda: call("shared")),
                              device_ms(lambda: call("device")),
                              device_ms(lambda: call("device")),
                              device_ms(lambda: call("shared")))
            say("f1_time", kernel=kernel, maze=name,
                raster=list(m.occ.shape), ray_mode=mode,
                raster_bytes=4 * weights.raster_words(m, cfg),
                shape=list(parts.shape[:1]) + [SERVE_B]
                if kernel == "beam_weights" else [SWEEP_E, SWEEP_N,
                                                  SWEEP_B],
                shared_device_ms=[s1, s2], device_form_device_ms=[d1, d2],
                device_over_shared=float(np.median([d1, d2])
                                         / np.median([s1, s2])),
                forms_bit_equal=same)
            if not same:
                raise AssertionError(f"F1 {kernel} {name} {mode}: the "
                                     "two forms differ")


# -- phase 3d: F2, batches past one grid's 65,535 episodes -----------------

def check_f2(gen) -> None:
    """K1 batched, K4, K2 batched (one block an episode at n = 8, and the
    two-launch path at n = 8193, one column) and K3 batched at E = F2_E
    episodes against their plain versions: K1 batched and K4 at 0.0
    max-abs error, K2 bit for bit, K3's centers within 1e-4; each call's
    last 16 episodes, 8 on each side of the chunk boundary at 65,535,
    equal to a call of their own."""
    dev = torch.device("cuda")
    m = presets.make_world(device=dev).maze
    tail = slice(F2_E - 16, None)     # 8 episodes on each side of a chunk
    for mode in ("fixed", "analytic"):
        cfg = SensorModelConfig(ray_mode=mode)
        parts, scan = batched_inputs(m, F2_E, 32, 12, cfg, gen)
        tscan = sensor.Scan(scan.angles, scan.ranges[tail], scan.mask[tail])
        for name, fn, plain in (
                ("beam_weights_batched", weights.beam_weights_batched_cuda,
                 weights.beam_weights_plain),
                ("beam_weights_beamsub", weights.beamsub_cuda,
                 weights.beamsub_plain)):
            got = fn(m, parts, scan, cfg)
            err = (got - plain(m, parts, scan, cfg)).abs().max().item()
            alone = torch.equal(got[tail], fn(m, parts[tail], tscan, cfg))
            torch.cuda.synchronize()
            say("check", kernel=name, what="F2", episodes=F2_E, n=32,
                beams=12, ray_mode=mode, max_abs_err=err,
                tail_equals_alone=alone)
            if err != 0.0 or not alone:
                raise AssertionError(f"F2 {name} {mode}: {err}, {alone}")
    for n, d in ((8, 3), (expand.SMALL_N + 1, 1)):
        parts = torch.randn((F2_E, n, d), generator=gen, device=dev)
        parts[..., 0] = torch.arange(n, device=dev, dtype=torch.float32)
        cdf = skewed_cdf(n, gen, dev, (F2_E,))
        u0 = torch.rand(F2_E, generator=gen, device=dev)
        got, launched = run_k2(expand.systematic_expand_batched_cuda, parts,
                               cdf, u0)
        exact = torch.equal(got, expand.systematic_expand_plain(parts, cdf,
                                                                u0))
        alone = torch.equal(got[tail], expand.systematic_expand_batched_cuda(
            parts[tail], cdf[tail], u0[tail]))
        say("check", kernel="systematic_expand_batched", what="F2",
            episodes=F2_E, n=n, columns=d, device_launches_per_call=launched,
            bit_exact=exact, tail_equals_alone=alone)
        if not (exact and alone):
            raise AssertionError(f"F2 K2 batched n={n}: exact={exact}, "
                                 f"alone={alone}")
        del parts, cdf, got
    xy = batched_blobs(F2_E, 64, gen, dev)
    c0, rs = kmeans_inputs(xy, gen)
    k3_against_plain(kmeans.kmeans_batched_cuda, xy, c0, rs, what="F2",
                     episodes=F2_E, n=64)
    c1, a1 = kmeans.kmeans_batched_cuda(xy, c0, rs)
    c2, a2 = kmeans.kmeans_batched_cuda(xy[tail], c0[tail], rs[tail])
    if not (torch.equal(c1[tail], c2) and torch.equal(a1[tail], a2)):
        raise AssertionError("F2 K3 batched: the tail differs alone")
    torch.cuda.empty_cache()


# -- phase 8b: path (a), the composed production sweep ----------------------

def production_sweep_phase(dev) -> dict:
    """The sweep at PROD_E x 500 x 24 x 300, fixed march, systematic, ESS
    0.5 and 2 rounds of refinement (BENCH_DETAILS.md:226-236, published
    99.8 % converged and alias-converged at 0.074 m on the TPU): raises
    below 0.95 converged or alias-converged or above 0.15 m alias RMSE.
    Then refinement's share of one batched tick (CUDA events, the tick
    with 2 rounds against the tick with none, at a cloud around each
    episode's truth) and its peak device memory."""
    world = presets.make_world(num_particles=SWEEP_N, num_beams=SWEEP_B,
                               ray_mode="fixed",
                               resample_method="systematic",
                               refine_iters=2, ess_threshold=ESS, device=dev)
    m, cfg = world.maze, world.cfg
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    k2_before = expand.device_launches()
    t0 = time.perf_counter()
    metrics = presets.run_sweep(world, batch=PROD_E, num_ticks=SWEEP_T,
                                seed=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak_sweep = torch.cuda.max_memory_allocated() - base
    launched, replayed = counts(), replay_counts()
    check_k2_device_launches("production sweep",
                             expand.device_launches() - k2_before,
                             launched["systematic_expand_batched"], SWEEP_N,
                             PROD_E)
    # One batched tick with and without refinement, and refinement alone.
    gen = torch.Generator(device=dev)
    gen.manual_seed(8)
    truth = resample.sample_uniform_particles(gen, m, SWEEP_E)
    state = mcl.init_tracking_state(m, cfg, truth, batch=SWEEP_E,
                                    sigma_xy=0.1, sigma_theta=0.1)
    scan = sensor.simulate_scan(m, truth, world.angles, cfg.sensor, gen=gen,
                                noise_sigma=0.02)
    enc = torch.full((SWEEP_E,), 0.1, device=dev)
    no_refine = dataclasses.replace(cfg, refine=dataclasses.replace(
        cfg.refine, iters=0))
    tick_ms = [cuda_ms(lambda c=c: mcl.mcl_step(state, enc, enc, scan, m, c))
               for c in (cfg, no_refine, no_refine, cfg)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    refine_ms = cuda_ms(lambda: refine.refine_particles(
        m, state.particles, scan, cfg), reps=5)
    peak_refine = torch.cuda.max_memory_allocated() - base
    with_ms = float(np.median([tick_ms[0], tick_ms[3]]))
    without_ms = float(np.median(tick_ms[1:3]))
    say("production_sweep", episodes=PROD_E, particles=SWEEP_N,
        beams=SWEEP_B, ticks=SWEEP_T, ray_mode="fixed",
        resample="systematic", ess=ESS, refine_iters=2, launches=launched,
        wall_s=wall, ticks_per_sec=SWEEP_T / wall,
        updates_per_sec=PROD_E * SWEEP_N * SWEEP_B * SWEEP_T / wall,
        tick_episodes=SWEEP_E,
        peak_memory_gib_sweep=peak_sweep / 2**30,
        peak_memory_gib_refine=peak_refine / 2**30,
        tick_ms_refine=with_ms, tick_ms_no_refine=without_ms,
        tick_ms_sides=tick_ms, refine_share_of_tick=1.0 - without_ms / with_ms,
        refine_ms=refine_ms, **metrics)
    short = {k: launched[k] for k in ("beam_weights_batched",
                                      "systematic_expand_batched",
                                      "kmeans_batched")
             if launched[k] < SWEEP_T}
    if short:
        raise AssertionError(f"production sweep: kernels launched < "
                             f"{SWEEP_T} times: {short}")
    # A tick refines once: 2 rounds, so R1 twice and R2 three times.
    calls = launched["beam_weights_batched"]
    if (launched["refine_grad"], launched["refine_score"]) != (2 * calls,
                                                               3 * calls):
        raise AssertionError(f"production sweep: refinement's kernels "
                             f"launched other than 2 and 3 times a tick's "
                             f"{calls}: {launched}")
    if not (metrics["converged_frac"] >= 0.95
            and metrics["alias_converged_frac"] >= 0.95
            and metrics["alias_rmse_xy"] <= 0.15):
        raise AssertionError(f"production sweep: below 0.95 / 0.95 / "
                             f"0.15 m: {metrics}")
    return launched, replayed


# -- phase 8c: path (b), the elastic server --------------------------------

def far_pose(m, start):
    """The free cell center farthest from `start`, facing +y."""
    rows, cols = torch.meshgrid(torch.arange(m.n_rows, device=m.device),
                                torch.arange(m.n_cols, device=m.device),
                                indexing="ij")
    cx, cy = cell_center(rows.float(), cols.float(), m.cell_meters)
    cx, cy = cx + 0.05, cy + 0.05
    d = torch.hypot(cx - start[0], cy - start[1])
    d = torch.where(is_valid_pos(m, cx, cy), d, -1.0)
    k = int(torch.argmax(d))
    return (float(cx.reshape(-1)[k]), float(cy.reshape(-1)[k]), math.pi / 2)


def raw_scan(ranges, angles, skip):
    """A raw LaserScan dict whose every skip-th beam is one of the beam
    table's ranges (filter_scan keeps those), with unreadable (NaN) beams
    between them, and beams past the +-120 degree crop."""
    full = np.repeat(np.float64(ranges), skip)
    full[3::skip] = np.nan
    inc = (float(angles[-1]) - float(angles[0])) / ((len(angles) - 1) * skip)
    return dict(ranges=[None if np.isnan(v) else float(v) for v in full],
                angle_min=float(angles[0]), angle_increment=inc,
                range_min=0.0, range_max=1.0)


def elastic_session(dev, tmp: str):
    """Path (b)'s world, kidnap pose, server maker and session lines, the
    checkpoint written under `tmp`."""
    world = presets.make_world(num_particles=ELASTIC[1], num_beams=SWEEP_B,
                               ray_mode="fixed",
                               resample_method="systematic",
                               refine_iters=2, ess_threshold=ESS,
                               device=dev)
    m = world.maze
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    kidnap = far_pose(m, ELASTIC_START)
    enc, ranges, truth = robot.generate_wander_episode(
        gen, m, world.cfg, world.angles, ELASTIC_FRAMES, batch=1,
        start_pose=ELASTIC_START, kidnap_tick=KIDNAP_AT,
        kidnap_pose=kidnap)
    enc, ranges = enc[0].cpu().numpy(), ranges[0].cpu().numpy()
    skip = world.cfg.sensor.beam_skip
    frames = []
    for k in range(ELASTIC_FRAMES):
        f = dict(encoder_left=float(enc[k, 0]),
                 encoder_right=float(enc[k, 1]))
        if k % 2:
            f["raw_scan"] = raw_scan(ranges[k], world.angles, skip)
        else:
            f["ranges"] = [float(r) for r in ranges[k]]
        frames.append(json.dumps(f))
    path = os.path.join(tmp, "elastic.npz")
    replay = frames[CHECKPOINT_AT:CHECKPOINT_AT + REPLAYED]
    lines = (frames[:CHECKPOINT_AT]
             + [json.dumps(dict(cmd="checkpoint", path=path))] + replay
             + [json.dumps(dict(cmd="restore", path=path))] + replay
             + frames[CHECKPOINT_AT + REPLAYED:])

    def make():
        return MCLServer(m, world.cfg, world.angles, seed=0, adapt=ELASTIC,
                         adapt_patience=ELASTIC_PATIENCE, adapt_mode="kld")

    return world, kidnap, make, lines


def elastic_phase(dev) -> dict:
    """MCLServer with the KLD budget on [1024, 65,536] and the production
    schedule (ESS gate, 2 rounds of refinement), 24 beams,
    ELASTIC_FRAMES frames of a wander from the sweep's start whose truth is
    carried at KIDNAP_AT to the free cell farthest from the start (the
    encoders run on), every other frame as a raw LaserScan, a checkpoint at
    CHECKPOINT_AT and a restore that replays the next REPLAYED frames.
    Raises unless the budget shrinks below n_max while the filter is
    confident before the kidnap, returns to n_max after it (the lost
    song), the replayed replies equal the first ones exactly, and the
    budget crosses K2's one-block limit and K3's cooperative-grid
    threshold (so both forms of each run)."""
    n_min, n_max = ELASTIC
    with tempfile.TemporaryDirectory() as tmp:
        world, kidnap, make, lines = elastic_session(dev, tmp)
        out = Replies()
        torch.cuda.synchronize()
        reset_counts()
        k2_before = expand.device_launches()
        k3_before = kmeans.device_launches()
        server = make()
        t0 = time.perf_counter()
        server.serve(lines, out_stream=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launched = counts()
    replies = [json.loads(s) for s in out.lines]
    errors = [r for r in replies if "error" in r]
    a = CHECKPOINT_AT
    first = replies[a + 1:a + 1 + REPLAYED]
    again = replies[a + 2 + REPLAYED:a + 2 + 2 * REPLAYED]
    ticks = replies[:a] + first + replies[a + 2 + 2 * REPLAYED:]
    sizes = [r["particles"] for r in ticks]
    conf = [r["confidence"] for r in ticks]
    before, after = sizes[:KIDNAP_AT], sizes[KIDNAP_AT:]
    back = any(s == n_max for s in after) and min(before) < n_max
    confident = world.cfg.hysteresis.conf_confident_threshold
    shrunk_confident = [s for s, c in zip(before, conf)
                        if s < n_max and c >= confident]
    lattice = sorted(set(sizes))
    crossed = (min(sizes) <= expand.SMALL_N < max(sizes)
               and min(sizes) <= kmeans.BLOCK_MAX_N < max(sizes))
    say("elastic", adapt=list(ELASTIC), adapt_mode="kld",
        patience=ELASTIC_PATIENCE, ess=ESS, beams=SWEEP_B,
        frames=ELASTIC_FRAMES, raw_frames=ELASTIC_FRAMES // 2,
        kidnap_at=KIDNAP_AT, kidnap_pose=list(kidnap), error_replies=len(
            errors), particles=sizes, confidence=conf,
        kld_target=[r["kld_target"] for r in ticks],
        songs=[r["song"] for r in ticks], lattice=lattice,
        min_before_kidnap=min(before),
        sizes_while_confident=shrunk_confident,
        returned_to_n_max=back, replay_equal=first == again,
        crossed_k2_and_k3_limits=crossed, launches=launched,
        k2_device_launches=expand.device_launches() - k2_before,
        k3_device_launches=kmeans.device_launches() - k3_before,
        wall_s=wall)
    if errors or len(ticks) != ELASTIC_FRAMES:
        raise AssertionError(f"elastic: {len(ticks)} tick replies, errors "
                             f"{errors[:3]}")
    if not (back and shrunk_confident and first == again and crossed):
        raise AssertionError(f"elastic: returned={back}, shrunk while "
                             f"confident={bool(shrunk_confident)}, replay "
                             f"equal={first == again}, crossed={crossed}, "
                             f"sizes {sizes}")
    if not all(launched[k] for k in SINGLE):
        raise AssertionError(f"elastic: launches {launched}")
    return launched


# -- phase 3e: K1 batched's map-stack form ---------------------------------

def stack_launch(stack, parts, scan, cfg, form):
    """One map-stack launch in a forced raster form (not counted: a
    comparison with the plain version)."""
    return weights._batched_launch(weights.STACK_ENTRY, stack, parts, scan,
                                   cfg, form=form)


def per_map_equal(stack, singles, got, parts, scan, cfg, form) -> bool:
    """Whether each map's episodes equal a single-map K1 batched launch on
    that map (uncounted, in the same raster form)."""
    index = stack.episode_maps
    same = True
    for i, one in enumerate(singles):
        eps = torch.nonzero(index == i).flatten()
        if eps.numel() == 0:
            continue
        want = weights._batched_launch(
            "mcl_beam_weights_batched", one, parts[eps],
            sensor.Scan(scan.angles, scan.ranges[eps], scan.mask[eps]), cfg,
            form=form)
        same = same and torch.equal(got[eps], want)
    return same


def check_stack(gen) -> dict:
    """K1 batched's map-stack form at 0.0 max-abs error from the plain
    version and equal to single-map launches map by map: M in STACK_MAPS
    mixed maps at E = 2 M, both ray modes, both combines and both raster
    forms (forced); a stack of random mazes past shared memory in the
    device form; and E = 65,543 episodes with the map index changing
    across the chunk boundary at 65,535, whose last 16 episodes equal a
    call of their own."""
    dev = gen.device
    worst = 0.0
    cases = []
    for n_maps in STACK_MAPS:
        stack = generator.generate_map_batch(n_maps, style="mixed",
                                             device=dev)
        cases.append((f"{n_maps} mixed maps", repeat_maps(stack, 2),
                      ("fixed", "analytic"), ("shared", "device"), SWEEP_N,
                      SWEEP_B))
    for mode in ("fixed", "analytic"):
        cells = device_form_cells(mode)
        big = stack_maps([random_maze(cells, cells, dev, seed=cells + s)
                          for s in range(STACK_BIG_MAPS)])
        cases.append((f"{STACK_BIG_MAPS} random {cells}-cell mazes",
                      repeat_maps(big, 2), (mode,), ("device",), 500, 24))
    for name, stack, modes, forms, n, nb in cases:
        singles = [stack.map_at(i) for i in range(stack.maps)]
        n_ep = stack.episode_maps.shape[0]
        for mode in modes:
            for comb in ("sum", "log"):
                cfg = SensorModelConfig(ray_mode=mode, beam_combine=comb)
                parts, scan = batched_inputs(stack, n_ep, n, nb, cfg, gen)
                want = weights.beam_weights_plain(stack, parts, scan, cfg)
                for form in forms:
                    got = stack_launch(stack, parts, scan, cfg, form)
                    err = (got - want).abs().max().item()
                    same = per_map_equal(stack, singles, got, parts, scan,
                                         cfg, form)
                    torch.cuda.synchronize()
                    worst = max(worst, err)
                    say("check", kernel="beam_weights_stack", maps=name,
                        episodes=n_ep, n=n, beams=nb, ray_mode=mode,
                        combine=comb, form=form,
                        raster=list(stack.occ.shape[1:]), max_abs_err=err,
                        equals_single_map_launches=same)
                    if not (err == 0.0 and same
                            and torch.isfinite(got).all()):
                        raise AssertionError(
                            f"K1 stack {name} {mode}/{comb} {form}: "
                            f"{err}, per map {same}")
        del stack, singles
    base = generator.generate_map_batch(3, style="mixed", device=dev)
    singles = [base.map_at(i) for i in range(3)]
    index = (torch.arange(F2_E) // 7) % 3
    stack = select_maps(base, index)
    tail = slice(F2_E - 16, None)
    tstack = select_maps(base, index[tail])
    for mode in ("fixed", "analytic"):
        cfg = SensorModelConfig(ray_mode=mode)
        parts, scan = batched_inputs(stack, F2_E, 32, 12, cfg, gen)
        tscan = sensor.Scan(scan.angles, scan.ranges[tail], scan.mask[tail])
        for form in ("shared", "device"):
            got = stack_launch(stack, parts, scan, cfg, form)
            err = (got - weights.beam_weights_plain(stack, parts, scan, cfg)
                   ).abs().max().item()
            alone = torch.equal(got[tail], stack_launch(
                tstack, parts[tail], tscan, cfg, form))
            same = per_map_equal(stack, singles, got, parts, scan, cfg,
                                 form)
            torch.cuda.synchronize()
            worst = max(worst, err)
            say("check", kernel="beam_weights_stack", what="F2",
                episodes=F2_E, maps=3, n=32, beams=12, ray_mode=mode,
                form=form, max_abs_err=err, tail_equals_alone=alone,
                equals_single_map_launches=same,
                maps_in_tail=sorted(set(index[tail].tolist())))
            if err != 0.0 or not (alone and same):
                raise AssertionError(f"K1 stack F2 {mode} {form}: {err}, "
                                     f"{alone}, {same}")
    torch.cuda.empty_cache()
    return dict(max_abs_err=worst)


def stack_time(gen) -> dict:
    """The map-stack form at the full-width sweep's shape (512 mixed maps,
    2 episodes a map, 500 x 24, fixed): CUDA events in turns against its
    plain version, and device time (profiling.device_ms) in turns against
    the single-map K1 batched on the stack's first map with the same
    inputs."""
    dev = gen.device
    stack = repeat_maps(generator.generate_map_batch(
        MULTIMAP_MAPS, style="mixed", device=dev), 2)
    one = stack.map_at(0)
    cfg = SensorModelConfig(ray_mode="fixed")
    parts, scan = batched_inputs(stack, 2 * MULTIMAP_MAPS, SWEEP_N, SWEEP_B,
                               cfg, gen)
    kern = lambda: weights.beam_weights_stack_cuda(stack, parts, scan, cfg)
    single = lambda: weights.beam_weights_batched_cuda(one, parts, scan,
                                                       cfg)
    s1, k1, k2, s2 = (device_ms(single), device_ms(kern), device_ms(kern),
                      device_ms(single))
    row = dict(
        **turns(kern, lambda: weights.beam_weights_plain(stack, parts, scan,
                                                         cfg)),
        **k1_bound(stack, parts, scan.angles, cfg), library_ms=None,
        shape=[2 * MULTIMAP_MAPS, SWEEP_N, SWEEP_B], maps=MULTIMAP_MAPS,
        device_ms=[k1, k2], single_map_device_ms=[s1, s2],
        stack_over_single=float(np.median([k1, k2]) / np.median([s1, s2])))
    say("time", kernel="beam_weights_stack", **row)
    return row


# -- phase 8c: sweeps over randomized maps ----------------------------------

def multimap_row_phase(dev) -> dict:
    """The published JAX row (BENCH_DETAILS.md:572-586): the JAX tool's
    defaults (fixed march, multinomial, 500 x 24, start (1.25, 1.25, 0)),
    64 mixed maps x 2 episodes x 150 ticks, converged 0.6016 on the TPU.
    The maps are the same, the draws are not; raises below 0.47, 3
    binomial standard deviations at 128 episodes."""
    maps = generator.generate_map_batch(MULTIMAP_ROW[0], style="mixed",
                                        device=dev)
    cfg = FilterConfig(num_particles=SWEEP_N, sensor=SensorModelConfig())
    angles = np.deg2rad(np.linspace(-118.0, 118.0, SWEEP_B)
                        ).astype(np.float32)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, _, truth = episodes.run_multimap_sweep(
        0, maps, cfg, angles, MULTIMAP_ROW[2],
        episodes_per_map=MULTIMAP_ROW[1], start_pose=START)
    metrics = episodes.sweep_rmse(final, truth)
    wall = time.perf_counter() - t0
    launched, replayed = counts(), replay_counts()
    say("multimap_row", maps=MULTIMAP_ROW[0],
        episodes_per_map=MULTIMAP_ROW[1], ticks=MULTIMAP_ROW[2],
        style="mixed", particles=SWEEP_N, beams=SWEEP_B, ray_mode="fixed",
        resample="multinomial", launches=launched, replayed=replayed,
        wall_s=wall, jax_converged_frac=0.6016, **metrics)
    if replayed["beam_weights_stack"] != MULTIMAP_ROW[2]:
        raise AssertionError(f"multimap row: K1 stack replayed "
                             f"{replayed['beam_weights_stack']} times")
    if not metrics["converged_frac"] >= 0.47:
        raise AssertionError(f"multimap row: converged "
                             f"{metrics['converged_frac']} < 0.47")
    return metrics


def multimap_phase(dev) -> dict:
    """The full-width sweep over randomized maps: 512 mixed maps x 2
    episodes = 1024 episodes x 500 x 24 x 300 ticks, fixed march,
    systematic resampling (the plain sweep's schedule), through
    run_multimap_sweep; K1 batched's map-stack form, K2 batched and K3
    batched must each launch once a tick."""
    maps = generator.generate_map_batch(MULTIMAP_MAPS, style="mixed",
                                        device=dev)
    cfg = FilterConfig(num_particles=SWEEP_N,
                       sensor=SensorModelConfig(ray_mode="fixed"),
                       resample=ResampleConfig(method="systematic"))
    angles = np.deg2rad(np.linspace(-118.0, 118.0, SWEEP_B)
                        ).astype(np.float32)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, _, truth = episodes.run_multimap_sweep(
        0, maps, cfg, angles, SWEEP_T, episodes_per_map=2,
        start_pose=START)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, replayed = counts(), replay_counts()
    metrics = episodes.sweep_rmse(final, truth)
    ran = {k: replayed[k] for k in ("beam_weights_stack",
                                    "systematic_expand_batched",
                                    "kmeans_batched")}
    say("multimap", maps=MULTIMAP_MAPS, episodes_per_map=2,
        episodes=2 * MULTIMAP_MAPS, particles=SWEEP_N, beams=SWEEP_B,
        ticks=SWEEP_T, style="mixed", ray_mode="fixed",
        resample="systematic", launches=launched, replayed=replayed,
        wall_s=wall, ticks_per_sec=SWEEP_T / wall,
        updates_per_sec=2 * MULTIMAP_MAPS * SWEEP_N * SWEEP_B * SWEEP_T
        / wall, **metrics)
    if any(v != SWEEP_T for v in ran.values()):
        raise AssertionError(f"multimap: kernels not replayed once a tick: "
                             f"{ran}")
    if not torch.isfinite(final.particles).all():
        raise AssertionError("multimap: non-finite particles")
    return launched, replayed


# -- phase 10: an imported map, the CLI and the replay ----------------------

def imported_map_phase(dev) -> None:
    """A generated 32 x 32-cell maze exported with pgm.export_map to a
    map_server YAML + PGM (its bit words past 1 KB: the device form),
    reloaded through presets.make_world(map_path=...) and localised by the
    localisation preset at 1500 x 24; then the same raster with a non-zero
    origin kept (keep_origin=True), tracked from a known start shifted by
    the origin.  K1 must launch every tick of both."""
    walls = generator.generate_maze(IMPORT_CELLS, IMPORT_CELLS, seed=11)
    src = from_walls(walls, device=dev)
    with tempfile.TemporaryDirectory() as tmp:
        yaml = os.path.join(tmp, "maze.yaml")
        pgm.export_map(src, os.path.join(tmp, "maze.pgm"), yaml)
        world = presets.make_world(map_path=yaml, num_particles=IMPORT_N,
                                   num_beams=SWEEP_B, device=dev)
        shifted = os.path.join(tmp, "shifted.yaml")
        with open(shifted, "w") as f:
            f.write("image: maze.pgm\nresolution: 0.1\n"
                    f"origin: [{IMPORT_ORIGIN[0]}, {IMPORT_ORIGIN[1]}, "
                    "0.0]\n")
        kept = pgm.from_pgm(shifted, keep_origin=True, device=dev)
    if not (torch.equal(world.maze.occ, src.occ)
            and torch.equal(kept.occ, src.occ)):
        raise AssertionError("imported map: raster differs from its source")
    form = weights.raster_form(world.maze, world.cfg.sensor)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, outs, truth = presets.run_localisation(world, seed=0,
                                                  num_ticks=IMPORT_TICKS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, replayed = counts(), replay_counts()
    best, tp = final.best_pose.cpu().numpy(), truth[-1].cpu().numpy()
    say("imported_map", cells=IMPORT_CELLS, raster=list(src.occ.shape),
        raster_bytes=4 * weights.raster_words(world.maze, world.cfg.sensor),
        form=form, particles=IMPORT_N, beams=SWEEP_B, ticks=IMPORT_TICKS,
        launches=launched, wall_s=wall, confidence=float(final.confidence),
        best_pose=best.tolist(), true_pose=tp.tolist(),
        position_error_m=float(np.hypot(*(best[:2] - tp[:2])))
        if best[0] >= 0 else None)
    if form != "device" or replayed["beam_weights"] != IMPORT_TICKS \
            or not torch.isfinite(final.particles).all():
        raise AssertionError(f"imported map: form {form}, {launched}")
    # keep_origin: the same wander in world coordinates shifted by the
    # origin, tracked from a known start.
    start = (2.05 + IMPORT_ORIGIN[0], 2.05 + IMPORT_ORIGIN[1], 0.0)
    cfg = world.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(12)
    enc, ranges, poses = robot.generate_wander_episode(
        gen, kept, cfg, world.angles, IMPORT_TICKS, start_pose=start)
    state = mcl.init_tracking_state(kept, cfg, start, seed=13)
    reset_counts()
    final, outs = mcl.run_episode(state, enc[0], ranges[0], world.angles,
                                  kept, cfg)
    torch.cuda.synchronize()
    launched, replayed = counts(), replay_counts()
    ep = outs.exact_pose[1:].cpu().numpy()
    tp = poses[0, :-1].cpu().numpy()
    ok = ep[:, 0] >= 0      # not the -1 sentinel: the origin is positive
    err = np.hypot(ep[:, 0] - tp[:, 0], ep[:, 1] - tp[:, 1])[ok]
    say("imported_map", what="keep_origin", origin=list(IMPORT_ORIGIN),
        ticks=IMPORT_TICKS, launches=launched,
        confident_share=float(ok.mean()),
        tracking_rmse_m=float(np.sqrt((err ** 2).mean())) if ok.any()
        else None, final_confidence=float(final.confidence))
    if replayed["beam_weights"] != IMPORT_TICKS or not bool(
            torch.isfinite(final.particles).all()):
        raise AssertionError(f"imported map keep_origin: {launched}")


def _flat(v) -> list:
    """The numbers of a JSON value, nested lists opened."""
    if isinstance(v, list):
        return [x for item in v for x in _flat(item)]
    return [v]


def cli_phase() -> None:
    """The CLI's localisation, moving, planning, challenge, mapping and
    slam presets on the card (planning and challenge at their defaults:
    1500 x 24, 800 and 2000 ticks), each line well-formed and finite
    (CLI_NULLABLE values may be null).  The processes run together, each
    with its own CUDA context: a line's seconds run from their common
    start to its process's end."""
    t0 = time.perf_counter()
    runs = []
    try:
        for args, _ in CLI_RUNS:
            out, err = tempfile.TemporaryFile("w+"), tempfile.TemporaryFile(
                "w+")
            runs.append((subprocess.Popen([sys.executable, "-m", PKG, *args],
                                          stdout=out, stderr=err,
                                          text=True), out, err))
        for (args, keys), (proc, out, err) in zip(CLI_RUNS, runs):
            proc.wait(timeout=600)
            out.seek(0)
            err.seek(0)
            if proc.returncode != 0:
                raise AssertionError(f"CLI {args}: {err.read()[-2000:]}")
            line = json.loads(out.read().strip().splitlines()[-1])
            # position_error_m is null exactly where the filter is not
            # localised (best_pose at the -1 sentinel).
            unlocalised = line.get("best_pose", [0.0])[0] < 0
            flat = []
            for k, v in line.items():
                if k in CLI_TEXT or (k == "position_error_m"
                                     and unlocalised) \
                        or (k in CLI_NULLABLE and v is None):
                    continue
                flat += _flat(v)
            finite = all(isinstance(v, (int, float)) and math.isfinite(v)
                         for v in flat)
            say("cli", args=args, seconds=time.perf_counter() - t0,
                line=line, finite=finite)
            if set(line) != keys or not finite:
                raise AssertionError(f"CLI {args}: {line}")
    finally:
        for proc, out, err in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
            err.close()


def replay_phase(dev) -> dict:
    """The shipped fixture replayed by REPLAY_REPLICAS replicas of 500
    particles with ray_mode="dda" (tests/test_replay_fixture.py:40-53),
    as run_episode_replicas runs them: one batch, then the replica with the
    most log evidence.  Reports the share of replicas that end confident
    (> 0.5) within 0.2 m of the truth; raises if none does."""
    log = EpisodeLog.load(FIXTURE)
    world = presets.make_world(device=dev)
    cfg = FilterConfig(num_particles=SWEEP_N,
                       sensor=SensorModelConfig(ray_mode="dda"))
    rep = REPLAY_REPLICAS
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, outs = episodes.run_episode_batch(
        2, world.maze, cfg, np.repeat(log.encoders[None], rep, 0),
        np.repeat(log.scan_ranges[None], rep, 0), log.scan_angles)
    win, _, info = episodes.pick_replicas(final, outs, rep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    truth = torch.as_tensor(log.true_poses[-1], device=dev)
    best = final.best_pose
    err = torch.hypot(best[:, 0] - truth[0], best[:, 1] - truth[1])
    good = (final.confidence > 0.5) & (best[:, 0] >= 0) & (err < 0.2)
    wb = win.best_pose[0]
    werr = (float(torch.hypot(wb[0] - truth[0], wb[1] - truth[1]))
            if float(wb[0]) >= 0 else None)
    say("replay", fixture=os.path.relpath(FIXTURE), ticks=log.num_ticks,
        replicas=rep, particles=SWEEP_N, ray_mode="dda",
        launches=counts(), wall_s=wall,
        good_share=float(good.float().mean()),
        winner=int(info["chosen"][0]),
        winner_confidence=float(win.confidence[0]),
        winner_error_m=werr)
    if not bool(good.any()):
        raise AssertionError("replay: no replica ends confident within "
                             "0.2 m of the truth")
    return dict(good_share=float(good.float().mean()))


# -- phase 11: the compiled tick, graphs against eager ticks ---------------

# Ticks of the episode A/Bs: two graphs of TICKS_PER_GRAPH and the
# remainder's.  Frames of the server A/Bs.
GRAPH_T = 20
GRAPH_FRAMES = 30
# The port's kernels as the profiler names them (csrc/*.cu).
DEVICE_KERNELS = ("beam_weights_kernel", "beam_weights_batched_kernel",
                  "beam_weights_cast_kernel",
                  "pack_kernel", "expand_block_kernel", "expand_scan_kernel",
                  "expand_copy_kernel", "kmeans_kernel", "beamsub_kernel",
                  "refine_grad_kernel", "refine_score_kernel",
                  "ism_update_kernel")


@contextlib.contextmanager
def eager_ticks():
    """Inside, every graph built runs its ticks as eager calls on its
    buffers, as it does on the CPU (a TickGraph without its capture), from
    a cache of its own: the eager side of each A/B.  The servers built
    inside hold such graphs for their lives."""
    capture, cache = compiled.TickGraph._capture, compiled.graphs
    compiled.TickGraph._capture = lambda self: None
    compiled.graphs = compiled.GraphCache()
    try:
        yield
    finally:
        compiled.TickGraph._capture = capture
        compiled.graphs = cache


def timed(fn):
    """(fn(), host seconds), the card synchronized at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def same_gen(gen):
    """A generator of gen's device in gen's state."""
    g = torch.Generator(device=gen.device)
    g.set_state(gen.get_state())
    return g


def differing(a, b) -> list:
    """The names of the tensors of two results (states, outputs, tuples
    or dicts of tensors) that are not bit-equal, generator states
    included."""
    bad = []

    def walk(x, y, name):
        if isinstance(x, torch.Tensor):
            if not torch.equal(x, y):
                bad.append(name)
        elif isinstance(x, torch.Generator):
            if not torch.equal(x.get_state(), y.get_state()):
                bad.append(name)
        elif dataclasses.is_dataclass(x):
            for f in dataclasses.fields(x):
                walk(getattr(x, f.name), getattr(y, f.name),
                     f"{name}.{f.name}")
        elif isinstance(x, (tuple, list)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{name}[{i}]")
        elif isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{name}.{k}")
        elif x != y:
            bad.append(name)

    walk(a, b, "")
    return bad


def new_entries(before: set) -> dict:
    """Capture statistics of the module cache's graphs that are not among
    `before` (a set of ids)."""
    gs = [g for g in compiled.graphs.entries() if id(g) not in before]
    return dict(graphs_built=len(gs),
                capture_s=sum(g.capture_s for g in gs),
                instantiate_s=sum(g.instantiate_s for g in gs),
                pool_mib=sum(g.pool_bytes for g in gs) / 2**20)


# Idle time at each end of a launch audit's profile (launch_audit): at
# least AUDIT_MARGIN_S, and after the block at least the block's own wall
# time.  With no margin a profile lost the block's last kernel in 2 of 25
# probes; with 50 ms, none of 25 probes and 120 audits did.
AUDIT_MARGIN_S = 0.05
# Each kernel family of the port: the names of its kernels in a profile
# (one of them launched once a wrapper call), and the KERNELS entries of
# the wrappers that launch them.
LAUNCH_AUDIT = (
    # In analytic mode K1 and K1 batched launch one kernel, the cast's.
    (("beam_weights_kernel", "beam_weights_batched_kernel",
      "beam_weights_cast_kernel"),
     ("beam_weights", "beam_weights_batched", "beam_weights_stack")),
    (("beamsub_kernel",), ("beam_weights_beamsub",)),
    (("expand_block_kernel", "expand_copy_kernel"),
     ("systematic_expand", "systematic_expand_batched")),
    (("kmeans_kernel",), ("kmeans", "kmeans_batched")),
    (("refine_grad_kernel",), ("refine_grad",)),
    (("refine_score_kernel",), ("refine_score",)),
    (("ism_update_kernel",), ("ism_update",)),
)
# The C entries' device launch counters and the kernels each counts.
DEVICE_AUDIT = (
    (("expand_block_kernel", "expand_scan_kernel", "expand_copy_kernel"),
     expand.device_launches),
    (("kmeans_kernel",), kmeans.device_launches),
)


def _kernel_count(names: dict, kernels) -> int:
    """The launches of `kernels` among a profile's kernel counts by name
    ("void (anonymous namespace)::kmeans_kernel<3, false>(...)")."""
    return sum(n for name, n in names.items()
               if any(f"::{k}<" in name or f"::{k}(" in name
                      for k in kernels))


@contextlib.contextmanager
def launch_audit(what: str):
    """torch.profiler over the block: the port's kernels that ran on the
    card, by family, must equal the launches the wrappers' counters and
    the C entries' device counters added in the block, or a raise.  Where
    the block only replays graphs, each replay added its capture's counts:
    this holds them against what the card ran.  Yields a dict that gets
    the counts and the replays' share of them."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    launched, replays = counts(), replay_counts()
    device = [f() for _, f in DEVICE_AUDIT]
    row = {}
    # The profile's margins: stopped right after the block's last kernel,
    # a profile at times lost that kernel's tick (the last of a replay,
    # or the last frame of a server), though kernels launched after it
    # were recorded.  Idle time at each end, the tail's growing with the
    # block's length, keeps the block's kernels inside the profile.
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(AUDIT_MARGIN_S)
        t0 = time.perf_counter()
        yield row
        torch.cuda.synchronize()
        time.sleep(max(AUDIT_MARGIN_S, time.perf_counter() - t0))
    names = {}
    for ev in prof.key_averages():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            names[ev.key] = names.get(ev.key, 0) + ev.count
    launched = {k: v - launched[k] for k, v in counts().items()}
    replays = {k: v - replays[k] for k, v in replay_counts().items()}
    bad = []
    for kernels, wrappers in LAUNCH_AUDIT:
        ran = _kernel_count(names, kernels)
        claimed = sum(launched[w] for w in wrappers)
        row[kernels[0]] = dict(ran=ran, counted=claimed,
                               replayed=sum(replays[w] for w in wrappers))
        if ran != claimed:
            bad.append((kernels, ran, claimed))
    for (kernels, f), before in zip(DEVICE_AUDIT, device):
        ran, claimed = _kernel_count(names, kernels), f() - before
        if ran != claimed:
            bad.append((kernels, ran, claimed))
    say("graphs", what=what, audit="kernels run against launch counts",
        **row)
    if bad:
        raise AssertionError(f"graphs {what}: the card ran other kernel "
                             f"counts than the counters claim (kernels, "
                             f"ran, counted): {bad}")


def replay_profile(run) -> dict:
    """torch.profiler over 3 calls of `run` (one graph replay each, after
    one unprofiled call): per replay its device ms, the launches and syncs
    on the host, and the port's kernels that ran inside it; the busy share
    is that device time over the wall time of 5 unprofiled calls (the
    profiler's own cost would lower it)."""
    prof = device_profile(run, 3)
    names = prof.pop("names")
    ran = sorted(k for k in names if any(d in k for d in DEVICE_KERNELS))
    _, wall_s = timed(lambda: [run() for _ in range(5)])
    wall_ms = 1e3 * wall_s / 5
    return dict(replay_wall_ms=wall_ms,
                replay_wall_ms_profiled=prof["wall_ms_per_tick"],
                replay_device_ms=prof["device_ms_per_tick"],
                replay_busy_share=prof["device_ms_per_tick"] / wall_ms,
                replay_device_ops=prof["device_ops_per_tick"],
                host_launch_calls=prof["host_launch_calls_per_tick"],
                host_sync_calls=prof["host_sync_calls_per_tick"],
                kernels_in_replay=ran)


def ab(what: str, run, ticks: int, audit=None, **fields) -> dict:
    """run() from the same seeds eagerly (eager_ticks), then through the
    graphs twice (the first builds and captures, the second replays): the
    three results bit-equal or a raise; host seconds of each and the new
    graphs' capture statistics.  A fourth run, of replays only, goes
    through launch_audit; or `audit()`, where one run holds more kernels
    than the profiler keeps."""
    with eager_ticks():
        eager, eager_s = timed(run)
    before = {id(g) for g in compiled.graphs.entries()}
    first, first_s = timed(run)
    stats = new_entries(before)
    graph, graph_s = timed(run)
    with launch_audit(what) as audited:
        (audit or run)()
    bad = sorted(set(differing(eager, first) + differing(eager, graph)))
    row = dict(what=what, ticks=ticks, bit_equal=not bad, eager_s=eager_s,
               graph_first_s=first_s, graph_s=graph_s,
               eager_ms_per_tick=1e3 * eager_s / ticks,
               graph_ms_per_tick=1e3 * graph_s / ticks, **stats,
               launch_audit=audited, **fields)
    say("graphs", **row)
    if bad:
        raise AssertionError(f"graphs {what}: graph and eager ticks differ "
                             f"in {bad[:8]}")
    return row


def sync_free(what: str, world, n_ep=None) -> None:
    """One eager mcl_step under torch.cuda.set_sync_debug_mode("error"):
    a tick that waits for the card anywhere raises, and could not be
    captured.  The encoders come as Python floats (one filter) or tensors
    (a batch)."""
    m, cfg = world.maze, world.cfg
    b = () if n_ep is None else (n_ep,)
    scan = sensor.Scan(
        angles=torch.as_tensor(world.angles, device=m.device),
        ranges=sensor.simulate_scan(m, START, world.angles, cfg.sensor
                                    ).ranges.expand(b + (len(world.angles),)
                                                    ).contiguous(),
        mask=torch.ones(b + (len(world.angles),), dtype=torch.bool,
                        device=m.device))
    enc = 0.1 if n_ep is None else torch.full(b, 0.1, device=m.device)
    state = mcl.init_state(m, cfg, 30, batch=n_ep)
    mcl.mcl_step(state, enc, enc, scan, m, cfg)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        mcl.mcl_step(state, enc, enc, scan, m, cfg)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    say("graphs", what=what, eager_tick_host_syncs=0)


def serve_lines(world, frames: int, seed: int) -> list:
    """JSONL frames of a short drive from START, the ranges simulated."""
    enc, truth = drive(frames)
    ranges = scans(world.maze, truth, world.angles, world.cfg.sensor,
                   seed=seed).cpu().numpy()
    return [json.dumps(dict(encoder_left=float(e[0]),
                            encoder_right=float(e[1]),
                            ranges=[float(r) for r in z]))
            for e, z in zip(enc, ranges)]


def serve_replies(server, lines) -> tuple:
    """(reply lines, host ms between consecutive replies)."""
    out = Replies()
    t0 = time.perf_counter()
    server.serve(lines, out_stream=out)
    torch.cuda.synchronize()
    return out.lines, np.diff(np.array([t0] + out.times)) * 1e3


def ab_server(what: str, make, lines, ticks: int, **fields) -> dict:
    """A server built by make() answers `lines` eagerly, then a new one
    through its graphs (built and captured at its first frame of each
    shape): equal replies or a raise; median and p90 latency over the
    first `ticks` replies, and the first frame's.  Three more frames on
    the graphed server go through launch_audit."""
    with eager_ticks():
        eager, eager_lat = serve_replies(make(), lines)
    server = make()
    graph, graph_lat = serve_replies(server, lines)
    g = server._graphs.stats()
    with launch_audit(what) as audit:
        serve_replies(server, lines[:3])
    lat = {f"{side}_ms_{q}": float(np.percentile(v[:ticks], p))
           for side, v in (("eager", eager_lat), ("graph", graph_lat))
           for q, p in (("median", 50), ("p90", 90))}
    errors = [r for r in eager + graph if '"error"' in r]
    if errors:
        raise AssertionError(f"graphs {what}: error replies {errors[:2]}")
    row = dict(what=what, frames=len(lines), replies_equal=eager == graph,
               **lat, graph_ms_first=float(graph_lat[0]),
               graphs_built=g["entries"], capture_s=g["capture_s"],
               instantiate_s=g["instantiate_s"],
               pool_mib=g["pool_bytes"] / 2**20, launch_audit=audit,
               **fields)
    say("graphs", **row)
    if not row["replies_equal"]:
        diff = next((i for i, (a, b) in enumerate(zip(eager, graph))
                     if a != b), min(len(eager), len(graph)))
        raise AssertionError(f"graphs {what}: reply {diff} differs: "
                             f"{eager[diff:diff + 1]} / "
                             f"{graph[diff:diff + 1]}")
    return row


def episode_inputs(world, n_ep, seed):
    """Encoders [.., T, 2] and ranges [.., T, B] of a drive for one filter,
    of a wander for a batch."""
    m, cfg = world.maze, world.cfg
    if n_ep is None:
        enc, truth = drive(GRAPH_T)
        return (torch.as_tensor(enc, device=m.device),
                scans(m, truth, world.angles, cfg.sensor, seed=seed))
    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, m, cfg, world.angles, GRAPH_T, batch=n_ep, start_pose=START)
    return enc, ranges


def ab_episode(what: str, world, n_ep, seed: int, direct: bool = False,
               **fields) -> dict:
    """run_episode over GRAPH_T ticks from one state, eager and through
    the graphs; with `direct`, also against mcl_step called tick by tick
    outside any graph; then one K-tick replay profiled."""
    m, cfg = world.maze, world.cfg
    enc, ranges = episode_inputs(world, n_ep, seed)
    state = mcl.init_state(m, cfg, seed, batch=n_ep)

    def run():
        return mcl.run_episode(
            dataclasses.replace(state, gen=same_gen(state.gen)), enc, ranges,
            world.angles, m, cfg)

    row = ab(what, run, GRAPH_T, **fields)
    if direct:
        st = dataclasses.replace(state, gen=same_gen(state.gen))
        angles = torch.as_tensor(world.angles, device=m.device)
        lead = len(st.batch)
        outs = []
        for t in range(GRAPH_T):
            e = enc.select(lead, t)
            sc = sensor.Scan(angles=angles, ranges=ranges.select(lead, t),
                             mask=torch.ones(ranges.select(lead, t).shape,
                                             dtype=torch.bool,
                                             device=m.device))
            st, o = mcl.mcl_step(st, e[..., 0], e[..., 1], sc, m, cfg)
            outs.append(o)
        direct_out = mcl.MCLOutput(**{
            f.name: torch.stack([getattr(o, f.name) for o in outs], dim=lead)
            for f in dataclasses.fields(mcl.MCLOutput)})
        bad = differing((st, direct_out), run())
        say("graphs", what=what, against="mcl_step tick by tick",
            bit_equal=not bad)
        if bad:
            raise AssertionError(f"graphs {what}: the graphs differ from "
                                 f"mcl_step tick by tick in {bad[:8]}")
    row.update(profile_ticks(what, state, enc, ranges, world.angles, m,
                             cfg))
    return row


def tick_replay(state, enc, ranges, angles, m, cfg):
    """A function that replays the filter's graph of TICKS_PER_GRAPH ticks
    on the first ticks of the episode inputs enc and ranges, from `state`
    and then from the state it left."""
    k = compiled.TICKS_PER_GRAPH
    sl = [v.narrow(len(state.batch), 0, k) for v in (enc, ranges)]
    mask = torch.ones(sl[1].shape, dtype=torch.bool, device=m.device)
    angles = torch.as_tensor(angles, device=m.device)
    holder = [state]

    def replay():
        holder[0] = mcl.run_ticks(holder[0], sl[0], sl[1], mask, angles, m,
                                  cfg)[0]

    return replay


def profile_ticks(what: str, state, enc, ranges, angles, m, cfg) -> dict:
    """replay_profile of tick_replay."""
    prof = replay_profile(tick_replay(state, enc, ranges, angles, m, cfg))
    say("graphs", what=what,
        profile=f"one replay of {compiled.TICKS_PER_GRAPH} ticks", **prof)
    return prof


def sweep_parts(world, n_ep, seed, maps=None):
    """The sweep's two halves timed apart: the wander of n_ep robots and
    the filter over their episodes; returns the results and the
    seconds."""
    m = world.maze if maps is None else maps
    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    wander, wander_s = timed(lambda: robot.generate_wander_episode(
        gen, m, world.cfg, world.angles, GRAPH_T, batch=n_ep,
        start_pose=START))
    filt, filter_s = timed(lambda: episodes.run_episode_batch(
        seed + 1, m, world.cfg, wander[0], wander[1], world.angles))
    return (wander, filt), wander_s, filter_s


def ab_sweep(what: str, world, n_ep, seed: int, maps=None,
             profile: bool = True, **fields) -> dict:
    """A sweep's wander and filter over GRAPH_T ticks, eager and through
    the graphs, each half timed; with `profile`, one replay of the
    filter's graph profiled, else only that replay's launches audited
    (path (a): a whole run holds more kernels than the profiler keeps)."""
    split, last = {}, []
    m = world.maze if maps is None else maps

    def run():
        out, w_s, f_s = sweep_parts(world, n_ep, seed, maps)
        split.setdefault("wander_s", []).append(w_s)
        split.setdefault("filter_s", []).append(f_s)
        last[:] = [out]
        return out

    def one_replay():
        # From a copy of the generator: the run's result stays as it was.
        (enc, ranges, _), (final, _) = last[0]
        tick_replay(dataclasses.replace(final, gen=same_gen(final.gen)),
                    enc, ranges, world.angles, m, world.cfg)()

    row = ab(what, run, GRAPH_T, audit=None if profile else one_replay,
             **fields)
    if profile:
        (enc, ranges, _), (final, _) = run()
        row.update(profile_ticks(what, final, enc, ranges, world.angles, m,
                                 world.cfg))
    ws, fs = split["wander_s"], split["filter_s"]
    row.update(wander_ms_per_tick=dict(
        eager=1e3 * ws[0] / GRAPH_T, graph=1e3 * min(ws[1:]) / GRAPH_T),
        filter_ms_per_tick=dict(eager=1e3 * fs[0] / GRAPH_T,
                                graph=1e3 * min(fs[1:]) / GRAPH_T))
    say("graphs", what=what, split="wander / filter", **{
        k: row[k] for k in ("wander_ms_per_tick", "filter_ms_per_tick")})
    return row


def ab_full(what: str, run, ticks: int, **fields) -> dict:
    """A whole sweep eagerly (eager_ticks) and through the graphs: its
    metrics (floats) equal or a raise, and the two wall times."""
    with eager_ticks():
        eager, eager_s = timed(run)
    graph, graph_s = timed(run)
    row = dict(what=what, ticks=ticks, metrics_equal=eager == graph,
               eager_wall_s=eager_s, graph_wall_s=graph_s, **graph,
               **fields)
    say("graphs", **row)
    if eager != graph:
        raise AssertionError(f"graphs {what}: eager {eager} != graph "
                             f"{graph}")
    return row


def bench_rows(dev) -> list:
    """The port's bench at 1M x 34 (analytic, systematic), every tick
    resampled and under the ESS gate, at --scan-chunk 1 and 8."""
    rows = []
    for ess in (None, ESS):
        for chunk in (1, 8):
            args = bench.parse_args(["--scan-chunk", str(chunk)] + (
                [] if ess is None else ["--ess", str(ess)]))
            r = bench.bench_full_step(bench.filter_config(args), args.beams,
                                      10, scan_chunk=chunk)
            rows.append(dict(scan_chunk=chunk, ess=ess,
                             updates_per_sec=r["updates_per_sec"],
                             ms_per_step=r["ms_per_step"]))
            say("graphs", what="bench", particles=args.particles,
                beams=args.beams, **rows[-1])
    return rows


def graphs_phase(dev) -> dict:
    """Each configuration through the graphs against the same ticks run
    eagerly (eager_ticks), from the same state and generator state: bit for
    bit, or a raise.  The module cache is emptied after each, so that its
    graphs' memory goes back."""
    rows = []

    def world(n, nb, mode, method, **kw):
        return presets.make_world(num_particles=n, num_beams=nb,
                                  ray_mode=mode, resample_method=method,
                                  device=dev, **kw)

    def done():
        compiled.graphs.clear()
        torch.cuda.empty_cache()

    big = world(SERVE_N, SERVE_B, "analytic", "systematic")
    big_ess = world(SERVE_N, SERVE_B, "analytic", "systematic",
                    ess_threshold=ESS)
    sync_free("1m_tick", big)
    sync_free("1m_ess_tick", big_ess)
    rows.append(ab_episode("1m_run_episode", big, None, 21, direct=True,
                           particles=SERVE_N, beams=SERVE_B))
    done()
    rows.append(ab_episode("1m_ess_run_episode", big_ess, None, 22,
                           particles=SERVE_N, beams=SERVE_B, ess=ESS))
    done()
    lines = serve_lines(big, SERVE_TICKS, seed=23)
    for w, name in ((big, "1m_serve"), (big_ess, "1m_ess_serve")):
        rows.append(ab_server(name, lambda w=w: MCLServer(
            w.maze, w.cfg, w.angles, seed=0), lines, SERVE_TICKS,
            particles=SERVE_N, beams=SERVE_B))
    del big, big_ess
    rows.append(dict(what="bench", rows=bench_rows(dev)))
    done()
    entry = world(ENTRY_N, ENTRY_B, "fixed", "multinomial")
    sync_free("entry_tick", entry)
    rows.append(ab_episode("entry_run_episode", entry, None, 24,
                           particles=ENTRY_N, beams=ENTRY_B))
    done()
    cli = world(1500, SWEEP_B, "fixed", "multinomial")
    rows.append(ab_server("cli_serve", lambda: MCLServer(
        cli.maze, cli.cfg, cli.angles, seed=0), serve_lines(
            cli, GRAPH_FRAMES, seed=25), GRAPH_FRAMES, particles=1500,
        beams=SWEEP_B))
    fleet = world(FLEET_N, FLEET_B, "fixed", "multinomial")
    flines = fleet_lines(fleet, FLEET_TICKS, seed=26)
    for pipe in (False, True):
        rows.append(ab_server(
            "fleet_pipelined" if pipe else "fleet", lambda pipe=pipe:
            MCLFleetServer(fleet.maze, fleet.cfg, fleet.angles,
                           n_robots=FLEET_R, seed=0, pipeline=pipe),
            flines, FLEET_TICKS, robots=FLEET_R, particles=FLEET_N,
            beams=FLEET_B))
    sweep = world(SWEEP_N, SWEEP_B, "fixed", "systematic")
    sync_free("sweep_tick", sweep, SWEEP_E)
    rows.append(ab_sweep("sweep", sweep, SWEEP_E, 27, episodes=SWEEP_E,
                         particles=SWEEP_N, beams=SWEEP_B))
    rows.append(ab_full("sweep_full", lambda: presets.run_sweep(
        sweep, batch=SWEEP_E, num_ticks=SWEEP_T, seed=0), SWEEP_T,
        episodes=SWEEP_E, particles=SWEEP_N, beams=SWEEP_B))
    done()
    maps = generator.generate_map_batch(MULTIMAP_MAPS, style="mixed",
                                        device=dev)
    rows.append(ab_sweep("multimap", sweep, 2 * MULTIMAP_MAPS, 28,
                         maps=repeat_maps(maps, 2),
                         episodes=2 * MULTIMAP_MAPS, particles=SWEEP_N,
                         beams=SWEEP_B))

    def multimap():
        final, _, truth = episodes.run_multimap_sweep(
            0, maps, sweep.cfg, sweep.angles, SWEEP_T, episodes_per_map=2,
            start_pose=START)
        return episodes.sweep_rmse(final, truth)

    rows.append(ab_full("multimap_full", multimap, SWEEP_T,
                        maps=MULTIMAP_MAPS, episodes=2 * MULTIMAP_MAPS,
                        particles=SWEEP_N, beams=SWEEP_B))
    # A second sweep on the same stack replays the first one's graphs.
    kept = (compiled.graphs.builds, len(compiled.graphs))
    _, again_s = timed(multimap)
    say("graphs", what="multimap_full", second_call_wall_s=again_s,
        graphs_built=compiled.graphs.builds - kept[0],
        graphs_kept=len(compiled.graphs))
    if (compiled.graphs.builds, len(compiled.graphs)) != kept:
        raise AssertionError("graphs multimap_full: a second sweep on the "
                             "same stack built graphs")
    del maps
    done()
    prod = world(SWEEP_N, SWEEP_B, "fixed", "systematic", refine_iters=2,
                 ess_threshold=ESS)
    sync_free("path_a_tick", prod, SWEEP_E)
    rows.append(ab_sweep("path_a", prod, SWEEP_E, 29, profile=False,
                         episodes=SWEEP_E, particles=SWEEP_N, beams=SWEEP_B,
                         ess=ESS, refine_iters=2))
    done()
    with tempfile.TemporaryDirectory() as tmp:
        _, _, make, elines = elastic_session(dev, tmp)
        rows.append(ab_server("path_b", make, elines, ELASTIC_FRAMES,
                              adapt=list(ELASTIC), ess=ESS, refine_iters=2))
    done()
    return dict(rows=rows)


# -- phase 12: the control stack -------------------------------------------

# The closed-loop sweep (BASELINE config 5, BENCH_DETAILS.md:595-600): 64
# episodes x 400 ticks at 500 particles x 24 beams, fixed march,
# multinomial, the planning preset's plan (BFS from cell (2, 2) to (4, 4),
# 4 driven waypoints); published on the TPU: median 4/4 waypoints, 70 % of
# the episodes complete.  Its full width is the sweep's 1024 episodes.
CL_E, CL_FULL_E, CL_N, CL_B, CL_T = 64, 1024, 500, 24, 400
CL_GRAPH_T = 16
CL_FLOOR = 0.5
PLAN_START, PLAN_GOAL = (2, 2), (4, 4)
PRESET_N, PLANNING_T, CHALLENGE_T = 1500, 800, 2000
BOX = [[[0, 1, 2, 3]]]


def closed_loop_world(dev):
    """The closed-loop sweep's world and the planning preset's plan: the
    waypoints after the first cell, the start at its centre, heading 0
    (presets.run_planning)."""
    world = presets.make_world(num_particles=CL_N, num_beams=CL_B,
                               ray_mode="fixed",
                               resample_method="multinomial", device=dev)
    path = bfs.bfs_path(world.walls, PLAN_START, PLAN_GOAL)
    wps = closed_loop.mission_waypoints(path)
    return world, wps[1:], (float(wps[0][0]), float(wps[0][1]), 0.0)


def closed_loop_run(world, wps, start, n_ep: int):
    """run_closed_loop over CL_T ticks for n_ep episodes, the counts set
    to 0 just before and read just after: (final state, outputs, row)."""
    before = {id(g) for g in compiled.graphs.entries()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, outs = closed_loop.run_closed_loop(
        world.maze, world.cfg, wps, CL_T, world.angles, start_pose=start,
        seed=0, batch=n_ep)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    reached = final.wp_idx.cpu().numpy()
    row = dict(episodes=n_ep, particles=CL_N, beams=CL_B, ticks=CL_T,
               ray_mode="fixed", resample="multinomial",
               waypoints=len(wps),
               median_waypoints_reached=float(np.median(reached)),
               complete_share=float((reached == len(wps)).mean()),
               wall_s=wall, ms_per_tick=1e3 * wall / CL_T,
               launches=counts(), replayed=replay_counts(),
               **new_entries(before))
    if not bool(torch.isfinite(outs.true_pose).all()):
        raise AssertionError(f"closed loop {n_ep}: non-finite poses")
    return final, outs, row


def closed_loop_busy(what: str, world, wps, state) -> dict:
    """replay_profile of one rollout of TICKS_PER_GRAPH ticks (one graph
    replay) from `state`: device and wall ms a tick, the busy share."""
    k = compiled.TICKS_PER_GRAPH
    prof = replay_profile(lambda: closed_loop.rollout(
        _twin(state), wps, world.maze, world.cfg, k, world.angles))
    row = dict(replay_device_ms_per_tick=prof["replay_device_ms"] / k,
               replay_wall_ms_per_tick=prof["replay_wall_ms"] / k,
               replay_busy_share=prof["replay_busy_share"],
               device_ops_per_tick=prof["replay_device_ops"] / k,
               host_sync_calls_per_replay=prof["host_sync_calls"])
    say("closed_loop", what=what, profile=f"one replay of {k} ticks", **row)
    return row


def closed_loop_row_phase(dev) -> dict:
    """(a) The published closed-loop row at 64 episodes: raises if fewer
    than CL_FLOOR of them complete the plan (published: 70 %, whose
    standard error at 64 episodes is about 5.7 points)."""
    world, wps, start = closed_loop_world(dev)
    final, _, row = closed_loop_run(world, wps, start, CL_E)
    say("closed_loop", row="published", published_complete_share=0.70,
        published_median_waypoints=4, **row)
    row.update(closed_loop_busy("published row", world, wps, final))
    if row["complete_share"] < CL_FLOOR:
        raise AssertionError(f"closed loop: {row['complete_share']} of "
                             f"{CL_E} episodes complete the plan, below "
                             f"{CL_FLOOR}")
    return row


def _twin(state):
    """The closed-loop state with copies of both generators."""
    return dataclasses.replace(
        state, gen=same_gen(state.gen),
        filt=dataclasses.replace(state.filt, gen=same_gen(state.filt.gen)))


def closed_loop_sync_free(world, wps, state) -> None:
    """One eager closed_loop_step under set_sync_debug_mode("error"): a
    tick that waits for the card anywhere raises."""
    m = world.maze
    args = (torch.as_tensor(wps, device=m.device), m, world.cfg,
            torch.as_tensor(world.angles, device=m.device))
    closed_loop.closed_loop_step(_twin(state), *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        closed_loop.closed_loop_step(_twin(state), *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    say("closed_loop", what="eager tick", batch=list(state.batch),
        eager_tick_host_syncs=0)


def closed_loop_full_phase(dev) -> dict:
    """(b) The full width, 1024 episodes: wall time and time a tick (the
    first call captures its graphs, the second replays them); K1 batched
    and K3 batched replayed once a tick, and once a tick by the
    profiler's count over one replay; no host sync in an eager tick, of
    one robot or of the batch; and CL_GRAPH_T ticks from the run's final
    state through the graphs against the same ticks run eagerly, bit for
    bit (states, both generators, every output)."""
    world, wps, start = closed_loop_world(dev)
    m, cfg = world.maze, world.cfg
    for batch in (None, CL_FULL_E):
        closed_loop_sync_free(world, wps, closed_loop.init_closed_loop(
            m, cfg, start, batch=batch))
    _, _, first = closed_loop_run(world, wps, start, CL_FULL_E)
    final, _, row = closed_loop_run(world, wps, start, CL_FULL_E)
    say("closed_loop", row="full width", first_call={
        k: first[k] for k in ("wall_s", "ms_per_tick", "graphs_built",
                              "capture_s", "instantiate_s", "pool_mib",
                              "complete_share")}, **row)
    per_tick = ("beam_weights_batched", "kmeans_batched")
    unbatched = ("beam_weights", "kmeans", "systematic_expand",
                 "systematic_expand_batched")
    if (any(row["replayed"][k] != CL_T for k in per_tick)
            or any(row["launches"][k] for k in unbatched)):
        raise AssertionError(f"closed loop: K1 batched and K3 batched not "
                             f"replayed once a tick, or another kernel "
                             f"ran: {row['launches']}")
    k = compiled.TICKS_PER_GRAPH
    with launch_audit("closed_loop_replay") as audited:
        closed_loop.rollout(_twin(final), wps, m, cfg, k, world.angles)
    # K1's family row (launch_audit's LAUNCH_AUDIT): here K1 batched
    # alone, the launch counts above holding the unbatched ones at zero.
    ran = {name: audited[name]["ran"] for name in ("beam_weights_kernel",
                                                   "kmeans_kernel")}
    if any(v != k for v in ran.values()):
        raise AssertionError(f"closed loop: the card ran {ran} kernels in "
                             f"one replay of {k} ticks")
    row.update(closed_loop_busy("full width", world, wps, final))

    def run():
        return closed_loop.rollout(_twin(final), wps, m, cfg, CL_GRAPH_T,
                                   world.angles)

    ab_row = ab("closed_loop", run, CL_GRAPH_T, episodes=CL_FULL_E,
                particles=CL_N, beams=CL_B)
    return dict(row, graph_against_eager=ab_row)


def presets_phase(dev) -> dict:
    """(c) presets.run_planning (1500 x 24, 800 ticks) and run_challenge
    (1500 x 24, 2000 ticks, 17 driven waypoints) on one robot: waypoints
    reached, final confidence, time a tick, and K1 and K3 replayed once a
    tick.  One episode is chaotic (a seed's success is not a result), so
    only a malformed or non-finite line raises."""
    world = presets.make_world(num_particles=PRESET_N, num_beams=CL_B,
                               device=dev)
    rows = {}
    for name, ticks in (("planning", PLANNING_T), ("challenge", CHALLENGE_T)):
        fn = getattr(presets, f"run_{name}")
        before = {id(g) for g in compiled.graphs.entries()}
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        plan, final, outs = fn(world, seed=0, num_ticks=ticks)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launched, replayed = counts(), replay_counts()
        driven = (len(plan) if name == "planning" else 1 + sum(
            len(leg.path) - 1 for leg in plan.legs)) - 1
        row = dict(particles=PRESET_N, beams=CL_B, ticks=ticks,
                   waypoints=driven, waypoints_reached=int(final.wp_idx),
                   final_confidence=float(final.filt.confidence),
                   wall_s=wall, ms_per_tick=1e3 * wall / ticks,
                   launches=launched, replayed=replayed,
                   **new_entries(before))
        say("presets", preset=name, **row)
        cells = plan if name == "planning" else [plan.legs[0].path[0]] + [
            c for leg in plan.legs for c in leg.path[1:]]
        row.update(closed_loop_busy(
            name, world, closed_loop.mission_waypoints(cells)[1:], final))
        finite = bool(torch.isfinite(outs.true_pose).all()) and math.isfinite(
            row["final_confidence"])
        if (not finite or outs.true_pose.shape != (ticks, 3)
                or final.robot.x.shape != ()
                or any(replayed[k] != ticks for k in ("beam_weights",
                                                      "kmeans"))):
            raise AssertionError(f"presets {name}: malformed or not finite, "
                                 f"or K1 / K3 not replayed once a tick: "
                                 f"{row}")
        rows[name] = row
    return rows


def host_simulators_phase(dev) -> dict:
    """(d) The host-driven simulators on the card, with the JAX suite's
    checks (tests/test_plan_exec.py, tests/test_align.py:169):
    execute_plan's square loop returns to its start, execute_plan_subgoals
    drives a straight plan in one drive, and run_align centres the robot
    in a closed cell from three starts.  Each one's seconds."""
    cfg = FilterConfig()
    out = {}

    def one(x, y, theta):
        return robot.make_robot(x, y, theta, batch=None, device=dev)

    t0 = time.perf_counter()
    _, trace = plan_exec.execute_plan(
        one(2.0, 2.0, 0.0), [DIR_RIGHT, DIR_DOWN, DIR_LEFT, DIR_UP], cfg)
    out["execute_plan_s"] = time.perf_counter() - t0
    want = [(2.8, 2.0), (2.8, 2.8), (2.0, 2.8), (2.0, 2.0)]
    out["square_loop_max_err_m"] = max(
        float(np.hypot(g[0] - w[0], g[1] - w[1]))
        for g, w in zip(trace, want))
    t0 = time.perf_counter()
    _, sub = plan_exec.execute_plan_subgoals(one(0.4, 2.0, 0.0),
                                             [DIR_RIGHT] * 4, cfg)
    out["execute_plan_subgoals_s"] = time.perf_counter() - t0
    out["subgoal_drives"] = len(sub)
    out["subgoal_err_m"] = float(np.hypot(sub[-1][0] - 3.6,
                                          sub[-1][1] - 2.0))
    box = from_walls(BOX, device=dev)
    dda = FilterConfig(sensor=SensorModelConfig(ray_mode="dda"))
    out["align"] = []
    for start in [(0.3, 0.55, 0.3), (0.6, 0.3, -1.0), (0.45, 0.45, 2.0)]:
        t0 = time.perf_counter()
        rb, plan = align_sim.run_align(box, dda, start)
        out["align"].append(dict(
            start=start, seconds=time.perf_counter() - t0,
            actions=len(plan),
            second_rotation=abs(plan[2].value) if len(plan) > 2 else None,
            centre_err_m=float(np.hypot(float(rb.x) - 0.45,
                                        float(rb.y) - 0.45))))
    say("host_simulators", **out)
    bad_align = [a for a in out["align"] if a["actions"] != 4
                 or abs(a["second_rotation"] - 90.0) >= 1e-6
                 or a["centre_err_m"] >= 0.30]
    if (out["square_loop_max_err_m"] >= 0.1 or out["subgoal_drives"] != 1
            or out["subgoal_err_m"] >= 0.15 or bad_align):
        raise AssertionError(f"host simulators: {out}")
    return out


def control_stack_phase(dev) -> dict:
    """Phases (a) to (d) of the control stack; the module cache is emptied
    after them."""
    rows = dict(published=closed_loop_row_phase(dev),
                full=closed_loop_full_phase(dev),
                presets=presets_phase(dev),
                host=host_simulators_phase(dev))
    compiled.graphs.clear()
    torch.cuda.empty_cache()
    return rows


# -- the mapping and SLAM phases ------------------------------------------

# (a) The published RBPF SLAM row (BENCH_DETAILS.md:858-870, the JAX
# tools/slam_sweep.py): episodes x replicas x particles x ticks on the
# default maze, 24 beams, 8 % wheel slip, keyframes 0.15 m / 0.5 rad;
# published on the TPU over four seed sets: mean explored-edge F1 0.798 to
# 0.853, SLAM beats dead reckoning in 12 to 15 of 16, final-quarter error
# 0.215 to 0.348 m, an F1 band of about +-0.03 at 16 episodes.
SLAM_E, SLAM_K, SLAM_P, SLAM_T, SLAM_B = 16, 4, 128, 1000, 24
SLAM_SLIP, SLAM_KF = 0.08, (0.15, 0.5)
SLAM_F1_FLOOR, SLAM_BEATS_FLOOR = 0.75, 10
SLAM_START = (1.25, 1.25, 0.0)
# (b) the tick's invariants; (c) the presets; (d) the servers; (f) render.
INV_E, INV_T, ISM_MAPS = 4, 16, 64
MAPPING_ROBOTS, MAPPING_T, MAPPING_FLOOR = 8, 600, 0.95
# The slam preset at the CLI's defaults, with the mission.
SLAM_PRESET = dict(num_ticks=1000, num_particles=128, slip_noise=0.03,
                   mission=True, mission_ticks=2000)
AUDIT_T = 16
SERVE_FRAMES, FLEET_ROBOTS, FLEET_FRAMES = 200, 4, 40
RENDER_T, RENDER_EVERY = 40, 5


# The slam preset's keys that are NaN where no episode qualifies (none
# converged, none stayed on explored pixels): every other number of its
# line must be finite.
SLAM_MAYBE_UNDEFINED = frozenset((
    "reloc_median_error_m", "reloc_in_coverage_frac",
    "track_in_coverage_frac", "track_to_coverage_edge_frac"))


def slam_line_faults(out: dict) -> list:
    """The keys of a slam preset line whose values are not numbers, or
    not finite (NaN allowed only for SLAM_MAYBE_UNDEFINED)."""
    bad = []
    for key, v in out.items():
        if key in ("explore_mode", "mission_legs"):
            continue
        if isinstance(v, bool) or not isinstance(v, (int, float)):
            bad.append(key)
        elif not math.isfinite(v) and not (
                key in SLAM_MAYBE_UNDEFINED and v != v):
            bad.append(key)
    return bad


def slam_config(m, **kw):
    fc = FilterConfig()
    return SLAMConfig(**dict(dict(
        num_particles=SLAM_P, mapping=presets._mapping_config(m),
        sensor=fc.sensor, motion=fc.motion, keyframe_trans=SLAM_KF[0],
        keyframe_rot=SLAM_KF[1]), **kw))


def slam_row_phase(dev) -> dict:
    """(a) The published SLAM row as one [E, K] state, scored as the JAX
    tools/slam_sweep.py:200-238 scores it: per episode the final-quarter
    error of the winner's estimate against dead reckoning's, and the
    explored-edge F1 of the winner's best map.  Raises below a mean F1 of
    SLAM_F1_FLOOR or SLAM_BEATS_FLOOR episodes beating dead reckoning, or
    unless the ISM kernel (csrc/ism.cu) replayed once a tick and no other
    kernel launched (every count set to 0 just before the run).  Then the
    ISM at the row's shape (ism_share)."""
    world = presets.make_world(num_beams=SLAM_B, device=dev)
    m = world.maze
    cfg = slam_config(m)
    gen = torch.Generator(device=dev)
    gen.manual_seed(13)
    enc, scans, truth = robot.generate_wander_episode(
        gen, m, world.cfg, world.angles, SLAM_T, batch=SLAM_E,
        start_pose=SLAM_START, slip_noise=SLAM_SLIP, explore=True)
    before = {id(g) for g in compiled.graphs.entries()}
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    final, est, info = slam.run_slam_replicas(
        100, enc, scans, world.angles, cfg, SLAM_START, replicas=SLAM_K)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, replayed = counts(), replay_counts()
    stats = new_entries(before)
    dr = mapping.dead_reckon_poses(enc, SLAM_START, world.cfg.motion)
    tail = max(SLAM_T // 4, 1)
    tr, est_n, dr = (v.cpu().numpy() for v in (truth, est, dr))
    slam_err = np.hypot(est_n[..., 0] - tr[..., 0],
                        est_n[..., 1] - tr[..., 1])[:, -tail:].mean(axis=1)
    dr_err = np.hypot(dr[..., 0] - tr[..., 0],
                      dr[..., 1] - tr[..., 1])[:, -tail:].mean(axis=1)
    maps = slam.best_map(final).cpu().numpy()
    truth_walls = m.walls.cpu().numpy()
    f1s = []
    for lo in maps:
        walls, seen = mapping.fit_walls(lo, cell_px=8, return_explored=True)
        f1s.append(mapping.wall_metrics(walls, truth_walls, mask=seen)["f1"])
    f1s = np.asarray(f1s)
    beats = int((slam_err < dr_err).sum())
    if not (np.isfinite(est_n).all() and np.isfinite(maps).all()):
        raise AssertionError("SLAM row: non-finite estimates or maps")
    row = dict(episodes=SLAM_E, replicas=SLAM_K, particles=SLAM_P,
               ticks=SLAM_T, beams=SLAM_B, slip=SLAM_SLIP,
               keyframe=list(SLAM_KF), mean_f1=float(f1s.mean()),
               min_f1=float(f1s.min()), beats_dead_reckoning=beats,
               mean_pose_err_m=float(slam_err.mean()),
               p90_pose_err_m=float(np.percentile(slam_err, 90)),
               mean_dead_reckoning_err_m=float(dr_err.mean()),
               wall_s=wall, ms_per_tick=1e3 * wall / SLAM_T,
               chosen=info["chosen"].tolist(), **stats,
               ism_launches=launched["ism_update"],
               ism_replayed=replayed["ism_update"],
               published=dict(mean_f1=[0.798, 0.853], beats=[12, 15],
                              pose_err_m=[0.215, 0.348]))
    say("slam", row="published", **row)
    if row["mean_f1"] < SLAM_F1_FLOOR or beats < SLAM_BEATS_FLOOR:
        raise AssertionError(f"SLAM row: mean F1 {row['mean_f1']} (floor "
                             f"{SLAM_F1_FLOOR}) or beats {beats}/{SLAM_E} "
                             f"(floor {SLAM_BEATS_FLOOR})")
    others = [k for k, n in launched.items() if n and k != "ism_update"]
    if replayed["ism_update"] != SLAM_T or others:
        raise AssertionError(f"SLAM row: the ISM kernel replayed "
                             f"{replayed['ism_update']} times in {SLAM_T} "
                             f"ticks, or {others} launched")
    row.update(ism_share(world, cfg, enc, scans))
    compiled.graphs.clear()
    torch.cuda.empty_cache()
    return row


def _twin_slam(state):
    """The SLAM state with a copy of its generator."""
    return dataclasses.replace(state, gen=same_gen(state.gen))


def ism_share(world, cfg, enc, scans) -> dict:
    """One replay of the row's graph (TICKS_PER_GRAPH ticks, on the state
    after the episodes' first graph) profiled against update_map alone at
    the row's shape: device ms of each, the ISM's share of the tick, and
    the ISM's bound (its maps read and written once; about 20 float ops a
    pixel a beam).  On that state, update_map (the kernel) against
    update_map_plain (check_ism), and the two timed in turns."""
    k = compiled.TICKS_PER_GRAPH
    b = (SLAM_E, SLAM_K)
    angles = torch.as_tensor(world.angles, device=enc.device)
    e, r = enc[:, None, :k].expand(b + (k, 2)), scans[:, None, :k].expand(
        b + (k, SLAM_B))
    ones = torch.ones_like(r)
    state, _ = slam.run_slam_ticks(
        slam.init_slam(100, SLAM_START, cfg, b, enc.device), e, r, ones,
        angles, cfg)
    state = compiled.detach_state(state)
    prof = replay_profile(lambda: slam.run_slam_ticks(
        _twin_slam(state), e, r, ones, angles, cfg))
    tick_ms = prof["replay_device_ms"] / k
    ism_ms = device_ms(lambda: mapping.update_map(
        state.logodds, state.poses, r[..., 0, None, :], angles,
        ones[..., 0, None, :], cfg.mapping, cfg.sensor), reps=5)
    maps = state.logodds.numel()
    bnd = bound(2 * 4 * maps, 20.0 * maps * SLAM_B)
    out = dict(tick_device_ms=tick_ms, tick_wall_ms=prof["replay_wall_ms"]
               / k, replay_busy_share=prof["replay_busy_share"],
               device_ops_per_tick=prof["replay_device_ops"] / k,
               ism_device_ms=ism_ms, ism_share=ism_ms / tick_ms,
               ism_bound_ms=bnd["bound_ms"], ism_bound_by=bnd["bound_by"])
    say("slam", what="ISM share of the row's tick", **out)
    args = (state.logodds, state.poses, r[..., 0, None, :], angles,
            ones[..., 0, None, :], cfg.mapping, cfg.sensor)
    out["ism_max_abs_err"] = check_ism(args)
    t = turns(lambda: mapping.update_map(*args),
              lambda: mapping.update_map_plain(*args))
    t.update(bnd, library_ms=None,
             shape=list(state.logodds.shape) + [SLAM_B])
    say("time", kernel="ism_update", **t)
    out["ism_time"] = t
    return out


def check_ism(args) -> float:
    """update_map(*args) (csrc/ism.cu) against update_map_plain(*args) at
    the row's shape, [SLAM_E, SLAM_K, SLAM_P] maps: every map painted, the
    keyframe gate [SLAM_E, SLAM_K, 1] mixed (by filter, as slam_step gives
    it) and closed; bit for bit, the input maps unchanged, or a raise.
    Returns the max-abs error (0)."""
    maps = args[0]
    keep = maps.clone()
    filters = torch.arange(SLAM_E * SLAM_K, device=maps.device).reshape(
        SLAM_E, SLAM_K, 1)
    gates = dict(every=None, mixed=filters % 3 == 0,
                 closed=torch.zeros_like(filters, dtype=torch.bool))
    err, bad = 0.0, []
    for name, paint in gates.items():
        got = mapping.update_map(*args, paint=paint)
        want = mapping.update_map_plain(*args, paint=paint)
        err = max(err, (got - want).abs().max().item())
        if not torch.equal(got, want):
            bad.append(name)
    untouched = bool(torch.equal(maps, keep))
    say("check", kernel="ism_update", shape=list(maps.shape) + [SLAM_B],
        gates=list(gates), max_abs_err=err, unequal=bad,
        input_unchanged=untouched)
    if bad or not untouched:
        raise AssertionError(f"the ISM kernel differs from update_map_plain "
                             f"under the gates {bad}, or wrote its input "
                             f"maps (unchanged: {untouched})")
    return err


def slam_invariants_phase(dev) -> dict:
    """(b) On a [INV_E] x SLAM_P state with K = 3 candidates, keyframes and
    the closure: INV_T ticks through the graphs against the same ticks
    eager (every state tensor, the generator, every info field, bit for
    bit); no host sync in an eager slam_step; the beam-accumulated ISM
    equal to the one-shot form, and the ISM kernel (csrc/ism.cu) equal to
    both, on [ISM_MAPS] maps."""
    world = presets.make_world(num_beams=SLAM_B, device=dev)
    m = world.maze
    cfg = slam_config(m, proposal_candidates=3, closure=True,
                      closure_margin=0.5, closure_min_beams=4)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    enc, scans, _ = robot.generate_wander_episode(
        gen, m, world.cfg, world.angles, 40 + INV_T, batch=INV_E,
        start_pose=SLAM_START, slip_noise=0.05, explore=True)
    start, _ = slam.run_slam_episode(3, enc[:, :40], scans[:, :40],
                                     world.angles, cfg, SLAM_START)
    angles = torch.as_tensor(world.angles, device=dev)
    ones = torch.ones_like(scans)
    k = compiled.TICKS_PER_GRAPH

    def run():
        st, infos = _twin_slam(start), []
        for t0 in range(40, 40 + INV_T, k):
            st, ys = slam.run_slam_ticks(
                st, enc[:, t0:t0 + k], scans[:, t0:t0 + k],
                ones[:, t0:t0 + k], angles, cfg)
            st = compiled.detach_state(st)
            infos.append({key: v.clone() for key, v in ys.items()})
        return st, infos

    row = ab("slam_tick", run, INV_T, episodes=INV_E, particles=SLAM_P,
             candidates=3, closure=True)
    st = _twin_slam(start)
    args = (enc[:, 40, 0], enc[:, 40, 1], scans[:, 40], angles,
            ones[:, 40], cfg)
    slam.slam_step(st, *args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        slam.slam_step(st, *args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    maps = start.logodds.reshape(-1, m.height, m.width)[:ISM_MAPS]
    poses = start.poses.reshape(-1, 3)[:ISM_MAPS]
    args = (maps, poses, scans[0, 40], angles, ones[0, 40], cfg.mapping,
            cfg.sensor)
    kernel = mapping.update_map(*args)
    one = mapping.update_map_plain(*args, beam_chunk=SLAM_B)
    acc = mapping.update_map_plain(*args, beam_chunk=1)
    ism_equal = bool(torch.equal(one, acc))
    kernel_equal = bool(torch.equal(kernel, one))
    say("slam", what="invariants", eager_tick_host_syncs=0,
        ism_accumulated_equals_one_shot=ism_equal,
        ism_kernel_equals_plain=kernel_equal, ism_maps=ISM_MAPS)
    if not (ism_equal and kernel_equal):
        raise AssertionError("SLAM: the beam-accumulated ISM differs from "
                             "the one-shot form, or the kernel from both")
    compiled.graphs.clear()
    return row


def slam_presets_phase(dev) -> dict:
    """(c) run_mapping (MAPPING_ROBOTS x MAPPING_T, true poses; raises
    below MAPPING_FLOOR F1) and with dead-reckoned poses at 3 % slip (no
    gate, no relocalization); run_slam at the CLI's defaults with the
    mission (one episode is chaotic: only a malformed or non-finite value
    raises), K3 batched replayed once a tick in reloc and track and K1 and
    K3 once a tick in the mission where one is driven; then launch_audit
    over AUDIT_T ticks of each."""
    world = presets.make_world(num_particles=PRESET_N, device=dev)
    rows = {}
    for source, slip in (("true", 0.0), ("odom", 0.03)):
        t0 = time.perf_counter()
        out = presets.run_mapping(world, seed=0, num_ticks=MAPPING_T,
                                  robots=MAPPING_ROBOTS, pose_source=source,
                                  slip_noise=slip,
                                  relocalize=source == "true")
        torch.cuda.synchronize()
        rows[source] = dict(out, seconds=time.perf_counter() - t0)
        say("slam_presets", preset="mapping", pose_source=source, slip=slip,
            **rows[source])
    if rows["true"]["f1"] < MAPPING_FLOOR:
        raise AssertionError(f"mapping: F1 {rows['true']['f1']} below "
                             f"{MAPPING_FLOOR} from true poses")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    out = presets.run_slam(world, seed=0, **SLAM_PRESET)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched, replayed = counts(), replay_counts()
    say("slam_presets", preset="slam", seconds=wall, launches=launched,
        replayed=replayed, **out)
    bad = slam_line_faults(out)
    reloc_t = min(max(SLAM_PRESET["num_ticks"] // 2, 150), 300)
    # No mission is driven where the learned map walls off the plan.
    mission_t = (SLAM_PRESET["mission_ticks"]
                 if out["mission_waypoints_total"] else 0)
    if (bad or replayed["kmeans_batched"] != 2 * reloc_t
            or replayed["beam_weights"] != mission_t
            or replayed["kmeans"] != mission_t):
        raise AssertionError(f"slam preset: malformed ({bad}) or K3 batched "
                             f"not replayed once a reloc and track tick, "
                             f"K1 / K3 not once a mission tick: {replayed}")
    rows["slam"] = dict(out, seconds=wall)
    rows["audit"] = slam_preset_audit(world)
    compiled.graphs.clear()
    return rows


def slam_preset_audit(world) -> dict:
    """launch_audit over AUDIT_T ticks of the preset's reloc, track and
    mission on a learned map (the true maze's walls, fitted as the preset
    fits them): the card's kernels equal the counters, K3 batched replayed
    once a reloc and track tick, K1 and K3 once a mission tick."""
    m = world.maze
    learned = presets._maze_from_wall_tensor(m.walls.cpu().numpy(),
                                             m.device)
    explored = np.ones((m.height, m.width), bool)
    runs = dict(
        reloc=lambda: presets._relocalize_on(
            learned, m, world, AUDIT_T, 1000, known_maze=learned,
            explored_px=explored),
        track=lambda: presets._track_on(
            learned, m, world, AUDIT_T, 2000, known_maze=learned,
            explored_px=explored),
        mission=lambda: presets._mission_on(
            learned, m.walls.cpu().numpy(), world, AUDIT_T, 2,
            presets.DEFAULT_GOLD, presets.DEFAULT_PICKUP))
    want = dict(reloc=("kmeans_batched",), track=("kmeans_batched",),
                mission=("beam_weights", "kmeans"))
    out = {}
    for name, run in runs.items():
        run()       # builds the graphs; the audited run replays them
        torch.cuda.synchronize()
        reset_counts()
        with launch_audit(f"slam_preset_{name}") as audited:
            run()
        replayed = replay_counts()
        out[name] = dict(audited, replayed={k: replayed[k]
                                            for k in want[name]})
        if any(replayed[k] != AUDIT_T for k in want[name]):
            raise AssertionError(f"slam preset {name}: {want[name]} not "
                                 f"replayed once a tick: {replayed}")
    return out


def slam_servers_phase(dev, tmp: str) -> dict:
    """(d) SLAMServer over SERVE_FRAMES frames of a wander equal to
    run_slam_episode from the same seed, bit for bit (the reply poses and
    the final state); replicas=3; export_map read back by maps/pgm; a
    fleet of FLEET_ROBOTS robots, each equal to its standalone server bit
    for bit; ms a frame for each."""
    world = presets.make_world(num_beams=SLAM_B, device=dev)
    m = world.maze
    cfg = slam_config(m)
    gen = torch.Generator(device=dev)
    gen.manual_seed(21)
    enc, scans, _ = robot.generate_wander_episode(
        gen, m, world.cfg, world.angles, SERVE_FRAMES, batch=FLEET_ROBOTS,
        start_pose=SLAM_START, slip_noise=0.03, explore=True)
    enc_h, scans_h = enc.cpu().numpy(), scans.cpu().numpy()

    def frame(k, r=0):
        return (float(enc_h[r, k, 0]), float(enc_h[r, k, 1]), scans_h[r, k])

    server = SLAMServer(cfg, world.angles, seed=9, device=dev)
    server.tick(*frame(0))          # builds and captures the graph
    server.reset(9)
    t0 = time.perf_counter()
    replies = [server.tick(*frame(k)) for k in range(SERVE_FRAMES)]
    serve_s = time.perf_counter() - t0
    final, poses = slam.run_slam_episode(9, enc[0], scans[0], world.angles,
                                         cfg, SLAM_START)
    want = [[round(float(v), 6) for v in p] for p in poses.cpu().numpy()]
    st = server.state
    same = ([r["pose"] for r in replies] == want and not differing(
        [st.poses, st.logodds, st.weights, st.scores, st.log_evidence],
        [final.poses, final.logodds, final.weights, final.scores,
         final.log_evidence]))
    exported = server.export_map(os.path.join(tmp, "slam_learned"))
    back = pgm.from_pgm(exported["yaml"], device=dev)
    rep = SLAMServer(cfg, world.angles, seed=9, replicas=3, device=dev)
    rep.tick(*frame(0))
    t0 = time.perf_counter()
    for k in range(1, FLEET_FRAMES):
        reply = rep.tick(*frame(k))
    rep_s = time.perf_counter() - t0
    ev = rep.state.log_evidence
    rep_ok = reply["replica"] == int(torch.argmax(ev))
    starts = [SLAM_START] * FLEET_ROBOTS
    fleet = SLAMFleetServer(cfg, world.angles, starts, seed=2, device=dev)
    singles = [SLAMServer(cfg, world.angles, start_pose=starts[r],
                          seed=2 * FLEET_ROBOTS + r, device=dev)
               for r in range(FLEET_ROBOTS)]
    fleet_s, fleet_same = 0.0, True
    for k in range(FLEET_FRAMES):
        t0 = time.perf_counter()
        fr = fleet.tick(enc_h[:, k, 0], enc_h[:, k, 1], scans_h[:, k])
        fleet_s += time.perf_counter() - t0 if k else 0.0
        for r in range(FLEET_ROBOTS):
            one = singles[r].tick(*frame(k, r))
            fleet_same &= all(fr[key][r] == one[key]
                              for key in ("pose", "best_pose", "ess",
                                          "mapped"))
    fst = fleet.state
    fleet_same &= all(not differing(
        [fst.poses[r], fst.logodds[r], fst.log_evidence[r]],
        [s.state.poses, s.state.logodds, s.state.log_evidence])
        for r, s in enumerate(singles))
    row = dict(particles=SLAM_P, beams=SLAM_B, frames=SERVE_FRAMES,
               server_equals_episode=same,
               server_ms_per_frame=1e3 * serve_s / SERVE_FRAMES,
               export_yaml_read_back=list(back.occ.shape),
               replicas=3, replica_picks_argmax=rep_ok,
               replicas_ms_per_frame=1e3 * rep_s / (FLEET_FRAMES - 1),
               fleet_robots=FLEET_ROBOTS, fleet_frames=FLEET_FRAMES,
               fleet_equals_standalone=fleet_same,
               fleet_ms_per_frame=1e3 * fleet_s / (FLEET_FRAMES - 1))
    say("slam_servers", **row)
    if not (same and rep_ok and fleet_same
            and list(back.occ.shape) == [m.height, m.width]):
        raise AssertionError(f"SLAM servers: {row}")
    return row


SLAM_SERVE_RUNS = (1, 2)


def slam_serve_cli_phase() -> None:
    """(e) `serve --slam-serve` on 20 JSONL frames, one robot and
    --robots 2: a reply a frame with the JAX server's keys, the summary
    line on stderr; the one robot's 4 replicas answer `stats` with K = 4
    (D1), and `--particles 16 --slam-replicas 1` serves 128 SLAM
    particles, as the JAX CLI does (D2)."""
    world = presets.make_world(device="cpu")
    gen = torch.Generator()
    gen.manual_seed(1)
    enc, scans, _ = robot.generate_wander_episode(
        gen, world.maze, world.cfg, world.angles, 20, batch=2,
        start_pose=SLAM_START)
    keys = {"tick", "pose", "best_pose", "ess", "mapped"}
    stats = '{"cmd": "stats"}'
    single = [json.dumps(dict(encoder_left=float(enc[0, k, 0]),
                              encoder_right=float(enc[0, k, 1]),
                              ranges=scans[0, k].tolist()))
              for k in range(20)]
    for robots in SLAM_SERVE_RUNS:
        if robots == 1:
            lines = single + [stats]
        else:
            lines = [json.dumps(dict(encoder_left=enc[:, k, 0].tolist(),
                                     encoder_right=enc[:, k, 1].tolist(),
                                     ranges=scans[:, k].tolist()))
                     for k in range(20)]
        t0 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", PKG, "serve",
                            "--slam-serve", "--robots", str(robots)],
                           input="\n".join(lines) + "\n",
                           capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise AssertionError(f"serve --slam-serve: {r.stderr[-2000:]}")
        replies = [json.loads(x) for x in r.stdout.splitlines()]
        summary = json.loads(r.stderr.strip().splitlines()[-1])
        want = keys | ({"replica", "log_evidence"} if robots == 1 else set())
        # D1: a replica server's stats count its 4 replicas, as JAX's.
        stats_ok = robots != 1 or replies.pop() == dict(tick=20,
                                                        particles=4)
        ok = (stats_ok and len(replies) == 20
              and all(set(x) == want for x in replies)
              and summary == dict(preset="serve", slam=True, robots=robots,
                                  ticks=20))
        say("cli", args=["serve", "--slam-serve", "--robots", str(robots)],
            seconds=time.perf_counter() - t0, frames=20, last=replies[-1],
            summary=summary, ok=ok)
        if not ok:
            raise AssertionError(f"serve --slam-serve: {replies[-1]}")
    # D2: --particles is the slam preset's alone, as in the JAX CLI: one
    # replica of 128 SLAM particles, whatever --particles says.
    args = ["serve", "--slam-serve", "--particles", "16", "--slam-replicas",
            "1"]
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", PKG, *args],
                       input="\n".join(single[:3] + [stats]) + "\n",
                       capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        raise AssertionError(f"serve --slam-serve: {r.stderr[-2000:]}")
    reply = json.loads(r.stdout.strip().splitlines()[-1])
    say("cli", args=args, seconds=time.perf_counter() - t0, stats=reply)
    if reply != dict(tick=3, particles=128):
        raise AssertionError(f"serve --slam-serve --particles 16: {reply}")


def render_phase(dev) -> dict:
    """(f) The render tool on each source at RENDER_T ticks: frames, their
    shape and seconds."""
    from montecarlolocalisation_tpu_torch.tools import render_episode

    m = presets.make_world(device=dev).maze
    log = EpisodeLog.load(FIXTURE)
    log = EpisodeLog(encoders=log.encoders[:RENDER_T],
                     scan_ranges=log.scan_ranges[:RENDER_T],
                     scan_angles=log.scan_angles,
                     true_poses=log.true_poses[:RENDER_T])
    runs = dict(
        log=lambda: render_episode.run_and_capture(
            m, FilterConfig(), log, RENDER_EVERY, 4),
        closed_loop=lambda: render_episode.run_closed_loop_capture(
            m, FilterConfig(), RENDER_T, 0, RENDER_EVERY, 4, SLAM_B),
        slam=lambda: render_episode.run_slam_capture(
            m, RENDER_T, 0, RENDER_EVERY, 4, SLAM_B))
    out = {}
    for name, run in runs.items():
        t0 = time.perf_counter()
        frames, labels = run()
        out[name] = dict(frames=len(frames), shape=list(frames[0].shape),
                         ticks=[labels[0], labels[-1]],
                         seconds=time.perf_counter() - t0)
        if not frames or any(f.dtype != np.uint8 or f.shape != frames[0].shape
                             for f in frames):
            raise AssertionError(f"render {name}: {out[name]}")
    say("render", ticks=RENDER_T, every=RENDER_EVERY, **out)
    return out


def slam_stack_phase(dev) -> dict:
    """The mapping and SLAM phases (a) to (f); (e)'s mapping and slam CLI
    lines run in the CLI phase."""
    with tempfile.TemporaryDirectory() as tmp:
        rows = dict(row=slam_row_phase(dev),
                    invariants=slam_invariants_phase(dev),
                    presets=slam_presets_phase(dev),
                    servers=slam_servers_phase(dev, tmp))
    slam_serve_cli_phase()
    rows["render"] = render_phase(dev)
    compiled.graphs.clear()
    torch.cuda.empty_cache()
    return rows


# Calibration, frontier exploration and profiling (utils/profiling).
CAL_STEPS = dict(fit_motion_params=500, fit_sensor_sigma=400)
CAL_TOL = dict(wheel_size=0.02, wheel_space=0.05, sigma=0.15)
# run_slam with the frontier explorer at the CLI's defaults, the mission
# on; then the other explorers at EXPLORE_PHASES phases of 120 ticks.
FRONTIER_PRESET = dict(SLAM_PRESET, explore_mode="frontier")
# The CLI's default budget maps half the maze, and the mission is planned
# on known-open edges only, so none is plannable there.  At this budget
# seed 0's hybrid explorer maps enough of it (0.715 of the edges) for the
# mission to plan and run, on the learned map, through K1 and K3.
MISSION_EXPLORE = dict(SLAM_PRESET, num_ticks=1920, explore_mode="hybrid",
                       relocalize=False)
EXPLORE_PHASES, EXPLORE_PHASE_T = 3, 120
KNOCKOUT_CONFIGS = (
    dict(n=SERVE_N, beams=SERVE_B, ray_mode="analytic",
         resample_method="systematic"),
    dict(n=ENTRY_N, beams=ENTRY_B, ray_mode="fixed",
         resample_method="multinomial"))
KNOCKOUT_ITERS = 20


@contextlib.contextmanager
def recording(module, name: str, rows: list, after=None):
    """Inside, module.name records each call: its arguments, its result,
    its host seconds (the card synchronized at both ends) and `after()`
    read just after it, appended to `rows`."""
    fn = getattr(module, name)

    def wrapped(*args, **kw):
        before = {id(g) for g in compiled.graphs.entries()}
        out, seconds = timed(lambda: fn(*args, **kw))
        rows.append(dict(args=args, kw=kw, out=out, seconds=seconds,
                         graphs=new_entries(before),
                         after=None if after is None else after()))
        return out

    setattr(module, name, wrapped)
    try:
        yield rows
    finally:
        setattr(module, name, fn)


def epoch_runs() -> dict:
    """The epochs that the calibration's epoch graphs in compiled.graphs
    ran, by their own count: as CUDA graph replays and eagerly."""
    ran = dict(replayed=0, eager=0)
    for g in compiled.graphs.entries():
        if g.step is calibrate._epoch:
            ran["replayed" if g.cuda else "eager"] += g.replays
    return ran


def calibrate_phase(dev) -> dict:
    """(a) presets.run_calibrate on the card: the JAX suite's recoveries
    (CAL_TOL: the wheel constants within 2 % and 5 %, sigma within 15 %)
    or a raise; every epoch a graph replay (500 and 400, none eager); the
    wall time of each fit, its capture and ms an epoch."""
    world = presets.make_world(device=dev)
    compiled.graphs.clear()
    fits = []
    with contextlib.ExitStack() as stack:
        for name in CAL_STEPS:
            stack.enter_context(recording(
                calibrate, name, fits, epoch_runs))
        out, wall = timed(lambda: presets.run_calibrate(world, seed=0))
    rows = {}
    for name, fit in zip(CAL_STEPS, fits):
        g = fit["graphs"]
        steps = fit["kw"]["steps"]
        epochs_s = fit["seconds"] - g["capture_s"] - g["instantiate_s"]
        rows[name] = dict(seconds=fit["seconds"], steps=steps,
                          ms_per_epoch=1e3 * epochs_s / steps, **g)
    err = {k: abs(out[f"{k}_fit"] - out[f"{k}_true"]) / out[f"{k}_true"]
           for k in CAL_TOL}
    epochs = epoch_runs()
    row = dict(out, relative_error=err, seconds=wall, epochs=epochs, **rows)
    say("calibrate", **row)
    want = sum(CAL_STEPS.values())
    if (any(not math.isfinite(v) for v in out.values())
            or any(err[k] >= tol for k, tol in CAL_TOL.items())
            or epochs != dict(replayed=want, eager=0)
            or [f["after"]["replayed"] for f in fits]
            != [CAL_STEPS["fit_motion_params"], want]):
        raise AssertionError(f"calibrate: {row}")
    compiled.graphs.clear()
    return row


def _coverage_ok(cov) -> bool:
    return (all(b >= a - 1e-9 for a, b in zip(cov, cov[1:]))
            and cov[-1] > cov[0] and all(map(math.isfinite, cov)))


def frontier_phase(dev) -> dict:
    """(b) run_slam(explore_mode="frontier") at the CLI's defaults with the
    mission: coverage by phase (never down, up from the first phase to
    the last, or a raise), the explored-edge F1, the SLAM error, ms an
    explore tick; one explore graph for every phase, replayed once a
    chunk; K3 batched replayed once a reloc and track tick, K1 and K3
    once a mission tick.  Then the mission after the hybrid explorer's
    MISSION_EXPLORE run, which must plan one and replay K1 and K3 once a
    mission tick; then the hybrid policy and the wall follower at
    EXPLORE_PHASES phases."""
    world = presets.make_world(num_particles=PRESET_N, device=dev)
    m = world.maze
    runs, phase_runs = [], []
    reset_counts()
    with recording(frontier, "run_frontier_slam", runs,
                   lambda: [(g.replays, id(g))
                            for g in compiled.graphs.entries()
                            if g.step is frontier._tick]), \
            recording(frontier, "explore_phase", phase_runs):
        out, wall = timed(lambda: presets.run_slam(world, seed=0,
                                                   **FRONTIER_PRESET))
    launched, replayed = counts(), replay_counts()
    (run,) = runs
    cov = run["out"][1]["coverage"]
    ticks = len(run["out"][1]["truth"])
    k = compiled.TICKS_PER_GRAPH
    graphs = run["after"]
    phases = ticks // EXPLORE_PHASE_T
    # The phases after the first replay a captured graph: their ms a
    # tick, apart from the host's planning between phases.
    later = phase_runs[1:]
    row = dict(out, seconds=wall, explore_seconds=run["seconds"],
               explore_ms_per_tick=1e3 * run["seconds"] / max(ticks, 1),
               phase_seconds=[r["seconds"] for r in phase_runs],
               phase_ms_per_tick=1e3 * sum(r["seconds"] for r in later)
               / max(len(later) * EXPLORE_PHASE_T, 1),
               coverage_by_phase=cov, explore_graphs=len(graphs),
               explore_replays=sum(r for r, _ in graphs),
               explore_graphs_built=run["graphs"]["graphs_built"],
               launches=launched, replayed=replayed)
    say("explore", preset="slam", **row)
    reloc_t = min(max(ticks // 2, 150), 300)
    mission_t = (FRONTIER_PRESET["mission_ticks"]
                 if out["mission_waypoints_total"] else 0)
    bad = slam_line_faults(out)
    if (bad or not _coverage_ok(cov) or ticks != phases * EXPLORE_PHASE_T
            or len(graphs) != 1
            or row["explore_replays"] != phases * -(-EXPLORE_PHASE_T // k)
            or replayed["kmeans_batched"] != 2 * reloc_t
            or replayed["beam_weights"] != mission_t
            or replayed["kmeans"] != mission_t):
        raise AssertionError(f"frontier slam preset: {row}")
    rows = dict(frontier=row)
    reset_counts()
    out, wall = timed(lambda: presets.run_slam(world, seed=0,
                                               **MISSION_EXPLORE))
    replayed = replay_counts()
    mission_t = MISSION_EXPLORE["mission_ticks"]
    rows["mission"] = dict(out, seconds=wall, replayed=replayed)
    say("explore", preset="slam", what="mission after exploring",
        **rows["mission"])
    if (slam_line_faults(out) or not out["mission_waypoints_total"]
            or replayed["beam_weights"] != mission_t
            or replayed["kmeans"] != mission_t):
        raise AssertionError(f"no mission after exploring, or K1 and K3 not "
                             f"replayed once a mission tick: "
                             f"{rows['mission']}")
    scfg = slam_config(m)
    for policy, kw in (("hybrid", {}),
                       ("wallfollow", dict(wander_style="wallfollow"))):
        (fst, info), seconds = timed(lambda: frontier.run_frontier_slam(
            0, m, scfg, world.angles, phases=EXPLORE_PHASES,
            phase_ticks=EXPLORE_PHASE_T, policy=policy, **kw))
        cov = info["coverage"]
        lo = slam.best_map(fst.slam).cpu().numpy()
        walls, seen = mapping.fit_walls(lo, cell_px=8, return_explored=True)
        f1 = mapping.wall_metrics(walls, m.walls.cpu().numpy(),
                                  mask=seen)["f1"]
        tail = max(len(info["truth"]) // 4, 1)
        err = float(np.hypot(*(info["est"][-tail:, :2]
                               - info["truth"][-tail:, :2]).T).mean())
        rows[policy] = dict(coverage_by_phase=cov, f1_explored=f1,
                            slam_final_err_m=err, seconds=seconds,
                            ms_per_tick=1e3 * seconds
                            / max(len(info["truth"]), 1))
        say("explore", policy=policy, phases=EXPLORE_PHASES, **rows[policy])
        if not (_coverage_ok(cov) and math.isfinite(err)):
            raise AssertionError(f"explore {policy}: {rows[policy]}")
    compiled.graphs.clear()
    return rows


def knockout_phase(dev) -> dict:
    """(c) profiling.stage_knockout_times at the bench's 1,048,576 x 34
    analytic systematic and at 65,536 x 12 fixed multinomial (each skip
    set its own one-tick graph), K1, K2 (systematic only) and K3 replayed
    once a replay of every variant that keeps their stage; then profiling.trace around one replay
    of a filter graph, whose file must exist and be non-empty."""
    rows = {}
    for c in KNOCKOUT_CONFIGS:
        world = presets.make_world(num_particles=c["n"], num_beams=c["beams"],
                                   ray_mode=c["ray_mode"],
                                   resample_method=c["resample_method"],
                                   device=dev)
        state = mcl.init_state(world.maze, world.cfg, seed=4)
        scan = sensor.simulate_scan(world.maze, torch.tensor(
            START, device=dev), world.angles, world.cfg.sensor)
        reset_counts()
        out = profiling.stage_knockout_times(world.maze, world.cfg, scan,
                                             state, iters=KNOCKOUT_ITERS)
        replayed = replay_counts()
        # Each variant replays its graph iters + 1 times, and a stage's
        # kernel runs in the variants that keep the stage: the full tick
        # and the knockouts of the other stages.
        kept = len(profiling.STAGES) * (KNOCKOUT_ITERS + 1)
        want = dict(beam_weights=kept, kmeans=kept, systematic_expand=(
            kept if c["resample_method"] == "systematic" else 0))
        name = f"{c['n']}x{c['beams']}"
        rows[name] = {k: 1e3 * v for k, v in out.items()}
        say("profile", what="stage knockout (ms)", config=name,
            ray_mode=c["ray_mode"], resample=c["resample_method"],
            iters=KNOCKOUT_ITERS, replayed=replayed, **rows[name])
        if not all(math.isfinite(v) for v in out.values()) \
                or out["full"] <= 0.0 \
                or any(replayed[k] != n for k, n in want.items()):
            raise AssertionError(f"stage knockout {name}: {out}, kernels "
                                 f"replayed {replayed}, want {want}")
        del world, state
        torch.cuda.empty_cache()
    world = presets.make_world(num_particles=ENTRY_N, num_beams=ENTRY_B,
                               device=dev)
    enc, truth = drive(compiled.TICKS_PER_GRAPH)
    ranges = scans(world.maze, truth, world.angles, world.cfg.sensor, 3)
    state = mcl.init_state(world.maze, world.cfg, seed=4)
    args = (torch.as_tensor(enc, device=dev), ranges,
            torch.ones_like(ranges, dtype=torch.bool),
            torch.as_tensor(world.angles, device=dev), world.maze, world.cfg)
    mcl.run_ticks(state, *args)
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp):
            mcl.run_ticks(state, *args)
        size = os.path.getsize(os.path.join(tmp, "trace.json"))
    rows["trace_bytes"] = size
    say("profile", what="trace of one replay", bytes=size)
    if size <= 0:
        raise AssertionError("profiling.trace wrote an empty trace")
    compiled.graphs.clear()
    torch.cuda.empty_cache()
    return rows


def explore_stack_phase(dev) -> dict:
    """Calibration, frontier exploration and profiling: (a) to (c); (d)
    runs in the SLAM CLI phase."""
    return dict(calibrate=calibrate_phase(dev), explore=frontier_phase(dev),
                knockout=knockout_phase(dev))


# -- phase: multi-GPU (parallel/distributed, parallel/multihost) ----------

# World size 1 under NCCL (one card): every collective is a real NCCL
# call, and the ring has no step.  (a) and (e) tick 1M x 34 in one graph of
# 8 ticks; (b) and (c) run 16 ticks; (d) is the sweep's full width.
DIST_T, DIST_LONG_T, DIST_TIMING_REPLAYS = 8, 16, 5
# The kernels of each path that must replay once a tick.
DIST_KERNELS = dict(
    a=("beam_weights",), b=("beam_weights_batched",), c=("ism_update",),
    d=("beam_weights_batched", "systematic_expand_batched",
       "kmeans_batched"), e=("beam_weights",))
DIST_FLOOR = 0.65          # PERF.md section 2's plain sweep limit


def nccl_world(dev, tmp: str):
    """A one-rank NCCL process group on the card (its communicator made at
    once: device_id), and the (1 x 1) mesh."""
    import torch.distributed as dist

    from montecarlolocalisation_tpu_torch.parallel import distributed as sd

    if not dist.is_initialized():
        dist.init_process_group(
            "nccl", init_method=f"file://{os.path.join(tmp, 'rdzv')}",
            world_size=1, rank=0,
            device_id=torch.device("cuda", torch.cuda.current_device()))
    return sd.make_mesh(1, 1)


def shard_draws(d):
    """mcl_step's TickDraws as one rank's ShardDraws: at world size 1 the
    rank's block is the whole cloud and every draw means the same."""
    from montecarlolocalisation_tpu_torch.parallel import distributed as sd

    return sd.ShardDraws(motion_normals=d.motion_normals, resample=d.resample,
                         kmeans_init=d.kmeans_init,
                         kmeans_reseed=d.kmeans_reseed)


def tick_draws(m, cfg, ticks: int, seed: int, batch=()):
    gen = torch.Generator(device=m.device)
    gen.manual_seed(seed)
    return [mcl.draw_tick(gen, m, cfg.num_particles, cfg, batch)
            for _ in range(ticks)]


def hold_ticks(what: str, got, want, got_out, want_out) -> dict:
    """A sharded run against its single-process counterpart on the same
    draws: >= 99.9 % of particle rows within 1e-5, weights rtol 1e-5,
    confidence and best pose within 1e-4, n_injected, songs and wanderer
    commands equal; or a raise."""
    close = torch.all(torch.abs(got.particles - want.particles) <= 1e-5,
                      dim=-1)
    row = dict(rows_within_1em5=float(close.float().mean()),
               rows_bit_equal=float(torch.all(
                   got.particles == want.particles, dim=-1).float().mean()),
               weights_max_rel=float(torch.max(
                   torch.abs(got.weights - want.weights)
                   / torch.clamp(want.weights.abs(), min=1e-30))),
               confidence_max_abs=float(torch.max(torch.abs(
                   got_out.confidence - want_out.confidence))),
               best_pose_max_abs=float(torch.max(torch.abs(
                   got.best_pose - want.best_pose))),
               finite=bool(torch.isfinite(got.particles).all()))
    equal = all(torch.equal(getattr(got_out, f), getattr(want_out, f))
                for f in ("n_injected", "song", "wanderer_cmd"))
    say("distributed", what=what, against="single process", **row,
        counts_equal=equal)
    if not (row["finite"] and row["rows_within_1em5"] >= 0.999
            and row["weights_max_rel"] <= 1e-5
            and row["confidence_max_abs"] <= 1e-4
            and row["best_pose_max_abs"] <= 1e-4 and equal):
        raise AssertionError(f"distributed {what}: the sharded run differs "
                             f"from its single-process counterpart: {row}")
    return row


def replayed_once_a_tick(what: str, names, ticks: int, graphs: int) -> dict:
    """The launches of the kernels `names` since reset_counts(): each
    replayed once a tick, and launched once more a graph (its warm-up);
    no other kernel launched.  Raises otherwise."""
    c, r = counts(), replay_counts()
    row = dict(launches={k: c[k] for k in names},
               replayed={k: r[k] for k in names})
    say("distributed", what=what, **row)
    bad = [k for k in names if r[k] != ticks or c[k] != ticks + graphs]
    others = [k for k in KERNELS if k not in names and c[k]]
    if bad or others:
        raise AssertionError(f"distributed {what}: kernels {bad} did not "
                             f"replay once a tick over {ticks} ticks "
                             f"({graphs} graphs), or {others} launched")
    return c


def sharded_ticks_path(what: str, world, mesh, seed: int) -> dict:
    """(a) and (e): make_sharded_step's 8-tick graph at 1M x 34 against
    mcl_step's (run_ticks) on the same draws; K1 counted, replayed once a
    tick and audited; the ms a tick of both, one replay each."""
    from montecarlolocalisation_tpu_torch.parallel import distributed as sd

    m, cfg = world.maze, world.cfg
    enc, truth = drive(DIST_T)
    enc = torch.as_tensor(enc, device=m.device)
    ranges = scans(m, truth, world.angles, cfg.sensor, seed=seed)
    mask = torch.ones(ranges.shape, dtype=torch.bool, device=m.device)
    angles = torch.as_tensor(world.angles, device=m.device)
    draws = tick_draws(m, cfg, DIST_T, seed)
    state = mcl.init_state(m, cfg, seed)
    step = sd.make_sharded_step(mesh, m, cfg)
    block = sd.shard_state(state, mesh)
    reset_counts()
    (got, got_out), first_s = timed(lambda: step.ticks(
        block, enc, ranges, mask, angles,
        compiled.stack_ticks([shard_draws(d) for d in draws], 0)))
    launched = replayed_once_a_tick(what, DIST_KERNELS[what[0]], DIST_T, 1)
    got, got_out = compiled.detach_state(got), compiled.tree_map(
        torch.clone, got_out)
    want, want_out = mcl.run_ticks(state, enc, ranges, mask, angles, m, cfg,
                                   compiled.stack_ticks(draws, 0))
    row = hold_ticks(what, got, want, got_out, want_out)
    if what.startswith("a"):
        # The generators' graphs (no draws slab), built before the clock.
        reps = DIST_TIMING_REPLAYS

        def sharded():
            step.ticks(block, enc, ranges, mask, angles)

        def single():
            mcl.run_ticks(state, enc, ranges, mask, angles, m, cfg)

        sharded()
        single()
        sd_ms = 1e3 * timed(lambda: [sharded() for _ in range(reps)])[1] / (
            reps * DIST_T)
        one_ms = 1e3 * timed(lambda: [single() for _ in range(reps)])[1] / (
            reps * DIST_T)
        with launch_audit(f"distributed {what}") as audited:
            sharded()
        row.update(sharded_ms_per_tick=sd_ms, mcl_step_ms_per_tick=one_ms,
                   launch_audit=audited)
    say("distributed", what=what, particles=cfg.num_particles,
        beams=len(world.angles), ticks=DIST_T, first_call_s=first_s, **{
            k: v for k, v in row.items() if k.endswith("per_tick")})
    compiled.graphs.clear()
    del step
    torch.cuda.empty_cache()
    return dict(row, launches=launched)


def batched_path(dev, mesh) -> dict:
    """(b) make_sharded_step_batched at the sweep's 1024 x 500 x 24, fixed,
    systematic, 16 ticks (two replays of one 8-tick graph) against
    run_episode_batch on the same draws; K1 batched once a tick."""
    from montecarlolocalisation_tpu_torch.parallel import distributed as sd

    w = presets.make_world(num_particles=SWEEP_N, num_beams=SWEEP_B,
                           ray_mode="fixed", resample_method="systematic",
                           device=dev)
    m, cfg = w.maze, w.cfg
    gen = torch.Generator(device=dev)
    gen.manual_seed(41)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, m, cfg, w.angles, DIST_LONG_T, batch=SWEEP_E,
        start_pose=(2.05, 2.05, 0.0))
    draws = tick_draws(m, cfg, DIST_LONG_T, 42, (SWEEP_E,))
    state = sd.init_batched_state(43, m, cfg, SWEEP_E)
    step = sd.make_sharded_step_batched(mesh, m, cfg)
    reset_counts()
    (got, got_out), wall_s = timed(lambda: step.episode(
        sd.shard_state(state, mesh, episode_axis="episode"), enc, ranges,
        w.angles, draws=[shard_draws(d) for d in draws]))
    launched = replayed_once_a_tick("b", DIST_KERNELS["b"], DIST_LONG_T, 1)
    (want, want_out), single_s = timed(lambda: episodes.run_episode_batch(
        43, m, cfg, enc, ranges, w.angles, state=state, draws=draws))
    row = hold_ticks("b", got, want, got_out, want_out)
    # The same runs again: replays of the graphs the first runs built.
    _, sd_s = timed(lambda: step.episode(
        sd.shard_state(state, mesh, episode_axis="episode"), enc, ranges,
        w.angles, draws=[shard_draws(d) for d in draws]))
    _, one_s = timed(lambda: episodes.run_episode_batch(
        43, m, cfg, enc, ranges, w.angles, state=state, draws=draws))
    row.update(sharded_ms_per_tick=1e3 * sd_s / DIST_LONG_T,
               run_episode_batch_ms_per_tick=1e3 * one_s / DIST_LONG_T)
    say("distributed", what="b", episodes=SWEEP_E, particles=SWEEP_N,
        beams=SWEEP_B, ticks=DIST_LONG_T, first_call_s=wall_s,
        single_first_call_s=single_s, **{
            k: v for k, v in row.items() if k.endswith("per_tick")})
    k = compiled.TICKS_PER_GRAPH

    def replay():
        step.ticks(got, enc[:, :k], ranges[:, :k], None, w.angles)

    replay()    # builds the generators' graph: the audit holds a replay
    with launch_audit("distributed b") as audited:
        replay()
    compiled.graphs.clear()
    del step
    torch.cuda.empty_cache()
    return dict(row, launches=launched, wall_s=wall_s, launch_audit=audited)


def slam_shard_path(dev, mesh) -> dict:
    """(c) slam_step_sharded at the SLAM row's width (128 particles, 49 x
    49 maps, 24 beams) for 16 ticks against slam_step on the same draws,
    the ISM kernel replayed once a tick; ms a tick of both."""
    from montecarlolocalisation_tpu_torch.parallel import distributed as sd

    w = presets.make_world(num_beams=SLAM_B, device=dev)
    cfg = slam_config(w.maze)
    gen = torch.Generator(device=dev)
    gen.manual_seed(44)
    enc, ranges, _ = (v[0] for v in robot.generate_wander_episode(
        gen, w.maze, FilterConfig(), w.angles, DIST_LONG_T,
        start_pose=SLAM_START))
    dgen = torch.Generator(device=dev)
    dgen.manual_seed(45)
    draws = [slam.draw_slam(dgen, cfg, (), dev) for _ in range(DIST_LONG_T)]
    state = slam.init_slam(46, SLAM_START, cfg, device=dev)
    step = sd.make_sharded_slam_step(mesh, cfg)

    def sharded():
        return step.episode(sd.shard_slam_state(state, mesh), enc, ranges,
                            w.angles, draws=draws)

    def single():
        return slam.run_slam_episode(46, enc, ranges, w.angles, cfg,
                                     SLAM_START, state0=state, draws=draws)

    reset_counts()
    (got, infos), _ = timed(sharded)
    launched = replayed_once_a_tick("c", DIST_KERNELS["c"], DIST_LONG_T, 1)
    (want, poses), _ = timed(single)
    _, sd_s = timed(sharded)
    _, one_s = timed(single)
    rows = torch.all(torch.abs(got.poses - want.poses) <= 1e-5, dim=-1)
    pixels = torch.abs(got.logodds - want.logodds) <= 1e-5
    row = dict(ticks=DIST_LONG_T, particles=cfg.num_particles,
               rows_within_1em5=float(rows.float().mean()),
               pixels_within_1em5=float(pixels.float().mean()),
               weights_max_rel=float(torch.max(
                   torch.abs(got.weights - want.weights)
                   / torch.clamp(want.weights, min=1e-30))),
               log_evidence_abs=float(torch.abs(
                   got.log_evidence - want.log_evidence)),
               mean_pose_max_abs=float(torch.max(torch.abs(
                   infos["pose"] - poses))),
               resampled_ticks=int(infos["resampled"].sum()),
               sharded_ms_per_tick=1e3 * sd_s / DIST_LONG_T,
               slam_step_ms_per_tick=1e3 * one_s / DIST_LONG_T)
    say("distributed", what="c", against="slam_step", **row)
    if not (row["rows_within_1em5"] >= 0.999
            and row["pixels_within_1em5"] >= 0.999
            and row["weights_max_rel"] <= 1e-4
            and row["log_evidence_abs"] <= 1e-4
            and row["mean_pose_max_abs"] <= 1e-4
            and bool(torch.isfinite(got.logodds).all())):
        raise AssertionError(f"distributed c: the sharded SLAM differs from "
                             f"slam_step: {row}")
    compiled.graphs.clear()
    del step
    torch.cuda.empty_cache()
    return dict(row, launches=launched)


def multihost_path(dev) -> dict:
    """(d) run_multihost_episode_batch at the sweep's 1024 x 500 x 24 x
    300, fixed, systematic, from its own draws, against run_episode_batch
    from the same seed, which draws the same numbers: bit for bit (the
    tick tolerance reported beside), or a raise; raises below DIST_FLOOR
    converged; K1, K2 and K3 batched replay once a tick, audited over one
    more replay."""
    from montecarlolocalisation_tpu_torch.maps import symmetry
    from montecarlolocalisation_tpu_torch.parallel import multihost

    w = presets.make_world(num_particles=SWEEP_N, num_beams=SWEEP_B,
                           ray_mode="fixed", resample_method="systematic",
                           device=dev)
    m, cfg = w.maze, w.cfg
    start, count = multihost.process_episode_slice(SWEEP_E)
    gen = torch.Generator(device=dev)
    gen.manual_seed(47)
    enc, ranges, truth = robot.generate_wander_episode(
        gen, m, cfg, w.angles, SWEEP_T, batch=count,
        start_pose=(2.05, 2.05, 0.0))
    k = compiled.TICKS_PER_GRAPH
    reset_counts()
    (final, outs), wall_s = timed(
        lambda: multihost.run_multihost_episode_batch(
            48, m, cfg, enc, ranges, w.angles))
    graphs = 1 + (SWEEP_T % k > 0)
    launched = replayed_once_a_tick("d", DIST_KERNELS["d"], SWEEP_T, graphs)
    (want, want_out), single_s = timed(lambda: episodes.run_episode_batch(
        48, m, cfg, enc, ranges, w.angles))
    held = hold_ticks("d", final, want, outs, want_out)
    got_t, want_t = (
        [v for v in compiled.leaves(tree) if isinstance(v, torch.Tensor)]
        for tree in ((final, outs), (want, want_out)))
    bit_equal = (len(got_t) == len(want_t)
                 and all(torch.equal(a, b) for a, b in zip(got_t, want_t))
                 and torch.equal(final.gen.get_state(),
                                 want.gen.get_state()))
    if not bit_equal:
        raise AssertionError(f"distributed d: the multihost sweep differs "
                             f"from run_episode_batch: {held}")
    sym = symmetry.maze_symmetries(m.walls.cpu().numpy(),
                                   float(m.cell_meters))
    metrics = episodes.sweep_rmse(final, truth, sym=sym)
    with launch_audit("distributed d") as audited:
        multihost.run_multihost_episode_batch(
            48, m, cfg, enc[:, :k], ranges[:, :k], w.angles)
    row = dict(episodes=SWEEP_E, particles=SWEEP_N, beams=SWEEP_B,
               ticks=SWEEP_T, slice=[start, count], wall_s=wall_s,
               ms_per_tick=1e3 * wall_s / SWEEP_T,
               run_episode_batch_ms_per_tick=1e3 * single_s / SWEEP_T,
               bit_equal=bit_equal, **metrics)
    say("distributed", what="d", launch_audit=audited, **row)
    if metrics["converged_frac"] < DIST_FLOOR:
        raise AssertionError(f"distributed d: converged "
                             f"{metrics['converged_frac']} < {DIST_FLOOR}")
    compiled.graphs.clear()
    torch.cuda.empty_cache()
    return dict(row, launches=launched)


def distributed_phase(dev) -> dict:
    """Multi-GPU at world size 1 under NCCL: (a) make_sharded_step at the
    bench's 1M x 34 (analytic, systematic, sum) in 8-tick graphs against
    mcl_step; (b) make_sharded_step_batched at 1024 x 500 x 24 against
    run_episode_batch; (c) slam_step_sharded against slam_step; (d)
    run_multihost_episode_batch at 1024 x 500 x 24 x 300; (e) the
    production configuration (ESS 0.5, one round of refinement) through
    (a)'s step.  Returns each path's kernel launches (every count set to 0
    just before the path)."""
    import torch.distributed as dist

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # The group goes down on a failure too: a live NCCL group keeps
        # the process from exiting until its monitor times out.
        try:
            mesh = nccl_world(dev, tmp)
            say("distributed", what="world", backend=dist.get_backend(),
                world_size=dist.get_world_size(),
                mesh=dict(zip(mesh.mesh_dim_names, mesh.shape)))
            big = presets.make_world(
                num_particles=SERVE_N, num_beams=SERVE_B,
                ray_mode="analytic", resample_method="systematic",
                device=dev)
            rows = dict(a=sharded_ticks_path("a", big, mesh, 40))
            del big
            rows["b"] = batched_path(dev, mesh)
            rows["c"] = slam_shard_path(dev, mesh)
            rows["d"] = multihost_path(dev)
            prod = presets.make_world(
                num_particles=SERVE_N, num_beams=SERVE_B,
                ray_mode="analytic", resample_method="systematic",
                ess_threshold=ESS, refine_iters=1, device=dev)
            rows["e"] = sharded_ticks_path("e", prod, mesh, 49)
            del prod
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
    say("distributed", what="phase", seconds=time.perf_counter() - t0)
    launches = {name: 0 for name in KERNELS}
    for path in rows.values():
        for name, n in path.get("launches", {}).items():
            launches[name] += n
    return launches


# -- the study tools ---------------------------------------------------------

# Each study tool's main at full width and small depth: (tool, argv, the
# kernels its path must launch).  The SLAM and mapping tools launch the
# ISM kernel alone (csrc/ism.cu, in models/mapping.update_map).
TOOL_BATCHED = ("beam_weights_batched", "systematic_expand_batched",
                "kmeans_batched")
TOOL_RUNS = (
    ("convergence_study", ["--batch", "64", "--ticks", "60", "--particles",
                           "500"], TOOL_BATCHED),
    ("convergence_study", ["--batch", "8", "--ticks", "60", "--particles",
                           "500", "--refine-iters", "2"],
     TOOL_BATCHED + ("refine_grad", "refine_score")),
    # Multinomial (the JAX tool's default) on a partial map: the weights
    # are plain torch in both packages, so K3 batched alone.
    ("reloc_sweep", ["--seeds", "7", "--replicas", "8", "--ticks", "100"],
     ("kmeans_batched",)),
    ("slam_sweep", ["--episodes", "2", "--ticks", "200", "--particles",
                    "128", "--replicas", "4", "--keyframe-trans", "0.15",
                    "--keyframe-rot", "0.5"], ("ism_update",)),
    ("explore_sweep", ["--maps", "2", "--seeds-per-map", "1", "--ticks",
                       "480"], ("ism_update",)),
    ("bench_fleet", ["--robots", "64", "--ticks", "5"],
     ("beam_weights_batched", "kmeans_batched")),
    ("bench_slam", ["--particles", "32", "128", "--ticks", "80", "--fleet",
                    "4", "--iters", "1"], ("ism_update",)),
    ("bench_mapping", ["--episodes", "32", "--ticks", "80", "--iters", "1"],
     ("ism_update",)),
    ("slam_scale", ["--particles", "128", "--worlds", "6x6", "16x12",
                    "--iters", "4"], ("ism_update",)),
    ("coverage_bound", ["--ticks", "2400"], ()),
)
# Launches a tick of a kernel on a tool's path: one, but refinement's at
# --refine-iters 2 (a gradient a round; the start's scoring and one a
# round).
TOOL_PER_TICK = dict(refine_grad=2, refine_score=3)
# bench_matrix's rows that no earlier phase runs as a whole tick, one
# dispatch each through the port's bench, and the kernels each launches.
MATRIX_ROWS = (("full fidelity: 10k x 360 analytic",
                ("beam_weights", "systematic_expand", "kmeans")),
               ("scaling: 4M x 34", ("beam_weights", "systematic_expand",
                                     "kmeans")))
NUMBER = r"-?(?:\d+(?:,\d{3})*(?:\.\d*)?(?:e[-+]?\d+)?|nan|inf)"


def printed(main, argv) -> tuple:
    """(the lines main(argv) prints, seconds); the lines are echoed."""
    import io

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        main(list(argv))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    lines = out.getvalue().splitlines()
    for line in lines:
        print(line, flush=True)
    return lines, seconds


def tool_lines(name: str, argv) -> tuple:
    """(the lines tools.<name>.main prints on the card, seconds)."""
    import importlib

    tool = importlib.import_module(f"{PKG}.tools.{name}")
    return printed(tool.main, list(argv) + (
        [] if name == "coverage_bound" else ["--device", "cuda"]))


def tool_numbers(name: str, lines) -> dict:
    """The numbers of a tool's lines by key (JSON lines) or in order (text
    lines), raising on one that is not finite, except where no episode
    qualified: the error means of a sweep with none converged or tracked
    and the median error of a reloc seed with no hit."""
    import re

    nums = {}
    for i, line in enumerate(lines):
        if line.startswith("{"):
            row = json.loads(line)
            for k, v in row.items():
                if isinstance(v, (int, float)) and not isinstance(v, bool):
                    nums[f"{i}.{k}"] = float(v)
            if row.get("converged_frac") == 0.0 or row.get(
                    "tracked_episodes_frac") == 0.0:
                nums = {k: v for k, v in nums.items()
                        if not ("rmse" in k and v != v)}
        else:
            vals = [float(v.replace(",", "")) for v in
                    re.findall(NUMBER, line.split(": ", 1)[-1])]
            if line.startswith("converged 0/"):
                vals = vals[:-1]          # median_err(hit) of no hit: nan
            for j, v in enumerate(vals):
                nums[f"{i}.{j}"] = v
    bad = [k for k, v in nums.items() if not math.isfinite(v)]
    if bad or not nums:
        raise AssertionError(f"tools {name}: non-finite or missing numbers "
                             f"{bad}: {lines}")
    return nums


def tool_checks(name: str, lines, nums: dict) -> dict:
    """The tool's own checks on its output; raises on a failed one."""
    import re

    row = {}
    if name == "convergence_study":
        row["converged_frac"] = json.loads(lines[0])["converged_frac"]
        ok = row["converged_frac"] > 0.0
    elif name == "reloc_sweep":
        hit = re.match(r"converged (\d+)/(\d+)", lines[0])
        row["converged"] = f"{hit.group(1)}/{hit.group(2)}"
        ok = int(hit.group(2)) == 16
    elif name == "slam_sweep":
        f1 = [float(v) for v in re.findall(r"F1 (\S+) \(min", " ".join(
            lines))]
        row["mean_f1"] = f1
        ok = len(lines) == 2 and all(0.0 <= v <= 1.0 for v in f1)
    elif name == "explore_sweep":
        out = json.loads(lines[-1])
        cov = [v for k, v in out.items() if "_cov" in k
               and isinstance(v, float)]
        # One wander, one SLAM and one explore graph for both worlds.
        row.update(captures=out["captures"],
                   wander_cov=out["wander_cov@480"],
                   frontier_cov=out["frontier_cov@480"])
        ok = out["captures"] == 3 and all(0.0 <= v <= 1.0 for v in cov)
    elif name == "bench_fleet":
        out = json.loads(lines[0])
        row.update(tick_ms=out["tick_ms"], device_ms=out["device_ms"])
        ok = out["device_ms"] > 0.0 and out["robots"] == 64
    else:
        ok = len(lines) >= 2
    if not ok:
        raise AssertionError(f"tools {name}: a check failed: {lines}")
    return row


def check_matrix_kernels(dev, gen) -> dict:
    """The kernels at bench_matrix's new shapes against their plain
    versions: K1 at 10,000 x 360 beams (analytic, both combines; 0.0
    max-abs error), K2 at 4,000,000 rows (bit-exact) and K3 at 4,000,000
    points (centers within 1e-4).  These launches are not the path's."""
    m = presets.make_world(device=dev).maze
    err = 0.0
    for comb in ("sum", "log"):
        cfg = SensorModelConfig(ray_mode="analytic", beam_combine=comb)
        parts, scan = k1_inputs(m, 10_000, 360, cfg, gen)
        got = weights.beam_weights_cuda(m, parts, scan, cfg)
        want = weights.beam_weights_plain(m, parts, scan, cfg)
        e = (got - want).abs().max().item()
        say("tools", check="beam_weights", n=10_000, beams=360,
            combine=comb, max_abs_err=e)
        if not (e == 0.0 and torch.isfinite(got).all()):
            raise AssertionError(f"K1 at 360 beams ({comb}): {e}")
        err = max(err, e)
    n = 4_000_000
    parts = k2_rows((n,), gen, dev)
    for kind in ("uniform", "skewed", "glitched"):
        u0 = torch.rand((), generator=gen, device=dev)
        cdf = k2_cdf(kind, n, u0, gen, dev)
        got, _ = run_k2(expand.systematic_expand_cuda, parts, cdf, u0)
        if not torch.equal(got, expand.systematic_expand_plain(parts, cdf,
                                                               u0)):
            raise AssertionError(f"K2 at 4M ({kind}): not bit-exact")
    say("tools", check="systematic_expand", n=n, bit_exact=True)
    xy = torch.cat([blobs(n, gen, dev),
                    torch.randn((n, 1), generator=gen, device=dev)], 1)[:, :2]
    c0 = xy[torch.randint(0, n, (3,), generator=gen, device=dev)]
    rs = xy[torch.randint(0, n, (20, 3), generator=gen, device=dev)]
    k3 = k3_against_plain(kmeans.kmeans_cuda, xy, c0, rs, n=n)
    return dict(beam_weights=err, systematic_expand=0.0, kmeans=k3)


def tools_phase(dev) -> tuple:
    """The study tools (montecarlolocalisation_tpu_torch/tools/): each
    tool's main once (TOOL_RUNS), every line finite and each tool's check
    held, each run's kernels launched alike (once a tick) and the first
    run of each kernel family audited against the profiler
    (launch_audit), the SLAM and mapping tools the ISM kernel alone; then
    bench_matrix's 10k x 360 analytic and 4M x 34 rows, one dispatch each, after their
    kernels are held against their plain versions at those shapes.
    Returns (the launches of every run, counted from 0 before the first,
    the check's max-abs errors)."""
    import importlib

    t0 = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(131)
    errs = check_matrix_kernels(dev, gen)
    say("tools", what="checks", at_s=time.perf_counter() - t0)
    matrix = importlib.import_module(f"{PKG}.tools.bench_matrix")
    reset_counts()
    audited_kernels = set()
    for name, argv, kernels in TOOL_RUNS:
        before = counts()
        # A run is audited where it launches a kernel no audited run of
        # the phase launched: a profile costs seconds a run (the
        # refinement run's holds some 10^5 kernels), and bench_fleet,
        # which profiles the card itself, cannot nest in one.
        if not set(kernels) <= audited_kernels:
            audited_kernels.update(kernels)
            with launch_audit(f"tools {name}") as audited:
                lines, seconds = tool_lines(name, argv)
        else:
            lines, seconds = tool_lines(name, argv)
            audited = None
        nums = tool_numbers(name, lines)
        launched = {k: v - before[k] for k, v in counts().items() if
                    v - before[k]}
        say("tools", tool=name, argv=argv, seconds=seconds,
            at_s=time.perf_counter() - t0,
            launches=launched, numbers=len(nums), audit=audited,
            **tool_checks(name, lines, nums))
        ticks = {v / TOOL_PER_TICK.get(k, 1) for k, v in launched.items()}
        if sorted(launched) != sorted(kernels) or len(ticks) > 1:
            raise AssertionError(f"tools {name}: launched {launched}, its "
                                 f"path's kernels are {kernels}, each as "
                                 f"often a tick as TOOL_PER_TICK says")
    configs = dict(matrix.CONFIGS)
    for row, kernels in MATRIX_ROWS:
        argv = list(configs[row])
        argv[argv.index("--iters") + 1] = "1"
        before = counts()
        with launch_audit(f"tools bench_matrix {row}") as audited:
            lines, seconds = printed(bench.main, argv)
        out = json.loads(lines[-1])
        launched = {k: v - before[k] for k, v in counts().items() if
                    v - before[k]}
        say("tools", tool="bench_matrix", row=row, argv=argv,
            seconds=seconds, at_s=time.perf_counter() - t0,
            launches=launched, audit=audited,
            ms_per_step=out["ms_per_step"], value=out["value"])
        if not (math.isfinite(out["value"]) and out["value"] > 0) or \
                sorted(launched) != sorted(kernels):
            raise AssertionError(f"tools bench_matrix {row}: {out}, "
                                 f"launched {launched}")
    compiled.graphs.clear()
    torch.cuda.empty_cache()
    say("tools", what="phase", seconds=time.perf_counter() - t0)
    return counts(), errs


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA card; "
                           "torch.cuda.is_available() is False")
    started = time.perf_counter()
    print(card(), flush=True)
    kind = torch.cuda.get_device_name(0)
    say("device", kind=kind, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda)
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    build.library()
    say("build", seconds=time.perf_counter() - t0,
        nvcc_seconds=build.build_seconds)

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    m = presets.make_world(device=dev).maze
    errs = dict(beam_weights=check_k1(m, gen), systematic_expand=check_k2(
        dev, gen))
    check_k2_strided(dev, gen)
    errs["kmeans"], errs["kmeans_batched"] = check_k3(dev, gen)
    errs["beam_weights_batched"], errs["beam_weights_beamsub"] = \
        check_batched_weights(m, gen)
    errs["systematic_expand_batched"] = check_k2_batched(dev, gen)
    errs["kmeans_batched"]["max_abs_err"] = max(
        errs["kmeans_batched"]["max_abs_err"], check_k3_batched(dev, gen))
    for name, err in check_f1(gen).items():
        errs[name]["max_abs_err"] = max(errs[name]["max_abs_err"], err)
    check_f2(gen)
    errs["beam_weights_stack"] = check_stack(gen)
    errs.update(check_refine(dev))

    # Each path is driven with every count set to 0 just before it and
    # read just after: one filter (serve), a batch (sweep, fleet), K4
    # (A/B), the production schedule's paths: (a) the production sweep,
    # (b) the elastic server, (c) the bench config under the ESS gate; and
    # the randomized-map sweeps (the published row, the full width), the
    # imported map, the CLI presets, the replay, and the control stack's
    # closed loop (the published row, the full width) and presets.
    world, server, launched, replayed = serve_phase(dev)
    entry_phase(dev)
    tick_phase(world, server.state)
    times = time_phase(world, server.state, gen)
    del server
    sweep_launched, sweep_replayed = sweep_phase(dev)
    multimap_row_phase(dev)
    multimap_launched, multimap_replayed = multimap_phase(dev)
    prod_launched, prod_replayed = production_sweep_phase(dev)
    elastic_phase(dev)
    serve_phase(dev, ess=ESS)
    fleet_phase(dev)
    imported_map_phase(dev)
    cli_phase()
    replay_phase(dev)
    control_stack_phase(dev)
    slam_row = slam_stack_phase(dev)["row"]
    explore_stack_phase(dev)
    graphs_phase(dev)
    dist_launched = distributed_phase(dev)
    tools_launched, tools_errs = tools_phase(dev)
    for name, err in tools_errs.items():
        errs[name]["max_abs_err"] = max(errs[name]["max_abs_err"], err)
    profile_phase(dev)
    ab_launched = ab_phase(m, gen)
    times.update(batched_time_phase(m, gen))
    times["beam_weights_stack"] = stack_time(gen)
    times.update(refine_time(dev))
    times["ism_update"] = slam_row["ism_time"]
    errs["ism_update"] = dict(max_abs_err=slam_row["ism_max_abs_err"])
    f1_time(gen)
    launches = {name: launched[name] for name in SINGLE}
    replays = {name: replayed[name] for name in SINGLE}
    for name in ("beam_weights_batched", "systematic_expand_batched",
                 "kmeans_batched"):
        launches[name] = sweep_launched[name]
        replays[name] = sweep_replayed[name]
    launches["beam_weights_stack"] = multimap_launched["beam_weights_stack"]
    replays["beam_weights_stack"] = multimap_replayed["beam_weights_stack"]
    launches["beam_weights_beamsub"] = ab_launched["beam_weights_beamsub"]
    replays["beam_weights_beamsub"] = 0    # on no filter path
    for name in ("refine_grad", "refine_score"):
        launches[name] = prod_launched[name]
        replays[name] = prod_replayed[name]
    launches["ism_update"] = slam_row["ism_launches"]
    replays["ism_update"] = slam_row["ism_replayed"]
    if not all(replays[k] for k in KERNELS if k != "beam_weights_beamsub"):
        raise AssertionError(f"a kernel of a filter path never ran inside a "
                             f"CUDA graph replay: {replays}")
    if not all(launches.values()):
        raise AssertionError(f"a kernel never launched on its path: "
                             f"{launches}")

    if "jax" in sys.modules or any(
            k == "montecarlolocalisation_tpu"
            or k.startswith("montecarlolocalisation_tpu.")
            for k in sys.modules):
        raise AssertionError("the port imported jax or the JAX package")
    say("done", seconds=time.perf_counter() - started)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps(dict(kernels=[
        dict(name=name, route="cuda", source=k["source"],
             replaces=k["replaces"], launches=launches[name],
             replayed=replays[name],
             distributed_launches=dist_launched[name],
             tools_launches=tools_launched[name],
             max_abs_err=errs[name]["max_abs_err"],
             **{key: times[name][key] for key in keys})
        for name, k in KERNELS.items()])), flush=True)
    print(card(), flush=True)
    print(json.dumps(dict(ok=True, device=dict(
        platform="gpu", kind=kind, count=torch.cuda.device_count()))),
        flush=True)


if __name__ == "__main__":
    main()
