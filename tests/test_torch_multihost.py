"""The port's multi-process episode sweep (parallel/multihost) and the
dry run of the sharded filter, on gloo ranks.

- `initialize`'s rules as tests/test_multihost.py:18 holds the JAX
  package's (one process is a no-op; a process count without a process id
  raises), and for real: two ranks joined through MCL_COORDINATOR,
  MCL_NUM_PROCESSES and MCL_PROCESS_ID, four through torchrun's variables.
- The mesh layout (episode, particle), too many particle shards raising,
  process_episode_slice's arithmetic, and a global episode array
  gathered back (tests/test_multihost.py:25-48); a mesh that would leave
  ranks out raising.
- run_multihost_episode_batch at 1, 2 and 4 ranks from its own draws
  (the whole sweep's, from the seed): equal episode for episode, bit for
  bit, to each other and to episodes.run_episode_batch over the whole
  sweep in one process (the single-process sweep, which
  tests/test_torch_episodes.py holds against JAX); and at 1 and 4 ranks on
  JAX's per-episode draws (its one-process sweep's initial states and
  key trees), equal to each other and to JAX's result within the tick
  tolerance (>= 99.9 % of particle rows within 1e-5, confidence and best
  pose within 1e-4).
- tools/dryrun_multichip at 4 ranks (2 x 2): its three OK lines.
"""
import os
import os.path as osp
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import FilterConfig, SensorModelConfig
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.parallel import episodes as jepisodes
from montecarlolocalisation_tpu.parallel import multihost as jmultihost
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.parallel import multihost

from torch_parity import as_numpy, jax_episode_draws, maps, spawn_ranks

torch.set_num_threads(1)

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
E, N, TICKS = 8, 128, 6
ANGLES = np.deg2rad(np.linspace(-118, 118, 12)).astype(np.float32)
CFG = FilterConfig(num_particles=N,
                   sensor=SensorModelConfig(ray_mode="fixed"))
SEED = 7


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_initialize_single_process_is_a_noop(monkeypatch):
    for v in ("MCL_NUM_PROCESSES", "MCL_COORDINATOR", "MCL_PROCESS_ID",
              "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(v, raising=False)
    assert multihost.initialize() is False
    assert multihost.initialize(num_processes=1) is False
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert multihost.initialize() is False


def test_initialize_needs_a_process_id(monkeypatch):
    monkeypatch.delenv("MCL_PROCESS_ID", raising=False)
    monkeypatch.delenv("RANK", raising=False)
    monkeypatch.setenv("MCL_NUM_PROCESSES", "2")
    with pytest.raises(ValueError, match="MCL_PROCESS_ID"):
        multihost.initialize(device="cpu")
    monkeypatch.delenv("MCL_NUM_PROCESSES")
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(ValueError, match="MCL_NUM_PROCESSES"):
        multihost.initialize(coordinator_address="localhost:1",
                             device="cpu")


def test_process_episode_slice(monkeypatch):
    assert multihost.process_episode_slice(12) == (0, 12)
    monkeypatch.setattr(multihost, "process_count", lambda: 4)
    seen = []
    for pid in range(4):
        monkeypatch.setattr(multihost, "process_index", lambda p=pid: p)
        s, c = multihost.process_episode_slice(12)
        assert c == 3
        seen.extend(range(s, s + c))
    assert sorted(seen) == list(range(12))
    with pytest.raises(ValueError):
        multihost.process_episode_slice(10)


def _sweep_job(name, jm, enc, ranges, states=None, draws=None):
    kw = dict(cfg=interop.config_from(CFG), maze=as_numpy(jm), seed=SEED,
              encoders=enc, ranges=ranges, angles=ANGLES)
    if states is not None:
        kw.update(states=as_numpy(states), draws=draws)
    return (name, "sweep", kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, _ = maps()
    tmp = tmp_path_factory.mktemp("multihost")
    enc, ranges, _ = jepisodes.simulate_episode_batch(
        jax.random.PRNGKey(0), jm, CFG, ANGLES, TICKS, E,
        start_pose=(2.05, 2.05, 0.0))
    enc, ranges = np.asarray(enc), np.asarray(ranges)
    key = jax.random.PRNGKey(1)
    final, _ = jmultihost.run_multihost_episode_batch(
        key, jm, CFG, enc, ranges, ANGLES,
        mesh=jmultihost.make_multihost_mesh())
    # The JAX sweep's episode e starts from init_state(fold_in(key, e)).
    states = jax.vmap(lambda i: jfilter.init_state(
        jax.random.fold_in(key, i), jm, CFG))(np.arange(E))
    draws = jax_episode_draws(states, jm, N, CFG, TICKS)
    own = _sweep_job("own", jm, enc, ranges)
    whole = ("whole", "whole_sweep", own[2])
    replay = _sweep_job("jax", jm, enc, ranges, states, draws)
    mcl_port = _free_port()
    torchrun_port = _free_port()
    out = {
        1: spawn_ranks(1, [own, replay, whole], tmp),
        2: spawn_ranks(2, [own], tmp, env_of=lambda r: dict(
            MCL_COORDINATOR=f"localhost:{mcl_port}", MCL_NUM_PROCESSES="2",
            MCL_PROCESS_ID=str(r))),
        4: spawn_ranks(4, [own, replay, (
            "layout", "mesh_layout",
            dict(particle_shards=2, too_many=8, not_dividing=3))],
            tmp, env_of=lambda r: dict(
                WORLD_SIZE="4", RANK=str(r), LOCAL_RANK=str(r),
                LOCAL_WORLD_SIZE="4", MASTER_ADDR="localhost",
                MASTER_PORT=str(torchrun_port))),
    }
    return dict(out, jax=final)


def test_mesh_layout_and_global_array(runs):
    for r, res in enumerate(runs[4]):
        lay = res["layout"]
        assert tuple(lay["names"]) == ("episode", "particle")
        assert tuple(lay["shape"]) == (2, 2)
        assert lay["raised"]
        assert tuple(lay["slice"]) == (2 * r, 2)
        np.testing.assert_array_equal(
            lay["back"], np.arange(16, dtype=np.float32).reshape(8, 2))


def test_meshes_cover_every_rank(runs):
    """Two intended divergences from the JAX package (ROADMAP section 3):
    a process drives one device, so a mesh leaves no rank out.  A
    particle_shards that does not divide one host's processes raises
    (JAX drops the remainder devices), and make_mesh over fewer ranks than
    the world raises (JAX's make_mesh takes a devices= subset)."""
    for res in runs[4]:
        assert res["layout"]["raised_not_dividing"]
        assert res["layout"]["raised_subset"]


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}.{k}"))
        return out
    return {prefix: tree}


def _arrays(res):
    """The sweep's final state and outputs, flat, arrays only."""
    out = _flat(res["final"])
    out.update(_flat(res["outs"], "outs"))
    return {k: v for k, v in out.items() if isinstance(v, np.ndarray)}


@pytest.mark.parametrize("world", [2, 4])
def test_sweep_is_the_same_on_any_number_of_ranks(runs, world):
    want = _arrays(runs[1][0]["own"])
    for res in runs[world]:
        got = _arrays(res["own"])
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert runs[1][0]["own"]["final"]["particles"].shape == (E, N, 3)


@pytest.mark.parametrize("world", [1, 2, 4])
def test_sweep_equals_run_episode_batch(runs, world):
    """The default path, on every rank, against the single-process sweep
    of all E episodes from the same seed: bit for bit."""
    want = _arrays(runs[1][0]["whole"])
    assert len(want) > 10
    for res in runs[world]:
        got = _arrays(res["own"])
        assert got.keys() == want.keys()
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_sweep_localizes_and_stays_finite(runs):
    final = runs[1][0]["own"]["final"]
    assert np.isfinite(final["particles"]).all()
    conf = final["confidence"]
    assert np.all((conf >= 0.0) & (conf <= 1.0))
    # Episodes differ: each has its own rows of the draws.
    assert len({float(c) for c in final["particles"][:, 0, 0]}) == E


@pytest.mark.parametrize("world", [1, 4])
def test_sweep_on_jax_draws_matches_jax(runs, world):
    jfinal = runs["jax"]
    for res in runs[world]:
        final = res["jax"]["final"]
        rows = np.all(np.abs(final["particles"]
                             - np.asarray(jfinal.particles)) <= 1e-5,
                      axis=-1)
        assert rows.mean() >= 0.999
        np.testing.assert_allclose(final["confidence"],
                                   np.asarray(jfinal.confidence), atol=1e-4)
        np.testing.assert_allclose(final["best_pose"],
                                   np.asarray(jfinal.best_pose), atol=1e-4)
    for k, v in _flat(runs[1][0]["jax"]["final"]).items():
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(
                _flat(runs[world][0]["jax"]["final"])[k], v, err_msg=k)


def test_dryrun_multichip_tool():
    r = subprocess.run(
        [sys.executable, "-m",
         "montecarlolocalisation_tpu_torch.tools.dryrun_multichip",
         "--devices", "4"], cwd=ROOT, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, PYTHONPATH=ROOT))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = [ln for ln in r.stdout.splitlines() if "OK" in ln]
    assert lines == [
        "dryrun_multichip OK: mesh=(2x2), episodes=4, particles=128",
        "dryrun_multichip OK (production: ess=0.5, refine=1): mesh=(2x2)",
        "dryrun_multichip OK (sharded SLAM: P=32 over 4 shards, ring map "
        "exchange)"], r.stdout
