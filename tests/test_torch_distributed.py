"""The port's particle-sharded filter (parallel/distributed) against the
JAX package's, on gloo ranks.

The JAX side runs here, on the virtual CPU devices tests/conftest.py
forces; the port side runs as 2 or 4 spawned gloo processes
(tests/torch_dist_child.py), each handed exactly what its JAX shard drew
(torch_parity.jax_shard_tick_draws rebuilds every shard's key tree).  One
spawn a world size runs every check of that size; the tests read its
results.

- The ring systematic draw, on JAX's adversarial weights, bit for bit
  against the port's own single-device systematic_indices on the same
  (gathered) CDF, and >= 99.9 % of rows equal to JAX's ring, at 2 and 4
  ranks.
- The ring multinomial draw: every row is parts[searchsorted(cdf, r)]
  for its sorted uniform r, and the frequencies follow the weights
  (tests/test_sharding.py:299, over 8 independent draws pooled for the
  top particle's share); >= 99.9 % of rows equal to JAX's.
- One make_sharded_step tick at 4 ranks on JAX's per-shard draws:
  multinomial and systematic, shared and per-particle noise, ESS 0.5 with
  one round of refinement (the closed-form caster, as in the single-device
  production tests), the "allgather" exchange and a forced injection:
  >= 99.9 % of particle rows within 1e-5, confidence and best pose within
  1e-4, n_injected equal; the replicated scalars bit-equal on every rank.
- The global injection cap from the ranks' own generators (0 < n <= 200,
  the cap binding), and the generators in lockstep: the shared stream
  equal on every rank after a tick, each rank's stream advanced by exactly
  one draw_shard_tick.
- A 2 x 2 make_sharded_step_batched tick against the JAX 2 x 2 mesh.
- slam_step_sharded at 2 ranks against JAX's over 3 ticks (SLAM's
  parity tolerances: poses and map pixels within 1e-5 on >= 99.9 %,
  weights rtol 1e-4, log evidence within 1e-4); the closure raises.
- No [N_global, .] tensor inside one rank's ring step (a
  TorchDispatchMode records every op's output shapes), while the legacy
  allgather exchange does make one.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from montecarlolocalisation_tpu.config import (
    FilterConfig, MappingConfig, MotionModelConfig, RefineConfig,
    ResampleConfig, SensorModelConfig, SLAMConfig,
)
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.models import resample as jresample
from montecarlolocalisation_tpu.models import sensor as jsensor
from montecarlolocalisation_tpu.models import slam as jslam
from montecarlolocalisation_tpu.parallel import distributed as jdist
from montecarlolocalisation_tpu_torch import interop
from montecarlolocalisation_tpu_torch.models import resample as tresample
from montecarlolocalisation_tpu_torch.parallel import distributed as sd

from torch_parity import (
    as_numpy, jax_shard_slam_draws, jax_shard_tick_draws, maps,
    spawn_ranks, stack,
)

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(len(jax.devices()) < 4,
                                reason="needs 4 virtual devices")

WORLD = 4
N = 1024                      # 4 ranks x 256
ANGLES = np.deg2rad(np.linspace(-118, 118, 8)).astype(np.float32)
ENC = (0.1, 0.12)
RING_N, RING_TRIALS, MN_N, MN_DRAWS = 512, 8, 2048, 8
SHAPES_N = 384                # 4 x 96: no other dimension of the tick
SLAM_P, SLAM_TICKS = 32, 3
SEED = 5


def _cfg(n=N, ray_mode="fixed", **resample_kw):
    shared = resample_kw.pop("shared", True)
    refine = resample_kw.pop("refine", 0)
    return FilterConfig(num_particles=n,
                        sensor=SensorModelConfig(ray_mode=ray_mode),
                        motion=MotionModelConfig(shared_noise=shared),
                        refine=RefineConfig(iters=refine),
                        resample=ResampleConfig(**resample_kw))


TICKS = {
    "multinomial": _cfg(),
    "systematic": _cfg(method="systematic", shared=False),
    "production": _cfg(ray_mode="analytic", method="systematic",
                       ess_threshold=0.5, refine=1),
    "allgather_multinomial": _cfg(sharded_exchange="allgather"),
    "allgather_systematic": _cfg(method="systematic",
                                 sharded_exchange="allgather"),
    "injection": _cfg(method="systematic"),
}


def _adversarial_weights(key, n, trial):
    """tests/test_sharding.py's weight patterns: heavy concentration,
    half-zero shards, all mass on one particle."""
    w = jax.random.uniform(key, (n,)) ** jnp.float32(
        8.0 if trial % 2 else 1.0)
    if trial % 3 == 0:
        w = w.at[: n // 2].set(0.0)
    if trial == 5:
        w = jnp.zeros((n,)).at[7].set(1.0)
    if trial == 7:
        w = jnp.zeros((n,)).at[n - 1].set(1.0)
    return w / jnp.sum(w)


def _jax_ring(fn, mesh, *args):
    return np.asarray(jax.jit(jax.shard_map(
        functools.partial(fn, axis_name="particle"), mesh=mesh,
        in_specs=(P("particle"), P("particle")),
        out_specs=P("particle")))(*args))


def _ring_cases(world):
    """JAX's ring draws on `world` shards, and the port's jobs."""
    mesh = jdist.make_mesh(n_particle_shards=world)
    jobs, want = [], {}
    key = jax.random.PRNGKey(11)
    for trial in range(RING_TRIALS):
        key, k_w, k_p, k_u = jax.random.split(key, 4)
        norm = _adversarial_weights(k_w, RING_N, trial)
        parts = jax.random.normal(k_p, (RING_N, 3))
        u0 = jax.random.uniform(k_u, ())
        want[trial] = _jax_ring(functools.partial(
            jdist._ring_systematic_draw, u0=u0), mesh, parts, norm)
        want[("in", trial)] = (np.asarray(parts), float(u0))
        jobs.append((f"sys{trial}", "ring", dict(
            kind="systematic", weights=np.asarray(norm),
            parts=np.asarray(parts), u0=float(u0))))
    k_w, _, k_d = jax.random.split(jax.random.PRNGKey(23), 3)
    norm = _adversarial_weights(k_w, MN_N, 1)
    parts = jnp.arange(MN_N, dtype=jnp.float32)[:, None] * jnp.ones((1, 3))
    n_loc = MN_N // world
    tiny = jnp.float32(1e-37)
    for i, k in enumerate(jax.random.split(k_d, MN_DRAWS)):
        want[f"mn{i}"] = _jax_ring(functools.partial(
            jdist._ring_multinomial_draw, k), mesh, parts, norm)
        spacings = np.concatenate([np.asarray(jax.random.uniform(
            jax.random.fold_in(k, s), (n_loc,), minval=tiny, maxval=1.0))
            for s in range(world)])
        extra = float(jax.random.uniform(jax.random.fold_in(k, world), (),
                                         minval=tiny, maxval=1.0))
        jobs.append((f"mn{i}", "ring", dict(
            kind="multinomial", weights=np.asarray(norm),
            parts=np.asarray(parts), spacings=spacings,
            spacing_extra=extra)))
    want["mn_norm"] = np.asarray(norm)
    return jobs, want


def _scan(jm, pose=(1.25, 1.25, 0.0)):
    return np.asarray(jsensor.simulate_scan(
        jm, jnp.asarray(pose, jnp.float32), ANGLES,
        SensorModelConfig()).ranges)


def _start(jm, name, cfg, seed):
    """A tick's start state and scan (numpy); "injection" forces heavy
    injection."""
    state = jfilter.init_state(jax.random.PRNGKey(seed), jm, cfg)
    ranges = _scan(jm)
    if name == "injection":
        # tests/test_sharding.py:83: good history, a scan that fits
        # nowhere, the lost regime: heavy injection under the global cap.
        state = dataclasses.replace(
            state, inj=jresample.InjectionState(jnp.float32(10.0),
                                                jnp.float32(10.0)),
            was_lost=jnp.bool_(True))
        ranges = np.full(len(ANGLES), 0.123, np.float32)
    return state, dict(angles=ANGLES, ranges=ranges,
                       mask=np.ones(len(ANGLES), bool))


def _tick_case(jm, name, cfg, seed):
    """JAX's sharded tick of one config, and the port's job."""
    mesh = jdist.make_mesh(n_particle_shards=WORLD)
    state, scan = _start(jm, name, cfg, seed)
    ranges = scan["ranges"]
    step = jdist.make_sharded_step(mesh, jm, cfg)
    new, out = step(jdist.shard_state(state, mesh), jnp.float32(ENC[0]),
                    jnp.float32(ENC[1]),
                    jsensor.Scan(angles=jnp.asarray(ANGLES),
                                 ranges=jnp.asarray(ranges),
                                 mask=jnp.ones(len(ANGLES), bool)))
    draws = jax_shard_tick_draws(state.key, jm, N // WORLD, WORLD, cfg)
    job = (name, "tick", dict(cfg=interop.config_from(cfg), maze=as_numpy(jm),
                              state=as_numpy(state), enc=ENC, scan=scan,
                              draws=[draws]))
    return job, (new, out)


def _batched_case(jm):
    """JAX's 2 x 2 episode x particle tick and the port's job."""
    mesh = jdist.make_mesh(n_particle_shards=2, n_episode_shards=2)
    cfg = _cfg(n=256, method="systematic")
    e = 4
    state = jdist.init_batched_state(jax.random.PRNGKey(0), jm, cfg, e)
    poses = [(1.25, 1.25, 0.0), (2.05, 2.05, 1.0), (1.25, 2.85, -1.0),
             (3.65, 1.25, 2.0)]
    ranges = np.stack([_scan(jm, p) for p in poses])
    enc = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    step = jdist.make_sharded_step_batched(mesh, jm, cfg)
    ep = NamedSharding(mesh, P("episode"))
    new, out = step(
        jdist.shard_state(state, mesh, episode_axis="episode"),
        jax.device_put(jnp.asarray(enc), ep), jax.device_put(
            jnp.asarray(enc + 0.05), ep),
        jsensor.Scan(angles=jnp.asarray(ANGLES),
                     ranges=jax.device_put(jnp.asarray(ranges), ep),
                     mask=jnp.ones(len(ANGLES), bool)))
    per_episode = [jax_shard_tick_draws(state.key[i], jm, 128, 2, cfg)
                   for i in range(e)]
    # Global rank ep * 2 + part holds episodes 2 ep, 2 ep + 1.
    draws = [stack([per_episode[2 * (r // 2) + i][r % 2] for i in range(2)])
             for r in range(WORLD)]
    job = ("batched", "tick", dict(
        cfg=interop.config_from(cfg), maze=as_numpy(jm),
        state=as_numpy(state), enc=(enc, enc + 0.05),
        scan=dict(angles=ANGLES, ranges=ranges,
                  mask=np.ones(len(ANGLES), bool)),
        draws=[draws], episode_shards=2))
    return job, (new, out)


def _slam_cfg(jm, **kw):
    mc = MappingConfig(height=jm.height, width=jm.width,
                       resolution=float(jm.resolution),
                       origin_x=float(jm.origin_x),
                       origin_y=float(jm.origin_y))
    return SLAMConfig(mapping=mc, sensor=SensorModelConfig(ray_mode="fixed"),
                      num_particles=SLAM_P, **kw)


def _slam_case(jm):
    """JAX's sharded SLAM ticks at 2 shards and the port's job."""
    world = 2
    cfg = _slam_cfg(jm, keyframe_trans=0.1, keyframe_rot=0.35,
                    ess_threshold=0.99)
    mesh = jdist.make_mesh(n_particle_shards=world)
    step = jdist.make_sharded_slam_step(mesh, cfg)
    state = jslam.init_slam(jax.random.PRNGKey(4), (1.25, 1.25, 0.0), cfg)
    start = as_numpy(state)
    st = jdist.shard_slam_state(state, mesh)
    key = state.key
    inputs, draws, infos = [], [], []
    for k in range(SLAM_TICKS):
        el, er = 0.8 * (k + 1), 0.82 * (k + 1)
        ranges = _scan(jm, (1.25 + 0.04 * (k + 1), 1.25, 0.02 * (k + 1)))
        mask = np.ones(len(ANGLES), np.float32)
        d, key = jax_shard_slam_draws(key, SLAM_P // world, world)
        st, info = step(st, jnp.float32(el), jnp.float32(er),
                        jnp.asarray(ranges), jnp.asarray(ANGLES),
                        jnp.asarray(mask))
        inputs.append((el, er, ranges, ANGLES, mask))
        draws.append(d)
        infos.append({k2: np.asarray(v) for k2, v in info.items()})
    job = ("slam", "slam", dict(cfg=interop.config_from(cfg), state=start,
                                inputs=inputs, draws=draws))
    return job, (st, infos)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jm, _ = maps()
    tmp = tmp_path_factory.mktemp("dist")
    jobs4, want_ring4 = _ring_cases(4)
    ticks = {}
    for i, (name, cfg) in enumerate(TICKS.items()):
        job, want = _tick_case(jm, name, cfg, 10 + i)
        jobs4.append(job)
        ticks[name] = want
    # The generators' own draws: one tick, then draw_shard_tick alone.
    own_cfg = interop.config_from(_cfg(shared=False))
    state, scan = _start(jm, "multinomial", TICKS["multinomial"], 30)
    jobs4.append(("own", "tick", dict(cfg=own_cfg, maze=as_numpy(jm),
                                      state=as_numpy(state), enc=ENC,
                                      scan=scan, seed=SEED)))
    jobs4.append(("own_draws", "own_draws", dict(
        cfg=own_cfg, maze=as_numpy(jm), n_loc=N // WORLD, seed=SEED)))
    state, scan = _start(jm, "injection", TICKS["injection"], 31)
    jobs4.append(("cap", "tick", dict(
        cfg=interop.config_from(TICKS["injection"]), maze=as_numpy(jm),
        state=as_numpy(state), enc=ENC, scan=scan, seed=SEED)))
    job, batched = _batched_case(jm)
    jobs4.append(job)
    sstate = jfilter.init_state(jax.random.PRNGKey(2), jm, _cfg(SHAPES_N))
    jobs4.append(("shapes", "shapes", dict(
        cfgs={k: interop.config_from(_cfg(SHAPES_N, **kw)) for k, kw in (
            ("ring_multinomial", {}),
            ("ring_systematic", dict(method="systematic", shared=False)),
            ("allgather", dict(method="systematic",
                               sharded_exchange="allgather")))},
        maze=as_numpy(jm), state=as_numpy(sstate), enc=ENC,
        scan=dict(angles=ANGLES, ranges=_scan(jm),
                  mask=np.ones(len(ANGLES), bool)), seed=SEED)))
    jobs2, want_ring2 = _ring_cases(2)
    job, slam = _slam_case(jm)
    jobs2.append(job)
    return dict(r4=spawn_ranks(4, jobs4, tmp), r2=spawn_ranks(2, jobs2, tmp),
                ring={4: want_ring4, 2: want_ring2}, ticks=ticks,
                batched=batched, slam=slam, jm=jm)


def _cat(results, name, key):
    return np.concatenate([r[name][key] for r in results], axis=0)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_systematic_bit_matches_single_device_indices(runs, world):
    res = runs[f"r{world}"]
    for trial in range(RING_TRIALS):
        cdf = torch.as_tensor(_cat(res, f"sys{trial}", "cdf"))
        parts, u0 = runs["ring"][world][("in", trial)]
        want = torch.from_numpy(parts.copy())[tresample.systematic_indices(
            cdf, torch.tensor(u0))]
        np.testing.assert_array_equal(_cat(res, f"sys{trial}", "drawn"),
                                      want.numpy(), err_msg=f"{trial}")


@pytest.mark.parametrize("world", [2, 4])
def test_ring_systematic_matches_jax_ring(runs, world):
    res = runs[f"r{world}"]
    for trial in range(RING_TRIALS):
        got = _cat(res, f"sys{trial}", "drawn")
        want = runs["ring"][world][trial]
        assert np.mean(np.all(got == want, axis=1)) >= 0.999, trial


@pytest.mark.parametrize("world", [2, 4])
def test_ring_multinomial_semantics_and_frequencies(runs, world):
    res = runs[f"r{world}"]
    norm = runs["ring"][world]["mn_norm"]
    counts = np.zeros(MN_N)
    for i in range(MN_DRAWS):
        got = _cat(res, f"mn{i}", "drawn")
        cdf = torch.as_tensor(_cat(res, f"mn{i}", "cdf"))
        rs = torch.as_tensor(_cat(res, f"mn{i}", "rs"))
        assert bool(torch.all(rs[1:] >= rs[:-1]))
        idx = torch.searchsorted(cdf, rs, side="left").clamp(max=MN_N - 1)
        np.testing.assert_array_equal(got[:, 0],
                                      idx.numpy().astype(np.float32))
        freq = np.bincount(got[:, 0].astype(np.int64), minlength=MN_N)
        assert np.abs(freq / MN_N - norm).max() < 0.02
        counts += freq
        want = runs["ring"][world][f"mn{i}"]
        assert np.mean(np.all(got == want, axis=1)) >= 0.999
    # The top particle's share over the pooled draws (one draw of 2048
    # holds about 9 copies of it: too few to test alone).
    top = int(np.argmax(norm))
    assert counts[top] / (MN_DRAWS * MN_N) > 0.5 * float(norm[top])


SCALARS = ("confidence", "was_lost", "cluster_threshold",
           "confident_threshold", "best_pose")


def _replicated_equal(res, name):
    """Every replicated field and output bit-equal on every rank."""
    for r in res[1:]:
        for f in SCALARS:
            np.testing.assert_array_equal(r[name]["state"][f],
                                          res[0][name]["state"][f], f)
        for part in ("odom", "inj"):
            for f, v in r[name]["state"][part].items():
                np.testing.assert_array_equal(
                    v, res[0][name]["state"][part][f], f)
        for k, out in enumerate(r[name]["outs"]):
            for f, v in out.items():
                np.testing.assert_array_equal(v, res[0][name]["outs"][k][f],
                                              f)


def _close_rows(got, want, atol=1e-5):
    return np.mean(np.all(np.abs(got - want) <= atol, axis=-1))


@pytest.mark.parametrize("name", list(TICKS))
def test_sharded_tick_matches_jax(runs, name):
    res = runs["r4"]
    new, out = runs["ticks"][name]
    got = np.concatenate([r[name]["state"]["particles"] for r in res])
    assert _close_rows(got, np.asarray(new.particles)) >= 0.999
    weights = np.concatenate([r[name]["state"]["weights"] for r in res])
    np.testing.assert_allclose(weights, np.asarray(new.weights), rtol=1e-5,
                               atol=1e-9)
    st, o = res[0][name]["state"], res[0][name]["outs"][0]
    np.testing.assert_allclose(st["confidence"], float(new.confidence),
                               atol=1e-4)
    np.testing.assert_allclose(st["best_pose"], np.asarray(new.best_pose),
                               atol=1e-4)
    for f in ("song", "wanderer_cmd", "n_injected"):
        assert int(o[f]) == int(getattr(out, f)), f
    _replicated_equal(res, name)


def test_injection_draws_inject_under_the_global_cap(runs):
    _, out = runs["ticks"]["injection"]
    assert 0 < int(out.n_injected) <= 200


def test_own_generators_inject_under_the_global_cap(runs):
    res = runs["r4"]
    out = res[0]["cap"]["outs"][0]
    n = int(out["n_injected"])
    assert 0 < n <= 200, n
    # The ranks' Bernoulli successes together exceed the cap: it binds.
    assert float(out["p_inject"]) * N > 300
    assert n == 200
    _replicated_equal(res, "cap")


def test_generators_stay_in_lockstep(runs):
    res = runs["r4"]
    gens = [r["own"]["state"]["gen"] for r in res]
    for g in gens[1:]:
        np.testing.assert_array_equal(g["shared"], gens[0]["shared"])
        assert not np.array_equal(g["rank"], gens[0]["rank"])
    for r, g in zip(res, gens):
        assert not np.array_equal(g["shared"], r["own"]["before"]["shared"])
        np.testing.assert_array_equal(g["shared"],
                                      r["own_draws"]["shared"])
        np.testing.assert_array_equal(g["rank"], r["own_draws"]["rank"])
    _replicated_equal(res, "own")


def test_batched_2x2_tick_matches_jax(runs):
    res = runs["r4"]
    new, out = runs["batched"]
    # Rank ep * 2 + part holds episodes [2 ep, 2 ep + 2), particles
    # [128 part, 128 part + 128).
    got = np.zeros((4, 256, 3), np.float32)
    for r, rr in enumerate(res):
        e0, p0 = 2 * (r // 2), 128 * (r % 2)
        got[e0:e0 + 2, p0:p0 + 128] = rr["batched"]["state"]["particles"]
    rows = _close_rows(got.reshape(-1, 3),
                       np.asarray(new.particles).reshape(-1, 3))
    assert rows >= 0.999
    for r, rr in enumerate(res):
        e0 = 2 * (r // 2)
        st, o = rr["batched"]["state"], rr["batched"]["outs"][0]
        np.testing.assert_allclose(st["confidence"],
                                   np.asarray(new.confidence)[e0:e0 + 2],
                                   atol=1e-4)
        np.testing.assert_allclose(st["best_pose"],
                                   np.asarray(new.best_pose)[e0:e0 + 2],
                                   atol=1e-4)
        np.testing.assert_array_equal(
            o["n_injected"], np.asarray(out.n_injected)[e0:e0 + 2])
    for a, b in ((0, 1), (2, 3)):
        for f in SCALARS:
            np.testing.assert_array_equal(res[a]["batched"]["state"][f],
                                          res[b]["batched"]["state"][f])


def test_slam_step_sharded_matches_jax(runs):
    res = runs["r2"]
    st, infos = runs["slam"]
    whole = res[0]["slam"]["whole"]
    for r in res[1:]:
        for f in ("poses", "logodds", "weights", "scores"):
            np.testing.assert_array_equal(r["slam"]["whole"][f], whole[f])
    assert _close_rows(whole["poses"], np.asarray(st.poses)) >= 0.999
    pixels = np.abs(whole["logodds"] - np.asarray(st.logodds)) <= 1e-5
    assert pixels.mean() >= 0.999
    np.testing.assert_allclose(whole["weights"], np.asarray(st.weights),
                               rtol=1e-4, atol=1e-9)
    assert abs(float(whole["log_evidence"])
               - float(st.log_evidence)) <= 1e-4
    resampled = []
    for k, want in enumerate(infos):
        got = res[0]["slam"]["infos"][k]
        for f in ("resampled", "mapped"):
            assert bool(got[f]) == bool(want[f]), (k, f)
        np.testing.assert_allclose(got["pose"], want["pose"], atol=1e-5)
        np.testing.assert_allclose(got["best_pose"], want["best_pose"],
                                   atol=1e-5)
        np.testing.assert_allclose(got["log_evidence"],
                                   want["log_evidence"], atol=1e-4)
        resampled.append(bool(want["resampled"]))
    assert any(resampled)


def test_slam_closure_raises():
    jm, _ = maps()
    cfg = interop.config_from(_slam_cfg(jm, closure=True))
    with pytest.raises(NotImplementedError):
        sd.slam_step_sharded(None, 0.0, 0.0, np.zeros(8), ANGLES,
                             np.ones(8), cfg, group=None)


def test_ring_step_makes_no_global_cloud(runs):
    found = runs["r4"][0]["shapes"]

    def global_dims(shapes):
        return [(op, s) for op, s in shapes if SHAPES_N in s]

    for name in ("ring_multinomial", "ring_systematic"):
        assert found[name], name
        assert any(SHAPES_N // WORLD in s for _, s in found[name])
        assert global_dims(found[name]) == [], name
    assert global_dims(found["allgather"])
