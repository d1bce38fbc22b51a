"""The compiled tick (models/compiled) on the CPU, where a TickGraph runs the
same buffers, copies and chunks as on the card with eager calls of the
ticks in place of capture and replay.

- run_episode in graphs of K = 1, 3 and 8 ticks (T = 20, so a remainder
  graph) equals mcl_step called tick by tick, bit for bit: states,
  outputs and the generator's state, for one filter and a batch,
  systematic and multinomial, ESS-gated with refinement, on a known map,
  on a map stack and with per-tick beam tables.
- With the draws JAX made, the graphs' run against the JAX package's
  run_episode_batch (vmap of init + lax.scan) at the suite's tick
  tolerance: song, wanderer command and n_injected equal, confidence and
  the published pose within 1e-3, >= 99.9 % of the final particle rows
  within 1e-5 (a cumsum ulp can move a rare draw across a CDF boundary).
- The wander simulator's chunks equal its tick function called tick by
  tick, bit for bit, with every stressor.
- MCLServer and MCLFleetServer give the replies of their tick functions
  called eagerly on the state (no graph, no buffers), across an elastic
  resize, a restore mid-session and a robot's reset.
- The cache builds once a key and again on a changed shape, config, map,
  K, draws or other static argument; a repeated multimap sweep on one
  stack replays its graphs; a graph goes when a map it reads dies, the
  module cache keeps the graphs used last, and a server's graphs die with
  the server.  The bench parses --scan-chunk and --ess as the JAX bench.
"""
import dataclasses
import gc
import json
import weakref

import jax
import numpy as np
import pytest
import torch

from montecarlolocalisation_tpu.config import (
    FilterConfig as JFilterConfig, ResampleConfig as JResampleConfig,
    SensorModelConfig as JSensorModelConfig,
)
from montecarlolocalisation_tpu.models import filter as jfilter
from montecarlolocalisation_tpu.parallel import episodes as jepisodes
from montecarlolocalisation_tpu_torch import bench, interop, presets
from montecarlolocalisation_tpu_torch.config import (
    FilterConfig, InitConfig, RefineConfig, ResampleConfig,
    SensorModelConfig,
)
from montecarlolocalisation_tpu_torch.io import fleet as tfleet
from montecarlolocalisation_tpu_torch.io import server as tserver
from montecarlolocalisation_tpu_torch.maps import (
    from_walls, generator, maze, repeat_maps,
)
from montecarlolocalisation_tpu_torch.models import compiled
from montecarlolocalisation_tpu_torch.models import filter as tfilter
from montecarlolocalisation_tpu_torch.models import sensor
from montecarlolocalisation_tpu_torch.parallel import episodes as tepisodes
from montecarlolocalisation_tpu_torch.sim import robot

from torch_parity import jax_episode_draws, maps

torch.set_num_threads(1)

N, BEAMS, T = 128, 12, 20
ANGLES = np.deg2rad(np.linspace(-118, 118, BEAMS)).astype(np.float32)
MAP_CELLS_CLOSED = ((0, 1), (2, 3))


def _cfg(mode="fixed", method="multinomial", ess=None, refine=0,
         init=InitConfig()):
    return FilterConfig(num_particles=N,
                        sensor=SensorModelConfig(ray_mode=mode),
                        resample=ResampleConfig(method=method,
                                                ess_threshold=ess),
                        refine=RefineConfig(iters=refine), init=init)


CASES = {
    "one_filter_multinomial": dict(cfg=_cfg()),
    "one_filter_per_tick_angles": dict(
        cfg=_cfg("analytic", "systematic"), per_tick=True),
    "batch_systematic": dict(cfg=_cfg(method="systematic"), batch=3),
    "batch_ess_refine": dict(cfg=_cfg("analytic", "systematic", ess=0.5,
                                      refine=1), batch=2),
    "known_map": dict(cfg=_cfg(init=InitConfig(
        partial_map_cells="explored")), known=True),
    "map_stack": dict(cfg=_cfg(), batch=4, stack=True),
}


def _maps(case):
    """(map, known map or None) of a case, on the CPU."""
    world = presets.make_world(device="cpu")
    if case.get("stack"):
        stack = generator.generate_map_batch(2, rows=4, cols=4, seed=0,
                                             device="cpu")
        return repeat_maps(stack, 2), None
    if not case.get("known"):
        return world.maze, None
    walls = maze.load_map_file(presets.DEFAULT_MAP)
    closed = [[list(c) for c in row] for row in walls]
    for r, c in MAP_CELLS_CLOSED:
        closed[r][c] = [0, 1, 2, 3]
    return (from_walls(closed, device="cpu"),
            from_walls(walls, device="cpu"))


def _inputs(batch, per_tick, seed):
    """Encoders [.., T, 2], ranges and mask [.., T, B], angles [B] or
    [T, B]."""
    rng = np.random.default_rng(seed)
    b = () if batch is None else (batch,)
    enc = np.cumsum(rng.uniform(0.0, 0.3, b + (T, 2)), axis=-2)
    ranges = rng.uniform(0.05, 1.0, b + (T, BEAMS))
    mask = rng.random(b + (T, BEAMS)) > 0.1
    angles = (ANGLES + rng.uniform(-0.01, 0.01, (T, BEAMS)) if per_tick
              else ANGLES)
    return (torch.as_tensor(enc, dtype=torch.float32),
            torch.as_tensor(ranges, dtype=torch.float32),
            torch.as_tensor(mask),
            torch.as_tensor(angles, dtype=torch.float32))


def _same_gen(state):
    gen = torch.Generator()
    gen.set_state(state.gen.get_state())
    return dataclasses.replace(state, gen=gen)


def _eager(state, enc, ranges, mask, angles, m, cfg, known_map):
    """mcl_step called tick by tick: the ticks the graphs hold."""
    lead = len(state.batch)
    outs = []
    for t in range(ranges.shape[lead]):
        scan = sensor.Scan(angles=angles[t] if angles.dim() == 2 else angles,
                           ranges=ranges.select(lead, t),
                           mask=mask.select(lead, t))
        e = enc.select(lead, t)
        state, out = tfilter.mcl_step(state, e[..., 0], e[..., 1], scan, m,
                                      cfg, known_map=known_map)
        outs.append(out)
    return state, tfilter.MCLOutput(**{
        f.name: torch.stack([getattr(o, f.name) for o in outs], dim=lead)
        for f in dataclasses.fields(tfilter.MCLOutput)})


def _differing(a, b):
    """The tensors of two (state, outputs) results that are not equal bit
    for bit, the generator's state among them."""
    bad = []
    for name, x, y in zip(
            [f"state.{f.name}" for f in dataclasses.fields(a[0])]
            + [f"out.{f.name}" for f in dataclasses.fields(a[1])],
            [getattr(a[0], f.name) for f in dataclasses.fields(a[0])]
            + [getattr(a[1], f.name) for f in dataclasses.fields(a[1])],
            [getattr(b[0], f.name) for f in dataclasses.fields(b[0])]
            + [getattr(b[1], f.name) for f in dataclasses.fields(b[1])]):
        if isinstance(x, torch.Generator):
            x, y = x.get_state(), y.get_state()
        if dataclasses.is_dataclass(x):
            bad += [f"{name}.{f.name}" for f in dataclasses.fields(x)
                    if not torch.equal(getattr(x, f.name),
                                       getattr(y, f.name))]
        elif not torch.equal(x, y):
            bad.append(name)
    return bad


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("name", list(CASES))
def test_chunked_run_episode_equals_eager_ticks(name, k, monkeypatch):
    monkeypatch.setattr(compiled, "TICKS_PER_GRAPH", k)
    case = CASES[name]
    m, known = _maps(case)
    cfg = case["cfg"]
    state = tfilter.init_state(m, cfg, seed=3, batch=case.get("batch"),
                               known_map=known)
    enc, ranges, mask, angles = _inputs(case.get("batch"),
                                        case.get("per_tick"), seed=4)
    want = _eager(_same_gen(state), enc, ranges, mask, angles, m, cfg,
                  known)
    start = _same_gen(state)
    before = compiled.graphs.builds
    got = tfilter.run_episode(start, enc, ranges, angles, m, cfg,
                              scan_mask=mask, known_map=known)
    assert compiled.graphs.builds - before <= 2     # K ticks, remainder
    assert _differing(want, got) == []
    assert got[0].gen is start.gen
    assert got[1].song.shape == state.batch + (T,)


def test_run_episode_returns_its_own_tensors():
    # A second episode on the same graphs leaves the first one's result
    # as it was: run_episode copies the state out of the buffers.
    world = presets.make_world(num_particles=64, num_beams=BEAMS,
                               device="cpu")
    enc, ranges, mask, _ = _inputs(None, False, seed=5)
    a = tfilter.init_state(world.maze, world.cfg, seed=1)
    b = tfilter.init_state(world.maze, world.cfg, seed=2)
    fa, oa = tfilter.run_episode(a, enc, ranges, ANGLES, world.maze,
                                 world.cfg)
    keep = fa.particles.clone(), oa.confidence.clone()
    tfilter.run_episode(b, enc, ranges, ANGLES, world.maze, world.cfg)
    assert torch.equal(fa.particles, keep[0])
    assert torch.equal(oa.confidence, keep[1])


E, JN, JT = 2, 256, 10


@pytest.fixture(scope="module")
def jax_run():
    jm, tm = maps()
    jcfg = JFilterConfig(num_particles=JN,
                         sensor=JSensorModelConfig(ray_mode="fixed"),
                         resample=JResampleConfig(method="systematic"))
    enc, ranges, _ = jepisodes.simulate_episode_batch(
        jax.random.PRNGKey(1), jm, jcfg, ANGLES, JT, E,
        start_pose=(2.05, 2.05, 0.0))
    enc, ranges = np.asarray(enc), np.asarray(ranges)
    key = jax.random.PRNGKey(6)
    jfinal, jouts = jepisodes.run_episode_batch(key, jm, jcfg, enc, ranges,
                                                ANGLES)
    states0 = jax.vmap(lambda k: jfilter.init_state(k, jm, jcfg))(
        jax.random.split(key, E))
    draws = jax_episode_draws(states0, jm, JN, jcfg, JT)
    return tm, jcfg, enc, ranges, jfinal, jouts, states0, draws


@pytest.mark.parametrize("k", [3, 8])
def test_chunked_run_matches_jax_scan(jax_run, k, monkeypatch):
    monkeypatch.setattr(compiled, "TICKS_PER_GRAPH", k)
    tm, jcfg, enc, ranges, jfinal, jouts, states0, draws = jax_run
    final, outs = tepisodes.run_episode_batch(
        0, tm, interop.config_from(jcfg), enc, ranges, ANGLES,
        state=interop.state_from_numpy(states0), draws=draws)
    for f in ("song", "wanderer_cmd", "n_injected"):
        np.testing.assert_array_equal(getattr(outs, f).numpy(),
                                      np.asarray(getattr(jouts, f)),
                                      err_msg=f)
    np.testing.assert_allclose(outs.confidence.numpy(),
                               np.asarray(jouts.confidence), atol=1e-3)
    np.testing.assert_allclose(outs.exact_pose.numpy(),
                               np.asarray(jouts.exact_pose), atol=1e-3)
    rows = np.all(np.abs(final.particles.numpy()
                         - np.asarray(jfinal.particles)) <= 1e-5, axis=-1)
    assert rows.mean() >= 0.999, rows.mean()


WANDERS = {
    "plain": dict(),
    "kidnap": dict(kidnap_tick=5, kidnap_pose=(0.45, 1.25, 0.5)),
    "moving_obstacle": dict(moving_obstacle=(2.05, 2.05, 0.5, 0.15, 0.3)),
    "explore_slip_faults": dict(explore=True, slip_noise=0.1,
                                dropout_p=0.1, outlier_p=0.1),
}


def _wander_by_ticks(gen, m, cfg, steps, batch, start, kw):
    """The wander's tick function called tick by tick, its inputs sliced
    as generate_wander_episode slices them."""
    draws = robot.draw_wander(gen, batch, steps, BEAMS, "cpu",
                              dropout_p=kw.get("dropout_p", 0.0),
                              outlier_p=kw.get("outlier_p", 0.0),
                              slip_noise=kw.get("slip_noise", 0.0),
                              explore=kw.get("explore", False))
    obstacle = kw.get("moving_obstacle")
    w = robot._Wander(
        speed=0.04, obstacle_stop=0.4, turn_ticks=10, scan_noise=0.02,
        kidnap_pose=tuple(kw.get("kidnap_pose", (0.45, 0.45, 0.0))),
        dropout_p=kw.get("dropout_p", 0.0),
        outlier_p=kw.get("outlier_p", 0.0),
        obstacle=None if obstacle is None else tuple(obstacle[:4]),
        slip_noise=kw.get("slip_noise", 0.0),
        explore=kw.get("explore", False))
    carry = dict(robot=robot.make_robot(*start, batch=batch),
                 turning=torch.zeros(batch, dtype=torch.int32),
                 tsign=torch.ones(batch))
    consts = dict(angles=torch.as_tensor(ANGLES))
    outs = []
    for tick in range(steps):
        x = dict(scan=sensor.ScanDraws(**{
            f.name: None if getattr(draws.scan, f.name) is None
            else getattr(draws.scan, f.name)[:, tick]
            for f in dataclasses.fields(draws.scan)}))
        if w.slip_noise:
            x["slip"] = draws.slip[:, tick]
        if w.explore:
            x["tie"], x["dur"] = draws.tie[:, tick], draws.dur[:, tick]
        if "kidnap_tick" in kw:
            x["kidnap"] = torch.full((batch,), tick == kw["kidnap_tick"])
        if obstacle is not None:
            phase = torch.tensor(obstacle[4], dtype=torch.float32) * float(
                tick)
            x["obstacle_cos"] = torch.cos(phase).expand(batch)
            x["obstacle_sin"] = torch.sin(phase).expand(batch)
        carry, y = robot._wander_tick(carry, x, consts, m, cfg, w)
        outs.append(y)
    return tuple(torch.stack([o[i] for o in outs], dim=1) for i in range(3))


@pytest.mark.parametrize("name", list(WANDERS))
def test_wander_chunks_equal_its_ticks(name, monkeypatch):
    monkeypatch.setattr(compiled, "TICKS_PER_GRAPH", 3)
    kw = WANDERS[name]
    world = presets.make_world(num_beams=BEAMS, device="cpu")
    steps, batch, start = 11, 3, (1.25, 1.25, 0.0)
    gen = torch.Generator()
    gen.manual_seed(7)
    want = _wander_by_ticks(gen, world.maze, world.cfg, steps, batch, start,
                            kw)
    gen.manual_seed(7)
    got = robot.generate_wander_episode(gen, world.maze, world.cfg, ANGLES,
                                        steps, batch=batch,
                                        start_pose=start, **kw)
    for a, b in zip(want, got):
        assert torch.equal(a, b)


class _EagerServer(tserver.MCLServer):
    """The server with its tick and resize functions called eagerly on
    its state: the replies the graphs must give."""

    def _run_tick(self, frame):
        self._state, reply = tserver._serve_tick(
            self._state, dict(frame=frame.clone()), None, **self._tick_args)
        return reply

    def _resize(self, n_new):
        st = self._state
        _, ys = tserver._resize_tick(
            dict(gen=st.gen), dict(particles=st.particles,
                                   weights=st.weights), None, n_new)
        return ys["particles"], ys["weights"]


class _EagerFleet(tfleet.MCLFleetServer):
    def _run_tick(self, frame):
        self._state, reply = tfleet._fleet_tick(
            self._state, dict(frame=frame.clone()), None, **self._tick_args)
        return reply


def _frames(world, n, robots=None):
    rng = np.random.default_rng(8)
    shape = (BEAMS,) if robots is None else (robots, BEAMS)
    lead = () if robots is None else (robots,)
    out = []
    for k in range(n):
        enc = (0.3 * (k + 1) + rng.uniform(0, 0.05, lead)).tolist()
        out.append(dict(encoder_left=enc,
                        encoder_right=(np.asarray(enc) * 1.1).tolist(),
                        ranges=rng.uniform(0.05, 1.0, shape).tolist()))
    return out


def test_server_graphs_give_the_eager_replies(tmp_path):
    world = presets.make_world(num_particles=256, num_beams=BEAMS,
                               resample_method="systematic", device="cpu")
    frames = _frames(world, 8)
    path = str(tmp_path / "ckpt.npz")
    replies = []
    for cls in (_EagerServer, tserver.MCLServer):
        s = cls(world.maze, world.cfg, world.angles, seed=0,
                adapt=(64, 256), adapt_mode="kld")
        out = [s.tick(**f) for f in frames[:2]]
        s._set_particle_count(128)                   # an elastic resize
        out += [s.tick(**f) for f in frames[2:4]]
        s.checkpoint(path)
        out += [s.tick(**f) for f in frames[4:6]]
        s.restore(path)                               # mid-session
        out += [s.tick(**f) for f in frames[4:6]]
        s._set_particle_count(256)
        out += [s.tick(**f) for f in frames[6:]]
        s.reset(seed=4)
        out += [s.tick(**f) for f in frames[:2]]
        replies.append(out)
    assert replies[0] == replies[1]
    assert replies[1][4:6] == replies[1][6:8]        # the restore repeats
    assert replies[1][2]["particles"] == 128       # ran at the new count


@pytest.mark.parametrize("pipeline", [False, True])
def test_fleet_graphs_give_the_eager_replies(tmp_path, pipeline):
    robots = 3
    world = presets.make_world(num_particles=64, num_beams=BEAMS,
                               device="cpu")
    lines = [json.dumps(f) for f in _frames(world, 6, robots)]
    path = str(tmp_path / "fleet.npz")
    session = (lines[:2] + [json.dumps(dict(cmd="reset", robot=1, seed=3))]
               + lines[2:4]
               + [json.dumps(dict(cmd="checkpoint", path=path))]
               + lines[4:] + [json.dumps(dict(cmd="restore", path=path))]
               + lines[4:])
    replies = []
    for cls in (_EagerFleet, tfleet.MCLFleetServer):
        fleet = cls(world.maze, world.cfg, world.angles, robots, seed=0,
                    pipeline=pipeline)
        sink = []
        fleet.serve(session, out_stream=type(
            "Sink", (), dict(write=lambda self, s: sink.append(s),
                             flush=lambda self: None))())
        replies.append([json.loads(r) for r in "".join(sink).splitlines()])
    assert replies[0] == replies[1]
    ticks = [r for r in replies[1] if "exact_pose" in r]
    assert len(ticks) == 8 and ticks[4:6] == ticks[6:8]
    assert not any("error" in r for r in replies[1])


def test_cache_builds_once_a_key(monkeypatch):
    world = presets.make_world(num_particles=64, num_beams=BEAMS,
                               device="cpu")
    m, cfg = world.maze, world.cfg
    enc, ranges, mask, angles = _inputs(None, False, seed=9)
    cache = compiled.GraphCache()
    monkeypatch.setattr(compiled, "graphs", cache)

    def run(state, mm=m, c=cfg, k=4, draws=None):
        return tfilter.run_ticks(state, enc[:k], ranges[:k], mask[:k],
                                 angles, mm, c, draws=draws)

    st = tfilter.init_state(m, cfg, seed=0)
    st1, _ = run(st)
    st2, _ = run(st1)
    assert cache.builds == 1 and len(cache) == 1
    assert cache.entries()[0].replays == 2
    assert st2.particles is st1.particles        # the state stays in place
    run(tfilter.init_state(m, cfg, seed=1))      # a new state, same key
    assert cache.builds == 1
    run(tfilter.init_state(m, dataclasses.replace(cfg, num_particles=32),
                           seed=0))              # a changed shape
    assert cache.builds == 2
    other = dataclasses.replace(cfg, resample=dataclasses.replace(
        cfg.resample, method="systematic"))
    run(tfilter.init_state(m, other, seed=0), c=other)   # a changed config
    assert cache.builds == 3
    twin = presets.make_world(num_particles=64, num_beams=BEAMS,
                              device="cpu").maze
    run(st, mm=twin)                             # another map, same raster
    assert cache.builds == 4
    run(st, k=3)                                 # another K
    assert cache.builds == 5
    gen = torch.Generator()
    gen.manual_seed(2)
    draws = compiled.stack_ticks(
        [tfilter.draw_tick(gen, m, 64, cfg) for _ in range(4)], 0)
    run(st, draws=draws)                         # draws passed in
    assert cache.builds == 6
    run(st)
    assert cache.builds == 6 and len(cache) == 6
    cache.clear()
    assert len(cache) == 0


def test_repeated_multimap_sweeps_replay(monkeypatch):
    # A second and third sweep on the same stack build no graph, and the
    # cache does not grow; when the stack dies, its graphs go too.
    cache = compiled.GraphCache(limit=compiled.GRAPHS_KEPT)
    monkeypatch.setattr(compiled, "graphs", cache)
    monkeypatch.setattr(compiled, "TICKS_PER_GRAPH", 4)
    cfg = _cfg()
    stack = generator.generate_map_batch(2, rows=4, cols=4, seed=0,
                                         device="cpu")
    first = tepisodes.run_multimap_sweep(0, stack, cfg, ANGLES, 6,
                                         episodes_per_map=2)
    built, kept = cache.builds, len(cache)
    assert built == 4            # the wander's and the filter's, K and 2
    for _ in range(2):
        again = tepisodes.run_multimap_sweep(0, stack, cfg, ANGLES, 6,
                                             episodes_per_map=2)
        assert (cache.builds, len(cache)) == (built, kept)
    assert _differing(first[:2], again[:2]) == []
    tepisodes.run_multimap_sweep(0, stack, cfg, ANGLES, 6,
                                 episodes_per_map=1)
    assert cache.builds == built + 4 and len(cache) == kept + 4
    del stack
    gc.collect()
    assert len(cache) == 0 and not tepisodes._episode_stacks


def test_graphs_die_with_their_map(monkeypatch):
    # A graph holds the maps it reads weakly: the map's death drops it,
    # and only it.
    cache = compiled.GraphCache()
    monkeypatch.setattr(compiled, "graphs", cache)
    enc, ranges, mask, angles = _inputs(None, False, seed=10)
    cfg = _cfg()
    worlds = [presets.make_world(num_particles=N, num_beams=BEAMS,
                                 device="cpu").maze for _ in range(2)]
    for m in worlds:
        tfilter.run_ticks(tfilter.init_state(m, cfg, seed=0), enc[:2],
                          ranges[:2], mask[:2], angles, m, cfg)
    assert len(cache) == 2
    del m, worlds[0]
    gc.collect()
    assert len(cache) == 1
    tfilter.run_ticks(tfilter.init_state(worlds[0], cfg, seed=0), enc[:2],
                      ranges[:2], mask[:2], angles, worlds[0], cfg)
    assert cache.builds == 2                     # the survivor replays


def test_cache_keeps_the_graphs_used_last():
    cache = compiled.GraphCache(limit=2)
    carry = dict(v=torch.zeros(3))
    xs = dict(x=torch.ones(1, 3))

    def step(c, x, consts, scale):
        v = c["v"] + scale * x["x"]
        return dict(v=v), v

    def run(scale):
        graph = compiled.cached(cache, step, carry, xs, None, 0,
                                scale=scale)
        return graph(carry, xs)[1][0]

    assert torch.equal(run(1.0), torch.ones(3))
    assert torch.equal(run(2.0), torch.full((3,), 2.0))
    run(1.0)                                     # used last: kept
    assert cache.builds == 2
    run(3.0)                                     # drops scale 2.0
    assert cache.builds == 3 and len(cache) == 2
    run(1.0)
    assert cache.builds == 3
    run(2.0)                                     # built again
    assert cache.builds == 4 and len(cache) == 2


def test_server_cache_dies_with_the_server():
    # The map outlives the server; the server's graphs do not.
    world = presets.make_world(num_particles=64, num_beams=BEAMS,
                               device="cpu")
    server = tserver.MCLServer(world.maze, world.cfg, world.angles, seed=0)
    for f in _frames(world, 3):
        server.tick(**f)
    graphs = weakref.ref(server._graphs)
    assert len(graphs()) == 1
    del server
    gc.collect()
    assert graphs() is None


def test_bench_parses_the_jax_flags():
    args = bench.parse_args([])
    assert args.scan_chunk == 8 and args.ess is None
    assert bench.filter_config(args).resample.ess_threshold is None
    args = bench.parse_args(["--ess", "0.5", "--scan-chunk", "1",
                             "--particles", "4096", "--resample",
                             "multinomial", "--beam-combine", "log"])
    cfg = bench.filter_config(args)
    assert cfg.resample == ResampleConfig(method="multinomial",
                                          ess_threshold=0.5)
    assert cfg.num_particles == 4096 and args.scan_chunk == 1
    assert cfg.sensor.beam_combine == "log"
    for bad in (["--scan-chunk", "0"], ["--iters", "0"]):
        with pytest.raises(SystemExit):
            bench.parse_args(bad)
