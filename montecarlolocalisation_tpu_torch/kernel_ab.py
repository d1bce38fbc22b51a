"""Time the kernels against an earlier version of their CUDA sources, on
one GPU.

    python -m montecarlolocalisation_tpu_torch.kernel_ab OLD_CSRC [PART ...]

PART is any of ptxas, sincosf, ablation, turns, expand, beamsub, batched
and cast; all of them without one.  OLD_CSRC holds the earlier sources the parts read:
for ablation and turns, csrc/weights.cu and csrc/kmeans.cu with the C
entries they had at commit 97cbc4c (a pixel-scan K1, a K3 of two launches
an iteration); for expand, csrc/expand.cu as it was from 97cbc4c to
e1e0d5d (K2 taking offspring counts computed in torch); for beamsub,
csrc/weights.cu as it was at commit 24f8e6e (K4 with eight threads a
particle on a grid of particle blocks x episodes); for batched,
csrc/weights.cu with the raster-words argument of commit 5c0d8c8 (K1
batched on one map, before its map-stack form); for cast, csrc/weights.cu
as it was before the analytic cast was scheduled by ray (commit 2fb1a6a:
every candidate slab of both axes with selects).  For example
`git archive 97cbc4c montecarlolocalisation_tpu_torch/csrc | tar -x
--strip-components=2 -C OLD_CSRC`.  Parts that need different commits run
in separate invocations.  It prints one JSON line a result:

1. `ptxas`: registers, stack and spills of every current kernel.
2. `sincosf`: whether the card's sincosf gives sinf's and cosf's bits on
   every float with |x| < 64 (the beam weight kernel calls sincosf).
3. `ablation`: the earlier K1 with one cost taken out at a time (the band
   scan cut to one pixel, the cast replaced by a constant, the trig by a
   fixed direction, expf by a polynomial, the raster read through L1), and
   the current fixed-mode K1 with its march replaced by a constant or its
   registers capped (in analytic mode K1 launches the cast kernel, which
   `cast` times), at 1M x 34 and 1024 x 500 x 24, analytic and fixed, in
   device time, on two kinds of particles:
   "uniform" (drawn over the map) and "filtered" (after 20 ticks of the
   filter along a wander, so neighbouring particles are resampled copies
   of one source, as in the serve's and the sweep's ticks).  The variants
   that take a cost out compute other weights: they time where the
   kernel's time goes.
4. `turns`: K1, K1 batched, K3, K3 batched and K4 at the shapes of
   PERF.md's kernel table (K1 and K1 batched on both kinds of particles),
   timed plain, old, new, new, old, plain, with CUDA events around one call
   (host enqueue included) and with the profiler's device time per call;
   the old and new outputs are compared.
5. `expand`: K2 and K2 batched at the shapes of PERF.md's kernel table and
   beside them (1M and 4M x 3; 1024 x 500, 64 x 1500 and 8 x 65,536
   episodes), on skewed, uniform and one-source CDFs.  "Old" is the
   earlier path: the offspring counts and their cummax in torch, then the
   earlier kernel; "new" the kernel that computes them itself.  Timed
   plain, old, new, new, old, plain, as in `turns`, with each side's
   device launches a call; the outputs are compared bit for bit.  Then
   `expand_paths`: the current kernel's two paths forced at the same
   sizes up to its one-block limit, ops/expand.SMALL_N, at 1, 8, 64 and
   1024 episodes, in device time.
6. `beamsub`: K4 of OLD_CSRC against the current one at 64 x {500, 768,
   2000} x 24, 1024 x 768 x 24, 64 x 1500 x 34 and 1 x 1500 x 24, analytic
   and fixed, on uniform particles, in device time, timed old, new, new,
   old; the outputs compared bit for bit.  Beside them, at each shape: K1
   batched; the current K4 with each T of 1, 2, 4 and 8 threads a particle
   forced; and three variants of the current source at the plan's T, timed
   in turns with it: "static_runs" (each block takes a fixed contiguous run
   of items instead of drawing the next from the counter), "recompute"
   (every thread of a group prepares its particle itself) and "shuffle"
   (the group's first thread prepares it and broadcasts the fields by
   __shfl_sync), which must give the current kernel's bits; and four
   diagnostics: "beam_order" (each thread's beams in beam order into one
   sum: other weights, the same work), "one_item_blocks" (one block an
   item, not persistent), "no_bounds" (no __launch_bounds__) and "bounds5"
   (registers capped for five blocks an SM).  The ptxas lines of every
   variant come first.
7. `batched`: K1 batched of OLD_CSRC against the current one on one map
   at the sweep's shape (1024 x 500 x 24), fixed and analytic, bit for bit
   and in device time, old, new, new, old.
8. `cast`: the analytic K1 of OLD_CSRC against the current one (the cast
   scheduled by ray) at 1M x 34 on uniform and on filtered particles,
   1024 x 500 x 24 batched and 10k x 360, in device time, old, new, new,
   old; the outputs compared bit for bit with each other and with the
   plain version; `cast_stats` at each shape beside the 2 x n_cand
   candidate slabs a beam of the earlier kernel; the kernels one current
   call runs, by name; and both sources' ptxas usage, the fixed-mode K1
   and K1 batched kernels' compared entry by entry.

It needs a CUDA card and nvcc, and fails without them.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

from . import presets
from .config import SensorModelConfig
from .models import filter as mcl
from .models import resample, sensor
from .sim import robot
from .ops import analytic, build, expand, kmeans, weights

START = (1.25, 1.25, 0.0)

SINCOS_CHECK = r"""
#include <cuda_runtime.h>
__global__ void chk(unsigned long long* bad) {
  const unsigned int top = 0x42800000u;  // 64.0f
  for (unsigned long long u = blockIdx.x * (unsigned long long)blockDim.x
           + threadIdx.x; u < 2ull * top;
       u += (unsigned long long)gridDim.x * blockDim.x) {
    unsigned int bits = (unsigned int)(u % top) | (u >= top ? 0x80000000u : 0u);
    float x = __uint_as_float(bits), s, c;
    sincosf(x, &s, &c);
    if (__float_as_uint(s) != __float_as_uint(sinf(x)) ||
        __float_as_uint(c) != __float_as_uint(cosf(x)))
      atomicAdd(bad, 1ull);
  }
}
extern "C" int run_chk(unsigned long long* bad) {
  chk<<<132 * 16, 256>>>(bad);
  return (int)cudaGetLastError();
}
"""

# Variants of the earlier weights.cu, each a list of (its text, what the
# variant puts in its place).
OLD_ABLATIONS = {
    "noscan": [("""    for (int j = 0; j < cnt; ++j) {
      int row = fwd ? lo + j : hi - j;
      if (line_bit(g, vertical, k, row)) {
        found = true;
        rr = row;
        break;
      }
    }""", """    if (cnt > 0) {
      rr = fwd ? lo : hi;
      found = line_bit(g, vertical, k, rr);
    }""")],
    "nocast": [("""  if (P.mode == kFixed) {
    dist = march(""", """  if (true) {
    dist = 0.5f + 1e-3f * dx;
  } else if (P.mode == kFixed) {
    dist = march(""")],
    "notrig": [("float dx = cosf(ray), dy = sinf(ray);",
                "float dx = 0.6f + 1e-3f * ray, dy = 0.8f - 1e-3f * ray;")],
    "noexp": [("expf(-(diff * diff) * P.inv_two_sigma2)",
               "(1.0f - (diff * diff) * P.inv_two_sigma2)")],
    "l1raster": [(
        "*raster_in_smem = (size_t)h * w <= (size_t)kSmemRasterMax;",
        "*raster_in_smem = 0;")],
}

# Variants of the current weights.cu's fixed-mode K1: the march replaced by
# a constant, and register caps.
NEW_ABLATIONS = {
    "nocast": [("""  if (P.mode == kFixed) {
    dist = march<G>(""", """  if (true) {
    dist = 0.5f + 1e-3f * dx;
  } else if (P.mode == kFixed) {
    dist = march<G>(""")],
    # Register caps that let 6 or 5 blocks of 256 threads share an SM.
    "regs40": [("__global__ void beam_weights",
                "__global__ void __launch_bounds__(kThreads, 6) beam_weights")],
    "regs48": [("__global__ void beam_weights",
                "__global__ void __launch_bounds__(kThreads, 5) beam_weights")],
}


# Variants of the current weights.cu's K4, named in the docstring's part 6.
_FIRST_ITEM = "  for (int f = blockIdx.x; f < items;) {"
_NEXT_ITEM = "    if (more && threadIdx.x == 0) s_item = gridDim.x + atomicAdd(next, 1);"
_SMEM_PREP = "    if constexpr (T > 1) {\n      if ((int)threadIdx.x < rows) {"
_GET_PREP = "      q = get_particle(s_prep, per, j);"
_OWN_PREP = """      if (live) {
        const float* row = parts + 3 * (k0 + j);
        q = prepare<G>(row[0], row[1], row[2], B, P);
      }"""
_SHFL = "__shfl_sync(0xffffffffu, {0}, 0, T)"
_SHFL_PREP = (_OWN_PREP.replace("if (live)", "if (live && r == 0)") + "\n"
              + "".join(f"      q.{f} = {_SHFL.format('q.' + f)};\n"
                        for f in ("x", "y", "th", "ox", "oy", "gx", "gy",
                                  "pv.k0", "ph.k0"))
              + "".join(f"      q.{f} = {_SHFL.format('(int)q.' + f)} != 0;\n"
                        for f in ("inb", "pv.inside0", "pv.origin0",
                                  "ph.inside0", "ph.origin0")))
BEAMSUB_VARIANTS = {
    "static_runs": [
        (_FIRST_ITEM, _FIRST_ITEM.replace(
            "blockIdx.x;",
            "(int)(blockIdx.x * (long long)items / gridDim.x);")),
        (_NEXT_ITEM, _NEXT_ITEM.replace(
            "gridDim.x + atomicAdd(next, 1)",
            "f + 1 < (int)((blockIdx.x + 1) * (long long)items / gridDim.x)"
            " ? f + 1 : items"))],
    "recompute": [(_SMEM_PREP, _SMEM_PREP.replace("(T > 1)", "(T < 1)")),
                  (_GET_PREP, _OWN_PREP)],
    "shuffle": [(_SMEM_PREP, _SMEM_PREP.replace("(T > 1)", "(T < 1)")),
                (_GET_PREP, _SHFL_PREP.rstrip("\n"))],
    "beam_order": [("for (int b = r + T * v; b < nb; b += kLanes)",
                    "for (int b = r; b < nb && v == 0; b += T)")],
    "one_item_blocks": [(
        "std::min(items, (long long)resident * sms)", "items")],
    "no_bounds": [("__global__ void __launch_bounds__(kThreads) beamsub",
                   "__global__ void beamsub")],
    "bounds5": [("__launch_bounds__(kThreads) beamsub",
                 "__launch_bounds__(kThreads, 5) beamsub")],
}
BEAMSUB_SHAPES = ((64, 500, 24), (64, 768, 24), (64, 2000, 24),
                  (1024, 768, 24), (64, 1500, 34), (1, 1500, 24))


def say(part: str, **fields) -> None:
    print(json.dumps(dict(part=part, **fields)), flush=True)


def ptxas_lines(stderr: str) -> list:
    return [ln.strip() for ln in stderr.splitlines()
            if "Compiling entry" in ln or "registers" in ln or "spill" in ln]


def compile_libs(sources: dict, workdir: str) -> dict:
    """name -> loaded library, one nvcc per source, all started together;
    prints each library's ptxas usage."""
    nvcc = build.find_nvcc()
    if nvcc is None:
        raise RuntimeError("nvcc not found")
    procs = {}
    for name, src in sources.items():
        cu = os.path.join(workdir, name + ".cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(workdir, name + ".so")
        procs[name] = (so, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-shared", "-o", so,
             cu],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (so, p) in procs.items():
        _, err = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed on {name}:\n{err}")
        say("ptxas", source=name, lines=ptxas_lines(err))
        libs[name] = ctypes.CDLL(so)
        libs[name].ptxas = ptxas_lines(err)
    return libs


def ptxas_usage(lines) -> dict:
    """Mangled kernel name -> its ptxas "Used ..." line (registers, stack,
    shared memory), from ptxas_lines."""
    usage, entry = {}, None
    for ln in lines:
        if "Compiling entry" in ln:
            entry = ln.split("'")[1]
        elif "Used" in ln and entry is not None:
            usage[entry] = ln.split("Used", 1)[1].strip()
    return usage


# The beam weight entries of the earlier sources (97cbc4c, 24f8e6e): no
# raster-words argument before the stream, and K4 with K1 batched's
# arguments, without a plan or a counter.
OLD_SIGNATURES = {
    name: build.SIGNATURES[name][:-2] + build.SIGNATURES[name][-1:]
    for name in ("mcl_beam_weights", "mcl_beam_weights_batched")}
OLD_SIGNATURES["mcl_beam_weights_beamsub"] = OLD_SIGNATURES[
    "mcl_beam_weights_batched"]


def weight_entries(lib, old: bool = False):
    """Set the beam weight entries' argtypes, the current sources' or
    (old) the earlier ones'; `lib.old_entries` records which."""
    table = OLD_SIGNATURES if old else build.SIGNATURES
    for entry in ("mcl_beam_weights", "mcl_beam_weights_batched",
                  "mcl_beam_weights_beamsub"):
        fn = getattr(lib, entry)
        fn.argtypes = table[entry]
        fn.restype = ctypes.c_int
    lib.old_entries = old
    return lib


def k1(lib, m, parts, scan, cfg):
    """One K1 launch through `lib`'s C entry, as ops/weights launches it
    (the shared-memory raster form)."""
    nb = scan.angles.shape[0]
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    table = torch.stack([sign * scan.angles, scan.ranges.expand(nb),
                         scan.mask.to(torch.float32)]).contiguous()
    out = torch.empty(parts.shape[0], dtype=torch.float32,
                      device=parts.device)
    fp, ip = weights._params(m, cfg)
    build.check(lib.mcl_beam_weights(
        parts.data_ptr(), parts.shape[0], table.data_ptr(), nb,
        m.occ.data_ptr(), m.occ_dilated.data_ptr(), m.height, m.width,
        ctypes.addressof(fp), ctypes.addressof(ip), out.data_ptr(),
        *(() if lib.old_entries else (None,)),
        build.stream_handle(parts.device)), "mcl_beam_weights")
    return out


def k1_batched(lib, entry, m, parts, scan, cfg, *plan):
    """One K1 batched or K4 launch through `lib`'s C entry; the current K4
    takes its threads a particle and particles a block (`plan`) and an
    item counter, an earlier one neither."""
    n_ep, n = parts.shape[0], parts.shape[1]
    nb = scan.angles.shape[0]
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    angles = (sign * scan.angles).contiguous()
    ranges = scan.ranges.contiguous()
    mask = scan.mask.to(torch.float32).contiguous()
    out = torch.empty((n_ep, n), dtype=torch.float32, device=parts.device)
    fp, ip = weights._params(m, cfg)
    counter = torch.empty(1, dtype=torch.int32, device=parts.device)
    tail = (*plan, counter.data_ptr()) if plan else ()
    if not lib.old_entries:
        tail += (None,)    # the shared-memory raster form
    build.check(getattr(lib, entry)(
        parts.data_ptr(), n_ep, n, angles.data_ptr(), ranges.data_ptr(),
        mask.data_ptr(), nb, m.occ.data_ptr(), m.occ_dilated.data_ptr(),
        m.height, m.width, ctypes.addressof(fp), ctypes.addressof(ip),
        out.data_ptr(), *tail, build.stream_handle(parts.device)), entry)
    return out


def old_kmeans(lib, xy, c0, rs):
    """The earlier K3 (two launches an iteration) on xy [E, n, 2]."""
    e, n, k = xy.shape[0], xy.shape[1], c0.shape[-2]
    n_blocks = max(1, min(-(-n // 256), 1024))
    xy = xy.contiguous()
    assign = torch.zeros((e, n), dtype=torch.int32, device=xy.device)
    centers = c0.clone().contiguous()
    partial = torch.empty(e * n_blocks * 3 * k, device=xy.device)
    changed = torch.empty(e * n_blocks, dtype=torch.int32, device=xy.device)
    done = torch.zeros(e, dtype=torch.int32, device=xy.device)
    build.check(lib.mcl_kmeans(
        xy.data_ptr(), e, n, rs.contiguous().data_ptr(), rs.shape[-3], k,
        assign.data_ptr(), centers.data_ptr(), partial.data_ptr(),
        changed.data_ptr(), done.data_ptr(), n_blocks,
        build.stream_handle(xy.device)), "old mcl_kmeans")
    return centers, assign


def event_ms(fn, reps: int = 20) -> float:
    """Median CUDA-event time of one call, after a warm-up."""
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


def device_ms(fn, reps: int = 20, tries: int = 3) -> float:
    """Device time of one call: every kernel and copy the profiler sees
    over `reps` calls, divided by reps.  A window in which the profiler
    recorded no device activity at all is taken again."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = 0.0
        for ev in prof.key_averages():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                total += getattr(ev, "self_device_time_total",
                                 None) or ev.self_cuda_time_total
        if total > 0.0:
            return total / 1e3 / reps
    raise RuntimeError("the profiler recorded no device time")


def weight_inputs(m, n, nb, cfg, gen, episodes=None):
    """Uniform particles ([n, 3], or [E, n, 3]) and a scan with two dead
    lanes: from START for one filter, from a pose of its own for each
    episode."""
    dev = m.device
    angles = np.deg2rad(np.linspace(-118.0, 118.0, nb)).astype(np.float32)
    if episodes is None:
        parts = resample.sample_uniform_particles(gen, m, n)
        truth = START
        mask = torch.ones(nb, dtype=torch.bool, device=dev)
    else:
        parts = resample.sample_uniform_particles(gen, m, n,
                                                  batch=(episodes,))
        truth = resample.sample_uniform_particles(gen, m, episodes)
        mask = torch.ones((episodes, nb), dtype=torch.bool, device=dev)
    mask[..., [1, nb // 2]] = False
    scan = sensor.simulate_scan(m, truth, angles, cfg)
    return parts, sensor.Scan(angles=scan.angles, ranges=scan.ranges,
                              mask=mask)


def filtered_inputs(m, n, nb, cfg, gen, episodes=None, ticks=20):
    """Particles after `ticks` filter ticks (systematic resampling) along a
    wander from START, and the last tick's scan with the same two dead
    lanes as weight_inputs."""
    dev = m.device
    world = presets.make_world(num_particles=n, num_beams=nb,
                               ray_mode=cfg.ray_mode,
                               resample_method="systematic", device=dev)
    enc, ranges, _ = robot.generate_wander_episode(
        gen, m, world.cfg, world.angles, ticks, batch=episodes or 1,
        start_pose=START)
    if episodes is None:
        enc, ranges = enc[0], ranges[0]
    state = mcl.init_state(m, world.cfg, seed=3, batch=episodes)
    final, _ = mcl.run_episode(state, enc, ranges, world.angles, m,
                               world.cfg)
    mask = torch.ones(ranges.shape[:-2] + (nb,), dtype=torch.bool,
                      device=dev)
    mask[..., [1, nb // 2]] = False
    return final.particles.contiguous(), sensor.Scan(
        angles=torch.as_tensor(world.angles, device=dev),
        ranges=ranges[..., -1, :].contiguous(), mask=mask)


def kmeans_inputs(xy, gen):
    """centers0 [..., 3, 2] and reseed [..., 20, 3, 2] drawn from xy."""
    n = xy.shape[-2]
    lead = xy.shape[:-2]
    init = torch.randint(0, n, lead + (3,), generator=gen, device=xy.device)
    again = torch.randint(0, n, lead + (60,), generator=gen,
                          device=xy.device)
    c0 = torch.take_along_dim(xy, init[..., None], dim=-2)
    rs = torch.take_along_dim(xy, again[..., None], dim=-2).reshape(
        lead + (20, 3, 2))
    return c0, rs


def sincos_part(workdir):
    lib = compile_libs({"sincos_check": SINCOS_CHECK}, workdir)["sincos_check"]
    lib.run_chk.argtypes = [ctypes.c_void_p]
    bad = torch.zeros(1, dtype=torch.int64, device="cuda")
    build.check(lib.run_chk(bad.data_ptr()), "run_chk")
    torch.cuda.synchronize()
    say("sincosf", floats_checked=2 * 0x42800000, mismatches=int(bad.item()))


def variants(source: str, edits: dict) -> dict:
    """name -> source: the source as it is ("base") and with each edit."""
    out = {"base": source}
    for name, pairs in edits.items():
        text = source
        for old, new in pairs:
            if old not in text:
                raise ValueError(f"no text for the {name} variant")
            text = text.replace(old, new)
        out[name] = text
    return out


def ablation_part(which: str, sources: dict, workdir, gen):
    """Each variant of `sources` timed in turns (all, then all reversed) at
    1M x 34 and 1024 x 500 x 24, analytic and fixed, on uniform and on
    filtered particles."""
    libs = {k: weight_entries(v, old=which == "old") for k, v in compile_libs(
        {f"{which}_{k}": v for k, v in sources.items()}, workdir).items()}
    libs = {k[len(which) + 1:]: v for k, v in libs.items()}
    names = list(libs)
    m = presets.make_world(device="cuda").maze
    for mode, kind in ((mode, kind) for mode in ("analytic", "fixed")
                       for kind in ("uniform", "filtered")):
        cfg = SensorModelConfig(ray_mode=mode)
        make = weight_inputs if kind == "uniform" else filtered_inputs
        parts, scan = make(m, 1_048_576, 34, cfg, gen)
        bparts, bscan = make(m, 500, 24, cfg, gen, episodes=1024)
        for shape, call in (
                ([1_048_576, 34], lambda lib: k1(lib, m, parts, scan, cfg)),
                ([1024, 500, 24], lambda lib: k1_batched(
                    lib, "mcl_beam_weights_batched", m, bparts, bscan,
                    cfg))):
            base = call(libs["base"])
            same = {k: bool(torch.equal(call(libs[k]), base))
                    for k in names}
            sides = {k: [] for k in names}
            for k in names + names[::-1]:
                sides[k].append(device_ms(lambda k=k: call(libs[k])))
            say("ablation", source=which, shape=shape, ray_mode=mode,
                particles=kind, device_ms={k: float(np.median(v)) for k, v in sides.items()},
                sides=sides, equal_to_base=same)


def ptxas_part(workdir):
    """Registers, stack and spills of each current kernel (nvcc -Xptxas
    -v)."""
    nvcc = build.find_nvcc()
    for src in build.sources():
        r = subprocess.run([nvcc, *build.NVCC_FLAGS, "-Xptxas", "-v", "-c",
                            "-o", os.path.join(workdir, "ptxas.o"), src],
                           capture_output=True, text=True)
        say("ptxas", source=os.path.basename(src), rc=r.returncode,
            lines=ptxas_lines(r.stderr))


def turns_part(old_libs, gen):
    dev = torch.device("cuda")
    old_w = weight_entries(old_libs["weights"], old=True)
    old_k = old_libs["kmeans"]
    old_k.mcl_kmeans.argtypes = [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_void_p]
    old_k.mcl_kmeans.restype = ctypes.c_int
    m = presets.make_world(device=dev).maze
    rows = []
    cfg = SensorModelConfig(ray_mode="analytic")
    parts, scan = weight_inputs(m, 1_048_576, 34, cfg, gen)
    fcfg = SensorModelConfig(ray_mode="fixed")
    for kind, make in (("uniform", weight_inputs),
                       ("filtered", filtered_inputs)):
        parts, scan = make(m, 1_048_576, 34, cfg, gen)
        rows.append(("beam_weights", [1_048_576, 34, "analytic", kind],
                     lambda p=parts, s=scan: weights.beam_weights_plain(
                         m, p, s, cfg),
                     lambda p=parts, s=scan: k1(old_w, m, p, s, cfg),
                     lambda p=parts, s=scan: weights.beam_weights_cuda(
                         m, p, s, cfg)))
        bparts, bscan = make(m, 500, 24, fcfg, gen, episodes=1024)
        rows.append(("beam_weights_batched", [1024, 500, 24, "fixed", kind],
                     lambda p=bparts, s=bscan: weights.beam_weights_plain(
                         m, p, s, fcfg),
                     lambda p=bparts, s=bscan: k1_batched(
                         old_w, "mcl_beam_weights_batched", m, p, s, fcfg),
                     lambda p=bparts, s=bscan:
                     weights.beam_weights_batched_cuda(m, p, s, fcfg)))
    aparts, ascan = weight_inputs(m, 768, 24, cfg, gen, episodes=64)
    rows.append(("beam_weights_beamsub", [64, 768, 24, "analytic"],
                 lambda: weights.beamsub_plain(m, aparts, ascan, cfg),
                 lambda: k1_batched(old_w, "mcl_beam_weights_beamsub", m,
                                    aparts, ascan, cfg),
                 lambda: weights.beamsub_cuda(m, aparts, ascan, cfg)))
    world = presets.make_world(num_particles=1_048_576, device=dev)
    xy = mcl.init_state(world.maze, world.cfg, seed=3).particles[:, :2]
    c0, rs = kmeans_inputs(xy, gen)
    rows.append(("kmeans", [1_048_576],
                 lambda: kmeans.kmeans_plain(xy, c0, rs),
                 lambda: old_kmeans(old_k, xy[None], c0[None], rs[None]),
                 lambda: kmeans.kmeans_cuda(xy, c0, rs)))
    bxy = weight_inputs(m, 500, 24, fcfg, gen, episodes=1024)[0][..., :2]
    bc0, brs = kmeans_inputs(bxy, gen)
    rows.append(("kmeans_batched", [1024, 500],
                 lambda: kmeans.kmeans_plain(bxy, bc0, brs),
                 lambda: old_kmeans(old_k, bxy, bc0, brs),
                 lambda: kmeans.kmeans_batched_cuda(bxy, bc0, brs)))
    for name, shape, plain, old, new in rows:
        o, w = old(), new()
        if name.startswith("kmeans"):
            same = dict(centers_max_abs_diff=(o[0].reshape(w[0].shape)
                                              - w[0]).abs().max().item(),
                        assign_equal_share=(o[1].reshape(w[1].shape) == w[1])
                        .float().mean().item())
        else:
            same = dict(bit_equal=bool(torch.equal(o, w)))
        p1, o1, n1 = event_ms(plain, 5), event_ms(old), event_ms(new)
        n2, o2, p2 = event_ms(new), event_ms(old), event_ms(plain, 5)
        say("turns", kernel=name, shape=shape, plain_ms=[p1, p2],
            old_ms=[o1, o2], new_ms=[n1, n2],
            old_device_ms=device_ms(old), new_device_ms=device_ms(new),
            **same)


def old_expand(lib, parts, cdf, u0):
    """The earlier path: offspring counts and their cummax in torch, then
    the earlier kernel (one thread an output, a binary search over the
    counts in device memory) through its C entry."""
    counts = expand.offspring_counts(cdf, u0)
    n, d = parts.shape[-2], parts.shape[-1]
    out = torch.empty_like(parts)
    build.check(lib.mcl_systematic_expand(
        parts.data_ptr(), counts.data_ptr(), parts.numel() // (n * d), n, d,
        out.data_ptr(), build.stream_handle(parts.device)),
        "old mcl_systematic_expand")
    return out


def forced_expand(parts, cdf, u0, one_block: bool):
    """The current kernel with its path forced: one block an episode
    (no scratch), or the two launches over source tiles (scratch)."""
    n, d = parts.shape[-2], parts.shape[-1]
    n_ep = parts.numel() // (n * d)
    out = torch.empty_like(parts)
    scratch = None if one_block else torch.empty(
        expand.LaunchPlan(n, n_ep, False).scratch_ints, dtype=torch.int32,
        device=parts.device)
    build.check(build.library().mcl_systematic_expand(
        parts.data_ptr(), cdf.data_ptr(), u0.data_ptr(), n_ep, n, d,
        out.data_ptr(), None if scratch is None else scratch.data_ptr(),
        build.stream_handle(parts.device)), "mcl_systematic_expand")
    return out


def expand_cdf(kind, n_ep, n, gen):
    """cdf [n_ep, n] of one kind, accumulated in float64 as the filter
    does: "skewed" (weights u^8, half of them zero), "uniform" (u), or
    "one_source" (source n // 3 owns every draw)."""
    dev = torch.device("cuda")
    if kind == "one_source":
        cdf = torch.zeros((n_ep, n), device=dev)
        cdf[:, n // 3:] = 1.0
        return cdf
    w = torch.rand((n_ep, n), generator=gen, device=dev)
    if kind == "skewed":
        w = w ** 8
        w[torch.rand((n_ep, n), generator=gen, device=dev) < 0.5] = 0.0
    return torch.cumsum((w / w.sum(-1, keepdim=True)).double(), -1).float()


def launches_of(fn) -> int:
    """Device launches of one call of fn, from the profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(ev.count for ev in prof.key_averages()
               if ev.device_type == torch.autograd.DeviceType.CUDA)


def expand_part(old_dir, workdir, gen):
    with open(os.path.join(old_dir, "expand.cu")) as f:
        old_lib = compile_libs({"expand": f.read()}, workdir)["expand"]
    old_lib.mcl_systematic_expand.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    old_lib.mcl_systematic_expand.restype = ctypes.c_int
    dev = torch.device("cuda")
    shapes = [("systematic_expand", 1, 1_048_576, kind)
              for kind in ("skewed", "uniform", "one_source")]
    shapes += [("systematic_expand", 1, 4_194_304, "skewed"),
               ("systematic_expand_batched", 1024, 500, "skewed"),
               ("systematic_expand_batched", 1024, 500, "uniform"),
               ("systematic_expand_batched", 64, 1500, "skewed"),
               ("systematic_expand_batched", 8, 65_536, "skewed")]
    for name, n_ep, n, kind in shapes:
        parts = torch.randn((n_ep, n, 3), generator=gen, device=dev)
        cdf = expand_cdf(kind, n_ep, n, gen)
        u0 = torch.rand(n_ep, generator=gen, device=dev)
        if name == "systematic_expand":
            parts, cdf, u0 = parts[0], cdf[0], u0[0]
        plain = lambda: expand.systematic_expand_plain(parts, cdf, u0)
        old = lambda: old_expand(old_lib, parts, cdf, u0)
        new = lambda: expand.systematic_expand(parts, cdf, u0)
        want, o, w = plain(), old(), new()
        p1, o1, n1 = event_ms(plain, 5), event_ms(old), event_ms(new)
        n2, o2, p2 = event_ms(new), event_ms(old), event_ms(plain, 5)
        od1, nd1 = device_ms(old), device_ms(new)
        nd2, od2 = device_ms(new), device_ms(old)
        say("expand", kernel=name, shape=list(parts.shape), cdf=kind,
            plain_ms=[p1, p2], old_ms=[o1, o2], new_ms=[n1, n2],
            old_device_ms=[od1, od2], new_device_ms=[nd1, nd2],
            old_launches=launches_of(old), new_launches=launches_of(new),
            offspring_counts_device_ms=device_ms(
                lambda: expand.offspring_counts(cdf, u0)),
            old_bit_equal=bool(torch.equal(o, want)),
            new_bit_equal=bool(torch.equal(w, want)))
    for n_ep in (1, 8, 64, 1024):
        for n in (1024, 2048, 4096, 6144, expand.SMALL_N):
            parts = torch.randn((n_ep, n, 3), generator=gen, device=dev)
            cdf = expand_cdf("skewed", n_ep, n, gen)
            u0 = torch.rand(n_ep, generator=gen, device=dev)
            block = lambda: forced_expand(parts, cdf, u0, True)
            grid = lambda: forced_expand(parts, cdf, u0, False)
            same = bool(torch.equal(block(), grid()))
            b1, g1, g2, b2 = (device_ms(block), device_ms(grid),
                              device_ms(grid), device_ms(block))
            say("expand_paths", episodes=n_ep, n=n,
                one_block_device_ms=[b1, b2], two_launch_device_ms=[g1, g2],
                equal=same)


def forced_plan(parts, t: int) -> tuple:
    """K4's C entry arguments (threads a particle, particles a block) with
    T = t forced on particles [E, n, 3]."""
    plan = weights.BeamsubPlan.for_threads(parts.shape[0], parts.shape[1], t)
    return plan.threads, plan.per_block


def beamsub_part(old_dir, workdir, gen):
    with open(os.path.join(old_dir, "weights.cu")) as f:
        old_src = f.read()
    with open(os.path.join(build.CSRC, "weights.cu")) as f:
        new_src = f.read()
    sources = {f"k4_{k}": v for k, v in variants(
        new_src, BEAMSUB_VARIANTS).items()}
    sources["k4_old"] = old_src
    libs = compile_libs(sources, workdir)
    old = weight_entries(libs.pop("k4_old"), old=True)
    libs = {k[3:]: weight_entries(v) for k, v in libs.items()}
    names = list(libs)
    entry = "mcl_beam_weights_beamsub"
    m = presets.make_world(device="cuda").maze
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for (n_ep, n, nb), mode in ((s, mode) for mode in ("analytic", "fixed")
                                for s in BEAMSUB_SHAPES):
        cfg = SensorModelConfig(ray_mode=mode)
        parts, scan = weight_inputs(m, n, nb, cfg, gen, episodes=n_ep)
        plan = weights.beamsub_plan(n_ep, n, nb, sms)
        p_args = (plan.threads, plan.per_block)
        want = weights.beamsub_plain(m, parts, scan, cfg)
        o_fn = lambda: k1_batched(old, entry, m, parts, scan, cfg)
        n_fn = lambda: weights.beamsub_cuda(m, parts, scan, cfg)
        o1, n1, n2, o2 = (device_ms(o_fn), device_ms(n_fn), device_ms(n_fn),
                          device_ms(o_fn))
        forced = {t: device_ms(lambda t=t: k1_batched(
            libs["base"], entry, m, parts, scan, cfg,
            *forced_plan(parts, t))) for t in (1, 2, 4, 8)}
        var = {k: lambda k=k: k1_batched(libs[k], entry, m, parts, scan, cfg,
                                         *p_args) for k in names}
        sides = {k: [] for k in names}
        for k in names + names[::-1]:
            sides[k].append(device_ms(var[k]))
        say("beamsub", shape=[n_ep, n, nb], ray_mode=mode,
            plan_threads=plan.threads, plan_per_block=plan.per_block,
            old_device_ms=[o1, o2], new_device_ms=[n1, n2],
            k1_batched_device_ms=device_ms(
                lambda: weights.beam_weights_batched_cuda(m, parts, scan,
                                                          cfg)),
            forced_threads_device_ms=forced,
            variant_device_ms={k: float(np.median(v))
                               for k, v in sides.items()},
            variant_sides=sides,
            old_bit_equal=bool(torch.equal(o_fn(), n_fn())),
            new_bit_equal_plain=bool(torch.equal(n_fn(), want)),
            variants_bit_equal={k: bool(torch.equal(f(), want))
                                for k, f in var.items()},
            forced_bit_equal={t: bool(torch.equal(k1_batched(
                libs["base"], entry, m, parts, scan, cfg,
                *forced_plan(parts, t)), want)) for t in (1, 2, 4, 8)})


PARTS = ("ptxas", "sincosf", "ablation", "turns", "expand", "beamsub",
         "batched", "cast")


def batched_part(old_dir, workdir, gen):
    """K1 batched of an earlier weights.cu with the current entry's
    arguments against the current one, on the default maze."""
    with open(os.path.join(old_dir, "weights.cu")) as f:
        old = weight_entries(compile_libs({"weights": f.read()},
                                          workdir)["weights"])
    m = presets.make_world(device="cuda").maze
    for mode in ("fixed", "analytic"):
        cfg = SensorModelConfig(ray_mode=mode)
        parts, scan = weight_inputs(m, 500, 24, cfg, gen, episodes=1024)
        o = lambda: k1_batched(old, "mcl_beam_weights_batched", m, parts,
                               scan, cfg)
        n = lambda: weights.beam_weights_batched_cuda(m, parts, scan, cfg)
        same = torch.equal(o(), n())
        t_old1, t_new1, t_new2, t_old2 = (device_ms(f) for f in (o, n, n, o))
        say("batched", kernel="beam_weights_batched", ray_mode=mode,
            shape=[1024, 500, 24], bit_equal=same,
            old_device_ms=[t_old1, t_old2], new_device_ms=[t_new1, t_new2])


def kernel_names(fn) -> list:
    """The device kernels one call of fn runs, by name, from the
    profiler."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sorted({ev.key for ev in prof.key_averages()
                   if ev.device_type == torch.autograd.DeviceType.CUDA})


# The fixed-mode K1 kernels, whose source the analytic schedule left as it
# was: their mangled names in ptxas' lines.
FIXED_K1 = ("19beam_weights_kernelI", "27beam_weights_batched_kernelI")


def cast_part(old_dir, workdir, gen):
    with open(os.path.join(old_dir, "weights.cu")) as f:
        old_src = f.read()
    with open(os.path.join(build.CSRC, "weights.cu")) as f:
        new_src = f.read()
    libs = compile_libs({"cast_old": old_src, "cast_new": new_src}, workdir)
    old, new = (weight_entries(libs[k]) for k in ("cast_old", "cast_new"))
    use_new = ptxas_usage(new.ptxas)
    # The fixed-mode kernels by their mangled names from the length-
    # prefixed name on: the anonymous namespace's part names the file.
    strip = lambda use: {k[k.index(f):]: v for k, v in use.items()
                         for f in FIXED_K1 if f in k}
    fixed_new = strip(use_new)
    fixed = {k: dict(old=v, new=fixed_new.get(k))
             for k, v in strip(ptxas_usage(old.ptxas)).items()}
    say("cast_ptxas", fixed=fixed, fixed_unchanged=bool(fixed) and all(
        v["old"] == v["new"] for v in fixed.values()),
        cast_kernels={k: v for k, v in use_new.items()
                      if "beam_weights_cast_kernel" in k})
    m = presets.make_world(device="cuda").maze
    cfg = SensorModelConfig(ray_mode="analytic")
    _, n_cand, _ = analytic.cast_constants(m, cfg.max_range)
    rows = []
    for kind, make in (("uniform", weight_inputs),
                       ("filtered", filtered_inputs)):
        parts, scan = make(m, 1_048_576, 34, cfg, gen)
        rows.append(([1_048_576, 34, kind], parts, scan))
    rows.append(([1024, 500, 24, "uniform"],
                 *weight_inputs(m, 500, 24, cfg, gen, episodes=1024)))
    rows.append(([10_000, 360, "uniform"],
                 *weight_inputs(m, 10_000, 360, cfg, gen)))
    for shape, parts, scan in rows:
        if parts.dim() == 2:
            call = lambda lib, p=parts, s=scan: k1(lib, m, p, s, cfg)
        else:
            call = lambda lib, p=parts, s=scan: k1_batched(
                lib, "mcl_beam_weights_batched", m, p, s, cfg)
        o_fn, n_fn = (lambda: call(old)), (lambda: call(new))
        got = n_fn()
        same = bool(torch.equal(o_fn(), got))
        plain = bool(torch.equal(
            got, weights.beam_weights_plain(m, parts, scan, cfg)))
        o1, n1, n2, o2 = (device_ms(f) for f in (o_fn, n_fn, n_fn, o_fn))
        stats = weights.cast_stats(m, parts, scan, cfg)
        say("cast", shape=shape, old_device_ms=[o1, o2],
            new_device_ms=[n1, n2], new_over_old=(n1 + n2) / (o1 + o2),
            bit_equal=same, plain_bit_equal=plain,
            slabs_per_beam=stats["slabs"] / stats["beams"],
            old_slabs_per_beam=2 * n_cand, stats=stats,
            kernels=kernel_names(
                lambda p=parts, s=scan: (weights.beam_weights_cuda if
                                         p.dim() == 2 else
                                         weights.beam_weights_batched_cuda)(
                    m, p, s, cfg)))


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or any(p not in PARTS for p in argv[1:]):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a CUDA card")
    old_dir, parts = argv[0], set(argv[1:] or PARTS)

    def read(d, name):
        with open(os.path.join(d, name)) as f:
            return f.read()

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    build.library()
    with tempfile.TemporaryDirectory() as workdir:
        if "ptxas" in parts:
            ptxas_part(workdir)
        if "sincosf" in parts:
            sincos_part(workdir)
        if "ablation" in parts:
            ablation_part("old", variants(read(old_dir, "weights.cu"),
                                          OLD_ABLATIONS), workdir, gen)
            ablation_part("new", variants(read(build.CSRC, "weights.cu"),
                                          NEW_ABLATIONS), workdir, gen)
        if "turns" in parts:
            old_libs = compile_libs({"weights": read(old_dir, "weights.cu"),
                                     "kmeans": read(old_dir, "kmeans.cu")},
                                    workdir)
            turns_part(old_libs, gen)
        if "expand" in parts:
            expand_part(old_dir, workdir, gen)
        if "beamsub" in parts:
            beamsub_part(old_dir, workdir, gen)
        if "batched" in parts:
            batched_part(old_dir, workdir, gen)
        if "cast" in parts:
            cast_part(old_dir, workdir, gen)


if __name__ == "__main__":
    main()
