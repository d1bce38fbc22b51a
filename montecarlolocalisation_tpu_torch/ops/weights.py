"""K1, K1 batched and K4: the beam weight kernels' wrappers, their plain
versions and launch counts.

Each wrapper takes the plain torch version for a tensor on the CPU and
launches csrc/weights.cu for a CUDA tensor; any other device raises.  Sum
mode returns validity-gated weights; log mode returns the RAW
per-particle log-sums, which models/sensor.finish_log_weights finishes
(temperature, per-episode max shift, validity), as the JAX package does
after its Pallas kernels (ops/weights_pallas.py:330, :371).

- K1 (`beam_weights`): one filter, particles [N, 3], one scan.
- K1 batched (`beam_weights_batched`): episodes [E, N, 3] with one shared
  beam table angles [B] and per-episode ranges and mask [E, B]; per
  episode the same arithmetic as K1, bit for bit.  On a map stack
  (maps/grid) it launches its map-stack form (`beam_weights_stack_cuda`),
  which reads each episode's own map and equals, per episode, a
  single-map launch on that map.
- In analytic mode K1 and both forms of K1 batched launch one kernel,
  which schedules the cast by ray (csrc/weights.cu): each axis's first
  slab ahead of the origin for every beam in lockstep, and the few pairs
  that must look further through a queue of each warp.  `cast_stats`
  counts what that schedule did on given inputs.
- K4 (`beam_weights_beamsub`): the function of the beam-per-sublane
  layout of weights_pallas.py:432 (`beamsub_plain`): eight lane sums, lane
  s adding beams s, s+8, ... in order, then the eight added in lane order.
  `beamsub_plan` picks how many threads hold a particle's lanes and how
  many particles a block takes; the bits do not depend on it.  Its public
  form finishes log mode per episode, as the JAX launcher does
  (weights_pallas.py:590-593).  The filter never dispatches it.

Every kernel takes any raster, as the TPU kernel takes any concrete one
(weights_pallas.py:295-326).  `raster_form` keeps a small raster's bit
words in each block's shared memory, which every block packs itself, and
a larger one in a device buffer that the C entry packs once a call and
the kernels read through the read-only cache.  The two forms run the same
arithmetic, so both give the plain version's bits.  Refinement's kernels
(ops/refine) take their raster by the same rule.
Any number of episodes takes one call: the C entries split a batch into
launches where the grid needs it.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math

import torch

from ..config import SensorModelConfig
from ..maps.grid import MazeMap, f32_reciprocal, is_valid_pos
from ..models import sensor
from . import analytic, build

MAX_BEAMS = 1024   # beam table in shared memory next to the raster's bits
SUBLANES = 8   # K4: lane sums a particle, lane s summing every 8th beam
BLOCK = 256    # threads of a block; K1 stages this many particle rows
SMEM_MAX = 232_448   # shared memory one H100 block may opt in to (bytes)
# The shared-memory raster form up to this many bytes of bit words.  Each
# block packs the raster itself there, a cost that grows with the raster,
# while the device-memory form's words stay in the L1 cache at a cost that
# does not: the two cross near 1 KB (chip_smoke.py's f1_time on an H100,
# PERF.md, section 6), and past it the shared form only loses, up to 55
# times at the largest raster that still fits.
SHARED_RASTER_BYTES = 1024
# K4's resident threads an SM: four blocks of BLOCK threads at its 60 to 64
# registers a thread (ptxas; PERF.md, section 6).
K4_THREADS_PER_SM = 1024
# The analytic kernel's shared memory past the beam table, the particle
# rows and the raster (csrc/weights.cu CastShared): the distances of
# CAST_CHUNK beams a thread, each particle's origin, and each warp's queue
# of CAST_QUEUE pairs, a word each.
CAST_CHUNK = 32
CAST_QUEUE = 64
CAST_WORDS = CAST_CHUNK * BLOCK + 2 * BLOCK + BLOCK // 32 * CAST_QUEUE


def _beam_terms(m: MazeMap, particles, scan: sensor.Scan,
                cfg: SensorModelConfig):
    """Masked per-beam terms [..., N, B]: p_b, or log(max(p_b, 1e-6)) in
    log mode, times the beam mask."""
    per_beam = sensor.per_beam_likelihood(m, particles, scan, cfg)
    mask = scan.mask.to(torch.float32)[..., None, :]
    if cfg.beam_combine == "log":
        return torch.log(torch.clamp(per_beam, min=1e-6)) * mask
    return per_beam * mask


def _gate(m: MazeMap, cfg: SensorModelConfig, particles, prob):
    if cfg.beam_combine == "log":
        return prob
    valid = is_valid_pos(m, particles[..., 0], particles[..., 1],
                         m.resolution)
    return torch.where(valid, prob, 0.0)


def beam_weights_plain(m: MazeMap, particles, scan: sensor.Scan,
                       cfg: SensorModelConfig):
    """What K1 and K1 batched compute, in plain torch: particles
    [..., N, 3] with ranges and mask [..., B] -> [..., N]."""
    return _gate(m, cfg, particles,
                 sensor.beam_sum(_beam_terms(m, particles, scan, cfg)))


def beamsub_plain(m: MazeMap, particles, scan: sensor.Scan,
                  cfg: SensorModelConfig):
    """What K4 computes, in plain torch, raw in log mode: the beams padded
    with dead lanes to a multiple of 8 and split as [..., G, 8]; lane s
    sums its G beams one after another, then the 8 lane sums are added in
    lane order."""
    terms = _beam_terms(m, particles, scan, cfg)
    pad = (-terms.shape[-1]) % SUBLANES
    terms = torch.nn.functional.pad(terms, (0, pad))
    groups = terms.reshape(*terms.shape[:-1], -1, SUBLANES)
    lanes = torch.zeros(groups.shape[:-2] + (SUBLANES,), dtype=terms.dtype,
                        device=terms.device)
    for g in range(groups.shape[-2]):
        lanes = lanes + groups[..., g, :]
    return _gate(m, cfg, particles, sensor.beam_sum(lanes))


@dataclasses.dataclass(frozen=True)
class BeamsubPlan:
    """How one K4 call runs.  `threads` threads (1, 2, 4 or 8) share a
    particle, thread r holding lane sums r, r + threads, ...; a block takes
    `per_block` particles (threads * per_block threads, whole warps, at most
    BLOCK).  Item f = e * chunks + c is particles [c * per_block,
    (c + 1) * per_block) of episode e, cut at n.  The grid is persistent
    (as many blocks as the card holds at once, chosen by the C entry); each
    block takes the next item, in item order, from a counter on the card
    whenever it is done with one."""
    episodes: int
    n: int
    threads: int
    per_block: int

    @classmethod
    def for_threads(cls, episodes: int, n: int, threads: int):
        """The plan with `threads` threads a particle: a block of BLOCK
        threads, fewer where n is small (whole warps)."""
        width = min(BLOCK, 32 * -(-max(n, 1) * threads // 32))
        return cls(episodes=episodes, n=n, threads=threads,
                   per_block=width // threads)

    @property
    def chunks(self) -> int:
        return -(-self.n // self.per_block)

    @property
    def items(self) -> int:
        return self.episodes * self.chunks

    def item(self, f: int):
        """(episode, first particle, particle past the last) of item f."""
        e, c = divmod(f, self.chunks)
        start = c * self.per_block
        return e, start, min(start + self.per_block, self.n)


def beamsub_plan(n_ep: int, n: int, nb: int, sms: int) -> BeamsubPlan:
    """K4's launch plan for E = n_ep episodes of n particles and nb beams
    on a card of `sms` SMs: the most threads a particle, 8, 4 or 2, that
    keeps E x n x T within the threads K4 holds resident (sms x
    K4_THREADS_PER_SM) and leaves no thread without a beam (T <= nb); else
    one.  So T = 8 only where the particles alone leave the card mostly
    idle (an eighth of it or less), T never grows with E x n, and T = 1
    once they fill half of it."""
    cap = sms * K4_THREADS_PER_SM
    t = next((t for t in (8, 4, 2) if t <= nb and n_ep * n * t <= cap), 1)
    return BeamsubPlan.for_threads(n_ep, n, t)


def sensor_prefix(m: MazeMap, cfg: SensorModelConfig):
    """(floats, ints): the parameters that K1, K4 and refinement's kernels
    all read, in the order of csrc/sensor_model.cuh's SensorParams, which
    each family's own parameters follow."""
    fp = [m.origin_x, m.origin_y, m.inv_resolution, m.resolution,
          m.extent_x, m.extent_y, cfg.laser_offset, cfg.max_range,
          cfg.ray_step, cfg.w_hit, cfg.w_rand, cfg.gauss_max_diff,
          f32_reciprocal(2.0 * cfg.sigma * cfg.sigma),
          f32_reciprocal(cfg.sigma * math.sqrt(2.0 * math.pi)),
          cfg.rand_window, 180.0 / math.pi, math.pi / 180.0]
    return fp, [int(cfg.quantize_ray_deg), cfg.num_ray_steps]


def _params(m: MazeMap, cfg: SensorModelConfig):
    smax, n_cand, span = analytic.cast_constants(m, cfg.max_range)
    fp, ip = sensor_prefix(m, cfg)
    ip += [0 if cfg.ray_mode == "fixed" else 1,
           int(cfg.beam_combine == "log"), n_cand, span,
           (m.width - 1) // analytic.CELL_PX + 1,
           (m.height - 1) // analytic.CELL_PX + 1]
    return build.floats(fp + [smax]), build.ints(ip)


def _check_particles(m: MazeMap, particles, rank: int, what: str,
                     stack: bool = False):
    if not particles.is_cuda or m.device != particles.device:
        raise ValueError(f"{what} needs particles and map on the same CUDA "
                         f"device, got {particles.device} and {m.device}")
    if m.is_stack != stack:
        want = "a map stack" if stack else "one map, not a map stack"
        raise ValueError(f"{what} takes {want}")
    shape = "[N, 3]" if rank == 2 else "[E, N, 3]"
    if particles.dtype != torch.float32 or particles.dim() != rank \
            or particles.shape[-1] != 3:
        raise ValueError(f"particles must be float32 {shape}, got "
                         f"{particles.dtype} {tuple(particles.shape)}")


def _check_scan(scan: sensor.Scan, device, what: str):
    if any(v.device != device for v in (scan.angles, scan.ranges,
                                         scan.mask)):
        raise ValueError(f"{what} needs the scan on {device}, got angles, "
                         f"ranges and mask on {scan.angles.device}, "
                         f"{scan.ranges.device}, {scan.mask.device}")


def _check_config(m: MazeMap, cfg: SensorModelConfig, nb: int):
    if cfg.ray_mode not in ("fixed", "analytic") or cfg.beam_combine not in (
            "sum", "log"):
        raise ValueError(f"no kernel for ray_mode={cfg.ray_mode!r}, "
                         f"beam_combine={cfg.beam_combine!r}")
    if cfg.ray_mode == "analytic" and not m.gridline:
        raise ValueError("the analytic cast needs a gridline raster")
    if nb > MAX_BEAMS:
        raise ValueError(f"{nb} beams > {MAX_BEAMS}")


def raster_words(m: MazeMap, cfg: SensorModelConfig) -> int:
    """The raster's 32-bit words: the gridlines for the analytic cast, one
    bit a pixel for the march (csrc/weights.cu raster_words)."""
    wv, wh = -(-m.height // 32), -(-m.width // 32)
    if cfg.ray_mode == "fixed":
        return m.height * wh
    n_v = (m.width - 1) // analytic.CELL_PX + 1
    n_h = (m.height - 1) // analytic.CELL_PX + 1
    return n_v * wv + n_h * wh


def smem_bytes(m: MazeMap, cfg: SensorModelConfig, nb: int) -> int:
    """Shared memory of one K1 block with the raster in it: the beam table,
    its particle rows, the raster's words and, in analytic mode, the cast's
    (CAST_WORDS).  Past SMEM_MAX only the device-memory form can take the
    raster."""
    cast = CAST_WORDS if cfg.ray_mode == "analytic" else 0
    return 4 * (3 * nb + 3 * BLOCK + raster_words(m, cfg) + cast)


def raster_form(m: MazeMap, cfg: SensorModelConfig) -> str:
    """"shared" for a raster of at most SHARED_RASTER_BYTES of bit words,
    else "device"."""
    small = 4 * raster_words(m, cfg) <= SHARED_RASTER_BYTES
    return "shared" if small else "device"


def _raster_buffer(m: MazeMap, cfg: SensorModelConfig, form=None):
    """The device-memory form's word buffer (int32 scratch the C entry
    packs, every map's words for a stack), or None for the shared-memory
    form; `form` forces one (the card's checks time both forms on rasters
    that fit both).  A stack's form is chosen per map, by the same rule."""
    if (form or raster_form(m, cfg)) == "shared":
        return None
    return torch.empty(m.maps * raster_words(m, cfg), dtype=torch.int32,
                       device=m.device)


def beam_weights_cuda(m: MazeMap, particles, scan: sensor.Scan,
                      cfg: SensorModelConfig):
    """Launch K1 on CUDA tensors: particles [N, 3], one scan."""
    out = _launch_k1(m, particles, scan, cfg)
    beam_weights_cuda.launches += 1
    return out


def _launch_k1(m: MazeMap, particles, scan: sensor.Scan,
               cfg: SensorModelConfig, form=None):
    _check_particles(m, particles, 2, "beam_weights_cuda")
    _check_scan(scan, particles.device, "beam_weights_cuda")
    nb = scan.angles.shape[0]
    _check_config(m, cfg, nb)
    lib = build.library()
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    table = torch.stack([sign * scan.angles, scan.ranges.expand(nb),
                         scan.mask.to(torch.float32)]).contiguous()
    parts = particles.contiguous()
    occ = m.occ.contiguous()
    dil = m.occ_dilated.contiguous()
    out = torch.empty(parts.shape[0], dtype=torch.float32,
                      device=parts.device)
    fp, ip = _params(m, cfg)
    words = _raster_buffer(m, cfg, form)
    err = lib.mcl_beam_weights(
        parts.data_ptr(), parts.shape[0], table.data_ptr(), nb,
        occ.data_ptr(), dil.data_ptr(), m.height, m.width,
        ctypes.addressof(fp), ctypes.addressof(ip), out.data_ptr(),
        None if words is None else words.data_ptr(),
        build.stream_handle(parts.device))
    build.check(err, "mcl_beam_weights")
    return out


beam_weights_cuda.launches = 0


STACK_ENTRY = "mcl_beam_weights_stack"
STATS_ENTRY = "mcl_beam_weights_cast_stats"


def _batched_launch(entry: str, m: MazeMap, particles, scan: sensor.Scan,
                    cfg: SensorModelConfig, *plan: int, form=None,
                    stats=None):
    """Launch a batched C entry (K1 batched, its map-stack form, K4 with
    its plan's threads a particle and particles a block, or the analytic
    kernel's counting form with its tallies `stats`): particles [E, N, 3],
    angles [B], ranges and mask [E, B] -> [E, N]; `form` forces a raster
    form."""
    counting = stats is not None
    _check_particles(m, particles, 3, entry,
                     stack=m.is_stack if counting else entry == STACK_ENTRY)
    _check_scan(scan, particles.device, entry)
    n_ep, n = particles.shape[0], particles.shape[1]
    maps = ()
    if m.is_stack:
        index = m.episode_maps.to(torch.int32).contiguous()
        if tuple(index.shape) != (n_ep,):
            raise ValueError(f"a map stack's index {tuple(index.shape)} for "
                             f"{n_ep} episodes")
        maps = (m.maps, index.data_ptr())
    elif counting:
        maps = (1, None)
    nb = scan.angles.shape[0]
    _check_config(m, cfg, nb)
    if scan.angles.dim() != 1 or scan.ranges.shape != (n_ep, nb) \
            or scan.mask.shape != (n_ep, nb):
        raise ValueError("need one beam table angles [B] and ranges, mask "
                         f"[E, B] = [{n_ep}, {nb}]")
    lib = build.library()
    sign = -1.0 if cfg.negate_beam_angle else 1.0
    angles = (sign * scan.angles).to(torch.float32).contiguous()
    ranges = scan.ranges.to(torch.float32).contiguous()
    mask = scan.mask.to(torch.float32).contiguous()
    parts = particles.contiguous()
    occ = m.occ.contiguous()
    dil = m.occ_dilated.contiguous()
    out = torch.empty((n_ep, n), dtype=torch.float32, device=parts.device)
    fp, ip = _params(m, cfg)
    # K4's item counter: one int of scratch, zeroed by the C entry.
    counter = torch.empty(1, dtype=torch.int32, device=parts.device) \
        if plan else None
    tail = (*plan, counter.data_ptr()) if plan else ()
    if counting:
        tail = (stats.data_ptr(),)
    words = _raster_buffer(m, cfg, form)
    err = getattr(lib, entry)(
        parts.data_ptr(), n_ep, n, angles.data_ptr(), ranges.data_ptr(),
        mask.data_ptr(), nb, occ.data_ptr(), dil.data_ptr(), *maps,
        m.height, m.width, ctypes.addressof(fp), ctypes.addressof(ip),
        out.data_ptr(), *tail, None if words is None else words.data_ptr(),
        build.stream_handle(parts.device))
    build.check(err, entry)
    return out


def beam_weights_batched_cuda(m: MazeMap, particles, scan: sensor.Scan,
                              cfg: SensorModelConfig):
    """Launch K1 batched on CUDA tensors."""
    out = _batched_launch("mcl_beam_weights_batched", m, particles, scan,
                          cfg)
    beam_weights_batched_cuda.launches += 1
    return out


beam_weights_batched_cuda.launches = 0


def beam_weights_stack_cuda(m: MazeMap, particles, scan: sensor.Scan,
                            cfg: SensorModelConfig):
    """Launch K1 batched's map-stack form on CUDA tensors: episode e reads
    map m.episode_maps[e] of the stack."""
    out = _batched_launch(STACK_ENTRY, m, particles, scan, cfg)
    beam_weights_stack_cuda.launches += 1
    return out


beam_weights_stack_cuda.launches = 0


def cast_stats(m: MazeMap, particles, scan: sensor.Scan,
               cfg: SensorModelConfig) -> dict:
    """What the analytic kernel's schedule does on these inputs, from a
    launch of its counting form (the same kernel with tallies; the
    filter's launches keep none): particles [N, 3] (K1, as its one
    episode) or [E, N, 3] (K1 batched, the map-stack form on a stack), on
    CUDA.  Returns `slabs` evaluated (`lockstep_slabs` + `queued_slabs`),
    `deferred` (pairs queued), `rounds` (queue rounds over every warp) and
    `beams` (particles x beams), and adds slabs, deferred and rounds to
    utils/profiling's counters k1.cast_slabs, k1.cast_deferred and
    k1.cast_rounds."""
    from ..utils import profiling

    if cfg.ray_mode != "analytic":
        raise ValueError("cast_stats counts the analytic cast's slabs, "
                         f"not ray_mode={cfg.ray_mode!r}")
    if particles.dim() == 2:
        nb = scan.angles.shape[0]
        particles = particles[None]
        scan = sensor.Scan(angles=scan.angles,
                           ranges=scan.ranges.expand(nb)[None],
                           mask=scan.mask.expand(nb)[None])
    stats = torch.zeros(4, dtype=torch.int64, device=particles.device)
    _batched_launch(STATS_ENTRY, m, particles, scan, cfg, stats=stats)
    lockstep, queued, deferred, rounds = stats.tolist()
    out = dict(slabs=lockstep + queued, lockstep_slabs=lockstep,
               queued_slabs=queued, deferred=deferred, rounds=rounds,
               beams=particles.shape[0] * particles.shape[1]
               * scan.angles.shape[0])
    for name in ("slabs", "deferred", "rounds"):
        profiling.count("k1.cast_" + name, out[name])
    return out


def beamsub_cuda(m: MazeMap, particles, scan: sensor.Scan,
                 cfg: SensorModelConfig):
    """Launch K4 on CUDA tensors (raw log-sums in log mode), planned for
    the card it runs on; `beamsub_cuda.last_plan` is the last launch's
    plan."""
    _check_particles(m, particles, 3, "beamsub_cuda")
    plan = beamsub_plan(particles.shape[0], particles.shape[1],
                        scan.angles.shape[0],
                        torch.cuda.get_device_properties(
                            particles.device).multi_processor_count)
    out = _batched_launch("mcl_beam_weights_beamsub", m, particles, scan,
                          cfg, plan.threads, plan.per_block)
    beamsub_cuda.launches += 1
    beamsub_cuda.last_plan = plan
    return out


beamsub_cuda.launches = 0
beamsub_cuda.last_plan = None


def _dispatch(plain, cuda, particles, *args):
    if particles.device.type == "cpu":
        return plain(*args)
    if particles.is_cuda:
        return cuda(*args)
    raise ValueError(f"no beam weight path for device {particles.device}")


def beam_weights(m: MazeMap, particles, scan: sensor.Scan,
                 cfg: SensorModelConfig):
    """Beam weights [N] for particles [N, 3]: plain torch on the CPU, K1 on
    CUDA."""
    return _dispatch(beam_weights_plain, beam_weights_cuda, particles, m,
                     particles, scan, cfg)


def beam_weights_batched(m: MazeMap, particles, scan: sensor.Scan,
                         cfg: SensorModelConfig):
    """Beam weights [E, N] for episodes [E, N, 3]: plain torch on the CPU,
    K1 batched on CUDA (its map-stack form on a map stack)."""
    cuda = (beam_weights_stack_cuda if m.is_stack
            else beam_weights_batched_cuda)
    return _dispatch(beam_weights_plain, cuda, particles, m, particles,
                     scan, cfg)


def beam_weights_beamsub(m: MazeMap, particles, scan: sensor.Scan,
                         cfg: SensorModelConfig):
    """K4's launcher (weights_pallas.py:540): weights [E, N] for episodes
    [E, N, 3], log mode finished per episode; plain torch on the CPU, K4 on
    CUDA."""
    out = _dispatch(beamsub_plain, beamsub_cuda, particles, m, particles,
                    scan, cfg)
    if cfg.beam_combine == "log":
        out = sensor.finish_log_weights(m, cfg, particles, out)
    return out
