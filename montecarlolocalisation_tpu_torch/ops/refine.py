"""Gradient refinement's kernels (csrc/refine.cu): wrappers and launch
counts.

- `refine_grad_cuda`: one round's proposals [E, N, 3] of particles
  [E, N, 3]: the gradient of sum log(w + eps) under the DDA caster, in
  closed form, and the step (what models/refine.closed_form_grad and
  propose compute).
- `refine_score_cuda`: the fixed march's likelihood [E, N] of the
  particles (sensor.beam_weights_dense's), or, given proposals and the
  current likelihood, the acceptance in place: where a proposal scores
  strictly higher, its row and its likelihood replace the particle's.
- `walk_stats`: what refine_grad_kernel's DDA walks cost on given inputs,
  from a counting launch of the same kernel: the steps the rays took and
  the lane-steps the warps spent (counters refine.walk_steps and
  refine.walk_slots; tests/refine_walk_mirror is its plain mirror).

Both take the signed beam table angles [B] (the beam angles negated where
the sensor negates them) and ranges and mask [E, B] (mask as 0/1
floats), as `beam_inputs` lays them out, on a CUDA device; any other
device raises.  `kernels_take` is models/refine's dispatch rule: CUDA
particles under the configurations the kernels implement; everything
else runs models/refine's dense path.  The kernels replace no TPU kernel
(the JAX package runs jax.grad on XLA here); csrc/refine.cu says why
they exist and what bounds them.

The raster, one bit a pixel, takes K1's form by K1's rule
(ops/weights.raster_form and _raster_buffer): at most 1 KB of words in
each block's shared memory, else a device buffer that the C entry packs
once a call; both read the same words, so both give the same bits.
"""
from __future__ import annotations

import ctypes

import torch

from ..config import FilterConfig
from ..maps.grid import MazeMap
from ..models import raycast, sensor
from . import build
from .weights import _raster_buffer, sensor_prefix

# torch's CUDA reduction (ATen/native/cuda/Reduce.cuh, setReduceConfig,
# as of torch 2.11): at most this many threads a block, and a warp's width.
REDUCE_THREADS = 512
WARP = 32


def kernels_take(m: MazeMap, particles, cfg: FilterConfig) -> bool:
    """Whether the kernels run this refinement: CUDA particles
    [..., N, 3], the "dda" objective, the fixed march scoring in sum mode,
    one map (not a stack), validity at one pixel of offset.  The rule reads
    the particles' device and the configuration and the map's form
    alone."""
    s = cfg.sensor
    return (particles.is_cuda and particles.dim() >= 2
            and cfg.refine.ray_mode == "dda"
            and s.ray_mode == "fixed" and s.beam_combine == "sum"
            and not m.is_stack
            and abs(cfg.valid_pos_offset - m.resolution) < 1e-9)


def reduce_width(nb: int, outputs: int) -> int:
    """The threads that share one output when torch's CUDA sum reduces a
    contiguous last dim of nb values for `outputs` outputs
    (ATen/native/cuda/Reduce.cuh: setReduceConfig and
    ReduceConfig.set_block_dimension, below the 128 values from which it
    vectorizes the loads).  Lane t of them adds values t, t + width, ...
    into four accumulators in turn and adds those in order; then the lanes
    meet in a halving tree, lane t taking lane t + width / 2, then t +
    width / 4, ... (block_x_reduce).  refine_grad_kernel sums the beams
    in that order, the order of autograd's sum over them on the card.
    The heuristic is torch's private code, read from torch 2.11
    (2.11.0+cu128): should another version reduce in another order, the
    card test's bit-for-bit check against autograd at the production
    shape (tests/test_torch_card_refine.py) fails."""
    def last_pow2(v):
        return max(1, 1 << (max(v, 1).bit_length() - 1))

    d0 = last_pow2(nb) if nb < REDUCE_THREADS else REDUCE_THREADS
    d1 = last_pow2(outputs) if outputs < REDUCE_THREADS else REDUCE_THREADS
    height = min(d1, REDUCE_THREADS // min(d0, WARP))
    return min(d0, REDUCE_THREADS // height)


def beam_inputs(particles, scan: sensor.Scan, cfg: FilterConfig):
    """(particles [E, N, 3], signed angles [B], ranges [E, B], mask [E, B]
    as floats) of particles [..., N, 3], contiguous, the particles a copy
    that the acceptance may write in place."""
    n, nb = particles.shape[-2], scan.angles.shape[-1]
    lead = particles.shape[:-2]
    sign = -1.0 if cfg.sensor.negate_beam_angle else 1.0
    parts = particles.reshape(-1, n, 3).to(torch.float32).clone(
        memory_format=torch.contiguous_format)
    ranges = scan.ranges.expand(lead + (nb,)).reshape(-1, nb)
    mask = scan.mask.expand(lead + (nb,)).reshape(-1, nb)
    return (parts, (sign * scan.angles).to(torch.float32).contiguous(),
            ranges.to(torch.float32).contiguous(),
            mask.to(torch.float32).contiguous())


def _params(m: MazeMap, cfg: FilterConfig, nb: int, outputs: int):
    rc = cfg.refine
    width = reduce_width(nb, outputs)
    fp, ip = sensor_prefix(m, cfg.sensor)
    return (build.floats(fp + [rc.eps, rc.step_xy, rc.step_theta]),
            build.ints(ip + [raycast.dda_iters(m, cfg.sensor), width,
                             width.bit_length() - 1]))


def _check(m: MazeMap, parts, angles, ranges, mask, cfg: FilterConfig,
           what: str):
    if not parts.is_cuda or m.device != parts.device:
        raise ValueError(f"{what} needs particles and map on the same CUDA "
                         f"device, got {parts.device} and {m.device}")
    if m.is_stack:
        raise ValueError(f"{what} takes one map, not a map stack")
    if cfg.sensor.ray_mode != "fixed":
        raise ValueError(f"{what} reads the fixed march's raster, not "
                         f"ray_mode={cfg.sensor.ray_mode!r}")
    if parts.dtype != torch.float32 or parts.dim() != 3 \
            or parts.shape[-1] != 3 or not parts.is_contiguous():
        raise ValueError("particles must be contiguous float32 [E, N, 3], "
                         f"got {parts.dtype} {tuple(parts.shape)}")
    nb = angles.shape[-1]
    for name, v, shape in (("angles", angles, (nb,)),
                           ("ranges", ranges, (parts.shape[0], nb)),
                           ("mask", mask, (parts.shape[0], nb))):
        if v.device != parts.device or v.dtype != torch.float32 \
                or tuple(v.shape) != shape or not v.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous float32 "
                             f"{shape} on {parts.device}, got {v.dtype} "
                             f"{tuple(v.shape)} on {v.device}")


def refine_grad_cuda(m: MazeMap, parts, angles, ranges, mask,
                     cfg: FilterConfig, detail: bool = False):
    """Launch refine_grad_kernel: the proposals [E, N, 3]; with `detail`,
    (proposals, the DDA likelihood [E, N], its gradient [E, N, 3], the
    walks' distances [E, N, B]) from the same launch."""
    _check(m, parts, angles, ranges, mask, cfg, "refine_grad_cuda")
    lib = build.library()
    n_ep, n, nb = parts.shape[0], parts.shape[1], angles.shape[0]
    prop = torch.empty_like(parts)
    more = ((torch.empty((n_ep, n), dtype=torch.float32,
                         device=parts.device), torch.empty_like(parts),
             torch.empty((n_ep, n, nb), dtype=torch.float32,
                         device=parts.device)) if detail else ())
    fp, ip = _params(m, cfg, nb, n_ep * n)
    occ, dil = m.occ.contiguous(), m.occ_dilated.contiguous()
    words = _raster_buffer(m, cfg.sensor)
    err = lib.mcl_refine_grad(
        parts.data_ptr(), n_ep * n, n, angles.data_ptr(), ranges.data_ptr(),
        mask.data_ptr(), nb, occ.data_ptr(), dil.data_ptr(), m.height,
        m.width, ctypes.addressof(fp), ctypes.addressof(ip),
        prop.data_ptr(), *([t.data_ptr() for t in more] or [None] * 3),
        None if words is None else words.data_ptr(),
        build.stream_handle(parts.device))
    build.check(err, "mcl_refine_grad")
    refine_grad_cuda.launches += 1
    return (prop, *more) if detail else prop


refine_grad_cuda.launches = 0


def walk_stats(m: MazeMap, particles, scan: sensor.Scan,
               cfg: FilterConfig) -> dict:
    """What refine_grad_kernel's DDA walks cost on these inputs, from a
    launch of its counting form (the same kernel with tallies; the
    filter's launches keep none): particles [..., N, 3] and a scan as
    refine_particles takes them, on CUDA.  Returns `steps` (the DDA steps
    the rays took), `slots` (the lane-steps the warps spent walking: 32 a
    step of a warp, which steps until the longest of its 32 rays of a
    beam ends; beams past the records twice), `rays` and `lane_share`
    (steps over slots), and adds steps and slots to utils/profiling's
    counters refine.walk_steps and refine.walk_slots."""
    from ..utils import profiling

    p, angles, ranges, mask = beam_inputs(particles, scan, cfg)
    _check(m, p, angles, ranges, mask, cfg, "walk_stats")
    n_ep, n, nb = p.shape[0], p.shape[1], angles.shape[0]
    prop = torch.empty_like(p)
    stats = torch.zeros(2, dtype=torch.int64, device=p.device)
    fp, ip = _params(m, cfg, nb, n_ep * n)
    occ, dil = m.occ.contiguous(), m.occ_dilated.contiguous()
    words = _raster_buffer(m, cfg.sensor)
    err = build.library().mcl_refine_walk_stats(
        p.data_ptr(), n_ep * n, n, angles.data_ptr(), ranges.data_ptr(),
        mask.data_ptr(), nb, occ.data_ptr(), dil.data_ptr(), m.height,
        m.width, ctypes.addressof(fp), ctypes.addressof(ip), prop.data_ptr(),
        stats.data_ptr(), None if words is None else words.data_ptr(),
        build.stream_handle(p.device))
    build.check(err, "mcl_refine_walk_stats")
    steps, slots = stats.tolist()
    out = dict(steps=steps, slots=slots, rays=n_ep * n * nb,
               lane_share=steps / max(slots, 1))
    for name in ("steps", "slots"):
        profiling.count("refine.walk_" + name, out[name])
    return out


def refine_score_cuda(m: MazeMap, parts, angles, ranges, mask,
                      cfg: FilterConfig, weights=None, prop=None):
    """Launch refine_score_kernel: without `prop`, the likelihood [E, N] of
    `parts` (into `weights` where given); with it, the acceptance in place
    into `parts` and `weights`.  Returns the likelihood."""
    _check(m, parts, angles, ranges, mask, cfg, "refine_score_cuda")
    n_ep, n, nb = parts.shape[0], parts.shape[1], angles.shape[0]
    if weights is None:
        if prop is not None:
            raise ValueError("the acceptance needs the current likelihood")
        weights = torch.empty((n_ep, n), dtype=torch.float32,
                              device=parts.device)
    if weights.dtype != torch.float32 or tuple(weights.shape) != (n_ep, n) \
            or not weights.is_contiguous():
        raise ValueError(f"weights must be contiguous float32 {(n_ep, n)}")
    if prop is not None and (prop.shape != parts.shape
                             or prop.dtype != torch.float32
                             or not prop.is_contiguous()):
        raise ValueError("proposals must be contiguous float32 like the "
                         "particles")
    lib = build.library()
    fp, ip = _params(m, cfg, nb, n_ep * n)
    occ, dil = m.occ.contiguous(), m.occ_dilated.contiguous()
    words = _raster_buffer(m, cfg.sensor)
    err = lib.mcl_refine_score(
        parts.data_ptr(), None if prop is None else prop.data_ptr(),
        weights.data_ptr(), n_ep * n, n, angles.data_ptr(), ranges.data_ptr(),
        mask.data_ptr(), nb, occ.data_ptr(), dil.data_ptr(), m.height,
        m.width, ctypes.addressof(fp), ctypes.addressof(ip),
        None if words is None else words.data_ptr(),
        build.stream_handle(parts.device))
    build.check(err, "mcl_refine_score")
    refine_score_cuda.launches += 1
    return weights


refine_score_cuda.launches = 0
