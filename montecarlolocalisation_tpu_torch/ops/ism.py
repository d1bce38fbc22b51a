"""SLAM's inverse sensor model kernel (csrc/ism.cu): its wrapper, its
dispatch rule and its launch counts.

- `ism_update_cuda`: one scan folded into each map of a stack, keyframe-
  gated, in one launch: what models/mapping.update_map_plain computes
  in plain torch, bit for bit (csrc/ism.cu says why the bits agree).  It
  reads the maps and writes a fresh tensor: no map a caller holds
  changes.
- `kernel_takes` is models/mapping.update_map's dispatch rule: float32
  maps on a CUDA device, with float32 poses and ray angles; everything
  else (the CPU, other dtypes) runs the plain form, the definition the
  tests hold against the JAX package.  The rule reads the tensors'
  device and dtype alone.

The wrapper takes the per-map inputs as models/mapping._scan_geometry
computes them in torch before the launch (the ray origin, the ray angles,
the ranges and the validity of each beam), so the kernel's cos and sin
are torch's.  Masks are 0/1: a fractional mask weights a beam's counts,
and those sum in beam order here, where the plain form's chunked sums may
take another order.

Each launch adds 1 to `ism_update_cuda.launches` and to utils/profiling's
counter `ism.calls`, and the maps it covers to `ism.maps` (a captured
tick counts once; models/compiled adds the launches of each replay).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..config import MappingConfig
from ..utils import profiling
from . import build

# The per-beam fields of the kernel's table, in its order (csrc/ism.cu).
FIELDS = ("cos", "sin", "r_lo", "r_hi", "valid", "hit_weight")


def kernel_takes(logodds, pose, ray) -> bool:
    """Whether update_map runs the kernel: float32 maps on CUDA, float32
    poses and ray angles (`ray`, the poses' headings plus the beam
    table)."""
    return (logodds.is_cuda and logodds.dtype == torch.float32
            and pose.dtype == torch.float32 and ray.dtype == torch.float32)


def _flat(v, lead, tail, maps):
    """v broadcast to lead + tail, as contiguous [maps, *tail]."""
    return v.expand(lead + tail).reshape((maps,) + tail).contiguous()


def ism_update_cuda(logodds, ox, oy, ray, ranges, valid, returned,
                    cfg: MappingConfig, window=None, paint=None):
    """The maps after one scan: logodds [..., H, W] float32 on CUDA; ox, oy
    [...] the ray origin; ray, ranges, valid and returned [..., B] (each
    broadcastable to the maps' leading dims); `window` None (every pixel)
    or (rows0, cols0, wh, ww), each map's window's first row and column
    [...] and its height and width; `paint` None or bool [...]: a map
    whose entry is False comes back unchanged.  Returns a fresh float32
    [..., H, W]."""
    if not logodds.is_cuda or logodds.dtype != torch.float32:
        raise ValueError("ism_update_cuda takes float32 maps on a CUDA "
                         f"device, got {logodds.dtype} on {logodds.device}")
    dev = logodds.device
    h, w = logodds.shape[-2], logodds.shape[-1]
    parts = [ox, oy, ray, ranges, valid, returned]
    shapes = [logodds.shape[:-2], ox.shape, oy.shape]
    shapes += [v.shape[:-1] for v in parts[2:]]
    if window is not None:
        shapes += [window[0].shape, window[1].shape]
        parts += [window[0], window[1]]
    if paint is not None:
        if paint.dtype != torch.bool:
            raise ValueError(f"paint must be bool, got {paint.dtype}")
        shapes.append(paint.shape)
        parts.append(paint)
    for v in parts:
        if v.device != dev:
            raise ValueError(f"ism_update_cuda: an input on {v.device}, the "
                             f"maps on {dev}")
    # numpy's broadcast_shapes: torch's imports sympy at its first call,
    # seconds of a process's set-up.
    lead = torch.Size(np.broadcast_shapes(*shapes))
    nb = ray.shape[-1]
    maps = math.prod(lead)
    table = torch.stack(torch.broadcast_tensors(
        torch.cos(ray), torch.sin(ray), ranges - cfg.hit_margin,
        ranges + cfg.hit_depth, valid, valid * returned), dim=-2)
    table = _flat(table, lead, (len(FIELDS), nb), maps)
    origins = _flat(torch.stack(torch.broadcast_tensors(ox, oy), dim=-1),
                    lead, (2,), maps)
    src = _flat(logodds, lead, (h, w), maps)
    if window is None:
        windows, wh, ww = None, h, w
    else:
        rows0, cols0, wh, ww = window
        windows = _flat(torch.stack(torch.broadcast_tensors(rows0, cols0),
                                    dim=-1).to(torch.int32), lead, (2,), maps)
    gate = None if paint is None else _flat(paint, lead, (), maps)
    out = torch.empty((maps, h, w), dtype=torch.float32, device=dev)
    fp = build.floats([cfg.origin_x, cfg.origin_y, cfg.resolution,
                       cfg.half_width, cfg.l_occ, cfg.l_free, cfg.clamp])
    err = build.library().mcl_ism_update(
        src.data_ptr(), out.data_ptr(), origins.data_ptr(),
        table.data_ptr(), None if windows is None else windows.data_ptr(),
        None if gate is None else gate.data_ptr(), maps, h, w, wh, ww, nb,
        ctypes.addressof(fp), build.stream_handle(dev))
    build.check(err, "mcl_ism_update")
    ism_update_cuda.launches += 1
    profiling.count("ism.calls")
    profiling.count("ism.maps", maps)
    return out.reshape(lead + (h, w))


ism_update_cuda.launches = 0
