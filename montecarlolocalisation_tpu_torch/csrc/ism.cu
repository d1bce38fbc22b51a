// SLAM's inverse sensor model (models/mapping.update_map, ops/ism): one
// scan folded into each of many log-odds maps, keyframe-gated.
//
// This replaces no TPU kernel.  The JAX package fuses the dense
// classification of every (pixel, beam) pair into one XLA kernel
// (montecarlolocalisation_tpu/models/mapping.py, _ism_delta); the port's
// plain torch form (models/mapping.update_map_plain) evaluates it as some 22
// full-size elementwise passes a beam over [..., H, W] (at the SLAM cell's
// 64 x 128 maps of 49 x 49, about 530 passes a tick, 95 % of its device
// time), then a `where` drops the maps the keyframe gate did not pass.
// This kernel computes the same function in one pass over the maps.
//
// The arithmetic is update_map_plain's, pair by pair, in its order and with
// its roundings (every multiply and add rounded on its own: __fmul_rn and
// __fadd_rn, never contracted):
// - the pixel's centre origin + (index + 0.5) * res, less the ray origin
//   (ox, oy): dx, dy;
// - proj = dx c + dy s, perp = |dy c - dx s| against the beam's cos and
//   sin (computed by torch before the launch, so no device sincos has to
//   match torch's);
// - free where perp <= half_width, proj >= 0 and proj < r - hit_margin,
//   adding the beam's valid; hit where perp <= half_width and r -
//   hit_margin <= proj <= r + hit_depth, adding valid * returned;
// - clamp(old + (l_occ hits - l_free frees), -clamp, clamp).
// The counts sum in beam order.  With valid and returned 0 or 1 they are
// small integers, exact in float32, so the plain form's chunking of beams
// cannot change a bit either.
//
// What bounds it on the H100: issue slots.  A pair is about 15
// instructions (4 multiplies, 2 adds, 5 compares, 2 selects, 2 adds); the
// maps are read once and written once (at the cell, 472 M pairs and 157 MB
// a tick: about 0.2 ms of float32 issue against 0.05 ms of memory).  So
// each thread keeps its pixels' dx, dy and both counts in registers across
// the beams, and reads each beam's six numbers once from shared memory for
// all its pixels.  A map whose gate is closed is copied and costs no pair.
//
// Layout: a block of kThreads takes a tile of kTile pixels of one map
// (grid x: the maps, y: the tiles; a 49 x 49 map is one tile), a thread
// kPixels of them, strided by kThreads so that a warp's loads and stores
// are contiguous.  256 threads of 10 pixels fit 128 registers without a
// spill (128 threads of 20 took 212 and ran a third slower on an H100).
// A windowed map (larger than twice sensor_window_px) names its window's
// first row and column: its other pixels are copied, as the plain form's
// gather and scatter leave them, and a tile with no window pixel is only
// copied.  The beam table comes from the wrapper as [maps, kFields, B] and
// enters shared memory kTableBeams beams at a time.
//
// Names: none contains beam_weights, expand_, kmeans or refine_, which the
// benchmark's trace readers match.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPixels = 10;
constexpr int kTile = kThreads * kPixels;   // 2,560 >= 49 x 49
constexpr int kTableBeams = 256;
// cos, sin, r - hit_margin, r + hit_depth, valid, valid * returned.
constexpr int kFields = 6;
constexpr long long kGridYMax = 65535;

struct IsmParams {
  float origin_x, origin_y, res, half_width, l_occ, l_free, clamp;
};

__device__ __forceinline__ void copy_tile(const float* __restrict__ src,
                                          float* __restrict__ dst, int base,
                                          long long npix) {
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const long long p = base + k * kThreads;
    if (p < npix) dst[p] = src[p];
  }
}

__global__ void __launch_bounds__(kThreads) ism_update_kernel(
    const float* __restrict__ logodds, float* __restrict__ out,
    const float* __restrict__ origins, const float* __restrict__ beams,
    const int* __restrict__ windows, const uint8_t* __restrict__ paint,
    int h, int w, int wh, int ww, int nb, IsmParams P) {
  __shared__ float table[kFields][kTableBeams];
  const long long m = blockIdx.x;
  const long long npix = (long long)h * w;
  const float* src = logodds + m * npix;
  float* dst = out + m * npix;
  const int base = blockIdx.y * kTile + threadIdx.x;
  // The gate is the block's: a closed one copies the map.
  if (paint != nullptr && paint[m] == 0) {
    copy_tile(src, dst, base, npix);
    return;
  }
  const int r0 = windows != nullptr ? windows[2 * m] : 0;
  const int c0 = windows != nullptr ? windows[2 * m + 1] : 0;
  const float ox = origins[2 * m], oy = origins[2 * m + 1];
  float dx[kPixels], dy[kPixels], hits[kPixels], frees[kPixels];
  unsigned inside = 0;
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const int p = base + k * kThreads;
    const int i = p / w, j = p - (p / w) * w;
    if (p < npix && i >= r0 && i < r0 + wh && j >= c0 && j < c0 + ww)
      inside |= 1u << k;
    const float px = __fadd_rn(
        P.origin_x, __fmul_rn(__fadd_rn((float)j, 0.5f), P.res));
    const float py = __fadd_rn(
        P.origin_y, __fmul_rn(__fadd_rn((float)i, 0.5f), P.res));
    dx[k] = __fsub_rn(px, ox);
    dy[k] = __fsub_rn(py, oy);
    hits[k] = 0.0f;
    frees[k] = 0.0f;
  }
  if (!__syncthreads_or(inside != 0)) {
    copy_tile(src, dst, base, npix);
    return;
  }
  const float* tab = beams + m * kFields * (long long)nb;
  for (int b0 = 0; b0 < nb; b0 += kTableBeams) {
    const int n = nb - b0 < kTableBeams ? nb - b0 : kTableBeams;
    __syncthreads();
    for (int t = threadIdx.x; t < kFields * n; t += kThreads) {
      const int f = t / n, b = t - f * n;
      table[f][b] = tab[(long long)f * nb + b0 + b];
    }
    __syncthreads();
    for (int b = 0; b < n; ++b) {
      const float c = table[0][b], s = table[1][b];
      const float lo = table[2][b], hi = table[3][b];
      const float valid = table[4][b], hit_w = table[5][b];
#pragma unroll
      for (int k = 0; k < kPixels; ++k) {
        const float proj =
            __fadd_rn(__fmul_rn(dx[k], c), __fmul_rn(dy[k], s));
        const float perp =
            fabsf(__fsub_rn(__fmul_rn(dy[k], c), __fmul_rn(dx[k], s)));
        const bool on = perp <= P.half_width;
        frees[k] = __fadd_rn(
            frees[k], (on && proj >= 0.0f && proj < lo) ? valid : 0.0f);
        hits[k] = __fadd_rn(
            hits[k], (on && proj >= lo && proj <= hi) ? hit_w : 0.0f);
      }
    }
  }
#pragma unroll
  for (int k = 0; k < kPixels; ++k) {
    const long long p = base + k * kThreads;
    if (p >= npix) continue;
    const float old = src[p];
    float v = old;
    if ((inside >> k) & 1u) {
      const float delta = __fsub_rn(__fmul_rn(P.l_occ, hits[k]),
                                    __fmul_rn(P.l_free, frees[k]));
      const float x = __fadd_rn(old, delta);
      // torch.clamp: NaN stays, -0 stays.
      v = x < -P.clamp ? -P.clamp : (x > P.clamp ? P.clamp : x);
    }
    dst[p] = v;
  }
}

}  // namespace

// One scan into `maps` maps of h x w: logodds and out [maps, h, w]
// (distinct), origins [maps, 2] (the ray origin's x, y), beams [maps,
// kFields, nb], windows [maps, 2] (the window's first row and column; null:
// the whole map, wh = h, ww = w), paint [maps] (0: copy the map; null:
// every map), fparams origin_x, origin_y, resolution, half_width, l_occ,
// l_free, clamp.  Launches ism_update_kernel on `stream`.
extern "C" int mcl_ism_update(const float* logodds, float* out,
                              const float* origins, const float* beams,
                              const int* windows, const uint8_t* paint,
                              long long maps, int h, int w, int wh, int ww,
                              int nb, const float* fparams, void* stream) {
  if (h <= 0 || w <= 0 || nb < 0 || wh <= 0 || ww <= 0 || wh > h ||
      ww > w || maps < 0 || maps > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  const long long tiles = ((long long)h * w + kTile - 1) / kTile;
  if (tiles > kGridYMax) return (int)cudaErrorInvalidValue;
  if (maps == 0) return (int)cudaGetLastError();
  IsmParams P;
  P.origin_x = fparams[0];
  P.origin_y = fparams[1];
  P.res = fparams[2];
  P.half_width = fparams[3];
  P.l_occ = fparams[4];
  P.l_free = fparams[5];
  P.clamp = fparams[6];
  const dim3 grid((unsigned)maps, (unsigned)tiles);
  ism_update_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      logodds, out, origins, beams, windows, paint, h, w, wh, ww, nb, P);
  return (int)cudaGetLastError();
}
