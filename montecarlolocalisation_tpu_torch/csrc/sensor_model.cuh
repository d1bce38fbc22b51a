// The sensor model as both kernel families read it, defined once: the beam
// weight kernels (weights.cu: K1, K1 batched and K4) and refinement's
// (refine.cu).  Here are the parameters they share, the per-beam term
// p_b(obs, dist), the quantised ray angle, sum mode's validity gate, the
// reference's fixed march, and the raster as bit words in its two forms.
//
// The raster's two forms, chosen by one rule for both families
// (ops/weights.raster_form: at most 1 KB of words in shared memory; the
// default maze's is 392 bytes).  A small raster's words are packed by every
// block into its shared memory (stage_bits).  A larger one's are packed
// once a call into a device buffer (pack_global, pack_kernel: the same
// words, the same ballots), which the kernels read through the read-only
// cache (template flag G), L1- and L2-resident: every block packing a large
// raster costs in proportion to it and holds the SM's shared memory, and at
// the largest raster that fits a block the shared form ran 29 to 55 times
// slower (PERF.md, section 6).  The words and the arithmetic are the same,
// so both forms give the same bits.
//
// Each .cu file includes this into its own translation unit, so everything
// here has internal linkage, as the files' own kernels do.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kCellPx = 8;         // a gridline every 8 px (the maze's cells)
constexpr int kPack = 8;           // words a lane loads before their ballots
constexpr int kPackThreads = 256;  // pack_kernel's block
constexpr int kMaxGridY = 65535;   // the most blocks along a grid's y

// The parameters both families read, in ops/weights.sensor_prefix's order;
// each family's Params derives from it and adds its own fields.
struct SensorParams {
  float origin_x, origin_y, inv_res, res, extent_x, extent_y;
  float laser_offset, max_range, ray_step, w_hit, w_rand, gauss_max_diff;
  float inv_two_sigma2, inv_denom, rand_window, rad2deg, deg2rad;
  int quantize, num_steps;
};
constexpr int kSensorFloats = 17, kSensorInts = 2;
static_assert(sizeof(SensorParams) == (kSensorFloats + kSensorInts) * 4,
              "SensorParams is 17 floats then 2 ints");

// The prefix of the host arrays fparams and iparams into S; each family's
// own fields follow it there.
void unpack_sensor(const float* fparams, const int* iparams,
                   SensorParams* S) {
  float* pf = &S->origin_x;
  for (int t = 0; t < kSensorFloats; ++t) pf[t] = fparams[t];
  S->quantize = iparams[0];
  S->num_steps = iparams[1];
}

// p_b of one beam from its distance (m): w_hit * N(|z - d|; sigma),
// truncated at gauss_max_diff, + w_rand * 1[|z - max_range| < window]
// (models/sensor.per_beam_likelihood).
__device__ __forceinline__ float beam_term(float obs, float dist,
                                           const SensorParams& P) {
  const float diff = fabsf(obs - dist);
  const float pdf = expf(-(diff * diff) * P.inv_two_sigma2) * P.inv_denom;
  const float gauss =
      (diff >= 0.0f && diff <= P.gauss_max_diff) ? pdf : 0.0f;
  const float p_rand = fabsf(obs - P.max_range) < P.rand_window ? 1.0f : 0.0f;
  return P.w_hit * gauss + P.w_rand * p_rand;
}

// The ray of beam `angle` from a particle of heading th: theta + the
// signed angle, rounded to whole degrees where quantize is set.
__device__ __forceinline__ float ray_angle(float th, float angle,
                                           const SensorParams& P) {
  float ray = th + angle;
  if (P.quantize) ray = rintf(ray * P.rad2deg) * P.deg2rad;
  return ray;
}

// Sum mode's gate: isValidPos at one pixel of offset, the dilated raster
// [h, w] at the particle's own (truncated) pixel, and the world extent.
__device__ __forceinline__ bool valid_pos(float x, float y,
                                          const uint8_t* dil,
                                          const SensorParams& P, int h,
                                          int w) {
  const int mx = (int)((x - P.origin_x) * P.inv_res);
  const int my = (int)((y - P.origin_y) * P.inv_res);
  const bool inside = x >= P.origin_x && x < P.extent_x &&
                      y >= P.origin_y && y < P.extent_y;
  return inside &&
         !(mx >= 0 && my >= 0 && mx < w && my < h && dil[my * w + mx] != 0);
}

// Where a raster's [h, w] bit words lie.  One bit a pixel, row by row
// (`lines` false: the march's and the DDA walk's), or the gridlines of the
// analytic cast: vertical line k is column 8k indexed by row, horizontal
// line k is row 8k indexed by column, n_v vertical lines then n_h
// horizontal ones.
struct Layout {
  int h, w;
  bool lines;
  int n_v, n_h;

  __host__ __device__ int words() const {
    const int wv = (h + 31) / 32, wh = (w + 31) / 32;
    return lines ? n_v * wv + n_h * wh : h * wh;
  }
};

__host__ __device__ inline Layout pixel_layout(int h, int w) {
  return Layout{h, w, false, 0, 0};
}

// The gridlines perpendicular to one axis, as bit words: line k's pixel r
// is bit r % 32 of words[k * wpl + r / 32].
struct Lines {
  const uint32_t* words;
  int wpl, length, n_lines;
};

// The raster as the kernels read it: gridline words (v, h) or one bit a
// pixel (map, wpr words a row).
struct Bits {
  Lines v, h;
  const uint32_t* map;
  int wpr, w, h_px;
};

// A raster word: from shared memory, or (G) from the device buffer through
// the read-only cache.
template <bool G>
__device__ __forceinline__ uint32_t word(const uint32_t* p) {
  if constexpr (G) return __ldg(p);
  return *p;
}

__device__ __forceinline__ bool in_map(const Bits& B, int mx, int my) {
  return mx >= 0 && my >= 0 && mx < B.w && my < B.h_px;
}

// Pixel (mx, my)'s bit, one bit a pixel: the one pixel lookup.  The pixel
// must be on the map (in_map).
template <bool G>
__device__ __forceinline__ bool bit(const Bits& B, int mx, int my) {
  return (word<G>(B.map + my * B.wpr + (mx >> 5)) >> (mx & 31)) & 1u;
}

// Whether pixel (mx, my) is a wall: false off the map.
template <bool G>
__device__ __forceinline__ bool occupied(const Bits& B, int mx, int my) {
  return in_map(B, mx, my) && bit<G>(B, mx, my);
}

// The reference march (monte_carlo.cpp:350-390, models/raycast
// raycast_fixed): the first occupied sample, stopping at the first sample
// off the map.
template <bool G>
__device__ float march(float ox, float oy, float dx, float dy, const Bits& B,
                       const SensorParams& P) {
  for (int s = 0; s < P.num_steps; ++s) {
    const float r = (float)s * P.ray_step;
    const float px = ox + r * dx;
    const float py = oy + r * dy;
    const int mx = (int)((px - P.origin_x) * P.inv_res);
    const int my = (int)((py - P.origin_y) * P.inv_res);
    if (!in_map(B, mx, my)) break;
    if (bit<G>(B, mx, my)) return fminf(P.max_range, r);
  }
  return P.max_range;
}

// Pack `n_lines` lines of `wpl` words each: one warp ballot a word, a
// lane's loads for kPack words issued before their ballots.  Warps warp,
// warp + nwarps, ... of the caller's set take part (a block's warps for
// shared memory, the grid's for the device buffer).
__device__ void pack(uint32_t* dst, const uint8_t* occ, int n_lines,
                     int wpl, int stride_line, int stride_px, int length,
                     int warp, int nwarps) {
  const int lane = threadIdx.x & 31;
  const int total = n_lines * wpl;
  for (int q0 = warp; q0 < total; q0 += kPack * nwarps) {
    bool on[kPack];
#pragma unroll
    for (int u = 0; u < kPack; ++u) {
      const int q = q0 + u * nwarps;
      const int k = q / wpl;
      const int r = (q - k * wpl) * 32 + lane;
      on[u] = q < total && r < length &&
              occ[(size_t)k * stride_line + (size_t)r * stride_px] != 0;
    }
#pragma unroll
    for (int u = 0; u < kPack; ++u) {
      const uint32_t bits = __ballot_sync(0xffffffffu, on[u]);
      if (lane == 0 && q0 + u * nwarps < total) dst[q0 + u * nwarps] = bits;
    }
  }
}

// Pack the raster occ [h, w] u8 into `words` with the given warps.
__device__ void pack_raster(uint32_t* words, const uint8_t* occ,
                            const Layout& L, int warp, int nwarps) {
  const int wv = (L.h + 31) / 32, wh = (L.w + 31) / 32;
  if (!L.lines) {
    pack(words, occ, L.h, wh, L.w, 1, L.w, warp, nwarps);
  } else {
    pack(words, occ, L.n_v, wv, kCellPx, L.w, L.h, warp, nwarps);
    pack(words + L.n_v * wv, occ, L.n_h, wh, kCellPx * L.w, 1, L.w, warp,
         nwarps);
  }
}

// The raster's bit words at `words`.
__device__ Bits bits_at(const uint32_t* words, const Layout& L) {
  Bits B;
  const int wv = (L.h + 31) / 32, wh = (L.w + 31) / 32;
  B.w = L.w;
  B.h_px = L.h;
  B.wpr = wh;
  B.map = words;
  B.v = Lines{words, wv, L.h, L.n_v};
  B.h = Lines{words + L.n_v * wv, wh, L.w, L.n_h};
  return B;
}

// The bits a block reads: packed into its shared `words`, or (G) the
// device buffer `gwords` packed before the launch.  The caller
// synchronizes before reading them.
template <bool G>
__device__ Bits stage_bits(uint32_t* words, const uint32_t* gwords,
                           const uint8_t* occ, const Layout& L) {
  if constexpr (G) {
    return bits_at(gwords, L);
  } else {
    pack_raster(words, occ, L, threadIdx.x >> 5, blockDim.x >> 5);
    return bits_at(words, L);
  }
}

// The device form's one pass: every warp of a grid row packs words of one
// map of the stack (rows stride over the maps), map m's raster at
// occ + m * h * w and its words at words + m * L.words().
__global__ void pack_kernel(uint32_t* __restrict__ words,
                            const uint8_t* __restrict__ occ, Layout L,
                            int maps) {
  const size_t rw = L.words(), hw = (size_t)L.h * L.w;
  for (int m = blockIdx.y; m < maps; m += gridDim.y)
    pack_raster(words + m * rw, occ + m * hw, L,
                (blockIdx.x * blockDim.x + threadIdx.x) >> 5,
                (gridDim.x * blockDim.x) >> 5);
}

// The device form's words of `maps` maps into `gwords` (maps * L.words()
// of them) on the stream, once a call, before the kernels that read them.
cudaError_t pack_global(uint32_t* gwords, const uint8_t* occ,
                        const Layout& L, cudaStream_t stream, int maps = 1) {
  const long long warps = (L.words() + kPack - 1) / kPack;
  const dim3 grid(
      (int)std::min(std::max((warps * 32 + kPackThreads - 1) / kPackThreads,
                             1ll),
                    4096ll),
      std::min(maps, kMaxGridY));
  pack_kernel<<<grid, kPackThreads, 0, stream>>>(gwords, occ, L, maps);
  return cudaGetLastError();
}

}  // namespace
