// K1, beam weights: the likelihood of every particle under one scan.
//
// Replaces montecarlolocalisation_tpu/ops/weights_pallas.py::_weights_kernel
// (pallas_call at weights_pallas.py:277, single-filter launch
// beam_weights_pallas :330), with the closed-form caster of
// ops/analytic.py (prepare :431, cast_prepared :459) inlined as it is
// traced into the TPU kernel.  The plain version is
// montecarlolocalisation_tpu_torch/ops/weights.py::beam_weights_plain.
//
// Per particle (x, y, theta) and beam b: the ray starts laser_offset ahead
// along theta and points along theta + signed_angle[b]; d is its first hit,
// from the reference 0.1 m march ("fixed") or the closed-form slab caster
// ("analytic", gridline rasters only); p_b = w_hit * N(|z_b - d|; sigma),
// truncated at gauss_max_diff, + w_rand * 1[|z_b - max_range| < window].
// Sum mode sums mask * p_b and gates with the dilated raster and the world
// extent; log mode writes the raw sum of mask * log(max(p_b, 1e-6)).
//
// What bounds it: arithmetic and raster lookups.  A particle reads 12 bytes
// and writes 4; per beam it computes a sine and a cosine and the cast (up to
// 11 march samples, or 2 axes x 3 candidate slabs with a band scan of at
// most `span` pixels).  So the raster (2.4 KB for the default 49 x 49 maze)
// and the beam table sit in shared memory, and no lookup reaches device
// memory; a raster larger than 32 KB is read from device memory.
//
// Design: one thread per particle with the beam loop inside, as the TPU
// kernel keeps one particle per lane.  The ray direction is cos/sin of
// (theta + signed angle), as the plain path computes it, not the TPU
// kernel's angle-addition identity, which differs in the last bit and so
// moves a march sample across a pixel boundary in about 1e-6 of rays.
// Built with -fmad=false, every float operation rounds as the plain torch
// operations do, and the plain version sums the beams in the kernel's
// order, so the two agree to the last bit unless a math function rounds
// differently.  The first occupied pixel of a slab band is found by a
// short loop over the raster instead of the TPU's packed bit words.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kFixed = 0;
constexpr int kCellPx = 8;
constexpr float kEps = 1e-9f;
constexpr float kInf = 3e38f;
constexpr int kThreads = 256;
constexpr int kSmemRasterMax = 32 * 1024;

struct Params {
  float origin_x, origin_y, inv_res, res, extent_x, extent_y;
  float laser_offset, max_range, ray_step, w_hit, w_rand, gauss_max_diff;
  float inv_two_sigma2, inv_denom, rand_window, smax, rad2deg, deg2rad;
  int mode, log_mode, quantize, num_steps, n_cand, span, n_v, n_h;
};
static_assert(sizeof(Params) == 26 * 4, "Params is 18 floats then 8 ints");

struct Raster {
  const uint8_t* occ;
  int w, h;
};

__device__ __forceinline__ bool pixel(const uint8_t* t, int w, int h, int mx,
                                      int my) {
  return mx >= 0 && my >= 0 && mx < w && my < h && t[my * w + mx] != 0;
}

// Pixel r of gridline k: vertical lines are the columns 8k, indexed by
// row; horizontal lines are the rows 8k, indexed by column.
__device__ __forceinline__ bool line_bit(const Raster& g, bool vertical,
                                         int k, int r) {
  return vertical ? pixel(g.occ, g.w, g.h, k * kCellPx, r)
                  : pixel(g.occ, g.w, g.h, r, k * kCellPx);
}

struct AxisPrep {
  int k0;
  bool inside0, origin0;
};

// Direction-independent state of one axis (analytic.py:332 _axis_prepare).
__device__ __forceinline__ AxisPrep axis_prepare(float gu, float gv,
                                                 const Raster& g,
                                                 bool vertical, int n_lines) {
  AxisPrep p;
  p.k0 = (int)floorf(gu * 0.125f);
  int r0 = (int)floorf(gv);
  float line_u0 = (float)(p.k0 * kCellPx);
  p.inside0 = gu >= line_u0 && gu < line_u0 + 1.0f;
  bool valid0 = p.k0 >= 0 && p.k0 < n_lines;
  p.origin0 = p.inside0 && valid0 && line_bit(g, vertical, p.k0, r0);
  return p;
}

// First hit s (pixel units) against the slabs of one axis
// (analytic.py:361 _axis_hits); u across the lines, v along them.
__device__ float axis_hits(float gu, float gv, float du, float dv,
                           const Raster& g, bool vertical, int n_lines,
                           int length, const AxisPrep& p, float smax,
                           int n_cand, int span) {
  bool small = fabsf(du) < kEps;
  float inv_du = 1.0f / (small ? kEps : du);
  int sgn = du >= 0.0f ? 1 : -1;
  bool fwd = dv >= 0.0f;
  bool small_v = fabsf(dv) < kEps;
  float inv_dv = 1.0f / (small_v ? kEps : dv);
  float best = p.origin0 ? 0.0f : kInf;
  for (int c = 0; c < n_cand; ++c) {
    int k = p.k0 + sgn * c;
    float line_u = (float)(k * kCellPx);
    float t_near = (line_u - gu) * inv_du;
    float t_far = (line_u + 1.0f - gu) * inv_du;
    float t_in = fminf(t_near, t_far);
    float t_out = fmaxf(t_near, t_far);
    if (small) {
      // Parallel to the lines: only the origin's own slab can be touched.
      t_in = (c == 0 && p.inside0) ? 0.0f : kInf;
      t_out = (c == 0 && p.inside0) ? smax : -kInf;
    }
    t_in = fmaxf(t_in, 0.0f);
    float t_out_c = fminf(t_out, smax);
    // Strict: touching the half-open slab's exit face is no crossing.
    if (!(t_in < t_out_c) || k < 0 || k >= n_lines) continue;
    int r_in = (int)floorf(gv + t_in * dv);
    int r_out = (int)floorf(gv + t_out_c * dv);
    int lo = max(min(r_in, r_out), 0);
    int hi = min(max(r_in, r_out), length - 1);
    int cnt = min(hi - lo + 1, span);
    bool found = false;
    int rr = 0;
    for (int j = 0; j < cnt; ++j) {
      int row = fwd ? lo + j : hi - j;
      if (line_bit(g, vertical, k, row)) {
        found = true;
        rr = row;
        break;
      }
    }
    if (!found) continue;
    float row_edge = (float)(fwd ? rr : rr + 1);
    float t_row = small_v ? 0.0f : (row_edge - gv) * inv_dv;
    float s_hit = fmaxf(t_in, t_row);
    if (s_hit < smax) best = fminf(best, s_hit);
  }
  return best;
}

// The reference march (monte_carlo.cpp:350-390): first occupied sample,
// stopping at the first out-of-map sample.
__device__ float march(float ox, float oy, float dx, float dy,
                       const Raster& g, const Params& P) {
  for (int s = 0; s < P.num_steps; ++s) {
    float r = (float)s * P.ray_step;
    float px = ox + r * dx;
    float py = oy + r * dy;
    int mx = (int)((px - P.origin_x) * P.inv_res);
    int my = (int)((py - P.origin_y) * P.inv_res);
    if (!(mx >= 0 && my >= 0 && mx < g.w && my < g.h)) break;
    if (g.occ[my * g.w + mx]) return fminf(P.max_range, r);
  }
  return P.max_range;
}

__global__ void beam_weights_kernel(const float* __restrict__ parts, int n,
                                    const float* __restrict__ beam_tab,
                                    int nb, const uint8_t* __restrict__ occ,
                                    const uint8_t* __restrict__ dil, int h,
                                    int w, int raster_in_smem, Params P,
                                    float* __restrict__ out) {
  extern __shared__ float smem[];
  float* s_ang = smem;         // signed beam angles
  float* s_obs = smem + nb;    // observed ranges
  float* s_msk = smem + 2 * nb;  // beam mask (0/1)
  uint8_t* s_occ = reinterpret_cast<uint8_t*>(smem + 3 * nb);
  for (int t = threadIdx.x; t < 3 * nb; t += blockDim.x) smem[t] = beam_tab[t];
  if (raster_in_smem)
    for (int t = threadIdx.x; t < h * w; t += blockDim.x) s_occ[t] = occ[t];
  __syncthreads();
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Raster g{raster_in_smem ? s_occ : occ, w, h};

  float x = parts[3 * i], y = parts[3 * i + 1], th = parts[3 * i + 2];
  float ox = x + P.laser_offset * cosf(th);
  float oy = y + P.laser_offset * sinf(th);

  // Per-particle cast state, hoisted out of the beam loop.
  float gx = (ox - P.origin_x) * P.inv_res;
  float gy = (oy - P.origin_y) * P.inv_res;
  bool inb = gx >= 0.0f && gy >= 0.0f && gx < (float)w && gy < (float)h;
  AxisPrep pv{}, ph{};
  if (P.mode != kFixed) {
    pv = axis_prepare(gx, gy, g, true, P.n_v);
    ph = axis_prepare(gy, gx, g, false, P.n_h);
  }

  float prob = 0.0f;
  for (int b = 0; b < nb; ++b) {
    float ray = th + s_ang[b];
    if (P.quantize) ray = rintf(ray * P.rad2deg) * P.deg2rad;
    float dx = cosf(ray), dy = sinf(ray);
    float dist;
    if (P.mode == kFixed) {
      dist = march(ox, oy, dx, dy, g, P);
    } else {
      float sv = axis_hits(gx, gy, dx, dy, g, true, P.n_v, h, pv, P.smax,
                           P.n_cand, P.span);
      float sh = axis_hits(gy, gx, dy, dx, g, false, P.n_h, w, ph, P.smax,
                           P.n_cand, P.span);
      float s = fminf(fminf(sv, sh), P.smax);
      dist = (inb ? s : P.smax) * P.res;
    }
    float obs = s_obs[b];
    float diff = fabsf(obs - dist);
    float pdf = expf(-(diff * diff) * P.inv_two_sigma2) * P.inv_denom;
    float gauss = (diff >= 0.0f && diff <= P.gauss_max_diff) ? pdf : 0.0f;
    float p_rand = fabsf(obs - P.max_range) < P.rand_window ? 1.0f : 0.0f;
    float per_beam = P.w_hit * gauss + P.w_rand * p_rand;
    if (P.log_mode)
      prob += logf(fmaxf(per_beam, 1e-6f)) * s_msk[b];
    else
      prob += per_beam * s_msk[b];
  }
  if (!P.log_mode) {
    // isValidPos at one pixel of offset: the dilated raster at the
    // particle's own (truncated) pixel, and the world extent.
    int mx = (int)((x - P.origin_x) * P.inv_res);
    int my = (int)((y - P.origin_y) * P.inv_res);
    bool inside = x >= P.origin_x && x < P.extent_x && y >= P.origin_y &&
                  y < P.extent_y;
    if (!inside || pixel(dil, w, h, mx, my)) prob = 0.0f;
  }
  out[i] = prob;
}

}  // namespace

// particles [n, 3] f32; beam_tab [3, nb] f32 (signed angles, ranges,
// mask); occ, dil [h, w] u8; fparams/iparams host arrays in Params order;
// out [n] f32.  Returns cudaGetLastError() after the launch.
extern "C" int mcl_beam_weights(const float* particles, int n,
                                const float* beam_tab, int nb,
                                const uint8_t* occ, const uint8_t* dil,
                                int h, int w, const float* fparams,
                                const int* iparams, float* out,
                                void* stream) {
  Params P;
  float* pf = &P.origin_x;
  for (int t = 0; t < 18; ++t) pf[t] = fparams[t];
  int* pi = &P.mode;
  for (int t = 0; t < 8; ++t) pi[t] = iparams[t];
  int raster_in_smem = (size_t)h * w <= (size_t)kSmemRasterMax;
  size_t smem = 3 * (size_t)nb * sizeof(float) +
                (raster_in_smem ? (size_t)h * w : 0);
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    beam_weights_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        particles, n, beam_tab, nb, occ, dil, h, w, raster_in_smem, P, out);
  }
  return (int)cudaGetLastError();
}
