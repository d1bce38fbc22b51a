// K1, K1 batched and K4, beam weights: the likelihood of every particle
// under one scan.
//
// K1 replaces montecarlolocalisation_tpu/ops/weights_pallas.py::
// _weights_kernel (pallas_call at weights_pallas.py:277, single-filter
// launch beam_weights_pallas :330), with the closed-form caster of
// ops/analytic.py (prepare :431, cast_prepared :459) inlined as it is
// traced into the TPU kernel.  K1 batched replaces the same kernel's
// episode-batched launch (beam_weights_pallas_batched :371), and K4 the
// beam-per-sublane layout _weights_kernel_beamsub (pallas_call at :576,
// launcher beam_weights_pallas_beamsub :540).  The plain versions are in
// montecarlolocalisation_tpu_torch/ops/weights.py (beam_weights_plain,
// beamsub_plain).
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
//
// K1 batched: a 2-D grid, x over particle blocks of one episode and y over
// episodes, so no block straddles two episodes; each block stages its
// episode's ranges and mask next to the shared beam table and the raster.
// The per-particle body is K1's own (particle_weight), so each episode's
// weights equal K1's on that episode bit for bit.  The TPU's packing of
// small episodes into one (8, 128) tile, and the padding gate around it,
// are tiling rules of the TPU and have no counterpart here.
//
// K4: the GPU reading of "one beam per sublane".  Eight consecutive threads
// share a particle; each repeats the hoisted per-particle work (the TPU
// kernel repeats it on its 8 sublanes) and sums beams s, s+8, ... in order;
// the group then adds its eight lane sums in lane order through warp
// shuffles.  It does 8x the hoisted work of K1 for 8x the threads, which
// is the trade the TPU layout makes for small episodes.

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

// Direction-independent state of one particle, hoisted out of the beam
// loop.
struct Particle {
  float x, y, th, ox, oy, gx, gy;
  bool inb;
  AxisPrep pv, ph;
};

__device__ __forceinline__ Particle prepare(float x, float y, float th,
                                            const Raster& g,
                                            const Params& P) {
  Particle q;
  q.x = x;
  q.y = y;
  q.th = th;
  q.ox = x + P.laser_offset * cosf(th);
  q.oy = y + P.laser_offset * sinf(th);
  q.gx = (q.ox - P.origin_x) * P.inv_res;
  q.gy = (q.oy - P.origin_y) * P.inv_res;
  q.inb = q.gx >= 0.0f && q.gy >= 0.0f && q.gx < (float)g.w &&
          q.gy < (float)g.h;
  q.pv = AxisPrep{};
  q.ph = AxisPrep{};
  if (P.mode != kFixed) {
    q.pv = axis_prepare(q.gx, q.gy, g, true, P.n_v);
    q.ph = axis_prepare(q.gy, q.gx, g, false, P.n_h);
  }
  return q;
}

// p_b of one beam: the cast, then the truncated Gaussian plus the
// max-range term.
__device__ __forceinline__ float beam_prob(const Particle& q, float angle,
                                           float obs, const Raster& g,
                                           const Params& P) {
  float ray = q.th + angle;
  if (P.quantize) ray = rintf(ray * P.rad2deg) * P.deg2rad;
  float dx = cosf(ray), dy = sinf(ray);
  float dist;
  if (P.mode == kFixed) {
    dist = march(q.ox, q.oy, dx, dy, g, P);
  } else {
    float sv = axis_hits(q.gx, q.gy, dx, dy, g, true, P.n_v, g.h, q.pv,
                         P.smax, P.n_cand, P.span);
    float sh = axis_hits(q.gy, q.gx, dy, dx, g, false, P.n_h, g.w, q.ph,
                         P.smax, P.n_cand, P.span);
    float s = fminf(fminf(sv, sh), P.smax);
    dist = (q.inb ? s : P.smax) * P.res;
  }
  float diff = fabsf(obs - dist);
  float pdf = expf(-(diff * diff) * P.inv_two_sigma2) * P.inv_denom;
  float gauss = (diff >= 0.0f && diff <= P.gauss_max_diff) ? pdf : 0.0f;
  float p_rand = fabsf(obs - P.max_range) < P.rand_window ? 1.0f : 0.0f;
  return P.w_hit * gauss + P.w_rand * p_rand;
}

__device__ __forceinline__ float accumulate(float prob, float per_beam,
                                            float mask, const Params& P) {
  if (P.log_mode) return prob + logf(fmaxf(per_beam, 1e-6f)) * mask;
  return prob + per_beam * mask;
}

// Sum mode: isValidPos at one pixel of offset, the dilated raster at the
// particle's own (truncated) pixel, and the world extent.  Log mode: the
// raw log-sum.
__device__ __forceinline__ float gate(const Particle& q, float prob,
                                      const uint8_t* dil, const Params& P,
                                      int h, int w) {
  if (P.log_mode) return prob;
  int mx = (int)((q.x - P.origin_x) * P.inv_res);
  int my = (int)((q.y - P.origin_y) * P.inv_res);
  bool inside = q.x >= P.origin_x && q.x < P.extent_x &&
                q.y >= P.origin_y && q.y < P.extent_y;
  return (!inside || pixel(dil, w, h, mx, my)) ? 0.0f : prob;
}

// One particle's weight over all beams, in beam order.
__device__ float particle_weight(float x, float y, float th,
                                 const float* s_ang, const float* s_obs,
                                 const float* s_msk, int nb, const Raster& g,
                                 const uint8_t* dil, const Params& P) {
  Particle q = prepare(x, y, th, g, P);
  float prob = 0.0f;
  for (int b = 0; b < nb; ++b)
    prob = accumulate(prob, beam_prob(q, s_ang[b], s_obs[b], g, P),
                      s_msk[b], P);
  return gate(q, prob, dil, P, g.h, g.w);
}

// Stage angles [nb], ranges [nb], mask [nb] and (if it fits) the raster
// into shared memory; returns the raster to read.
__device__ __forceinline__ Raster stage(float* smem, const float* ang,
                                        const float* obs, const float* msk,
                                        int nb, const uint8_t* occ, int h,
                                        int w, int raster_in_smem) {
  uint8_t* s_occ = reinterpret_cast<uint8_t*>(smem + 3 * nb);
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    smem[t] = ang[t];
    smem[nb + t] = obs[t];
    smem[2 * nb + t] = msk[t];
  }
  if (raster_in_smem)
    for (int t = threadIdx.x; t < h * w; t += blockDim.x) s_occ[t] = occ[t];
  __syncthreads();
  return Raster{raster_in_smem ? s_occ : occ, w, h};
}

__global__ void beam_weights_kernel(const float* __restrict__ parts, int n,
                                    const float* __restrict__ beam_tab,
                                    int nb, const uint8_t* __restrict__ occ,
                                    const uint8_t* __restrict__ dil, int h,
                                    int w, int raster_in_smem, Params P,
                                    float* __restrict__ out) {
  extern __shared__ float smem[];
  Raster g = stage(smem, beam_tab, beam_tab + nb, beam_tab + 2 * nb, nb, occ,
                   h, w, raster_in_smem);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  out[i] = particle_weight(parts[3 * i], parts[3 * i + 1], parts[3 * i + 2],
                           smem, smem + nb, smem + 2 * nb, nb, g, dil, P);
}

// Episode e = blockIdx.y; its particles [n, 3] start at e * n.
__global__ void beam_weights_batched_kernel(
    const float* __restrict__ parts, int n, const float* __restrict__ ang,
    const float* __restrict__ obs, const float* __restrict__ msk, int nb,
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ dil, int h,
    int w, int raster_in_smem, Params P, float* __restrict__ out) {
  extern __shared__ float smem[];
  size_t e = blockIdx.y;
  Raster g = stage(smem, ang, obs + e * nb, msk + e * nb, nb, occ, h, w,
                   raster_in_smem);
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  size_t k = e * (size_t)n + i;
  out[k] = particle_weight(parts[3 * k], parts[3 * k + 1], parts[3 * k + 2],
                           smem, smem + nb, smem + 2 * nb, nb, g, dil, P);
}

// K4: kLanes threads per particle.  Every thread of the warp takes part in
// the shuffles, so threads past the end compute nothing but do not return
// early.
constexpr int kLanes = 8;

__global__ void beam_weights_beamsub_kernel(
    const float* __restrict__ parts, int n, const float* __restrict__ ang,
    const float* __restrict__ obs, const float* __restrict__ msk, int nb,
    const uint8_t* __restrict__ occ, const uint8_t* __restrict__ dil, int h,
    int w, int raster_in_smem, Params P, float* __restrict__ out) {
  extern __shared__ float smem[];
  size_t e = blockIdx.y;
  Raster g = stage(smem, ang, obs + e * nb, msk + e * nb, nb, occ, h, w,
                   raster_in_smem);
  const float* s_ang = smem;
  const float* s_obs = smem + nb;
  const float* s_msk = smem + 2 * nb;
  int lane = threadIdx.x % kLanes;
  int i = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  bool live = i < n;
  size_t k = e * (size_t)n + (live ? i : 0);
  Particle q = prepare(parts[3 * k], parts[3 * k + 1], parts[3 * k + 2], g,
                       P);
  float part = 0.0f;
  if (live)
    for (int b = lane; b < nb; b += kLanes)
      part = accumulate(part, beam_prob(q, s_ang[b], s_obs[b], g, P),
                        s_msk[b], P);
  int base = (threadIdx.x % 32) & ~(kLanes - 1);
  float prob = 0.0f;
#pragma unroll
  for (int s = 0; s < kLanes; ++s)
    prob += __shfl_sync(0xffffffffu, part, base + s);
  if (live && lane == 0) out[k] = gate(q, prob, dil, P, h, w);
}

void unpack(const float* fparams, const int* iparams, Params* P) {
  float* pf = &P->origin_x;
  for (int t = 0; t < 18; ++t) pf[t] = fparams[t];
  int* pi = &P->mode;
  for (int t = 0; t < 8; ++t) pi[t] = iparams[t];
}

size_t smem_bytes(int nb, int h, int w, int* raster_in_smem) {
  *raster_in_smem = (size_t)h * w <= (size_t)kSmemRasterMax;
  return 3 * (size_t)nb * sizeof(float) +
         (*raster_in_smem ? (size_t)h * w : 0);
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
  unpack(fparams, iparams, &P);
  int raster_in_smem;
  size_t smem = smem_bytes(nb, h, w, &raster_in_smem);
  if (n > 0) {
    int blocks = (n + kThreads - 1) / kThreads;
    beam_weights_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
        particles, n, beam_tab, nb, occ, dil, h, w, raster_in_smem, P, out);
  }
  return (int)cudaGetLastError();
}

// particles [episodes, n, 3] f32; angles [nb] f32 (signed); ranges, mask
// [episodes, nb] f32; occ, dil [h, w] u8; out [episodes, n] f32.
// episodes <= 65535 (gridDim.y).  Returns cudaGetLastError().
extern "C" int mcl_beam_weights_batched(
    const float* particles, int episodes, int n, const float* angles,
    const float* ranges, const float* mask, int nb, const uint8_t* occ,
    const uint8_t* dil, int h, int w, const float* fparams,
    const int* iparams, float* out, void* stream) {
  if (episodes > 65535) return (int)cudaErrorInvalidValue;
  Params P;
  unpack(fparams, iparams, &P);
  int raster_in_smem;
  size_t smem = smem_bytes(nb, h, w, &raster_in_smem);
  if (n > 0 && episodes > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, episodes);
    beam_weights_batched_kernel<<<grid, kThreads, smem,
                                  (cudaStream_t)stream>>>(
        particles, n, angles, ranges, mask, nb, occ, dil, h, w,
        raster_in_smem, P, out);
  }
  return (int)cudaGetLastError();
}

// K4, same arguments as mcl_beam_weights_batched.
extern "C" int mcl_beam_weights_beamsub(
    const float* particles, int episodes, int n, const float* angles,
    const float* ranges, const float* mask, int nb, const uint8_t* occ,
    const uint8_t* dil, int h, int w, const float* fparams,
    const int* iparams, float* out, void* stream) {
  if (episodes > 65535) return (int)cudaErrorInvalidValue;
  Params P;
  unpack(fparams, iparams, &P);
  int raster_in_smem;
  size_t smem = smem_bytes(nb, h, w, &raster_in_smem);
  if (n > 0 && episodes > 0) {
    int per_block = kThreads / kLanes;
    dim3 grid((n + per_block - 1) / per_block, episodes);
    beam_weights_beamsub_kernel<<<grid, kThreads, smem,
                                  (cudaStream_t)stream>>>(
        particles, n, angles, ranges, mask, nb, occ, dil, h, w,
        raster_in_smem, P, out);
  }
  return (int)cudaGetLastError();
}
