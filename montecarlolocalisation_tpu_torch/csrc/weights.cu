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
// extent; log mode writes the raw sum of mask * log(max(p_b, 1e-6)).  The
// parameters, p_b, the ray angle, the gate, the march and the raster's bit
// words are sensor_model.cuh's, which refinement's kernels read too.
//
// What bounds it on the H100: issue slots.  A particle reads 12 bytes and
// writes 4, and a beam needs ~15 float operations plus ~10 for each
// candidate slab its cast needs, so the bound is ~0.016 ms at 1M x 34; the
// pixel-scan kernel this design replaced took ~1 ms, nine tenths of it in
// the analytic cast (PERF.md: that kernel timed with one cost removed at a
// time).  Of the cast, the band
// scan pixel by pixel, whose data-dependent trip count makes a warp wait
// for its longest lane, was a third on uniform particles and a fifth on
// filtered ones; the rest is the exact float arithmetic of the candidate
// slabs, ~100 lane instructions a candidate, which the schedule by ray
// (below) cuts from 6 a beam to about 2.  Bank conflicts cost nothing
// measurable, expf under 1 %.
//
// Design:
// - Gridlines as bit words.  Each block packs the raster's gridlines into
//   32-bit words in shared memory (one warp ballot a word): vertical line k
//   is column 8k indexed by row, horizontal line k is row 8k indexed by
//   column.  A band of at most 32 px lies in two words, so its first
//   occupied pixel along the ray is one 64-bit window, a mask and a __ffs
//   (forward) or __clz (backward), with no loop and no branch; longer bands
//   (smax > 30 px) walk the words.  It is the row the plain version's pixel
//   loop returns.
// - The analytic cast scheduled by ray, not by warp (K1 and K1 batched in
//   analytic mode: beam_weights_cast_kernel).  A beam reaches 1.8 of its 6
//   candidate slabs on average, but a lane that stops where its ray does
//   still waits for the warp's slowest lane at every beam, so a per-lane
//   stop inside the beam loop gained nothing.  Instead every lane
//   evaluates each axis's first slab ahead of its origin for every beam in
//   lockstep and marks, in a bit of a register, the pairs whose next slab
//   the ray enters before the beam's distance; only those, about 2 % of
//   pairs at a 1 m range, go through a queue of the warp, 32 at a time, so
//   a beam costs about 2.0 slab evaluations instead of 6 (cast_stats;
//   PERF.md, section 6).  The pairs that stop provably miss nothing, and the
//   distance is a minimum, whatever the order, so the bits are the
//   all-candidate kernels'.  K4 keeps evaluating every candidate with
//   selects (axis_hits); K1 and K1 batched in fixed mode only march
//   (march_weight), with no cast state.
// - The fixed march reads a raster packed one bit a pixel (300 bytes for the
//   49 x 49 maze, 7.3 KB for 241 x 241).  A sample costs a shift and a mask
//   more than a byte raster's: 5 to 7 % of K1 batched's time.
// - Two raster forms, one arithmetic, by one rule (sensor_model.cuh says
//   why); the template flag G picks the form.
// - The two axes share 1/dx and 1/dy; sincosf gives both directions (equal
//   to sinf and cosf bit for bit on the card, PERF.md); particle rows come
//   in through shared memory, coalesced.
// - One thread per particle with the beam loop inside, as the TPU kernel
//   keeps one particle per lane.  The ray direction is cos/sin of
//   (theta + signed angle), as the plain path computes it, not the TPU
//   kernel's angle-addition identity, which differs in the last bit.  Built
//   with -fmad=false, every float operation rounds as the plain torch
//   operations do, and the plain version sums the beams in the kernel's
//   order, so the two agree to the last bit.
//
// K1 batched: a 2-D grid, x over particle blocks of one episode and y over
// episodes, so no block straddles two episodes; each block stages its
// episode's ranges and mask next to the shared beam table and the raster.
// The per-particle body is K1's own (march_weight; in analytic mode
// both launch beam_weights_cast_kernel, K1 as its one episode), so each
// episode's weights equal K1's on that episode bit for bit.  Its map-stack form
// (mcl_beam_weights_stack) is the same kernel reading one raster per
// episode, for sweeps over randomized maps: a block stages (or, in the
// device-memory form, reads) the bit words of its episode's map and gates
// with that map's dilated raster, and one pack pass writes every map's
// words.  The JAX package computes this under vmap over traced maps with
// XLA (no Pallas kernel runs there); per episode it is the dense path's
// function, so each episode equals a single-map launch on its map.
//
// K4: the beam-per-sublane function, laid out for the card.  What it
// computes is fixed by the TPU layout (ops/weights.beamsub_plain): eight
// lane sums, lane s adding beams s, s+8, ... one after another, then the
// eight added in lane order.  How many threads hold them is a launch
// choice (ops/weights.beamsub_plan): T in {1, 2, 4, 8} threads a particle,
// each keeping its 8/T lane sums apart (never folded together), added in
// lane order at the end through shuffles, so the bits do not depend on T.
// Eight threads a particle only where the particles alone leave the card
// mostly idle; one once they fill half of it.  The per-particle work
// (sincos of theta, the origin, both axes' state) is done once a particle
// and shared through shared memory; the gate runs on the group's first
// thread.  The grid is persistent: as many blocks as the card holds at
// once, each staging the raster's bit words once and taking (episode,
// particle block) items from a counter, so there is no tail wave and the
// blocks finish within about one item of each other.  Bound as K1: issue
// slots, the cast's arithmetic (PERF.md, section 6).

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <algorithm>

#include "sensor_model.cuh"

namespace {

constexpr int kFixed = 0;
constexpr float kEps = 1e-9f;
constexpr float kInf = 3e38f;
constexpr int kThreads = 256;
constexpr int kLanes = 8;      // K4: lane sums a particle
constexpr int kPrepWords = 10;  // K4: a prepared particle in shared memory

// The sensor's parameters, then the cast's (smax, n_cand and span:
// ops/analytic.cast_constants; the gridlines n_v and n_h), the ray mode
// and the log mode.
struct Params : SensorParams {
  float smax;
  int mode, log_mode, n_cand, span, n_v, n_h;
};

void unpack(const float* fparams, const int* iparams, Params* P) {
  unpack_sensor(fparams, iparams, P);
  P->smax = fparams[kSensorFloats];
  int* pi = &P->mode;
  for (int t = 0; t < 6; ++t) pi[t] = iparams[kSensorInts + t];
}

// The raster's words as the mode reads them: the gridlines for the
// analytic cast, one bit a pixel for the march.
__host__ __device__ inline Layout layout(const Params& P, int h, int w) {
  return Layout{h, w, P.mode != kFixed, P.n_v, P.n_h};
}

template <bool G>
__device__ __forceinline__ bool line_bit(const Lines& L, int k, int r) {
  return r >= 0 && r < L.length &&
         ((word<G>(L.words + k * L.wpl + (r >> 5)) >> (r & 31)) & 1u);
}

// The first set pixel of a line in [a, b] (0 <= a, b < length), walking
// forward (lowest) or backward (highest); -1 if none or if b < a.  Out of
// line: only bands longer than 32 px take it, and inlined it slows the
// common path.
template <bool G>
__device__ __noinline__ int first_set(const uint32_t* line, int a, int b,
                                      bool fwd) {
  const int qa = a >> 5, qb = b >> 5;
  const uint32_t ma = 0xffffffffu << (a & 31);
  const uint32_t mb = 0xffffffffu >> (31 - (b & 31));
  if (fwd) {
    for (int q = qa; q <= qb; ++q) {
      uint32_t m = word<G>(line + q);
      if (q == qa) m &= ma;
      if (q == qb) m &= mb;
      if (m) return (q << 5) + __ffs(m) - 1;
    }
  } else {
    for (int q = qb; q >= qa; --q) {
      uint32_t m = word<G>(line + q);
      if (q == qa) m &= ma;
      if (q == qb) m &= mb;
      if (m) return (q << 5) + 31 - __clz(m);
    }
  }
  return -1;
}

// The first set pixel of the band [a, a + cnt) of a line of `wpl` words
// (cnt = 0: none), walking forward or backward; -1 if none.  When bands are
// at most 32 px (span <= 32: smax <= 30 px), a band lies in two words, and
// one 64-bit window with a mask finds it without a loop.
template <bool G>
__device__ __forceinline__ int band_first(const uint32_t* line, int wpl,
                                          int a, int cnt, bool fwd,
                                          int span) {
  if (span > 32) return first_set<G>(line, a, a + cnt - 1, fwd);
  const int qa = a >> 5;
  const uint64_t win = (uint64_t)word<G>(line + qa) |
      (qa + 1 < wpl ? (uint64_t)word<G>(line + qa + 1) << 32 : 0ull);
  const uint32_t m = (uint32_t)(win >> (a & 31)) &
                     (cnt > 0 ? 0xffffffffu >> (32 - cnt) : 0u);
  const int off = fwd ? __ffs(m) - 1 : 31 - __clz(m);
  return m ? a + off : -1;
}

struct AxisPrep {
  int k0;
  bool inside0, origin0;
};

// Direction-independent state of one axis (analytic.py:332 _axis_prepare).
template <bool G>
__device__ __forceinline__ AxisPrep axis_prepare(float gu, float gv,
                                                 const Lines& L) {
  AxisPrep p;
  p.k0 = (int)floorf(gu * 0.125f);
  int r0 = (int)floorf(gv);
  float line_u0 = (float)(p.k0 * kCellPx);
  p.inside0 = gu >= line_u0 && gu < line_u0 + 1.0f;
  bool valid0 = p.k0 >= 0 && p.k0 < L.n_lines;
  p.origin0 = p.inside0 && valid0 && line_bit<G>(L, p.k0, r0);
  return p;
}

// First hit s (pixel units) against the slabs of one axis
// (analytic.py:361 _axis_hits), u across the lines and v along them; kInf
// if none.  Every candidate slab is evaluated with selects, not branches: a
// warp's lanes cast in different directions, and a branch per lane makes
// the warp run every lane's path.
template <bool G>
__device__ float axis_hits(float gu, float gv, float du, float dv,
                           float inv_du, float inv_dv, bool small,
                           bool small_v, const Lines& L, const AxisPrep& p,
                           float smax, int n_cand, int span) {
  float best = p.origin0 ? 0.0f : kInf;
  const int sgn = du >= 0.0f ? 1 : -1;
  const bool fwd = dv >= 0.0f;
  for (int c = 0; c < n_cand; ++c) {
    const int k = p.k0 + sgn * c;
    const float line_u = (float)(k * kCellPx);
    const float t_near = (line_u - gu) * inv_du;
    const float t_far = (line_u + 1.0f - gu) * inv_du;
    float t_in = fminf(t_near, t_far);
    float t_out = fmaxf(t_near, t_far);
    // Parallel to the lines: only the origin's own slab can be touched.
    t_in = small ? (c == 0 && p.inside0 ? 0.0f : kInf) : t_in;
    t_out = small ? (c == 0 && p.inside0 ? smax : -kInf) : t_out;
    t_in = fmaxf(t_in, 0.0f);
    const float t_out_c = fminf(t_out, smax);
    const int r_in = (int)floorf(gv + t_in * dv);
    const int r_out = (int)floorf(gv + t_out_c * dv);
    const int lo = max(min(r_in, r_out), 0);
    const int hi = min(max(r_in, r_out), L.length - 1);
    const int cnt = min(hi - lo + 1, span);
    // Strict: touching the half-open slab's exit face is no crossing.
    const bool ok = t_in < t_out_c && k >= 0 && k < L.n_lines && cnt > 0;
    const int rr = band_first<G>(L.words + (ok ? k : 0) * L.wpl, L.wpl,
                              ok ? (fwd ? lo : hi - cnt + 1) : 0,
                              ok ? cnt : 0, fwd, span);
    const float row_edge = (float)(fwd ? rr : rr + 1);
    const float t_row = small_v ? 0.0f : (row_edge - gv) * inv_dv;
    const float s_hit = fmaxf(t_in, t_row);
    best = (rr >= 0 && s_hit < smax) ? fminf(best, s_hit) : best;
  }
  return best;
}

// Direction-independent state of one particle, hoisted out of the beam
// loop.
struct Particle {
  float x, y, th, ox, oy, gx, gy;
  bool inb;
  AxisPrep pv, ph;
};

template <bool G>
__device__ __forceinline__ Particle prepare(float x, float y, float th,
                                            const Bits& B, const Params& P) {
  Particle q;
  q.x = x;
  q.y = y;
  q.th = th;
  float s, c;
  sincosf(th, &s, &c);
  q.ox = x + P.laser_offset * c;
  q.oy = y + P.laser_offset * s;
  q.gx = (q.ox - P.origin_x) * P.inv_res;
  q.gy = (q.oy - P.origin_y) * P.inv_res;
  q.inb = q.gx >= 0.0f && q.gy >= 0.0f && q.gx < (float)B.w &&
          q.gy < (float)B.h_px;
  q.pv = AxisPrep{};
  q.ph = AxisPrep{};
  if (P.mode != kFixed) {
    q.pv = axis_prepare<G>(q.gx, q.gy, B.v);
    q.ph = axis_prepare<G>(q.gy, q.gx, B.h);
  }
  return q;
}

// K4's p_b of one beam: the march or the cast with every candidate, then
// the per-beam term.
template <bool G>
__device__ __forceinline__ float beam_prob(const Particle& q, float angle,
                                           float obs, const Bits& B,
                                           const Params& P) {
  float dx, dy;
  sincosf(ray_angle(q.th, angle, P), &dy, &dx);
  float dist;
  if (P.mode == kFixed) {
    dist = march<G>(q.ox, q.oy, dx, dy, B, P);
  } else if (!q.inb) {
    dist = P.smax * P.res;
  } else {
    const bool small_x = fabsf(dx) < kEps, small_y = fabsf(dy) < kEps;
    const float inv_dx = 1.0f / (small_x ? kEps : dx);
    const float inv_dy = 1.0f / (small_y ? kEps : dy);
    float sv = axis_hits<G>(q.gx, q.gy, dx, dy, inv_dx, inv_dy, small_x,
                            small_y, B.v, q.pv, P.smax, P.n_cand, P.span);
    float sh = axis_hits<G>(q.gy, q.gx, dy, dx, inv_dy, inv_dx, small_y,
                            small_x, B.h, q.ph, P.smax, P.n_cand, P.span);
    dist = fminf(fminf(sv, sh), P.smax) * P.res;
  }
  return beam_term(obs, dist, P);
}

__device__ __forceinline__ float accumulate(float prob, float per_beam,
                                            float mask, const Params& P) {
  if (P.log_mode) return prob + logf(fmaxf(per_beam, 1e-6f)) * mask;
  return prob + per_beam * mask;
}

// Sum mode: the validity gate at (x, y).  Log mode: the raw log-sum.
__device__ __forceinline__ float gate(float x, float y, float prob,
                                      const uint8_t* dil, const Params& P,
                                      int h, int w) {
  if (P.log_mode) return prob;
  return valid_pos(x, y, dil, P, h, w) ? prob : 0.0f;
}

// One particle's weight over all beams, in beam order, by the fixed march
// (K1 and K1 batched in fixed mode).
template <bool G>
__device__ float march_weight(const float* row, const float* s_ang,
                              const float* s_obs, const float* s_msk, int nb,
                              const Bits& B, const uint8_t* dil,
                              const Params& P) {
  const float x = row[0], y = row[1], th = row[2];
  float s, c;
  sincosf(th, &s, &c);
  const float ox = x + P.laser_offset * c;
  const float oy = y + P.laser_offset * s;
  float prob = 0.0f;
  for (int b = 0; b < nb; ++b) {
    float dx, dy;
    sincosf(ray_angle(th, s_ang[b], P), &dy, &dx);
    prob = accumulate(
        prob, beam_term(s_obs[b], march<G>(ox, oy, dx, dy, B, P), P),
        s_msk[b], P);
  }
  return gate(x, y, prob, dil, P, B.h_px, B.w);
}

// Stage the beam table (angles [nb], ranges [nb], mask [nb]), the block's
// particle rows ([rows, 3] from p0) and, in the shared-memory form, the
// raster's bit words into shared memory; returns the bits to read.
template <bool G>
__device__ Bits stage(float* smem, const float* ang, const float* obs,
                      const float* msk, int nb, const float* p0, int rows,
                      int rows_max, const uint8_t* occ,
                      const uint32_t* gwords, const Layout& L) {
  for (int t = threadIdx.x; t < nb; t += blockDim.x) {
    smem[t] = ang[t];
    smem[nb + t] = obs[t];
    smem[2 * nb + t] = msk[t];
  }
  float* s_parts = smem + 3 * nb;
  for (int t = threadIdx.x; t < 3 * rows; t += blockDim.x) s_parts[t] = p0[t];
  Bits B = stage_bits<G>(reinterpret_cast<uint32_t*>(s_parts + 3 * rows_max),
                         gwords, occ, L);
  __syncthreads();
  return B;
}

// K1 in fixed mode.
template <bool G>
__global__ void beam_weights_kernel(const float* __restrict__ parts, int n,
                                    const float* __restrict__ beam_tab,
                                    int nb, const uint8_t* __restrict__ occ,
                                    const uint32_t* __restrict__ gwords,
                                    const uint8_t* __restrict__ dil, int h,
                                    int w, Params P,
                                    float* __restrict__ out) {
  extern __shared__ float smem[];
  const int i0 = blockIdx.x * blockDim.x;
  const int rows = min((int)blockDim.x, n - i0);
  Bits B = stage<G>(smem, beam_tab, beam_tab + nb, beam_tab + 2 * nb, nb,
                    parts + 3 * (size_t)i0, rows, blockDim.x, occ, gwords,
                    pixel_layout(h, w));
  if ((int)threadIdx.x >= rows) return;
  out[i0 + threadIdx.x] =
      march_weight<G>(smem + 3 * nb + 3 * threadIdx.x, smem, smem + nb,
                      smem + 2 * nb, nb, B, dil, P);
}

// K1 batched in fixed mode.  Episode e = blockIdx.y of this launch's
// episodes; its particles [n, 3] start at e * n (the entry offsets the
// pointers of each chunk).  A map stack (map_idx not null): episode e
// reads map map_idx[e], whose raster and dilated raster start at m * h * w
// and whose device-form words at m * h * wpr; the single-map form reads
// map 0.
template <bool G>
__global__ void beam_weights_batched_kernel(
    const float* __restrict__ parts, int n, const float* __restrict__ ang,
    const float* __restrict__ obs, const float* __restrict__ msk, int nb,
    const uint8_t* __restrict__ occ, const uint32_t* __restrict__ gwords,
    const uint8_t* __restrict__ dil, const int* __restrict__ map_idx, int h,
    int w, Params P, float* __restrict__ out) {
  extern __shared__ float smem[];
  const size_t e = blockIdx.y;
  const int i0 = blockIdx.x * blockDim.x;
  const int rows = min((int)blockDim.x, n - i0);
  const size_t k0 = e * (size_t)n + i0;
  const size_t m = map_idx == nullptr ? 0 : (size_t)map_idx[e];
  const size_t hw = (size_t)h * w;
  const Layout L = pixel_layout(h, w);
  const uint32_t* words = G ? gwords + m * L.words() : gwords;
  Bits B = stage<G>(smem, ang, obs + e * nb, msk + e * nb, nb,
                    parts + 3 * k0, rows, blockDim.x, occ + m * hw, words, L);
  if ((int)threadIdx.x >= rows) return;
  out[k0 + threadIdx.x] =
      march_weight<G>(smem + 3 * nb + 3 * threadIdx.x, smem, smem + nb,
                      smem + 2 * nb, nb, B, dil + m * hw, P);
}

// -- The analytic cast, scheduled by ray (K1 and K1 batched, analytic) ----
//
// A (ray, axis) pair's candidate slabs come in ray order, and a slab's
// entry time t_in = max(min(t_near, t_far), 0) never falls from one to the
// next in float arithmetic: line_u - gu is monotone in line_u, and so is
// its product with the one inv_du.  A hit is never earlier than its slab's
// t_in.  So once a pair's next slab starts at or after a distance the beam
// already has (smax where it has no hit), no slab from there on can lower
// it, and the pair stops; the slab k0 behind an origin outside it (du >=
// 0, gu >= 8 k0 + 1) has t_out <= 0, so axis_hits' ok is false there.
// The distance is the least of the hits, whichever order they come in, so
// it is the axis minimum of the selects above, bit for bit.

constexpr int kChunk = 32;   // beams whose distances a block holds at once
constexpr int kWarps = kThreads / 32;
constexpr int kQueue = 64;   // a warp's queue: < 32 left and 32 pushed
constexpr int kStats = 4;    // lockstep slabs, queued slabs, deferred
                             // pairs, queue rounds
static_assert(kChunk <= 32, "a chunk's pairs of an axis are bits of a word");

// The cast's shared memory, after stage()'s: each thread's distances
// (pixels) for the chunk's beams, each particle's origin (pixels) and each
// warp's queue of deferred (ray, axis) pairs, each at its next candidate
// slab: tag = lane | (beam of the chunk) << 5 | axis << 10 | candidate <<
// 11, candidate 0 for the pair's first queued slab.
struct CastShared {
  float dist[kChunk][kThreads];
  float gx[kThreads], gy[kThreads];
  int queue[kWarps][kQueue];
};
constexpr int kCastWords = sizeof(CastShared) / 4;

// One beam's ray against one axis's lines: u across them, v along them.
struct AxisRay {
  float du, dv, inv_du, inv_dv;
  bool small, small_v;
};

// The ray of beam angle `angle` from a particle of heading th, as beam_prob
// computes it, against the vertical lines (rv) and the horizontal (rh).
__device__ __forceinline__ void cast_rays(float th, float angle,
                                          const Params& P, AxisRay& rv,
                                          AxisRay& rh) {
  float dx, dy;
  sincosf(ray_angle(th, angle, P), &dy, &dx);
  const bool small_x = fabsf(dx) < kEps, small_y = fabsf(dy) < kEps;
  const float inv_dx = 1.0f / (small_x ? kEps : dx);
  const float inv_dy = 1.0f / (small_y ? kEps : dy);
  rv = AxisRay{dx, dy, inv_dx, inv_dy, small_x, small_y};
  rh = AxisRay{dy, dx, inv_dy, inv_dx, small_y, small_x};
}

// Candidate c (line k) of one axis with axis_hits' arithmetic: its hit s
// (pixels) if it counts there, else kInf.
template <bool G>
__device__ __forceinline__ float slab_hit(float gu, float gv,
                                          const AxisRay& a, bool inside0,
                                          const Lines& L, int k, int c,
                                          float smax, int span) {
  const bool fwd = a.dv >= 0.0f;
  const float line_u = (float)(k * kCellPx);
  const float t_near = (line_u - gu) * a.inv_du;
  const float t_far = (line_u + 1.0f - gu) * a.inv_du;
  float t_in = fminf(t_near, t_far);
  float t_out = fmaxf(t_near, t_far);
  t_in = a.small ? (c == 0 && inside0 ? 0.0f : kInf) : t_in;
  t_out = a.small ? (c == 0 && inside0 ? smax : -kInf) : t_out;
  t_in = fmaxf(t_in, 0.0f);
  const float t_out_c = fminf(t_out, smax);
  const int r_in = (int)floorf(gv + t_in * a.dv);
  const int r_out = (int)floorf(gv + t_out_c * a.dv);
  const int lo = max(min(r_in, r_out), 0);
  const int hi = min(max(r_in, r_out), L.length - 1);
  const int cnt = min(hi - lo + 1, span);
  const bool ok = t_in < t_out_c && k >= 0 && k < L.n_lines && cnt > 0;
  const int rr = band_first<G>(L.words + (ok ? k : 0) * L.wpl, L.wpl,
                               ok ? (fwd ? lo : hi - cnt + 1) : 0,
                               ok ? cnt : 0, fwd, span);
  const float row_edge = (float)(fwd ? rr : rr + 1);
  const float t_row = a.small_v ? 0.0f : (row_edge - gv) * a.inv_dv;
  const float s_hit = fmaxf(t_in, t_row);
  return rr >= 0 && s_hit < smax ? s_hit : kInf;
}

// Whether a pair whose beam has a distance `bound` must look at candidate
// c (line k): it exists and the ray enters it before the bound.  The
// entry is slab_hit's t_in, whose min is t_near where du > 0 and t_far
// where du < 0 (rays parallel to the lines never ask), so one product
// gives it.
__device__ __forceinline__ bool reaches(float gu, const AxisRay& a, int k,
                                        int c, const Lines& L, float bound,
                                        const Params& P) {
  const float line_u = (float)(k * kCellPx);
  const float t_in =
      fmaxf(((a.du >= 0.0f ? line_u : line_u + 1.0f) - gu) * a.inv_du, 0.0f);
  return (c < P.n_cand) & (k >= 0) & (k < L.n_lines) & (t_in < bound);
}

// The first candidate ahead of the origin: k0 where the ray runs toward it,
// lies along the lines or starts inside it, else k0 + sgn.
__device__ __forceinline__ int first_candidate(const AxisRay& a,
                                               bool inside0) {
  return a.small || a.du < 0.0f || inside0 ? 0 : 1;
}

__device__ __forceinline__ int axis_sign(const AxisRay& a) {
  return a.du >= 0.0f ? 1 : -1;
}

// Append the lanes' tags that `want` to the warp's queue, in lane order.
__device__ __forceinline__ void push(int* queue, int& count, bool want,
                                     int tag) {
  const unsigned m = __ballot_sync(0xffffffffu, want);
  if (want)
    queue[count + __popc(m & ((1u << (threadIdx.x & 31)) - 1u))] = tag;
  count += __popc(m);
}

// One round of a warp's queue: lanes 0 .. take - 1 take its top `take`
// pairs, each with its beam's distance as the round starts for bound, and
// evaluate each at its candidate (the ray recomputed from the particle's
// staged row), lower the beam's distance where the hit is earlier, and
// queue the pair again at the next candidate where it must look further.
template <bool G, bool Count>
__device__ __forceinline__ void cast_round(CastShared& S, int* queue,
                                           int& count, int take,
                                           const float* s_rows,
                                           const float* s_ang, int b0,
                                           const Bits& B, const Params& P,
                                           unsigned (&tally)[kStats]) {
  __syncwarp();  // the pushes and the distances are in place
  const int lane = threadIdx.x & 31;
  const int base = count - take;
  const bool mine = lane < take;
  int tag = mine ? queue[base + lane] : 0;
  const int p = (threadIdx.x & ~31) | (tag & 31);
  const int b = (tag >> 5) & 31, axis = (tag >> 10) & 1;
  float bound = mine ? S.dist[b][p] : 0.0f;
  __syncwarp();  // read before the hits lower them and pushes reuse places
  count = base;
  bool again = false;
  if (mine) {
    AxisRay rv, rh;
    cast_rays(s_rows[3 * p + 2], s_ang[b0 + b], P, rv, rh);
    // Values, not references: a reference chosen at run time would put
    // the rays and the bits in local memory.
    const AxisRay a = axis ? rh : rv;
    const float gu = axis ? S.gy[p] : S.gx[p];
    const float gv = axis ? S.gx[p] : S.gy[p];
    const Lines L = axis ? B.h : B.v;
    const int k0 = (int)floorf(gu * 0.125f);
    const float line_u0 = (float)(k0 * kCellPx);
    int c = tag >> 11;
    if (c == 0)
      c = first_candidate(a, gu >= line_u0 && gu < line_u0 + 1.0f) + 1;
    const int sgn = axis_sign(a);
    const int k = k0 + sgn * c;
    const float hit = slab_hit<G>(gu, gv, a, false, L, k, c, P.smax, P.span);
    if (hit < bound)
      atomicMin(reinterpret_cast<int*>(&S.dist[b][p]), __float_as_int(hit));
    bound = fminf(bound, hit);
    again = reaches(gu, a, k + sgn, c + 1, L, bound, P);
    tag = (tag & 0x7ff) | (c + 1) << 11;
    if constexpr (Count) tally[1] += 1;
  }
  if constexpr (Count) tally[3] += lane == 0;
  push(queue, count, again, tag);
}

// One particle's weight over all beams with the cast scheduled by ray, the
// whole warp taking part.  Chunk by chunk of beams: the lockstep pass
// evaluates each axis's first candidate for every beam, with no exchange
// between lanes, and marks the pairs that must look further; the warp
// queues them, one pair a lane at a time in lane order (a lane's vertical
// pairs in beam order, then its horizontal ones), runs a round whenever 32
// wait and, once all are queued, rounds until the queue is empty; then
// each thread adds its beams' terms in beam order.  Count: tally the
// schedule into stats (ops/weights.cast_stats).
template <bool G, bool Count>
__device__ float cast_weight(const float* s_rows, bool live,
                             const float* s_ang, const float* s_obs,
                             const float* s_msk, int nb, const Bits& B,
                             const uint8_t* dil, const Params& P,
                             CastShared& S, unsigned long long* stats) {
  const int t = threadIdx.x, lane = t & 31;
  int* queue = S.queue[t >> 5];
  const float* row = s_rows + 3 * t;
  const Particle q = prepare<G>(live ? row[0] : 0.0f, live ? row[1] : 0.0f,
                                live ? row[2] : 0.0f, B, P);
  const bool cast = live && q.inb;
  S.gx[t] = q.gx;
  S.gy[t] = q.gy;
  const float bound0 = q.pv.origin0 || q.ph.origin0 ? 0.0f : P.smax;
  unsigned tally[kStats] = {0u, 0u, 0u, 0u};
  float prob = 0.0f;
  const int chunks = (nb + kChunk - 1) / kChunk;
  for (int ch = 0; ch < chunks; ++ch) {
    const int b0 = ch * nb / chunks, b1 = (ch + 1) * nb / chunks;
    unsigned more_v = 0u, more_h = 0u;  // bit b - b0: the pair looks on
    for (int b = b0; b < b1; ++b) {
      float s = P.smax;
      if (cast) {
        AxisRay rv, rh;
        cast_rays(q.th, s_ang[b], P, rv, rh);
        const int cv = first_candidate(rv, q.pv.inside0);
        const int chh = first_candidate(rh, q.ph.inside0);
        const int kv = q.pv.k0 + axis_sign(rv) * cv;
        const int kh = q.ph.k0 + axis_sign(rh) * chh;
        const float hv = slab_hit<G>(q.gx, q.gy, rv, q.pv.inside0, B.v, kv,
                                     cv, P.smax, P.span);
        const float hh = slab_hit<G>(q.gy, q.gx, rh, q.ph.inside0, B.h, kh,
                                     chh, P.smax, P.span);
        s = fminf(bound0, fminf(hv, hh));
        more_v |= (unsigned)(!rv.small & reaches(q.gx, rv, kv + axis_sign(rv),
                                                 cv + 1, B.v, s, P))
                  << (b - b0);
        more_h |= (unsigned)(!rh.small & reaches(q.gy, rh, kh + axis_sign(rh),
                                                 chh + 1, B.h, s, P))
                  << (b - b0);
        if constexpr (Count) tally[0] += 2;
      }
      S.dist[b - b0][t] = s;
    }
    if constexpr (Count) tally[2] += __popc(more_v) + __popc(more_h);
    int count = 0;
    for (;;) {
      const bool pending = (more_v | more_h) != 0u;
      if (count < 32 && __any_sync(0xffffffffu, pending)) {
        const int axis = more_v != 0u ? 0 : 1;
        const unsigned bits = axis ? more_h : more_v;
        const int tag = lane | (__ffs(bits) - 1) << 5 | axis << 10;
        if (axis)
          more_h &= more_h - 1u;
        else
          more_v &= more_v - 1u;
        push(queue, count, pending, tag);
      } else if (count > 0) {
        cast_round<G, Count>(S, queue, count, min(count, 32), s_rows, s_ang,
                             b0, B, P, tally);
      } else {
        break;
      }
    }
    __syncwarp();  // the chunk's distances are final
    if (live)
      for (int b = b0; b < b1; ++b)
        prob = accumulate(prob,
                          beam_term(s_obs[b], S.dist[b - b0][t] * P.res, P),
                          s_msk[b], P);
    __syncwarp();  // read before the next chunk's distances overwrite them
  }
  if constexpr (Count) {
    for (int i = 0; i < kStats; ++i) {
      const unsigned v = __reduce_add_sync(0xffffffffu, tally[i]);
      if (lane == 0) atomicAdd(stats + i, (unsigned long long)v);
    }
  }
  return gate(q.x, q.y, prob, dil, P, B.h_px, B.w);
}

// K1 and K1 batched in analytic mode, both raster forms and the map stack:
// K1 batched's grid and arguments (K1 is its one episode), the cast
// scheduled by ray; stats: the Count instantiation's tallies.
template <bool G, bool Count>
__global__ void __launch_bounds__(kThreads) beam_weights_cast_kernel(
    const float* __restrict__ parts, int n, const float* __restrict__ ang,
    const float* __restrict__ obs, const float* __restrict__ msk, int nb,
    const uint8_t* __restrict__ occ, const uint32_t* __restrict__ gwords,
    const uint8_t* __restrict__ dil, const int* __restrict__ map_idx, int h,
    int w, Params P, float* __restrict__ out,
    unsigned long long* __restrict__ stats) {
  extern __shared__ float smem[];
  const size_t e = blockIdx.y;
  const int i0 = blockIdx.x * blockDim.x;
  const int rows = min((int)blockDim.x, n - i0);
  const size_t k0 = e * (size_t)n + i0;
  const size_t m = map_idx == nullptr ? 0 : (size_t)map_idx[e];
  const size_t hw = (size_t)h * w;
  const Layout L = layout(P, h, w);
  const uint32_t* words = G ? gwords + m * L.words() : gwords;
  Bits B = stage<G>(smem, ang, obs + e * nb, msk + e * nb, nb,
                    parts + 3 * k0, rows, blockDim.x, occ + m * hw, words, L);
  CastShared& S = *reinterpret_cast<CastShared*>(
      smem + 3 * nb + 3 * kThreads + (G ? 0 : L.words()));
  const int t = threadIdx.x;
  if ((t & ~31) >= rows) return;  // a warp with no particle
  const float wgt = cast_weight<G, Count>(
      smem + 3 * nb, t < rows, smem, smem + nb, smem + 2 * nb, nb, B,
      dil + m * hw, P, S, stats);
  if (t < rows) out[k0 + t] = wgt;
}

// K4's prepared particles in shared memory: field f of particle j at
// s[f * per + j].
__device__ __forceinline__ void put_particle(float* s, int per, int j,
                                             const Particle& q) {
  s[j] = q.x;
  s[per + j] = q.y;
  s[2 * per + j] = q.th;
  s[3 * per + j] = q.ox;
  s[4 * per + j] = q.oy;
  s[5 * per + j] = q.gx;
  s[6 * per + j] = q.gy;
  int* si = reinterpret_cast<int*>(s);
  si[7 * per + j] = q.pv.k0;
  si[8 * per + j] = q.ph.k0;
  si[9 * per + j] = (int)q.inb | (int)q.pv.inside0 << 1 |
                    (int)q.pv.origin0 << 2 | (int)q.ph.inside0 << 3 |
                    (int)q.ph.origin0 << 4;
}

__device__ __forceinline__ Particle get_particle(const float* s, int per,
                                                 int j) {
  Particle q;
  q.x = s[j];
  q.y = s[per + j];
  q.th = s[2 * per + j];
  q.ox = s[3 * per + j];
  q.oy = s[4 * per + j];
  q.gx = s[5 * per + j];
  q.gy = s[6 * per + j];
  const int* si = reinterpret_cast<const int*>(s);
  const int f = si[9 * per + j];
  q.inb = f & 1;
  q.pv = AxisPrep{si[7 * per + j], (f & 2) != 0, (f & 4) != 0};
  q.ph = AxisPrep{si[8 * per + j], (f & 8) != 0, (f & 16) != 0};
  return q;
}

// K4: T threads a particle, blocks of `per` particles (per * T threads, a
// whole number of warps), a persistent grid of G blocks.  Item f = e *
// chunks + c is particles [c * per, c * per + per) of episode e, cut at n.
// Block b takes item b first; where there are more items than blocks, a
// block done with one takes the next, G + the counter `next` (zero at the
// launch), so blocks that draw short casts take more items and all finish
// within about one item of each other.  Items come in episode order, so
// blocks side by side work on one episode, and a block restages the
// episode's ranges and mask only where its item moved to another.  Thread
// r of a particle's group sums its lanes r, r + T, ... one after another,
// each lane's beams in order in one register, and keeps lane r + T * v in
// acc[v]; the group adds the eight in lane order (with T = 1 the thread
// adds each lane as it is done).  Every thread of the warp takes part in
// the shuffles, so threads past the end compute nothing but stay.
template <int T, bool G>
__global__ void __launch_bounds__(kThreads) beamsub_kernel(
    const float* __restrict__ parts, int episodes, int n,
    const float* __restrict__ ang, const float* __restrict__ obs,
    const float* __restrict__ msk, int nb, const uint8_t* __restrict__ occ,
    const uint32_t* __restrict__ gwords, const uint8_t* __restrict__ dil,
    int h, int w, Params P, int per, int* __restrict__ next,
    float* __restrict__ out) {
  constexpr int L = kLanes / T;
  // Shared memory: the beam table, the prepared particles (T > 1), the
  // raster's words (shared-memory form), and the next item.
  extern __shared__ float smem[];
  float* s_ang = smem;
  float* s_obs = smem + nb;
  float* s_msk = smem + 2 * nb;
  float* s_prep = smem + 3 * nb;
  uint32_t* words =
      reinterpret_cast<uint32_t*>(s_prep + (T > 1 ? kPrepWords * per : 0));
  int& s_item =
      reinterpret_cast<int*>(words)[G ? 0 : layout(P, h, w).words()];
  for (int t = threadIdx.x; t < nb; t += blockDim.x) s_ang[t] = ang[t];
  const Bits B = stage_bits<G>(words, gwords, occ, layout(P, h, w));
  const int chunks = (n + per - 1) / per;
  const int items = episodes * chunks;
  const bool more = items > (int)gridDim.x;
  const int j = threadIdx.x / T, r = threadIdx.x % T;
  int staged = -1;
  __syncthreads();  // the raster is packed
  for (int f = blockIdx.x; f < items;) {
    const int e = f / chunks;
    const int i0 = (f - e * chunks) * per;
    const int rows = min(per, n - i0);
    const size_t k0 = (size_t)e * n + i0;
    if (e != staged) {
      for (int t = threadIdx.x; t < nb; t += blockDim.x) {
        s_obs[t] = obs[(size_t)e * nb + t];
        s_msk[t] = msk[(size_t)e * nb + t];
      }
      staged = e;
    }
    if constexpr (T > 1) {
      if ((int)threadIdx.x < rows) {
        const float* row = parts + 3 * (k0 + threadIdx.x);
        put_particle(s_prep, per, threadIdx.x,
                     prepare<G>(row[0], row[1], row[2], B, P));
      }
    }
    __syncthreads();
    if (more && threadIdx.x == 0) s_item = gridDim.x + atomicAdd(next, 1);
    const bool live = j < rows;
    Particle q;
    if constexpr (T > 1) {
      q = get_particle(s_prep, per, j);
    } else if (live) {
      const float* row = parts + 3 * (k0 + j);
      q = prepare<G>(row[0], row[1], row[2], B, P);
    }
    float acc[L], prob = 0.0f;
#pragma unroll
    for (int v = 0; v < L; ++v) acc[v] = 0.0f;
    if (live) {
#pragma unroll 1
      for (int v = 0; v < L; ++v) {
        float lane = 0.0f;
        for (int b = r + T * v; b < nb; b += kLanes)
          lane = accumulate(lane,
                            beam_prob<G>(q, s_ang[b], s_obs[b], B, P),
                            s_msk[b], P);
        if constexpr (T == 1) {
          prob += lane;  // one thread holds all eight, in lane order
        } else {
#pragma unroll
          for (int u = 0; u < L; ++u) acc[u] = u == v ? lane : acc[u];
        }
      }
    }
    if constexpr (T > 1) {
#pragma unroll
      for (int s = 0; s < kLanes; ++s)
        prob += __shfl_sync(0xffffffffu, acc[s / T], s % T, T);
    }
    if (live && r == 0) out[k0 + j] = gate(q.x, q.y, prob, dil, P, h, w);
    if (!more) break;  // one item a block
    __syncthreads();   // the item is read and s_item is set
    f = s_item;
  }
}

// Shared memory of a block: the beam table, `extra` words (particle rows,
// K4's prepared particles and item) and, in the shared-memory form, the
// raster's words; raises the kernel's limit past 48 KB where needed.
cudaError_t smem_for(const void* kernel, const Layout& L, int nb, int extra,
                     bool global_raster, size_t* bytes) {
  *bytes = 4 * (3 * (size_t)nb + (size_t)extra +
                (global_raster ? 0 : (size_t)L.words()));
  int dev, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (*bytes > (size_t)optin) return cudaErrorInvalidValue;
  if (*bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*bytes);
}

// The analytic kernel over `episodes` episodes of n particles (K1: one),
// in launches of at most kMaxGridY episodes each, their pointers offset as
// launch_batched offsets them; stats: null, or the counting launch's four
// tallies.
cudaError_t launch_cast(const float* particles, int episodes, int n,
                        const float* angles, const float* ranges,
                        const float* mask, int nb, const uint8_t* occ,
                        const uint8_t* dil, int maps, const int* map_idx,
                        int h, int w, const Params& P, float* out,
                        uint32_t* gwords, unsigned long long* stats,
                        cudaStream_t s) {
  const bool G = gwords != nullptr;
  auto* kernel = stats == nullptr
                     ? (G ? beam_weights_cast_kernel<true, false>
                          : beam_weights_cast_kernel<false, false>)
                     : (G ? beam_weights_cast_kernel<true, true>
                          : beam_weights_cast_kernel<false, true>);
  const Layout L = layout(P, h, w);
  size_t smem;
  cudaError_t err = smem_for((const void*)kernel, L, nb,
                             3 * kThreads + kCastWords, G, &smem);
  if (err != cudaSuccess) return err;
  if (maps < 1) return cudaErrorInvalidValue;
  if (n <= 0 || episodes <= 0) return cudaGetLastError();
  if (G && (err = pack_global(gwords, occ, L, s, maps)) != cudaSuccess)
    return err;
  for (int e0 = 0; e0 < episodes; e0 += kMaxGridY) {
    const dim3 grid((n + kThreads - 1) / kThreads,
                    std::min(kMaxGridY, episodes - e0));
    kernel<<<grid, kThreads, smem, s>>>(
        particles + 3 * (size_t)e0 * n, n, angles, ranges + (size_t)e0 * nb,
        mask + (size_t)e0 * nb, nb, occ, gwords, dil,
        map_idx == nullptr ? nullptr : map_idx + e0, h, w, P,
        out + (size_t)e0 * n, stats);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// particles [n, 3] f32; beam_tab [3, nb] f32 (signed angles, ranges,
// mask); occ, dil [h, w] u8; fparams/iparams host arrays in Params order;
// out [n] f32.  gwords: null for the shared-memory raster form, else
// layout(P, h, w).words() ints of device scratch for the device-memory form,
// which the entry packs on the stream before the launch.  Returns the
// first CUDA error.
extern "C" int mcl_beam_weights(const float* particles, int n,
                                const float* beam_tab, int nb,
                                const uint8_t* occ, const uint8_t* dil,
                                int h, int w, const float* fparams,
                                const int* iparams, float* out,
                                uint32_t* gwords, void* stream) {
  Params P;
  unpack(fparams, iparams, &P);
  if (P.mode != kFixed)
    return (int)launch_cast(particles, 1, n, beam_tab, beam_tab + nb,
                            beam_tab + 2 * nb, nb, occ, dil, 1, nullptr, h, w,
                            P, out, gwords, nullptr, (cudaStream_t)stream);
  const bool G = gwords != nullptr;
  const void* kernel = G ? (const void*)beam_weights_kernel<true>
                         : (const void*)beam_weights_kernel<false>;
  const Layout L = pixel_layout(h, w);
  size_t smem;
  cudaError_t err = smem_for(kernel, L, nb, 3 * kThreads, G, &smem);
  if (err != cudaSuccess) return (int)err;
  if (n <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (G && (err = pack_global(gwords, occ, L, s)) != cudaSuccess)
    return (int)err;
  const int blocks = (n + kThreads - 1) / kThreads;
  if (G)
    beam_weights_kernel<true><<<blocks, kThreads, smem, s>>>(
        particles, n, beam_tab, nb, occ, gwords, dil, h, w, P, out);
  else
    beam_weights_kernel<false><<<blocks, kThreads, smem, s>>>(
        particles, n, beam_tab, nb, occ, gwords, dil, h, w, P, out);
  return (int)cudaGetLastError();
}

namespace {

// K1 batched on one map (maps = 1, map_idx null) or a map stack: any
// number of episodes, in launches of at most kMaxGridY episodes each (grid
// y), their pointers offset (map_idx too), so each episode's weights are
// the same bits whatever chunk holds it.
cudaError_t launch_batched(const float* particles, int episodes, int n,
                           const float* angles, const float* ranges,
                           const float* mask, int nb, const uint8_t* occ,
                           const uint8_t* dil, int maps, const int* map_idx,
                           int h, int w, const float* fparams,
                           const int* iparams, float* out, uint32_t* gwords,
                           cudaStream_t s) {
  Params P;
  unpack(fparams, iparams, &P);
  if (P.mode != kFixed)
    return launch_cast(particles, episodes, n, angles, ranges, mask, nb, occ,
                       dil, maps, map_idx, h, w, P, out, gwords, nullptr, s);
  const bool G = gwords != nullptr;
  const void* kernel = G ? (const void*)beam_weights_batched_kernel<true>
                         : (const void*)beam_weights_batched_kernel<false>;
  const Layout L = pixel_layout(h, w);
  size_t smem;
  cudaError_t err = smem_for(kernel, L, nb, 3 * kThreads, G, &smem);
  if (err != cudaSuccess) return err;
  if (maps < 1) return cudaErrorInvalidValue;
  if (n <= 0 || episodes <= 0) return cudaGetLastError();
  if (G && (err = pack_global(gwords, occ, L, s, maps)) != cudaSuccess)
    return err;
  for (int e0 = 0; e0 < episodes; e0 += kMaxGridY) {
    const dim3 grid((n + kThreads - 1) / kThreads,
                    std::min(kMaxGridY, episodes - e0));
    const float* p = particles + 3 * (size_t)e0 * n;
    const float* r = ranges + (size_t)e0 * nb;
    const float* k = mask + (size_t)e0 * nb;
    const int* mi = map_idx == nullptr ? nullptr : map_idx + e0;
    float* o = out + (size_t)e0 * n;
    if (G)
      beam_weights_batched_kernel<true><<<grid, kThreads, smem, s>>>(
          p, n, angles, r, k, nb, occ, gwords, dil, mi, h, w, P, o);
    else
      beam_weights_batched_kernel<false><<<grid, kThreads, smem, s>>>(
          p, n, angles, r, k, nb, occ, gwords, dil, mi, h, w, P, o);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

// particles [episodes, n, 3] f32; angles [nb] f32 (signed); ranges, mask
// [episodes, nb] f32; occ, dil [h, w] u8; out [episodes, n] f32; gwords
// as for mcl_beam_weights.  Any number of episodes (launch_batched).
// Returns the first CUDA error.
extern "C" int mcl_beam_weights_batched(
    const float* particles, int episodes, int n, const float* angles,
    const float* ranges, const float* mask, int nb, const uint8_t* occ,
    const uint8_t* dil, int h, int w, const float* fparams,
    const int* iparams, float* out, uint32_t* gwords, void* stream) {
  return (int)launch_batched(particles, episodes, n, angles, ranges, mask,
                             nb, occ, dil, 1, nullptr, h, w, fparams,
                             iparams, out, gwords, (cudaStream_t)stream);
}

// K1 batched, map-stack form: the arguments of mcl_beam_weights_batched
// with occ, dil [maps, h, w] u8 and map_idx [episodes] i32 (each in
// [0, maps)), episode e reading map map_idx[e].  gwords: null for the
// shared-memory form, else maps * layout(P, h, w).words() ints of scratch,
// which one pack pass fills for every map before the launches.  Returns
// the first CUDA error.
extern "C" int mcl_beam_weights_stack(
    const float* particles, int episodes, int n, const float* angles,
    const float* ranges, const float* mask, int nb, const uint8_t* occ,
    const uint8_t* dil, int maps, const int* map_idx, int h, int w,
    const float* fparams, const int* iparams, float* out, uint32_t* gwords,
    void* stream) {
  if (map_idx == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_batched(particles, episodes, n, angles, ranges, mask,
                             nb, occ, dil, maps, map_idx, h, w, fparams,
                             iparams, out, gwords, (cudaStream_t)stream);
}

// The analytic kernel's counting instantiation: the arguments of
// mcl_beam_weights_stack (maps = 1 and map_idx null for one map), then
// stats, four unsigned 64-bit tallies of device memory that the launch adds
// to (the caller zeroes them): slabs in the lockstep pass, slabs taken from
// the queues, pairs deferred to a queue, queue rounds.  Fixed mode has no
// slabs and is refused.  Returns the first CUDA error.
extern "C" int mcl_beam_weights_cast_stats(
    const float* particles, int episodes, int n, const float* angles,
    const float* ranges, const float* mask, int nb, const uint8_t* occ,
    const uint8_t* dil, int maps, const int* map_idx, int h, int w,
    const float* fparams, const int* iparams, float* out,
    unsigned long long* stats, uint32_t* gwords, void* stream) {
  Params P;
  unpack(fparams, iparams, &P);
  if (P.mode == kFixed || stats == nullptr) return (int)cudaErrorInvalidValue;
  return (int)launch_cast(particles, episodes, n, angles, ranges, mask, nb,
                          occ, dil, maps, map_idx, h, w, P, out, gwords,
                          stats, (cudaStream_t)stream);
}

// K4: the arguments of mcl_beam_weights_batched, then T threads a particle
// (1, 2, 4 or 8) and `per` particles a block (per * T threads, a whole
// number of warps, at most kThreads), both from ops/weights.beamsub_plan,
// `next`, one int of device scratch for the item counter, which the entry
// zeroes on the stream where there are more items than blocks, and gwords
// as for mcl_beam_weights.  The grid is as many blocks as the card holds
// at once, at most one an item, over grid x: any number of episodes takes
// one launch.  Returns the first CUDA error.
namespace {

template <int T, bool G>
cudaError_t launch_beamsub(const float* particles, int episodes, int n,
                           const float* angles, const float* ranges,
                           const float* mask, int nb, const uint8_t* occ,
                           const uint32_t* gwords, const uint8_t* dil, int h,
                           int w, const Params& P, int per, int* next,
                           float* out, cudaStream_t stream) {
  const void* kernel = (const void*)beamsub_kernel<T, G>;
  const int threads = per * T;
  size_t smem;
  cudaError_t err = smem_for(kernel, layout(P, h, w), nb,
                             (T > 1 ? kPrepWords * per : 0) + 1, G, &smem);
  int dev, sms, resident;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident, kernel,
                                                        threads, smem);
  if (err != cudaSuccess) return err;
  if (resident < 1) return cudaErrorInvalidConfiguration;
  const long long items = (long long)episodes * ((n + per - 1) / per);
  const long long grid = std::min(items, (long long)resident * sms);
  if (items + grid > INT_MAX) return cudaErrorInvalidValue;
  if (items > grid) err = cudaMemsetAsync(next, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  beamsub_kernel<T, G><<<(int)grid, threads, smem, stream>>>(
      particles, episodes, n, angles, ranges, mask, nb, occ, gwords, dil, h,
      w, P, per, next, out);
  return cudaGetLastError();
}

template <int T>
cudaError_t launch_beamsub_form(const float* particles, int episodes, int n,
                                const float* angles, const float* ranges,
                                const float* mask, int nb, const uint8_t* occ,
                                uint32_t* gwords, const uint8_t* dil, int h,
                                int w, const Params& P, int per, int* next,
                                float* out, cudaStream_t stream) {
  if (gwords == nullptr)
    return launch_beamsub<T, false>(particles, episodes, n, angles, ranges,
                                    mask, nb, occ, gwords, dil, h, w, P, per,
                                    next, out, stream);
  cudaError_t err = pack_global(gwords, occ, layout(P, h, w), stream);
  if (err != cudaSuccess) return err;
  return launch_beamsub<T, true>(particles, episodes, n, angles, ranges, mask,
                                 nb, occ, gwords, dil, h, w, P, per, next,
                                 out, stream);
}

}  // namespace

extern "C" int mcl_beam_weights_beamsub(
    const float* particles, int episodes, int n, const float* angles,
    const float* ranges, const float* mask, int nb, const uint8_t* occ,
    const uint8_t* dil, int h, int w, const float* fparams,
    const int* iparams, float* out, int threads_per_particle, int per,
    int* next, uint32_t* gwords, void* stream) {
  const int T = threads_per_particle;
  if ((T != 1 && T != 2 && T != 4 && T != 8) || per < 1 ||
      per * T > kThreads || (per * T) % 32 != 0)
    return (int)cudaErrorInvalidValue;
  if (n <= 0 || episodes <= 0) return (int)cudaGetLastError();
  Params P;
  unpack(fparams, iparams, &P);
  auto* launch = T == 1   ? &launch_beamsub_form<1>
                 : T == 2 ? &launch_beamsub_form<2>
                 : T == 4 ? &launch_beamsub_form<4>
                          : &launch_beamsub_form<8>;
  return (int)launch(particles, episodes, n, angles, ranges, mask, nb, occ,
                     gwords, dil, h, w, P, per, next, out,
                     (cudaStream_t)stream);
}
