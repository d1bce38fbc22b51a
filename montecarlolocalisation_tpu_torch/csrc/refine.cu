// Gradient refinement (models/refine, ops/refine): a round's gradient and
// proposal (refine_grad_kernel), and the scoring and acceptance
// (refine_score_kernel), one thread a particle.
//
// These replace no TPU kernel.  The JAX package has no Pallas kernel for
// refinement: it runs jax.grad through its dense DDA caster on XLA
// (montecarlolocalisation_tpu/models/refine.py:81-128 refine_particles),
// and the port ran autograd through the same dense caster, which unrolls
// ceil(max_range / res) * 2 + 2 traversal steps of about 15 elementwise
// operations over every ray and keeps each for the backward: 99 % of the
// production schedule's device tick (PERF.md).  These kernels compute the
// same function: the plain versions are ops/refine.py's (refine_grad_plain,
// refine_score_plain, over models/refine.closed_form_grad).
//
// refine_grad_kernel, per particle (x, y, theta), beams in order:
// - the ray from laser_offset ahead along theta at theta + signed angle
//   (quantized where quantize_ray_deg is set), as sensor.expected_ranges;
// - the walk: raycast_dda's traversal, step for step, leaving the loop
//   where the ray is done (a wall pixel entered, the map left, or
//   max_range reached), so every distance is raycast_dda's, which freezes
//   each value once the ray is done;
// - the DDA likelihood w, summed in beam order and gated as the dense
//   path's;
// - the derivative: the distance is t_max + k * t_delta on the axis of the
//   step that hit, so d/d(origin, angle) is a few products at the hit.  It
//   is applied as autograd's backward applies it (raycast.dda_vjp): the
//   upstream factor first, t_delta's k terms added one after another, then
//   inv_d = |1 / d| and the first crossing's lead; the beams' terms are
//   summed in the order of torch's CUDA reduction over the beams
//   (ops/refine.reduce_width: lane t of `width` takes beams t, t +
//   width, ... into four accumulators, the lanes meet in a halving tree,
//   evaluated here in bit-reversed lane order with a stack), and theta's
//   three paths in the order autograd's engine adds them.  So the
//   gradient, and the proposal, are autograd's on the card to the last
//   bit (below 128 beams, from which torch vectorizes that reduction and
//   the last bits may differ).  Each ray is walked once: the block keeps
//   its threads' first kRecords beams' Walks (distance, hit code) in
//   shared memory between the likelihood pass and the derivative pass,
//   which needs w first; a thread walks any further beams again.
// - the step: step_xy along the xy gradient over its norm (+ 1e-20),
//   step_theta along sign(d/dtheta), theta wrapped by atan2: the proposal.
//
// refine_score_kernel: the fixed march's likelihood of the particle (the
// start) or of its proposal, in K1's arithmetic (sensor_model.cuh: K1's
// march, per-beam term and gate, the beams in order), and for a
// proposal the acceptance in place: where w_prop > w, the proposal's row
// and w_prop are written (torch.where and torch.maximum of the dense
// path, so a tie keeps the particle).
//
// What bounds them on the H100: issue slots, in the walk.  A ray takes up
// to 22 traversal steps at the production shapes (1 m at 0.1 m pixels),
// with a bit lookup in shared memory each; a particle reads 12 bytes and
// writes 12.  The dense path ran every step for every ray, kept it, and
// read it back in the backward.  One pass a ray, stopped at the hit, keeps
// the walk to its necessary steps; the derivative adds about 60 operations
// a beam.  A step is 25 instructions (raycast_dda's loop written out took
// 39): one exit, the pixel's word read without a branch, the row's first
// word as state, the loop's constants in registers.
//
// The schedule: one thread a particle, its beams in order, the walk a
// loop of its own, so a warp steps each beam until its longest ray ends
// and its lanes whose rays ended wait (ops/refine.walk_stats counts the
// steps and the lane-steps: 74 % of the lane-steps are steps over a sweep
// of the production cell, 50 to 54 % on the uniform cloud it starts from,
// PERF.md).  Pooling a warp's rays to raise that share measured slower in
// every form tried, each bit-exact (PERF.md, section 6): lockstep steps
// with a vote a step and a queue of the warp (as K1's cast schedules its
// slabs), lanes refilled from the pool (persistent threads), a vote every
// 2 to 6 steps, capped walks with the tails queued, and tails donated to a
// queue without a vote.  The votes, the queue's state and the refetched
// ray set-ups cost more than the idle lanes did.
//
// Layout: one thread per particle with the beam loop inside, as K1, in
// blocks of kGradThreads (the records' shared memory: 18 KB at 24 beams);
// the signed beam table in each block's shared memory; the raster one bit
// a pixel, in K1's two forms by K1's rule (sensor_model.cuh), read by the
// walk and the march.  The episodes' ranges and masks are read from device
// memory, a warp's particles mostly sharing one episode.  Built with
// -fmad=false, every float operation rounds as the plain torch operation
// does.
//
// Names: none contains beam_weights, expand_ or kmeans, which the
// benchmark's trace readers match to K1, K2 and K3.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sensor_model.cuh"

namespace {

constexpr int kThreads = 256;
constexpr float kEps = 1e-9f;       // raycast_dda's direction clamp
constexpr float kNormEps = 1e-20f;  // models/refine.NORM_EPS
constexpr int kGradThreads = 128;   // refine_grad_kernel's block
constexpr int kRecords = 48;        // beams a block's records hold
constexpr int kMaxLevels = 10;      // the lane tree's stack: width <= 512
constexpr int kMaxIters = 16384;    // a code in 16 bits: (k << 1) | 1
constexpr int kWalkStats = 2;       // the counting form's tallies

// The sensor's parameters, then the objective's eps, the steps, the DDA's
// iterations and the beams' reduction width and its levels.
struct Params : SensorParams {
  float eps, step_xy, step_theta;
  int dda_iters, width, levels;
};

void unpack(const float* fparams, const int* iparams, Params* P) {
  unpack_sensor(fparams, iparams, P);
  float* pf = &P->eps;
  for (int t = 0; t < 3; ++t) pf[t] = fparams[kSensorFloats + t];
  int* pi = &P->dda_iters;
  for (int t = 0; t < 3; ++t) pi[t] = iparams[kSensorInts + t];
}

// Stage the signed beam table and, in the shared form, the raster's bit
// words, one bit a pixel; the caller synchronizes.
template <bool G>
__device__ Bits stage(float* smem, const float* angles, int nb,
                      const uint8_t* occ, const uint32_t* gwords, int h,
                      int w) {
  for (int t = threadIdx.x; t < nb; t += blockDim.x) smem[t] = angles[t];
  return stage_bits<G>(reinterpret_cast<uint32_t*>(smem + nb), gwords, occ,
                       pixel_layout(h, w));
}

// One particle's origin in pixels, and each axis's first-crossing
// fraction for either sign of the direction (raycast_dda's frac).
struct Origin {
  float gx, gy, fx_pos, fx_neg, fy_pos, fy_neg;
  int ix, iy;
};

__device__ __forceinline__ Origin origin_of(float ox, float oy,
                                            const Params& P) {
  Origin o;
  o.gx = (ox - P.origin_x) * P.inv_res;
  o.gy = (oy - P.origin_y) * P.inv_res;
  o.ix = (int)floorf(o.gx);
  o.iy = (int)floorf(o.gy);
  o.fx_neg = o.gx - (float)o.ix;
  o.fy_neg = o.gy - (float)o.iy;
  o.fx_pos = 1.0f - o.fx_neg;
  o.fy_pos = 1.0f - o.fy_neg;
  return o;
}

// A walk's result: the distance, and -1 where it has no derivative, else
// (earlier steps along the hit axis) << 1 | (hit axis is x).
struct Walk {
  float dist;
  int code;
};

// raycast_dda's traversal of one ray, stopped where the ray is done (a
// wall pixel entered, the map left, max_range reached or its dda_iters
// steps taken), so every distance is raycast_dda's, which freezes each
// value once the ray is done; `steps` receives the steps it took.  One
// exit, no branch around the pixel's word (read only on the map, 0 off
// it), the row's first word index as state and the loop's constants held
// in registers: 25 instructions a step where raycast_dda's loop written
// out took 39 (PERF.md, section 6).
template <bool G>
__device__ __forceinline__ Walk walk(const Origin& o, float dx, float dy,
                                     const Bits& B, const Params& P,
                                     int& steps) {
  const int sx = dx >= 0.0f ? 1 : -1, sy = dy >= 0.0f ? 1 : -1;
  const float inv_dx = fabsf(1.0f / (fabsf(dx) < kEps ? kEps : dx));
  const float inv_dy = 1.0f / fabsf(fabsf(dy) < kEps ? kEps : dy);
  float tx = ((dx >= 0.0f ? o.fx_pos : o.fx_neg) * P.res) * inv_dx;
  float ty = ((dy >= 0.0f ? o.fy_pos : o.fy_neg) * P.res) * inv_dy;
  const float ddx = P.res * inv_dx, ddy = P.res * inv_dy;
  const float max_range = P.max_range;
  steps = 0;
  if (occupied<G>(B, o.ix, o.iy)) return Walk{0.0f, -1};
  if (!in_map(B, o.ix, o.iy) || P.dda_iters <= 0) return Walk{max_range, -1};
  int last = P.dda_iters - 1;
  unsigned w = B.w, rows = (unsigned)(B.h_px * B.wpr);
  float max_r = max_range;
  // Opaque to the compiler, so the loop keeps them in registers: ptxas
  // otherwise reloads each from the constant bank at every step.
  asm volatile("" : "+r"(last), "+r"(w), "+r"(rows), "+f"(max_r));
  const int drow = sy * B.wpr;
  int ix = o.ix, row = o.iy * B.wpr, kx = 0, ky = 0;
  for (;;) {
    const bool take_x = tx < ty;
    const float t = take_x ? tx : ty;
    ix = take_x ? ix + sx : ix;
    row = take_x ? row : row + drow;
    const bool inside = (unsigned)ix < w && (unsigned)row < rows;
    const uint32_t wd = inside ? word<G>(B.map + row + (ix >> 5)) : 0u;
    const bool hit = ((wd >> (ix & 31)) & 1u) && t < max_r;
    if (hit || !inside || t >= max_r || kx + ky >= last) {
      steps = kx + ky + 1;
      return hit ? Walk{t, take_x ? (kx << 1) | 1 : ky << 1}
                 : Walk{max_range, -1};
    }
    if (take_x) {
      tx = tx + ddx;
      ++kx;
    } else {
      ty = ty + ddy;
      ++ky;
    }
  }
}

__device__ __forceinline__ float sgn(float v) {
  return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f);
}

// One beam's gradient terms (origin x, origin y, ray angle) for the
// upstream factor g_prob = d/dw of log(w + eps): the sensor model's
// derivative (models/refine.closed_form_grad), then raycast.dda_vjp's.
struct Terms {
  float ox, oy, ang;
};

__device__ __forceinline__ Terms beam_terms(float g_prob, float mask,
                                            float obs, Walk wk,
                                            const Origin& o, float dx,
                                            float dy, const Params& P) {
  Terms r{0.0f, 0.0f, 0.0f};
  if (wk.code < 0) return r;
  const float raw = obs - wk.dist;
  const float diff = fabsf(raw);
  const float e = expf(-(diff * diff) * P.inv_two_sigma2);
  const bool inr = diff >= 0.0f && diff <= P.gauss_max_diff;
  const float g_pdf = inr ? (g_prob * mask) * P.w_hit : 0.0f;
  const float g_q = (g_pdf * P.inv_denom) * e;
  const float g_sq = (-(g_q * P.inv_two_sigma2)) * diff;
  const float g = -((g_sq + g_sq) * sgn(raw));
  const bool ax = wk.code & 1;
  const int k = wk.code >> 1;
  float g_delta = 0.0f;
  for (int j = 0; j < k; ++j) g_delta = g_delta + g;
  const float d = ax ? dx : dy;
  const float cl = fabsf(d) < kEps ? kEps : d;
  const float inv_d = fabsf(1.0f / cl);
  const float lead = (ax ? (dx >= 0.0f ? o.fx_pos : o.fx_neg)
                         : (dy >= 0.0f ? o.fy_pos : o.fy_neg)) * P.res;
  const float g_inv = g * lead + g_delta * P.res;
  const float rc = 1.0f / cl;
  const float g_d = fabsf(d) < kEps ? 0.0f : (-(g_inv * sgn(cl))) * (rc * rc);
  const float g_lead = (g * inv_d) * P.res;
  const float g_origin = (d >= 0.0f ? -g_lead : g_lead) * P.inv_res;
  if (ax)
    r.ox = g_origin;
  else
    r.oy = g_origin;
  if (!P.quantize) r.ang = ax ? g_d * -dy : g_d * dx;
  return r;
}

__device__ __forceinline__ Terms add(Terms a, Terms b) {
  return Terms{a.ox + b.ox, a.oy + b.oy, a.ang + b.ang};
}

// Each ray's Walk in the block's shared memory, [beam][thread], for the
// first `nr` beams: the distance, and the code in 16 bits (the C entry
// bounds dda_iters).
struct Records {
  float* dist;
  short* code;

  __device__ void put(int b, Walk wk) const {
    dist[b * kGradThreads + threadIdx.x] = wk.dist;
    code[b * kGradThreads + threadIdx.x] = (short)wk.code;
  }
  __device__ Walk get(int b) const {
    return Walk{dist[b * kGradThreads + threadIdx.x],
                code[b * kGradThreads + threadIdx.x]};
  }
};

// Count: the counting form (ops/refine.walk_stats), which adds to stats
// the DDA steps its rays took and the lane-steps its warps spent walking,
// 32 a warp's step, a warp stepping until its longest ray of the beam
// ends.
template <bool G, bool Count>
__global__ void __launch_bounds__(kGradThreads) refine_grad_kernel(
    const float* __restrict__ parts, int total, int n,
    const float* __restrict__ angles, const float* __restrict__ ranges,
    const float* __restrict__ mask, int nb, int nr,
    const uint8_t* __restrict__ occ, const uint32_t* __restrict__ gwords,
    const uint8_t* __restrict__ dil, int h, int w, Params P,
    float* __restrict__ prop, float* __restrict__ lik,
    float* __restrict__ grad, float* __restrict__ dists,
    unsigned long long* __restrict__ stats) {
  extern __shared__ float smem[];
  const Bits B = stage<G>(smem, angles, nb, occ, gwords, h, w);
  float* rec = smem + nb + (G ? 0 : pixel_layout(h, w).words());
  const Records R{rec, reinterpret_cast<short*>(rec + nr * kGradThreads)};
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* obs = ranges + (size_t)(i / n) * nb;
  const float* msk = mask + (size_t)(i / n) * nb;
  const float x = parts[3 * (size_t)i], y = parts[3 * (size_t)i + 1];
  const float th = parts[3 * (size_t)i + 2];
  float s_th, c_th;
  sincosf(th, &s_th, &c_th);
  const float ox = x + P.laser_offset * c_th;
  const float oy = y + P.laser_offset * s_th;
  const Origin o = origin_of(ox, oy, P);
  // The warp's lanes with a particle (all but in the grid's last warp).
  const int held = total - (i - (int)(threadIdx.x & 31));
  const unsigned lanes = held >= 32 ? 0xffffffffu : (1u << held) - 1u;
  unsigned tally[kWalkStats] = {0u, 0u};

  // Pass 1: the walks and the DDA likelihood; the first nr beams' Walks
  // into the records.
  float prob = 0.0f;
  for (int b = 0; b < nb; ++b) {
    float dx, dy;
    sincosf(ray_angle(th, smem[b], P), &dy, &dx);
    int steps;
    const Walk wk = walk<G>(o, dx, dy, B, P, steps);
    if (b < nr) R.put(b, wk);
    if constexpr (Count) {
      // Beams past the records are walked again in pass 2.
      const unsigned longest = __reduce_max_sync(lanes, (unsigned)steps);
      tally[0] += steps;
      if ((threadIdx.x & 31) == 0) tally[1] += (b < nr ? 32 : 64) * longest;
    }
    if (dists != nullptr) dists[(size_t)i * nb + b] = wk.dist;
    prob = prob + beam_term(__ldg(obs + b), wk.dist, P) * __ldg(msk + b);
  }
  if constexpr (Count) {
    for (int k = 0; k < kWalkStats; ++k) {
      const unsigned v = __reduce_add_sync(lanes, tally[k]);
      if ((threadIdx.x & 31) == 0) atomicAdd(stats + k, (unsigned long long)v);
    }
  }
  const bool valid = valid_pos(x, y, dil, P, h, w);
  const float wv = valid ? prob : 0.0f;
  const float g_prob = valid ? 1.0f / (wv + P.eps) : 0.0f;

  // Pass 2: each beam's terms, summed in torch's reduction order.
  Terms stack[kMaxLevels + 1];
  int sp = 0;
  const int width = P.width;
  for (int j = 0; j < width; ++j) {
    const int t = P.levels ? (int)(__brev((unsigned)j) >> (32 - P.levels))
                           : 0;
    Terms acc[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) acc[a] = Terms{0.0f, 0.0f, 0.0f};
    int idx = t;
    auto term = [&](int b) {
      float dx, dy;
      sincosf(ray_angle(th, smem[b], P), &dy, &dx);
      int steps;
      const Walk wk = b < nr ? R.get(b) : walk<G>(o, dx, dy, B, P, steps);
      return beam_terms(g_prob, __ldg(msk + b), __ldg(obs + b), wk, o, dx,
                        dy, P);
    };
    while (idx + 3 * width < nb) {
#pragma unroll
      for (int a = 0; a < 4; ++a) acc[a] = add(acc[a], term(idx + a * width));
      idx += 4 * width;
    }
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      if (idx >= nb) break;
      acc[a] = add(acc[a], term(idx));
      idx += width;
    }
    Terms leaf = add(add(add(acc[0], acc[1]), acc[2]), acc[3]);
    for (int k = j; k & 1; k >>= 1) leaf = add(stack[--sp], leaf);
    stack[sp++] = leaf;
  }
  const Terms s = stack[0];

  // theta's three paths, as autograd's engine adds them: the ray angles',
  // then oy's sin(theta), then ox's cos(theta).
  const float gx = s.ox, gy = s.oy;
  const float gt = (s.ang + (s.oy * P.laser_offset) * c_th) +
                   (s.ox * P.laser_offset) * -s_th;
  if (lik != nullptr) {
    lik[i] = wv;
    grad[3 * (size_t)i] = gx;
    grad[3 * (size_t)i + 1] = gy;
    grad[3 * (size_t)i + 2] = gt;
  }
  const float gn = sqrtf(gx * gx + gy * gy);
  const float px = x + (gx * P.step_xy) / (gn + kNormEps);
  const float py = y + (gy * P.step_xy) / (gn + kNormEps);
  float s_a, c_a;
  sincosf(th + sgn(gt) * P.step_theta, &s_a, &c_a);
  prop[3 * (size_t)i] = px;
  prop[3 * (size_t)i + 1] = py;
  prop[3 * (size_t)i + 2] = atan2f(s_a, c_a);
}

// The fixed march's likelihood of rows `cand` (the particles, or their
// proposals) into w, or, with a proposal, the acceptance in place.
template <bool G>
__global__ void refine_score_kernel(float* __restrict__ parts,
                                    const float* __restrict__ cand,
                                    float* __restrict__ weights, int total,
                                    int n, const float* __restrict__ angles,
                                    const float* __restrict__ ranges,
                                    const float* __restrict__ mask, int nb,
                                    const uint8_t* __restrict__ occ,
                                    const uint32_t* __restrict__ gwords,
                                    const uint8_t* __restrict__ dil, int h,
                                    int w, Params P, bool accept) {
  extern __shared__ float smem[];
  const Bits B = stage<G>(smem, angles, nb, occ, gwords, h, w);
  __syncthreads();
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const float* obs = ranges + (size_t)(i / n) * nb;
  const float* msk = mask + (size_t)(i / n) * nb;
  const float x = cand[3 * (size_t)i], y = cand[3 * (size_t)i + 1];
  const float th = cand[3 * (size_t)i + 2];
  float s_th, c_th;
  sincosf(th, &s_th, &c_th);
  const float ox = x + P.laser_offset * c_th;
  const float oy = y + P.laser_offset * s_th;
  float prob = 0.0f;
  for (int b = 0; b < nb; ++b) {
    float dx, dy;
    sincosf(ray_angle(th, smem[b], P), &dy, &dx);
    prob = prob + beam_term(__ldg(obs + b), march<G>(ox, oy, dx, dy, B, P),
                            P) * __ldg(msk + b);
  }
  const float wv = valid_pos(x, y, dil, P, h, w) ? prob : 0.0f;
  if (!accept) {
    weights[i] = wv;
  } else if (wv > weights[i]) {
    parts[3 * (size_t)i] = x;
    parts[3 * (size_t)i + 1] = y;
    parts[3 * (size_t)i + 2] = th;
    weights[i] = wv;
  }
}

// A launch's shared memory (the beam table and, in the shared form, the
// raster's words) into smem, after the device form's pack where gwords is
// given; the first CUDA error.
cudaError_t prepare(const uint8_t* occ, uint32_t* gwords, int h, int w,
                    int nb, cudaStream_t s, size_t* smem) {
  const Layout L = pixel_layout(h, w);
  *smem = 4 * ((size_t)nb + (gwords != nullptr ? 0 : (size_t)L.words()));
  return gwords == nullptr ? cudaSuccess : pack_global(gwords, occ, L, s);
}

// refine_grad_kernel's launch: shared memory for the beam table, the
// raster's words in the shared form and the records of min(nb, kRecords)
// beams; stats null, or the counting form's tallies.
int launch_grad(const float* parts, int total, int n, const float* angles,
                const float* ranges, const float* mask, int nb,
                const uint8_t* occ, const uint8_t* dil, int h, int w,
                const float* fparams, const int* iparams, float* prop,
                float* lik, float* grad, float* dists, uint32_t* gwords,
                unsigned long long* stats, void* stream) {
  Params P;
  unpack(fparams, iparams, &P);
  if (P.levels > kMaxLevels || P.width != (1 << P.levels) ||
      P.dda_iters > kMaxIters || (lik == nullptr) != (grad == nullptr) ||
      (lik == nullptr) != (dists == nullptr))
    return (int)cudaErrorInvalidValue;
  if (total <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem;
  const cudaError_t err = prepare(occ, gwords, h, w, nb, s, &smem);
  if (err != cudaSuccess) return (int)err;
  const int nr = nb < kRecords ? nb : kRecords;
  smem += (size_t)nr * kGradThreads * (sizeof(float) + sizeof(short));
  const bool g = gwords != nullptr;
  auto* kernel = stats != nullptr
                     ? (g ? refine_grad_kernel<true, true>
                          : refine_grad_kernel<false, true>)
                     : (g ? refine_grad_kernel<true, false>
                          : refine_grad_kernel<false, false>);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<(total + kGradThreads - 1) / kGradThreads, kGradThreads, smem,
           s>>>(parts, total, n, angles, ranges, mask, nb, nr, occ, gwords,
                dil, h, w, P, prop, lik, grad, dists, stats);
  return (int)cudaGetLastError();
}

}  // namespace

// One round's proposals: particles [total, 3] (episode i / n of row i),
// the signed beam table angles [nb], ranges and mask [total / n, nb]
// (mask as 0/1 floats), occ and dil [h, w] u8, the parameters
// (ops/refine._params), prop [total, 3] out; lik [total], grad [total, 3]
// and dists [total, nb], null or all three given, receive the DDA
// likelihood, its gradient and the walks' distances (for the tests);
// gwords: null for the shared-memory raster form, else h * ((w + 31) / 32)
// ints of device scratch for the device-memory form, which the entry packs
// on the stream before the launch (ops/weights.raster_form, K1's rule).
extern "C" int mcl_refine_grad(const float* parts, int total, int n,
                               const float* angles, const float* ranges,
                               const float* mask, int nb, const uint8_t* occ,
                               const uint8_t* dil, int h, int w,
                               const float* fparams, const int* iparams,
                               float* prop, float* lik, float* grad,
                               float* dists, uint32_t* gwords, void* stream) {
  return launch_grad(parts, total, n, angles, ranges, mask, nb, occ, dil, h,
                     w, fparams, iparams, prop, lik, grad, dists, gwords,
                     nullptr, stream);
}

// The counting form of mcl_refine_grad's launch (ops/refine.walk_stats),
// its proposals into prop: the same arguments, then stats, two unsigned
// 64-bit tallies of device memory that the launch adds to (the caller
// zeroes them): the DDA steps the rays took, and the lane-steps the warps
// spent walking.
extern "C" int mcl_refine_walk_stats(
    const float* parts, int total, int n, const float* angles,
    const float* ranges, const float* mask, int nb, const uint8_t* occ,
    const uint8_t* dil, int h, int w, const float* fparams,
    const int* iparams, float* prop, unsigned long long* stats,
    uint32_t* gwords, void* stream) {
  if (stats == nullptr) return (int)cudaErrorInvalidValue;
  return launch_grad(parts, total, n, angles, ranges, mask, nb, occ, dil, h,
                     w, fparams, iparams, prop, nullptr, nullptr, nullptr,
                     gwords, stats, stream);
}

// The fixed march's scoring: with prop null, the likelihood of parts
// [total, 3] into weights [total]; else the likelihood of prop, and where
// it exceeds weights[i], prop's row written into parts and the likelihood
// into weights.  The other arguments as mcl_refine_grad's.
extern "C" int mcl_refine_score(float* parts, const float* prop,
                                float* weights, int total, int n,
                                const float* angles, const float* ranges,
                                const float* mask, int nb, const uint8_t* occ,
                                const uint8_t* dil, int h, int w,
                                const float* fparams, const int* iparams,
                                uint32_t* gwords, void* stream) {
  Params P;
  unpack(fparams, iparams, &P);
  if (total <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem;
  const cudaError_t err = prepare(occ, gwords, h, w, nb, s, &smem);
  if (err != cudaSuccess) return (int)err;
  auto* kernel =
      gwords ? refine_score_kernel<true> : refine_score_kernel<false>;
  kernel<<<(total + kThreads - 1) / kThreads, kThreads, smem, s>>>(
      parts, prop ? prop : parts, weights, total, n, angles, ranges, mask, nb,
      occ, gwords, dil, h, w, P, prop != nullptr);
  return (int)cudaGetLastError();
}
