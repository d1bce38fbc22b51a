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
//   the last bits may differ).  Each ray is walked once: a thread keeps
//   its first kCache beams' distances and hit axes in local memory
//   between the likelihood pass and the derivative pass, which needs w
//   first, and walks any further beams again.
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
// about 20 instructions each with a bit lookup in shared memory, and a
// warp waits for its longest ray; a particle reads 12 bytes and writes 12.
// The dense path ran every step for every ray, kept it, and read it back
// in the backward.  One pass a ray, stopped at the hit, keeps the walk to
// its necessary steps; the derivative adds about 60 operations a beam.
//
// Layout: one thread per particle with the beam loop inside, as K1; the
// signed beam table in each block's shared memory; the raster one bit a
// pixel, in K1's two forms by K1's rule (sensor_model.cuh), read by the
// walk and the march through one pixel lookup.  The episodes' ranges and
// masks are read from device memory, a warp's particles mostly sharing one
// episode.  Built with -fmad=false, every float operation rounds as the
// plain torch operation does.
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
constexpr int kCache = 32;          // beams a thread keeps between passes
constexpr int kMaxLevels = 10;      // the lane tree's stack: width <= 512

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

// raycast_dda's traversal of one ray, stopped where the ray is done.
template <bool G>
__device__ Walk walk(const Origin& o, float dx, float dy, const Bits& B,
                     const Params& P) {
  const int sx = dx >= 0.0f ? 1 : -1, sy = dy >= 0.0f ? 1 : -1;
  const float inv_dx = fabsf(1.0f / (fabsf(dx) < kEps ? kEps : dx));
  const float inv_dy = 1.0f / fabsf(fabsf(dy) < kEps ? kEps : dy);
  float tx = ((dx >= 0.0f ? o.fx_pos : o.fx_neg) * P.res) * inv_dx;
  float ty = ((dy >= 0.0f ? o.fy_pos : o.fy_neg) * P.res) * inv_dy;
  const float ddx = P.res * inv_dx, ddy = P.res * inv_dy;
  Walk out{P.max_range, -1};
  int ix = o.ix, iy = o.iy;
  if (occupied<G>(B, ix, iy)) {
    out.dist = 0.0f;
    return out;
  }
  if (!in_map(B, ix, iy)) return out;
  int kx = 0, ky = 0;
  for (int s = 0; s < P.dda_iters; ++s) {
    const bool take_x = tx < ty;
    const float t = take_x ? tx : ty;
    const int nix = take_x ? ix + sx : ix;
    const int niy = take_x ? iy : iy + sy;
    if (occupied<G>(B, nix, niy) && t < P.max_range) {
      out.dist = t;
      out.code = take_x ? (kx << 1) | 1 : ky << 1;
      return out;
    }
    if (!in_map(B, nix, niy) || t >= P.max_range) return out;
    ix = nix;
    iy = niy;
    if (take_x) {
      tx = tx + ddx;
      ++kx;
    } else {
      ty = ty + ddy;
      ++ky;
    }
  }
  return out;
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

template <bool G>
__global__ void refine_grad_kernel(const float* __restrict__ parts,
                                   int total, int n,
                                   const float* __restrict__ angles,
                                   const float* __restrict__ ranges,
                                   const float* __restrict__ mask, int nb,
                                   const uint8_t* __restrict__ occ,
                                   const uint32_t* __restrict__ gwords,
                                   const uint8_t* __restrict__ dil, int h,
                                   int w, Params P,
                                   float* __restrict__ prop,
                                   float* __restrict__ lik,
                                   float* __restrict__ grad,
                                   float* __restrict__ dists) {
  extern __shared__ float smem[];
  const Bits B = stage<G>(smem, angles, nb, occ, gwords, h, w);
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

  // Pass 1: the walks and the DDA likelihood.
  float dist[kCache];
  int code[kCache];
  float prob = 0.0f;
  for (int b = 0; b < nb; ++b) {
    float dx, dy;
    sincosf(ray_angle(th, smem[b], P), &dy, &dx);
    const Walk wk = walk<G>(o, dx, dy, B, P);
    if (b < kCache) {
      dist[b] = wk.dist;
      code[b] = wk.code;
    }
    if (dists != nullptr) dists[(size_t)i * nb + b] = wk.dist;
    prob = prob + beam_term(__ldg(obs + b), wk.dist, P) * __ldg(msk + b);
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
      const Walk wk = b < kCache ? Walk{dist[b], code[b]}
                                 : walk<G>(o, dx, dy, B, P);
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
  Params P;
  unpack(fparams, iparams, &P);
  if (P.levels > kMaxLevels || P.width != (1 << P.levels) ||
      (lik == nullptr) != (grad == nullptr) ||
      (lik == nullptr) != (dists == nullptr))
    return (int)cudaErrorInvalidValue;
  if (total <= 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  size_t smem;
  const cudaError_t err = prepare(occ, gwords, h, w, nb, s, &smem);
  if (err != cudaSuccess) return (int)err;
  auto* kernel = gwords ? refine_grad_kernel<true> : refine_grad_kernel<false>;
  kernel<<<(total + kThreads - 1) / kThreads, kThreads, smem, s>>>(
      parts, total, n, angles, ranges, mask, nb, occ, gwords, dil, h, w, P,
      prop, lik, grad, dists);
  return (int)cudaGetLastError();
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
