// K2 and K2 batched, systematic-resampling expansion from the CDF:
// drawn[k] = particles[lower_bound(cdf, (k + u0) / N)], per episode.
//
// Replaces montecarlolocalisation_tpu/ops/expand_pallas.py::
// systematic_expand (:177; its offspring counts at :186 through
// offspring_counts :64-74, its kernel _expand_kernel :77, pallas_call at
// :220), and, for episode batches, the one-hot matmul the JAX package runs
// in its place under vmap (models/resample.py:284 _expand_onehot_batched,
// a TPU workaround for a pallas_call that cannot batch).  The plain version
// is montecarlolocalisation_tpu_torch/ops/expand.py::
// systematic_expand_plain.
//
// What it computes, per episode (cdf f32 [N], u0 f32, particles [N, D]):
//   c_i  = clip(floor(N * cdf_i - u0) + 1, 0, N)   (offspring counts)
//   cm_i = max(c_0, ..., c_i)                       (the monotone guard)
//   out[k] = particles[first i with cm_i > min(k, cm_{N-1} - 1)]
// Source i owns outputs [cm_{i-1}, cm_i).  Outputs past cm_{N-1} (a cdf a
// few ulps short of 1) copy the last source with offspring; every output
// copies source 0 if cm_{N-1} == 0.  The counts use the plain version's
// float operations (N * cdf rounded, then - u0 rounded; -fmad=false and
// __fmul_rn/__fsub_rn keep them apart), so the kernel, the plain version
// and the JAX package agree bit for bit.  The max-scan is exact in any
// order, so a batch equals its episodes one by one, and a call repeats
// itself, whatever the launch shape.
//
// What bounds it on the H100: bytes.  Each source reads its cdf value, and
// each output reads one row and writes one: 28 bytes a particle at D = 3,
// 8.8 us at 1M.  The CDF's float64 scan stays outside (models/resample.py):
// torch's CUDA cumsum adds in another order, and at 1M one ulp of the CDF
// moves about 1 % of the draws.
//
// Design: no output searches for its source.  Each source with offspring
// writes its index at its first output, cm_{i-1} (distinct sources, distinct
// slots), into a row of zeros, and a max-scan over the outputs spreads it
// over the rest of its interval, and past cm_{N-1} the last source with
// offspring.  Every scan is a max-scan of values held in registers, P a
// thread, in the order (warp, round, lane), so each round's loads and
// stores are coalesced and shared memory holds only the warps' totals (no
// bank is shared).  A thread keeps 8 row loads in flight before it stores.
// The work is split by outputs, never by sources: a converged filter gives
// one source all N outputs, and a skewed CDF runs of thousands of sources
// without offspring, and either would serialize a split by sources.
// - One block an episode, one launch (ops/expand.launch_plan: n <= 8192,
//   32 KB of shared memory).  The block scans the counts from the cdf,
//   scatters the first outputs into shared memory (4 bytes an output),
//   spreads them, and copies the rows as one contiguous [n * D] span, so
//   the stores are coalesced.
// - Otherwise two launches.  Phase 1, one block per source tile (4096
//   sources, a multiple of it past 1024 tiles) and episode: the counts,
//   max-scanned within the tile, to scratch, and the tile's maximum.
//   Phase 2, one block per 2048 outputs and episode: the tile maxima's
//   prefix max in shared memory; two warps find the sources of the block's
//   first and last outputs by a 32-way search, over the tile maxima and
//   then inside one tile (three dependent loads for 4096 sources); the
//   sources between them scatter their first outputs and a max-scan
//   spreads them, as in the one-block path.  A window wider than 65,536
//   sources (a long run without offspring) makes each output search its
//   source in device memory instead.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlockThreads = 1024;  // one-block path, at most
constexpr int kBlockRounds = 4;      // one-block path: sources a thread scans
constexpr int kBlockMaxN = 8192;     // one-block path: 32 KB of shared memory
constexpr int kScanThreads = 512;    // phase 1
constexpr int kScanRounds = 8;
constexpr int kScanChunk = kScanThreads * kScanRounds;  // 4096 sources
constexpr int kCopyThreads = 256;    // phase 2
constexpr int kCopyRounds = 8;
constexpr int kOutTile = kCopyThreads * kCopyRounds;    // 2048 outputs
constexpr int kMaxTiles = 1024;      // phase 2: tile maxima in shared memory
constexpr int kWindowMax = 1 << 16;  // phase 2: sources scattered, at most
constexpr int kCopyBatch = 8;        // loads a thread has in flight

int g_device_launches = 0;

// c = clip(floor(N * cdf - u0) + 1, 0, N), with the plain version's
// roundings: N * cdf, then - u0, each rounded to float32.
__device__ __forceinline__ int offspring(float cdf, float nf, float u0,
                                         int n) {
  const float x = floorf(__fsub_rn(__fmul_rn(nf, cdf), u0));
  return min(max((int)x + 1, 0), n);
}

__device__ __forceinline__ int warp_max_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v = max(v, u);
  }
  return v;
}

// Inclusive max-scan, across the block, of P values a thread holds in
// registers, in the order (warp, round, lane): element warp * 32 * P +
// r * 32 + lane of the block's span, so a round's loads and stores are
// coalesced and no shared memory bank is shared.  `carry` enters as the
// maximum before the span and leaves as the span's total; `before` is each
// thread's maximum before its warp's part (carry included).  0 is the
// identity: every value scanned is >= 0.  Ends with __syncthreads.
template <int P>
__device__ __forceinline__ void block_max_scan(int (&v)[P], int& carry,
                                               int& before, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int run = 0;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    v[r] = max(warp_max_scan(v[r], lane), run);
    run = __shfl_sync(0xffffffffu, v[r], 31);
  }
  if (lane == 0) s_warp[warp] = run;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_max_scan(
        lane < (int)(blockDim.x >> 5) ? s_warp[lane] : 0, lane);
    s_warp[lane] = w;
  }
  __syncthreads();
  before = max(carry, warp > 0 ? s_warp[warp - 1] : 0);
#pragma unroll
  for (int r = 0; r < P; ++r) v[r] = max(v[r], before);
  carry = max(carry, s_warp[(blockDim.x >> 5) - 1]);
  __syncthreads();
}

// The value before each of a thread's scanned values, in the same order:
// the lane below, the last lane of the round before, or `before`.
template <int P>
__device__ __forceinline__ void predecessors(const int (&v)[P], int before,
                                             int (&prev)[P]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int up = __shfl_up_sync(0xffffffffu, v[r], 1);
    const int last = r > 0 ? __shfl_sync(0xffffffffu, v[r - 1], 31) : before;
    prev[r] = lane > 0 ? up : last;
  }
}

// First j in [lo, hi] with s[j] > key, given s monotone and s[hi] > key.
__device__ __forceinline__ int first_above(const int* s, int lo, int hi,
                                           int key) {
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (s[mid] > key)
      hi = mid;
    else
      lo = mid + 1;
  }
  return lo;
}

// The same, by one whole warp with lo, hi and key alike in every lane: 32
// probes a step, so 4096 entries take three dependent loads.
__device__ int warp_first_above(const int* v, int lo, int hi, int key) {
  const int lane = threadIdx.x & 31;
  while (hi - lo >= 32) {
    const int step = (hi - lo + 32) >> 5;  // ceil((hi - lo + 1) / 32)
    const int p = min(lo + (lane + 1) * step - 1, hi);
    const unsigned m = __ballot_sync(0xffffffffu, p == hi || v[p] > key);
    const int j = __ffs(m) - 1;  // lane 31 probes hi, so j exists
    // v[lo + j * step - 1] <= key (lane j - 1 said no), v[p_j] > key.
    const int nlo = lo + j * step;
    hi = min(lo + (j + 1) * step - 1, hi);
    lo = nlo;
  }
  const int p = lo + lane;
  const unsigned m = __ballot_sync(0xffffffffu, p >= hi || v[p] > key);
  return lo + __ffs(m) - 1;
}

// Max-scan s_src[0, cnt) in place (cnt <= blockDim * P), from `carry`: a
// source written at the first output it owns spreads to the outputs after
// it.  Unwritten entries hold 0, which every source index bounds.
template <int P>
__device__ __forceinline__ void spread_sources(int* s_src, int cnt,
                                               int& carry, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int base = warp * 32 * P + lane;
  int v[P], before;
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int j = base + r * 32;
    v[r] = j < cnt ? s_src[j] : 0;
  }
  block_max_scan<P>(v, carry, before, s_warp);
#pragma unroll
  for (int r = 0; r < P; ++r) {
    const int j = base + r * 32;
    if (j < cnt) s_src[j] = v[r];
  }
  __syncthreads();
}

// dst[j] = rows[src[j / D] * D + j % D] for j < cnt * D: a tile of outputs
// as one contiguous span, so neighbouring threads store neighbouring
// floats.  A thread has kCopyBatch loads in flight before it stores.
template <int D>
__device__ __forceinline__ void copy_rows_d(const float* __restrict__ rows,
                                            const int* s_src, int cnt, int d,
                                            float* __restrict__ dst) {
  const int dd = D > 0 ? D : d;
  const int total = cnt * dd, step = blockDim.x;
  for (int j0 = threadIdx.x; j0 < total; j0 += kCopyBatch * step) {
    float v[kCopyBatch];
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int j = j0 + u * step, r = j / dd;
      if (j < total) v[u] = rows[(size_t)s_src[r] * dd + (j - dd * r)];
    }
#pragma unroll
    for (int u = 0; u < kCopyBatch; ++u) {
      const int j = j0 + u * step;
      if (j < total) dst[j] = v[u];
    }
  }
}

__device__ __forceinline__ void copy_rows(const float* __restrict__ rows,
                                          const int* s_src, int cnt, int d,
                                          float* __restrict__ dst) {
  if (d == 3)
    copy_rows_d<3>(rows, s_src, cnt, d, dst);
  else
    copy_rows_d<0>(rows, s_src, cnt, d, dst);
}

// One block an episode.  The counts are scanned in registers, span by
// span; each source with offspring writes its index at its first output
// (cm_{i-1}, distinct for distinct sources), and a max-scan over the
// outputs spreads it to the rest of its interval, and past cm_{N-1} the
// last source with offspring.  No search.
__global__ void expand_block_kernel(const float* __restrict__ parts,
                                    const float* __restrict__ cdf,
                                    const float* __restrict__ u0, int n,
                                    int d, float* __restrict__ out) {
  constexpr int P = kBlockRounds;
  extern __shared__ int s_src[];  // [n]
  __shared__ int s_warp[32];
  const size_t e = blockIdx.x;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const float* c = cdf + e * n;
  const float uu = u0[e];
  const float nf = (float)n;
  for (int k = tid; k < n; k += nthr) s_src[k] = 0;
  __syncthreads();
  int carry = 0;
  for (int c0 = 0; c0 < n; c0 += nthr * P) {
    const int base = c0 + warp * 32 * P + lane;
    int v[P], prev[P], before;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int i = base + r * 32;
      v[r] = i < n ? offspring(c[i], nf, uu, n) : 0;
    }
    block_max_scan<P>(v, carry, before, s_warp);
    predecessors<P>(v, before, prev);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int i = base + r * 32;
      if (i < n && v[r] > prev[r]) s_src[prev[r]] = i;
    }
  }
  __syncthreads();
  carry = 0;
  for (int k0 = 0; k0 < n; k0 += nthr * P)
    spread_sources<P>(s_src + k0, min(nthr * P, n - k0), carry, s_warp);
  copy_rows(parts + e * n * d, s_src, n, d, out + e * n * d);
}

// Phase 1: block (t, e) scans sources [t * S, min((t + 1) * S, n)) of
// episode e: their counts, max-scanned within the tile, to local, and the
// tile's maximum to tmax.
__global__ void __launch_bounds__(kScanThreads)
    expand_scan_kernel(const float* __restrict__ cdf,
                       const float* __restrict__ u0, int n, int S,
                       int n_tiles, int* __restrict__ local,
                       int* __restrict__ tmax) {
  constexpr int P = kScanRounds;
  __shared__ int s_warp[32];
  const size_t e = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* c = cdf + e * n;
  int* L = local + e * n;
  const float uu = u0[e];
  const float nf = (float)n;
  const int end = min((int)blockIdx.x * S + S, n);
  int carry = 0;
  for (int c0 = blockIdx.x * S; c0 < end; c0 += kScanChunk) {
    const int base = c0 + warp * 32 * P + lane;
    int v[P], before;
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int i = base + r * 32;
      v[r] = i < end ? offspring(c[i], nf, uu, n) : 0;
    }
    block_max_scan<P>(v, carry, before, s_warp);
#pragma unroll
    for (int r = 0; r < P; ++r) {
      const int i = base + r * 32;
      if (i < end) L[i] = v[r];
    }
  }
  if (threadIdx.x == 0) tmax[e * n_tiles + blockIdx.x] = carry;
}

// Phase 2: block (b, e) writes outputs [b * kOutTile, ...) of episode e.
// Inside source tile t, cm_i = max(P_t, local_i), P_t the tiles' prefix
// maximum before t.
__global__ void __launch_bounds__(kCopyThreads)
    expand_copy_kernel(const float* __restrict__ parts,
                       const int* __restrict__ local,
                       const int* __restrict__ tmax, int n, int d, int S,
                       int n_tiles, float* __restrict__ out) {
  __shared__ int s_pre[kMaxTiles];  // inclusive prefix maxima of the tiles
  __shared__ int s_src[kOutTile];
  __shared__ int s_warp[32];
  __shared__ int s_bounds[2];
  constexpr int PT = kMaxTiles / kCopyThreads;
  const size_t e = blockIdx.y;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * kOutTile;
  const int cnt = min(kOutTile, n - k0);
  const int* L = local + e * n;
  {
    const int base = warp * 32 * PT + lane;
    int v[PT], carry = 0, before;
#pragma unroll
    for (int r = 0; r < PT; ++r) {
      const int t = base + r * 32;
      v[r] = t < n_tiles ? tmax[e * n_tiles + t] : 0;
    }
    block_max_scan<PT>(v, carry, before, s_warp);
#pragma unroll
    for (int r = 0; r < PT; ++r) s_pre[base + r * 32] = v[r];
  }
  for (int j = tid; j < cnt; j += nthr) s_src[j] = 0;
  __syncthreads();
  const int last = s_pre[n_tiles - 1];
  if (last > 0) {
    // The sources of the tile's first and last outputs: the first i with
    // cm_i > key lies in the first tile t with prefix max > key, and there
    // P_t <= key, so cm_i > key exactly where local_i > key.
    if (warp < 2) {
      const int key = min(warp == 0 ? k0 : k0 + cnt - 1, last - 1);
      const int t = first_above(s_pre, 0, n_tiles - 1, key);
      const int i = warp_first_above(L, t * S, min(t * S + S, n) - 1, key);
      if (lane == 0) s_bounds[warp] = i;
    }
    __syncthreads();
    const int lo = s_bounds[0], hi = s_bounds[1];
    if (hi - lo < kWindowMax) {
      // Output k0 takes source lo; each later source of the window with
      // offspring writes its index at its first output, cm_{i-1} > k0.
      if (tid == 0) s_src[0] = lo;
      for (int i0 = lo + 1 + tid; i0 <= hi; i0 += kCopyBatch * nthr) {
        int cur[kCopyBatch], prv[kCopyBatch];
#pragma unroll
        for (int u = 0; u < kCopyBatch; ++u) {
          const int i = min(i0 + u * nthr, hi);
          const int t = i / S, tp = (i - 1) / S;
          cur[u] = t > 0 ? max(L[i], s_pre[t - 1]) : L[i];
          prv[u] = tp > 0 ? max(L[i - 1], s_pre[tp - 1]) : L[i - 1];
        }
#pragma unroll
        for (int u = 0; u < kCopyBatch; ++u) {
          const int i = i0 + u * nthr;
          if (i <= hi && cur[u] > prv[u] && prv[u] < k0 + cnt)
            s_src[prv[u] - k0] = i;
        }
      }
      __syncthreads();
      int carry = 0;
      spread_sources<kCopyRounds>(s_src, cnt, carry, s_warp);
    } else {
      // A window this wide is a long run of sources without offspring:
      // search each output's source in device memory instead.
      for (int j = tid; j < cnt; j += nthr) {
        const int key = min(k0 + j, last - 1);
        const int t = first_above(s_pre, lo / S, hi / S, key);
        s_src[j] = first_above(L, max(lo, t * S), min(hi, t * S + S - 1),
                               key);
      }
    }
  }
  __syncthreads();
  copy_rows(parts + e * n * d, s_src, cnt, d, out + (e * n + k0) * d);
}

}  // namespace

// particles [E, n, d] f32, cdf [E, n] f32, u0 [E] f32 (all read on the
// device), out [E, n, d] f32, any E.  scratch null: one block an episode
// (episodes along grid x), one launch, for n <= kBlockMaxN.  Otherwise the
// two-launch path, with scratch int32 [E * (n + ceil(n / 4096))]: each
// episode's tile-scanned counts and one maximum a source tile; it lays
// episodes along grid y, so a batch launches in chunks of kMaxGridY
// episodes, their pointers offset (each episode's rows are the same bits
// whatever chunk holds it).  Returns the first CUDA error.
extern "C" int mcl_systematic_expand(const float* particles, const float* cdf,
                                     const float* u0, int episodes, int n,
                                     int d, float* out, int* scratch,
                                     void* stream) {
  constexpr int kMaxGridY = 65535;
  if (episodes < 0 || n < 0 || d < 1) return (int)cudaErrorInvalidValue;
  if (n == 0 || episodes == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  if (scratch == nullptr) {
    if (n > kBlockMaxN) return (int)cudaErrorInvalidValue;
    // kBlockRounds sources a thread, in whole warps.
    const int threads = min(
        kBlockThreads,
        max(32, ((n + kBlockRounds - 1) / kBlockRounds + 31) / 32 * 32));
    expand_block_kernel<<<episodes, threads, sizeof(int) * (size_t)n, s>>>(
        particles, cdf, u0, n, d, out);
    ++g_device_launches;
    return (int)cudaGetLastError();
  }
  // Source tiles of kScanChunk sources, or a multiple of it where more
  // than kMaxTiles would be needed: the copy keeps the tile maxima in
  // shared memory.
  const int chunks = (n + kScanChunk - 1) / kScanChunk;
  const int source_tile = kScanChunk * ((chunks + kMaxTiles - 1) / kMaxTiles);
  const int n_tiles = (n + source_tile - 1) / source_tile;
  cudaError_t err;
  for (int e0 = 0; e0 < episodes; e0 += kMaxGridY) {
    const int ne = min(kMaxGridY, episodes - e0);
    int* local = scratch + (size_t)e0 * n;
    int* tmax = scratch + (size_t)episodes * n + (size_t)e0 * n_tiles;
    expand_scan_kernel<<<dim3(n_tiles, ne), kScanThreads, 0, s>>>(
        cdf + (size_t)e0 * n, u0 + e0, n, source_tile, n_tiles, local, tmax);
    ++g_device_launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    expand_copy_kernel<<<dim3((n + kOutTile - 1) / kOutTile, ne),
                         kCopyThreads, 0, s>>>(
        particles + (size_t)e0 * n * d, local, tmax, n, d, source_tile,
        n_tiles, out + (size_t)e0 * n * d);
    ++g_device_launches;
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// Device launches made by mcl_systematic_expand since the library loaded.
extern "C" int mcl_expand_device_launches() { return g_device_launches; }
