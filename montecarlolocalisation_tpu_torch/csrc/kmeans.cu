// K3 and K3 batched, k-means for the cluster confidence: Lloyd's
// iterations on the particles' xy, all of them inside one launch.
//
// Replaces montecarlolocalisation_tpu/ops/kmeans_pallas.py::_kmeans_kernel
// (pallas_call at kmeans_pallas.py:133, launcher kmeans_pallas :115), and,
// for episode batches, the dense scan the JAX package runs in its place
// under vmap (models/cluster.py:59-80, a TPU workaround for a pallas_call
// that cannot batch).  The plain version is
// montecarlolocalisation_tpu_torch/ops/kmeans.py::kmeans_plain, the dense
// path of models/cluster.py:83-123: ties go to the first index, an empty
// cluster takes that iteration's reseed candidate, and the early-exit latch
// is tested before the update (the first iteration that changes no
// assignment freezes centers and assignments).  The TPU kernel drops the
// latch; this kernel keeps it.
//
// What bounds it on the H100: latency, not bytes or arithmetic.  An
// iteration is ~30 float operations and 16 bytes a point, a few
// microseconds of the card at 1M points, but each iteration ends in a
// reduction over every point and a decision that every point waits for.
// Launched from a host loop (two kernels an iteration, 40 a call) the
// launches and the one-block reduction cost 50 to 100 times the bound.
//
// Design: the ≤ 20 iterations run inside one launch.
// - The sums have one order, fixed by n alone.  A chunk is 256 points of an
//   episode; lane l of a warp adds points l, l+32, ... of it in float, and a
//   fixed butterfly over the 32 lanes gives the chunk's partial sums.  A
//   group is 32 chunks (8192 points); one warp adds their partials in
//   double by the same butterfly.  An episode's groups are then added in
//   group order, in double.  So whatever the launch shape, a batch equals
//   its episodes run one by one and a call repeats itself bit for bit.  No
//   float atomics.
// - n ≤ 16,384 (ops/kmeans.BLOCK_MAX_N): one block an episode.  It stages
//   its xy in shared memory once, keeps the assignments there, and writes
//   them to device memory once at the end; __syncthreads is the only
//   barrier.  This covers the sweep's 500 and the fleet's 1500.
// - Larger n: a persistent cooperative grid (cudaLaunchKernelEx with the
//   cooperative attribute, which a CUDA graph capture records),
//   as many blocks as can be resident, each owning groups g, g + grid, ...
//   of all episodes.  A block keeps its groups' xy and assignments in
//   shared memory when they fit (up to 2 groups a block: 96 KB each), else
//   reads xy from L2 every iteration.  Each iteration writes every group's
//   sums and `changed` flag to a buffer picked by the iteration's parity,
//   then one grid.sync(); after it every block adds the group sums of its
//   own episodes itself, in group order, so no block has to publish centers
//   and one barrier an iteration is enough.  That reads n/8192 x 3K doubles
//   a block per episode from L2 (at 1M points, K = 3: 9 KB a block, 1.2 MB
//   over the grid an iteration), against a last-block scheme's 9 KB plus a
//   second wait for its published centers.
// - The latch is a loop exit taken by every thread of the launch at the
//   same iteration, once no live episode changed; nothing is enqueued
//   after it.
// - xy is read as rows with a stride, so the [..., :2] view of [..., N, 3]
//   particles goes in without a copy.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxK = 8;
constexpr int kChunk = 256;                     // points of a chunk
constexpr int kPerLane = kChunk / 32;           // points a lane adds
constexpr int kGroupChunks = 32;                // chunks of a group
constexpr int kGroup = kChunk * kGroupChunks;   // 8192 points
constexpr int kGridThreads = 1024;
constexpr int kMaxStagedSlots = 2;  // groups a grid block keeps in smem
constexpr int kTile = 128;          // group sums a grid block loads at once

int g_device_launches = 0;

struct Args {
  const float* xy;
  long long ep_stride, row_stride;  // in floats
  int episodes, n, n_groups;
  const float* centers0;            // [E, K, 2]
  const float* reseed;              // [E, iters, K, 2]
  int iters;
  int* assign;                      // [E, n]
  float* centers;                   // [E, K, 2]
  double* gsum;                     // grid: [2][T][3K] group sums
  int* gflag;                       // grid: [2][T] group `changed` flags
  int staged;                       // xy and assignments in shared memory
  int slots;                        // groups a block holds at most
  int stage_pts;                    // points of shared xy a block holds
};

__host__ __device__ inline size_t align16(size_t b) {
  return (b + 15) & ~size_t(15);
}

// Shared memory of one block, in bytes from the start.
struct Layout {
  size_t red, gsum, tile, xy, chunk, cent, flag, live, ch, cflag, asg, bytes;
};

__host__ __device__ inline Layout layout(int k, int slots, int stage_pts,
                                         bool grid) {
  const int v = 3 * k;
  Layout L;
  size_t o = 0;
  L.red = o;  // an episode's summed group sums, per slot
  o += align16(sizeof(double) * slots * v);
  L.gsum = o;  // one-block path: the group sums
  o += grid ? 0 : align16(sizeof(double) * slots * v);
  L.tile = o;  // grid path: group sums loaded from L2
  o += grid ? align16(sizeof(double) * kTile * v) : 0;
  L.xy = o;
  o += align16(sizeof(float2) * stage_pts);
  L.chunk = o;
  o += align16(sizeof(float) * kGroupChunks * v);
  L.cent = o;
  o += align16(sizeof(float) * slots * 2 * k);
  L.flag = o;
  o += align16(sizeof(int) * slots);
  L.live = o;
  o += align16(sizeof(int) * slots);
  L.ch = o;
  o += align16(sizeof(int) * slots);
  L.cflag = o;
  o += align16(sizeof(int) * kGroupChunks);
  L.asg = o;
  o += align16(sizeof(int) * stage_pts);
  L.bytes = o;
  return L;
}

// A block's slot s: group g of all T = episodes x n_groups, episode e, its
// group gi within the episode, and the group's points [base, base + cnt).
struct Slot {
  int g, e, gi, base, cnt;
};

template <bool kGrid>
__device__ __forceinline__ Slot slot_of(const Args& a, int s) {
  Slot q;
  q.g = kGrid ? blockIdx.x + s * gridDim.x : blockIdx.x * a.n_groups + s;
  q.e = q.g / a.n_groups;
  q.gi = q.g - q.e * a.n_groups;
  q.base = q.gi * kGroup;
  q.cnt = min(kGroup, a.n - q.base);
  return q;
}

__device__ __forceinline__ float lane_sum(float v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

__device__ __forceinline__ double lane_sum(double v) {
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(0xffffffffu, v, m);
  return v;
}

// Nearest center, ties to the first index: the dense path's arithmetic.
template <int K>
__device__ __forceinline__ int nearest(float x, float y, const float* c) {
  float dx = x - c[0], dy = y - c[1];
  float best = dx * dx + dy * dy;
  int a = 0;
#pragma unroll
  for (int j = 1; j < K; ++j) {
    float ex = x - c[2 * j], ey = y - c[2 * j + 1];
    float d = ex * ex + ey * ey;
    if (d < best) {
      best = d;
      a = j;
    }
  }
  return a;
}

template <int K, bool kGrid>
__global__ void __launch_bounds__(kGridThreads, 1) kmeans_kernel(Args a) {
  constexpr int V = 3 * K;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L = layout(K, a.slots, a.stage_pts, kGrid);
  double* s_red = reinterpret_cast<double*>(smem + L.red);
  double* s_gsum = reinterpret_cast<double*>(smem + L.gsum);
  double* s_tile = reinterpret_cast<double*>(smem + L.tile);
  float2* s_xy = reinterpret_cast<float2*>(smem + L.xy);
  float* s_chunk = reinterpret_cast<float*>(smem + L.chunk);
  float* s_cent = reinterpret_cast<float*>(smem + L.cent);
  int* s_flag = reinterpret_cast<int*>(smem + L.flag);
  int* s_live = reinterpret_cast<int*>(smem + L.live);
  int* s_ch = reinterpret_cast<int*>(smem + L.ch);
  int* s_cflag = reinterpret_cast<int*>(smem + L.cflag);
  int* s_asg = reinterpret_cast<int*>(smem + L.asg);

  const int T = a.episodes * a.n_groups;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int warp = tid >> 5, lane = tid & 31, nwarps = nthr >> 5;
  const int nslots =
      kGrid ? ((int)blockIdx.x < T ? (T - 1 - (int)blockIdx.x) / gridDim.x + 1
                                   : 0)
            : a.n_groups;
  const bool staged = !kGrid || a.staged;

  // Set-up: stage xy, zero the assignments, load centers0.
  for (int s = 0; s < nslots; ++s) {
    const Slot q = slot_of<kGrid>(a, s);
    const float* src = a.xy + q.e * a.ep_stride + q.base * a.row_stride;
    if (staged) {
      for (int i = tid; i < q.cnt; i += nthr) {
        s_xy[s * kGroup + i] =
            make_float2(src[i * a.row_stride], src[i * a.row_stride + 1]);
        s_asg[s * kGroup + i] = 0;
      }
    } else {
      int* dst = a.assign + (size_t)q.e * a.n + q.base;
      for (int i = tid; i < q.cnt; i += nthr) dst[i] = 0;
    }
    if (tid < 2 * K) s_cent[s * 2 * K + tid] = a.centers0[q.e * 2 * K + tid];
    if (tid == 0) s_live[s] = 1;
  }
  __syncthreads();

  for (int t = 0; t < a.iters; ++t) {
    const int par = t & 1;
    // 1. Assign every point of every live group; chunk and group sums.
    for (int s = 0; s < nslots; ++s) {
      const Slot q = slot_of<kGrid>(a, s);
      const bool live = s_live[s];
      const int nch = (q.cnt + kChunk - 1) / kChunk;
      if (live) {
        float c[2 * K];
#pragma unroll
        for (int j = 0; j < 2 * K; ++j) c[j] = s_cent[s * 2 * K + j];
        const float* px;
        long long stride;
        int* pa;
        if (staged) {
          px = reinterpret_cast<const float*>(s_xy + s * kGroup);
          stride = 2;
          pa = s_asg + s * kGroup;
        } else {
          px = a.xy + q.e * a.ep_stride + q.base * a.row_stride;
          stride = a.row_stride;
          pa = a.assign + (size_t)q.e * a.n + q.base;
        }
        for (int ch = warp; ch < nch; ch += nwarps) {
          float acc[V];
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = 0.0f;
          // All of a lane's loads first, so they are in flight together.
          float xs[kPerLane], ys[kPerLane];
          int was[kPerLane];
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            const int i = ch * kChunk + j * 32 + lane;
            const bool in = i < q.cnt;
            xs[j] = in ? px[i * stride] : 0.0f;
            ys[j] = in ? px[i * stride + 1] : 0.0f;
            was[j] = in ? pa[i] : 0;
          }
          int moved = 0;
#pragma unroll
          for (int j = 0; j < kPerLane; ++j) {
            const int i = ch * kChunk + j * 32 + lane;
            if (i < q.cnt) {
              const int m = nearest<K>(xs[j], ys[j], c);
              moved |= was[j] != m;
              pa[i] = m;
#pragma unroll
              for (int j2 = 0; j2 < K; ++j2) {
                const bool on = m == j2;
                acc[3 * j2] += on ? xs[j] : 0.0f;
                acc[3 * j2 + 1] += on ? ys[j] : 0.0f;
                acc[3 * j2 + 2] += on ? 1.0f : 0.0f;
              }
            }
          }
#pragma unroll
          for (int v = 0; v < V; ++v) acc[v] = lane_sum(acc[v]);
          moved = __any_sync(0xffffffffu, moved);
          if (lane == 0) {
#pragma unroll
            for (int v = 0; v < V; ++v) s_chunk[ch * V + v] = acc[v];
            s_cflag[ch] = moved;
          }
        }
      }
      __syncthreads();
      if (warp == 0) {
        double* dst = kGrid ? a.gsum + ((size_t)par * T + q.g) * V
                            : s_gsum + s * V;
        int* fdst = kGrid ? a.gflag + (size_t)par * T + q.g : s_flag + s;
        if (live) {
          const int moved = __any_sync(0xffffffffu, lane < nch && s_cflag[lane]);
#pragma unroll
          for (int v = 0; v < V; ++v) {
            double d = lane_sum(lane < nch ? (double)s_chunk[lane * V + v]
                                           : 0.0);
            if (lane == 0) dst[v] = d;
          }
          if (lane == 0) *fdst = moved;
        } else if (lane == 0) {
          *fdst = 0;
        }
      }
      __syncthreads();
    }
    if constexpr (kGrid) cg::this_grid().sync();

    // 2. Each slot's episode: its group sums added in group order.
    for (int s = 0; s < nslots; ++s) {
      if (!s_live[s]) continue;  // uniform over the block
      const Slot q = slot_of<kGrid>(a, s);
      if (s > 0 && slot_of<kGrid>(a, s - 1).e == q.e) {
        if (tid < V) s_red[s * V + tid] = s_red[(s - 1) * V + tid];
        if (tid == 0) s_ch[s] = s_ch[s - 1];
        continue;
      }
      if constexpr (kGrid) {
        const size_t g0 = (size_t)par * T + (size_t)q.e * a.n_groups;
        double run = 0.0;
        int moved = 0;
        for (int t0 = 0; t0 < a.n_groups; t0 += kTile) {
          const int nt = min(kTile, a.n_groups - t0);
          for (int i = tid; i < nt * V; i += nthr)
            s_tile[i] = a.gsum[(g0 + t0) * V + i];
          for (int i = tid; i < nt; i += nthr) moved |= a.gflag[g0 + t0 + i];
          __syncthreads();
          if (tid < V)
            for (int j = 0; j < nt; ++j) run += s_tile[j * V + tid];
          __syncthreads();
        }
        moved = __syncthreads_or(moved);
        if (tid < V) s_red[s * V + tid] = run;
        if (tid == 0) s_ch[s] = moved;
      } else {
        if (tid < V) {
          double run = 0.0;
          for (int gi = 0; gi < a.n_groups; ++gi) run += s_gsum[gi * V + tid];
          s_red[s * V + tid] = run;
        }
        if (tid == 0) {
          int moved = 0;
          for (int gi = 0; gi < a.n_groups; ++gi) moved |= s_flag[gi];
          s_ch[s] = moved;
        }
      }
    }
    // Did any group of any live episode of this launch change?
    int local = 0;
    if constexpr (kGrid) {
      for (int g = tid; g < T; g += nthr) local |= a.gflag[(size_t)par * T + g];
    } else {
      local = tid < a.n_groups ? s_flag[tid] : 0;
    }
    const int go_on = __syncthreads_or(local);

    // 3. The update, where the episode changed (the latch before it).
    for (int i = tid; i < nslots * K; i += nthr) {
      const int s = i / K, j = i - (i / K) * K;
      if (!s_live[s] || !s_ch[s]) continue;
      const Slot q = slot_of<kGrid>(a, s);
      const double* r = s_red + s * V;
      const float cnt = (float)r[3 * j + 2];
      const float denom = fmaxf(cnt, 1.0f);
      float* c = s_cent + s * 2 * K;
      const float* rs = a.reseed + ((size_t)q.e * a.iters + t) * 2 * K;
      if (cnt > 0.0f) {
        c[2 * j] = (float)r[3 * j] / denom;
        c[2 * j + 1] = (float)r[3 * j + 1] / denom;
      } else {
        c[2 * j] = rs[2 * j];
        c[2 * j + 1] = rs[2 * j + 1];
      }
    }
    __syncthreads();
    for (int s = tid; s < nslots; s += nthr) s_live[s] = s_live[s] && s_ch[s];
    __syncthreads();
    if (!go_on) break;
  }

  // Epilogue: assignments (if staged) and centers to device memory.
  for (int s = 0; s < nslots; ++s) {
    const Slot q = slot_of<kGrid>(a, s);
    if (staged) {
      int* dst = a.assign + (size_t)q.e * a.n + q.base;
      for (int i = tid; i < q.cnt; i += nthr) dst[i] = s_asg[s * kGroup + i];
    }
    if (q.gi == 0 && tid < 2 * K)
      a.centers[q.e * 2 * K + tid] = s_cent[s * 2 * K + tid];
  }
}

cudaError_t set_smem(const void* fn, size_t bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

template <int K>
cudaError_t launch(Args a, int one_block, int threads, cudaStream_t s) {
  int dev, sms, optin;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin,
                                 cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  if (one_block) {
    a.staged = 1;
    a.slots = a.n_groups;
    a.stage_pts = a.n;
    const size_t bytes = layout(K, a.slots, a.stage_pts, false).bytes;
    if (bytes > (size_t)optin) return cudaErrorInvalidValue;
    const void* fn = (const void*)kmeans_kernel<K, false>;
    if ((err = set_smem(fn, bytes)) != cudaSuccess) return err;
    kmeans_kernel<K, false><<<a.episodes, threads, bytes, s>>>(a);
    ++g_device_launches;
    return cudaGetLastError();
  }
  const void* fn = (const void*)kmeans_kernel<K, true>;
  const int T = a.episodes * a.n_groups;
  // Keep each block's groups in shared memory where they fit.
  for (int staged = 1; staged >= 0; --staged) {
    a.slots = (T + sms - 1) / sms;
    if (staged && a.slots > kMaxStagedSlots) continue;
    a.staged = staged;
    a.stage_pts = staged ? a.slots * kGroup : 0;
    const size_t bytes = layout(K, a.slots, a.stage_pts, true).bytes;
    if (bytes > (size_t)optin) continue;
    if ((err = set_smem(fn, bytes)) != cudaSuccess) return err;
    int occ = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ, fn, threads,
                                                        bytes);
    if (err != cudaSuccess) return err;
    if (occ < 1) continue;
    // A cooperative launch through cudaLaunchKernelEx, which stream
    // capture records as a cooperative kernel node of a CUDA graph.
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(min(T, occ * sms));
    cfg.blockDim = dim3(threads);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kmeans_kernel<K, true>, a);
    ++g_device_launches;
    return err != cudaSuccess ? err : cudaGetLastError();
  }
  return cudaErrorInvalidConfiguration;
}

}  // namespace

// xy rows at xy + e * ep_stride + i * row_stride (floats; x then y);
// centers0 [E, K, 2], reseed [E, iters, K, 2] f32; assign [E, n] i32 and
// centers [E, K, 2] f32 outputs; gsum [2, E * n_groups, 3K] f64 and gflag
// [2, E * n_groups] i32 scratch of the grid path (null for one block an
// episode).  The plan (one_block, n_groups, threads) is ops/kmeans.
// launch_plan's.  One launch on `stream`; returns its CUDA error.
extern "C" int mcl_kmeans(const float* xy, long long ep_stride,
                          long long row_stride, int episodes, int n,
                          const float* centers0, const float* reseed,
                          int iters, int k, int* assign, float* centers,
                          double* gsum, int* gflag, int one_block,
                          int n_groups, int threads, void* stream) {
  if (k < 1 || k > kMaxK || n < 0 || iters < 0 || episodes < 1 ||
      n_groups != (n > 0 ? (n + kGroup - 1) / kGroup : 1) || threads < 32 ||
      threads > kGridThreads || threads % 32 != 0 ||
      (!one_block && (gsum == nullptr || gflag == nullptr)))
    return (int)cudaErrorInvalidValue;
  Args a{xy,     ep_stride, row_stride, episodes, n,  n_groups, centers0,
         reseed, iters,     assign,     centers,  gsum, gflag, 0, 0, 0};
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return (int)launch<1>(a, one_block, threads, s);
    case 2: return (int)launch<2>(a, one_block, threads, s);
    case 3: return (int)launch<3>(a, one_block, threads, s);
    case 4: return (int)launch<4>(a, one_block, threads, s);
    case 5: return (int)launch<5>(a, one_block, threads, s);
    case 6: return (int)launch<6>(a, one_block, threads, s);
    case 7: return (int)launch<7>(a, one_block, threads, s);
    default: return (int)launch<8>(a, one_block, threads, s);
  }
}

// Device launches made by mcl_kmeans since the library was loaded.
extern "C" int mcl_kmeans_device_launches() { return g_device_launches; }
