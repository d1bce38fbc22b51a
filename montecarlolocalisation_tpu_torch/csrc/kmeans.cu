// K3 and K3 batched, k-means for the cluster confidence: Lloyd's
// iterations on the particles' xy.
//
// Replaces montecarlolocalisation_tpu/ops/kmeans_pallas.py::_kmeans_kernel
// (pallas_call at kmeans_pallas.py:133, launcher kmeans_pallas :115), and,
// for episode batches, the dense scan the JAX package runs in its place
// under vmap (models/cluster.py:59-80, a TPU workaround for a pallas_call
// that cannot batch).  The plain version is
// montecarlolocalisation_tpu_torch/ops/kmeans.py::kmeans_plain, the dense
// path of models/cluster.py:83-123.
//
// Each iteration assigns every particle to its nearest center (ties to the
// first index) and moves each center to its members' mean; an empty
// cluster takes that iteration's reseed candidate.  Unlike the TPU kernel,
// this follows the dense path's early-exit latch: the first iteration that
// changes no assignment freezes centers and assignments, so the returned
// assignments are those of the last applied update.
//
// What bounds it: memory and launches.  An iteration reads the xy cloud
// (8 bytes a particle) and reads and writes the assignments (4 + 4 bytes);
// at 1M particles that is ~16 MB, a few microseconds, so the 2 launches of
// each of the 20 iterations weigh as much as the traffic.
//
// Design: the TPU grid is sequential and carries the centers across grid
// steps; blocks here run in no order, so each iteration is two launches.
// assign_kernel: nearest center, the `changed` test against the stored
// assignment, and per-block partial sums (3 floats a cluster), reduced in
// a fixed order.  update_kernel (one block an episode): sums the partials
// over blocks in a fixed order, in double, updates the centers and sets the
// device-side `done` flag when nothing changed; later launches of the same
// call return at once, so the latch needs no host sync.  No float atomics:
// a run repeats bit for bit.  The grid's y dimension is the episode: each
// episode has its own blocks, partial sums, centers, reseed candidates and
// latch, so a batch equals its episodes run one by one, bit for bit; one
// filter is one episode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxK = 8;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__global__ void assign_kernel(const float* __restrict__ xy_all, int n,
                              int k, const float* __restrict__ centers_all,
                              int* __restrict__ assign_all,
                              float* __restrict__ partial_all,
                              int* __restrict__ changed_all,
                              const int* __restrict__ done_all) {
  size_t e = blockIdx.y;
  if (done_all[e]) return;
  const float* xy = xy_all + e * 2 * n;
  const float* centers = centers_all + e * 2 * k;
  int* assign = assign_all + e * n;
  float* partial = partial_all + e * gridDim.x * 3 * k;
  __shared__ float s_warp[kWarps][3 * kMaxK];
  float c[2 * kMaxK];
  float acc[3 * kMaxK];
#pragma unroll
  for (int j = 0; j < kMaxK; ++j) {
    c[2 * j] = j < k ? centers[2 * j] : 0.0f;
    c[2 * j + 1] = j < k ? centers[2 * j + 1] : 0.0f;
    acc[3 * j] = acc[3 * j + 1] = acc[3 * j + 2] = 0.0f;
  }
  int any = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += gridDim.x * blockDim.x) {
    float x = xy[2 * i], y = xy[2 * i + 1];
    float dx = x - c[0], dy = y - c[1];
    float best = dx * dx + dy * dy;
    int a = 0;
#pragma unroll
    for (int j = 1; j < kMaxK; ++j) {
      if (j < k) {
        float ex = x - c[2 * j], ey = y - c[2 * j + 1];
        float d = ex * ex + ey * ey;
        if (d < best) {
          best = d;
          a = j;
        }
      }
    }
    any |= assign[i] != a;
    assign[i] = a;
#pragma unroll
    for (int j = 0; j < kMaxK; ++j) {
      bool m = a == j;
      acc[3 * j] += m ? x : 0.0f;
      acc[3 * j + 1] += m ? y : 0.0f;
      acc[3 * j + 2] += m ? 1.0f : 0.0f;
    }
  }
  int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
#pragma unroll
  for (int v = 0; v < 3 * kMaxK; ++v) {
    float s = acc[v];
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) s_warp[warp][v] = s;
  }
  int block_any = __syncthreads_or(any);
  if (threadIdx.x < 3 * k) {
    float s = 0.0f;
    for (int wi = 0; wi < kWarps; ++wi) s += s_warp[wi][threadIdx.x];
    partial[(size_t)blockIdx.x * 3 * k + threadIdx.x] = s;
  }
  if (threadIdx.x == 0) changed_all[e * gridDim.x + blockIdx.x] = block_any;
}

// One block an episode (e = blockIdx.x).
__global__ void update_kernel(const float* __restrict__ partial_all,
                              const int* __restrict__ changed_all,
                              int n_blocks, int k,
                              const float* __restrict__ reseed_t,
                              size_t reseed_stride,
                              float* __restrict__ centers_all,
                              int* __restrict__ done_all) {
  size_t e = blockIdx.x;
  if (done_all[e]) return;
  const float* partial = partial_all + e * n_blocks * 3 * k;
  const int* changed = changed_all + e * n_blocks;
  const float* reseed = reseed_t + e * reseed_stride;
  float* centers = centers_all + e * 2 * k;
  __shared__ double s_red[kThreads];
  __shared__ double s_sum[3 * kMaxK];
  int any = 0;
  for (int g = threadIdx.x; g < n_blocks; g += blockDim.x) any |= changed[g];
  any = __syncthreads_or(any);
  for (int v = 0; v < 3 * k; ++v) {
    double a = 0.0;
    for (int g = threadIdx.x; g < n_blocks; g += blockDim.x)
      a += (double)partial[(size_t)g * 3 * k + v];
    s_red[threadIdx.x] = a;
    __syncthreads();
    for (int half = blockDim.x / 2; half > 0; half >>= 1) {
      if (threadIdx.x < half) s_red[threadIdx.x] += s_red[threadIdx.x + half];
      __syncthreads();
    }
    if (threadIdx.x == 0) s_sum[v] = s_red[0];
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  if (!any) {
    done_all[e] = 1;  // converged: freeze centers and assignments
    return;
  }
  for (int j = 0; j < k; ++j) {
    float cnt = (float)s_sum[3 * j + 2];
    float denom = fmaxf(cnt, 1.0f);
    if (cnt > 0.0f) {
      centers[2 * j] = (float)s_sum[3 * j] / denom;
      centers[2 * j + 1] = (float)s_sum[3 * j + 1] / denom;
    } else {
      centers[2 * j] = reseed[2 * j];
      centers[2 * j + 1] = reseed[2 * j + 1];
    }
  }
}

}  // namespace

// xy [episodes, n, 2] f32; reseed [episodes, iters, k, 2] f32; assign
// [episodes, n] i32, zeroed by the caller; centers [episodes, k, 2] f32,
// holding centers0 on entry; partial [episodes, n_blocks, 3k] f32 and
// changed [episodes, n_blocks] i32 scratch; done [episodes] i32, zeroed.
// episodes <= 65535.  2 * iters launches on `stream`; returns
// cudaGetLastError().
extern "C" int mcl_kmeans(const float* xy, int episodes, int n,
                          const float* reseed, int iters, int k, int* assign,
                          float* centers, float* partial, int* changed,
                          int* done, int n_blocks, void* stream) {
  if (k < 1 || k > kMaxK || n_blocks < 1 || episodes > 65535)
    return (int)cudaErrorInvalidValue;
  if (episodes < 1) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  size_t reseed_stride = (size_t)iters * 2 * k;
  for (int t = 0; t < iters; ++t) {
    assign_kernel<<<dim3(n_blocks, episodes), kThreads, 0, s>>>(
        xy, n, k, centers, assign, partial, changed, done);
    update_kernel<<<episodes, kThreads, 0, s>>>(
        partial, changed, n_blocks, k, reseed + (size_t)t * 2 * k,
        reseed_stride, centers, done);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaGetLastError();
}
