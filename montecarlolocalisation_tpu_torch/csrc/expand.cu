// K2 and K2 batched, systematic-resampling expansion:
// drawn[k] = particles[i(k)].
//
// Replaces montecarlolocalisation_tpu/ops/expand_pallas.py::_expand_kernel
// (pallas_call at expand_pallas.py:220, launcher systematic_expand :177),
// and, for episode batches, the one-hot matmul the JAX package runs in its
// place under vmap (models/resample.py:284 _expand_onehot_batched, a TPU
// workaround for a pallas_call that cannot batch).  The plain version is
// montecarlolocalisation_tpu_torch/ops/expand.py::systematic_expand_plain.
//
// counts[i] = clip(floor(N*cdf_i - u0) + 1, 0, N), made monotone by cummax
// (computed in torch, as the JAX package computes it outside its kernel),
// gives source i the output interval [counts[i-1], counts[i]).  Output k
// copies the first source whose count exceeds k.  Outputs past counts[N-1]
// (a cdf that sums a few ulps short of 1) copy the last source with
// offspring, as the scatter + cummax + gather path
// (resample.systematic_indices) does.
//
// What bounds it: memory.  Each output reads its source row (D floats) and
// ~log2(N) counts, and writes D floats; the counts of neighbouring outputs
// share cache lines, so a 1M x 3 expansion moves ~28 MB.
//
// Design: one thread per output, a binary search over the int32 counts and
// a copy.  The TPU kernel's one-hot matmul over a carried chunk cursor, and
// its float32 count rows (exact only to 2^24), are TPU workarounds: here
// the copy is exact by construction and N is bounded by int32.  The grid's
// y dimension is the episode: block (x, e) expands outputs of episode e
// from that episode's particles and counts only, so a batch equals its
// episodes expanded one by one, bit for bit; one filter is one episode.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void expand_kernel(const float* __restrict__ parts,
                              const int* __restrict__ counts, int n, int d,
                              float* __restrict__ out) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  size_t base = (size_t)blockIdx.y * n;
  const int* c = counts + base;
  int c_last = c[n - 1];
  int src = 0;
  if (c_last > 0) {
    int key = min(k, c_last - 1);
    // First i with c[i] > key; c[n - 1] > key, so it exists.
    int lo = 0, hi = n - 1;
    while (lo < hi) {
      int mid = lo + ((hi - lo) >> 1);
      if (c[mid] > key)
        hi = mid;
      else
        lo = mid + 1;
    }
    src = lo;
  }
  const float* row = parts + (base + src) * d;
  float* dst = out + (base + k) * d;
  for (int j = 0; j < d; ++j) dst[j] = row[j];
}

}  // namespace

// particles [episodes, n, d] f32, counts [episodes, n] i32 (monotone per
// episode), out [episodes, n, d] f32; episodes <= 65535 (gridDim.y).
extern "C" int mcl_systematic_expand(const float* particles,
                                     const int* counts, int episodes, int n,
                                     int d, float* out, void* stream) {
  if (episodes > 65535) return (int)cudaErrorInvalidValue;
  if (n > 0 && episodes > 0) {
    dim3 grid((n + kThreads - 1) / kThreads, episodes);
    expand_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        particles, counts, n, d, out);
  }
  return (int)cudaGetLastError();
}
