// Stage marks: one empty kernel a mark, each under its own unmangled
// name, so that a trace of the card names the stage whose operations
// follow it (utils/profiling.mark, ops/marks.py).  A mark launched inside
// a CUDA-graph capture becomes a node of the graph, and every replay runs
// it in stream order between the stage before it and the stage after.
//
// The names contain none of the hand-written kernels' names
// (beam_weights, expand_, kmeans_kernel), which traces match by name.
// A mark reads and writes nothing: it changes no value.

#include <cuda_runtime.h>

extern "C" __global__ void mcl_mark_begin() {}
extern "C" __global__ void mcl_mark_motion() {}
extern "C" __global__ void mcl_mark_weights() {}
extern "C" __global__ void mcl_mark_resample() {}
extern "C" __global__ void mcl_mark_cluster() {}
extern "C" __global__ void mcl_mark_emit() {}
extern "C" __global__ void mcl_mark_end() {}
extern "C" __global__ void mcl_mark_refine() {}
extern "C" __global__ void mcl_mark_refine_grad() {}
extern "C" __global__ void mcl_mark_refine_score() {}
extern "C" __global__ void mcl_mark_slam_motion() {}
extern "C" __global__ void mcl_mark_slam_field() {}
extern "C" __global__ void mcl_mark_slam_resample() {}
extern "C" __global__ void mcl_mark_slam_map() {}

// Launches mark `which`, in the order of ops/marks.py's MARKS, on
// `stream`: one block of one thread.
extern "C" int mcl_mark(int which, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (which) {
    case 0: mcl_mark_begin<<<1, 1, 0, s>>>(); break;
    case 1: mcl_mark_motion<<<1, 1, 0, s>>>(); break;
    case 2: mcl_mark_weights<<<1, 1, 0, s>>>(); break;
    case 3: mcl_mark_resample<<<1, 1, 0, s>>>(); break;
    case 4: mcl_mark_cluster<<<1, 1, 0, s>>>(); break;
    case 5: mcl_mark_emit<<<1, 1, 0, s>>>(); break;
    case 6: mcl_mark_end<<<1, 1, 0, s>>>(); break;
    case 7: mcl_mark_refine<<<1, 1, 0, s>>>(); break;
    case 8: mcl_mark_refine_grad<<<1, 1, 0, s>>>(); break;
    case 9: mcl_mark_refine_score<<<1, 1, 0, s>>>(); break;
    case 10: mcl_mark_slam_motion<<<1, 1, 0, s>>>(); break;
    case 11: mcl_mark_slam_field<<<1, 1, 0, s>>>(); break;
    case 12: mcl_mark_slam_resample<<<1, 1, 0, s>>>(); break;
    case 13: mcl_mark_slam_map<<<1, 1, 0, s>>>(); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
