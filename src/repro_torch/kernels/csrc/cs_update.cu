// B5 · cs_update: batch UPDATE of a count-sketch, a signed scatter-add of
// (k, d) rows where duplicate buckets accumulate.
//
// Replaces the TPU kernel src/repro/kernels/cs_update.py::cs_update (body
// _update_kernel).  The TPU has no atomics: it sorts the items by bucket
// and walks them on its sequential grid, seeding a bucket's row from the
// old sketch at the first item and accumulating the rest.  Here the same
// stable sort (bucket_csr, before the launch) gives each (hash row,
// bucket) its items in item order, and one thread per (hash row, bucket,
// column) adds them into the cell one after another (cs::bucket_scatter).
// Deterministic, no atomics, and in the order of the CPU index_add_.
//
// Bound on the H100: memory.  Each item's row is read once per hash row
// and each touched cell is read and written once; threads run along d, so
// a warp moves 128 contiguous bytes.  Threads of empty buckets read two
// offsets and stop.
#include "cs_common.cuh"

namespace {

__global__ void update_kernel(float* __restrict__ S,
                              const int* __restrict__ order,
                              const int* __restrict__ starts,
                              const float* __restrict__ s,
                              const float* __restrict__ delta, int depth,
                              int width, int d, int k) {
  cs::bucket_scatter(S, order, starts, s, delta, depth, width, d, k);
}

}  // namespace

extern "C" int cs_update_launch(float* S, const int* order, const int* starts,
                                const float* s, const float* delta, int depth,
                                int width, int d, int k, void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  update_kernel<<<cs::grid_for(depth * width, d), cs::kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      S, order, starts, s, delta, depth, width, d, k);
  return (int)cudaGetLastError();
}
