// B4 · cs_query: batch QUERY of a count-sketch, one thread per (item,
// column).
//
// Replaces the TPU kernel src/repro/kernels/cs_query.py::cs_query (body
// _query_kernel).  There, each grid step DMAs the depth sketch rows of one
// item by scalar-prefetched bucket and reduces them.  Here a thread
// gathers the depth cells of its (item, column), signs them and takes the
// median or the min (cs::estimate).  It only gathers, so it is bit-equal
// to ref.cs_query_ref.
//
// Bound on the H100: memory.  Each output cell reads depth sketch cells
// and the item's buckets and signs; threads run along d, so a warp reads
// 128 contiguous bytes of one sketch row and writes 128 of the output.
#include "cs_common.cuh"

namespace {

__global__ void query_kernel(const float* __restrict__ S,
                             const int* __restrict__ b,
                             const float* __restrict__ s,
                             float* __restrict__ out, int depth, int width,
                             int d, int k) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  for (int r = blockIdx.y; r < k; r += gridDim.y) {
    out[(size_t)r * d + c] = cs::estimate(S, b, s, r, c, depth, width, d, k);
  }
}

}  // namespace

extern "C" int cs_query_launch(const float* S, const int* b, const float* s,
                               float* out, int depth, int width, int d, int k,
                               void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (depth < 1 || depth > cs::kMaxDepth) return (int)cudaErrorInvalidValue;
  query_kernel<<<cs::grid_for(k, d), cs::kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(S, b, s, out, depth,
                                                      width, d, k);
  return (int)cudaGetLastError();
}
