// B4 · cs_query: batch QUERY of a count-sketch, one block per item.
//
// Replaces the TPU kernel src/repro/kernels/cs_query.py::cs_query (body
// _query_kernel).  There, each grid step DMAs the depth sketch rows of one
// item by scalar-prefetched bucket and reduces them.  Here one block
// takes one item: each warp loads the item's depth buckets and signs once
// (one lane a word, then shuffles), and each thread gathers its columns
// of all depth rows, 16 bytes a row when d % 4 == 0 and the pointers
// allow (4 otherwise), every load issued before the median or the min is
// taken (cs::gather_lanes, the routine of B1's read).  It only gathers,
// so it is bit-equal to ref.cs_query_ref.
//
// Bound on the H100: memory.  The item's buckets and signs, its depth
// sketch rows and its output row; a warp reads 512 contiguous bytes of a
// sketch row and writes 512 of the output, and a thread keeps depth
// 16-byte loads in flight.
#include "cs_common.cuh"

namespace {

template <int DEPTH, int N>
__global__ void query_kernel(const float* __restrict__ S,
                             const int* __restrict__ b,
                             const float* __restrict__ s,
                             float* __restrict__ out, int depth_rt,
                             int width, int d, int k) {
  const int depth = DEPTH ? DEPTH : depth_rt;
  const int r = blockIdx.x;
  const int lane = threadIdx.x & 31;
  int word = 0;
  if (lane < depth) {
    word = b[(size_t)lane * k + r];
  } else if (s != nullptr && lane < 2 * depth) {
    word = __float_as_int(s[(size_t)(lane - depth) * k + r]);
  }
  int bj[cs::kMaxDepth];
  float sj[cs::kMaxDepth];
  cs::item_addressing<DEPTH>(word, depth, s != nullptr, 0, bj, sj);
  for (int c = threadIdx.x * N; c < d; c += blockDim.x * N) {
    cs::Lanes<N> cells[cs::kMaxDepth];
    cs::gather_lanes<DEPTH, N>(cells, S, bj, depth, width, d, c);
    cs::Lanes<N> e;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      e.v[t] = cs::reduce_lane<DEPTH, N>(cells, sj, s != nullptr, depth, t);
    }
    cs::store_lanes<N>(out + (size_t)r * d + c, e);
  }
}

template <int N>
void launch(const float* S, const int* b, const float* s, float* out,
            int depth, int width, int d, int k, cudaStream_t st) {
  const int threads = cs::row_threads(d / N);
  if (depth == 3) {
    query_kernel<3, N><<<k, threads, 0, st>>>(S, b, s, out, depth, width,
                                              d, k);
  } else {
    query_kernel<0, N><<<k, threads, 0, st>>>(S, b, s, out, depth, width,
                                              d, k);
  }
}

}  // namespace

extern "C" int cs_query_launch(const float* S, const int* b, const float* s,
                               float* out, int depth, int width, int d, int k,
                               void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (depth < 1 || depth > cs::kMaxDepth) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 && reinterpret_cast<uintptr_t>(S) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec) {
    launch<4>(S, b, s, out, depth, width, d, k, st);
  } else {
    launch<1>(S, b, s, out, depth, width, d, k, st);
  }
  return (int)cudaGetLastError();
}
