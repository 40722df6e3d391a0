// Shared device helpers of the sketch kernels: the depth-way estimators,
// an item's gathered sketch rows and their estimate (B1's read and B4),
// the stochastic rounding of bf16 cells (repro_torch/core/quantize.py),
// and cp.async copies from device to shared memory.
//
// Built with --fmad=false, so each add and multiply rounds on its own, in
// the order written, exactly as the plain PyTorch versions
// (repro_torch/core/sketch.py::median_rows, min_rows,
// repro_torch/kernels/ref.py) round them.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cs {

constexpr int kMaxDepth = 8;

// Median over depth, the forms of sketch.median_rows: depth 3 is
// a+b+c-max-min (left to right), other odd depths the middle of a sort,
// even depths the mean of the two middles.
__device__ __forceinline__ float median(float* v, int depth) {
  if (depth == 1) return v[0];
  if (depth == 3) {
    float hi = fmaxf(fmaxf(v[0], v[1]), v[2]);
    float lo = fminf(fminf(v[0], v[1]), v[2]);
    return v[0] + v[1] + v[2] - hi - lo;
  }
  for (int i = 1; i < depth; ++i) {  // insertion sort, depth <= kMaxDepth
    float x = v[i];
    int j = i - 1;
    while (j >= 0 && v[j] > x) {
      v[j + 1] = v[j];
      --j;
    }
    v[j + 1] = x;
  }
  int mid = depth / 2;
  if (depth % 2) return v[mid];
  return 0.5f * (v[mid - 1] + v[mid]);
}

__device__ __forceinline__ float min_of(const float* v, int depth) {
  float out = v[0];
  for (int j = 1; j < depth; ++j) out = fminf(out, v[j]);
  return out;
}

// Offset of cell (row j, bucket b, column c) in a (depth, width, d) sketch.
__device__ __forceinline__ size_t cell(int j, int b, int c, int width, int d) {
  return ((size_t)j * width + (size_t)b) * d + c;
}

// N consecutive f32 columns of one row: N = 4 is one 16-byte access
// (the caller checks the alignment), N = 1 the 4-byte path.
template <int N>
struct Lanes {
  float v[N];
};

template <int N>
__device__ __forceinline__ Lanes<N> load_lanes(const float* p) {
  Lanes<N> out;
  if constexpr (N == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    out.v[0] = q.x;
    out.v[1] = q.y;
    out.v[2] = q.z;
    out.v[3] = q.w;
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) out.v[t] = p[t];
  }
  return out;
}

template <int N>
__device__ __forceinline__ void store_lanes(float* p, const Lanes<N>& x) {
  if constexpr (N == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(x.v[0], x.v[1], x.v[2],
                                                x.v[3]);
  } else {
#pragma unroll
    for (int t = 0; t < N; ++t) p[t] = x.v[t];
  }
}

// Buckets b[j] (and signs s[j]) of the depth hash rows from the warp's
// word, laid out as depth buckets, then depth signs when ``with_signs``.
template <int DEPTH>
__device__ __forceinline__ void item_addressing(int word, int depth,
                                                bool with_signs, int base,
                                                int (&b)[kMaxDepth],
                                                float (&s)[kMaxDepth]) {
#pragma unroll
  for (int j = 0; j < kMaxDepth; ++j) {
    if (j < (DEPTH ? DEPTH : depth)) {
      b[j] = __shfl_sync(0xffffffffu, word, base + j);
      s[j] = with_signs ? __int_as_float(__shfl_sync(
                              0xffffffffu, word, base + depth + j))
                        : 1.0f;
    }
  }
}

// The depth cells of one item in N columns from c: row j of the (depth,
// width, d) sketch S at bucket b[j].  Every load is issued before any
// value is used.
template <int DEPTH, int N>
__device__ __forceinline__ void gather_lanes(Lanes<N> (&cells)[kMaxDepth],
                                             const float* __restrict__ S,
                                             const int (&b)[kMaxDepth],
                                             int depth, int width, int d,
                                             int c) {
#pragma unroll
  for (int j = 0; j < kMaxDepth; ++j) {
    if (j < (DEPTH ? DEPTH : depth)) {
      cells[j] = load_lanes<N>(S + cell(j, b[j], c, width, d));
    }
  }
}

// Column t of gathered cells reduced over depth, as ref.cs_query_ref
// does: each cell times its sign and the median when ``signed_``, else
// the min.
template <int DEPTH, int N>
__device__ __forceinline__ float reduce_lane(
    const Lanes<N> (&cells)[kMaxDepth], const float (&s)[kMaxDepth],
    bool signed_, int depth_rt, int t) {
  const int depth = DEPTH ? DEPTH : depth_rt;
  float v[kMaxDepth];
#pragma unroll
  for (int j = 0; j < kMaxDepth; ++j) {
    if (j < depth) v[j] = signed_ ? cells[j].v[t] * s[j] : cells[j].v[t];
  }
  return signed_ ? median(v, depth) : min_of(v, depth);
}

// Threads of a block for ``cols`` column groups: whole warps, at most
// 256, so that every lane takes part in the addressing shuffles.
inline int row_threads(int cols) {
  const int w = (cols + 31) / 32 * 32;
  return w < 256 ? w : 256;
}

// One launch of the run scatter (csrc/cs_update.cu): hash rows [0,
// depth0) of the CSR add the rows of x0, times the signs s0 (depth0, k)
// when given, into S0 (depth0, width0 rows of ld floats); rows [depth0,
// depth) add the rows of x1, unsigned, into S1 (width1 rows of ld).  Both
// add ncols columns: x0 and x1 are (k, ncols), and S0, S1 point at the
// first column.  order (depth, k) and starts (depth, width + 1) are the
// stable bucket CSR of buckets (depth, k); n_valid is a device int32
// scalar (items at or past it add nothing) or null.  With skip_single,
// runs of one item are left as they are.
struct RunScatter {
  float* S0;
  const float* x0;
  const float* s0;
  int depth0, width0;
  float* S1;
  const float* x1;
  int width1;
  const int* order;
  const int* starts;
  const int* buckets;
  const int* n_valid;
  int depth, width, ncols, ld, k;
  bool skip_single;
};
int launch_run_scatter(const RunScatter& a, cudaStream_t stream);

// splitmix32 finalizer (core/hashing.py::_mix), wrapping uint32.
__device__ __forceinline__ uint32_t mix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

// Rounding bits of the cell with linear index lin under a step's seed
// (core/quantize.py::cell_bits): splitmix32 in counter mode.
__device__ __forceinline__ uint32_t cell_bits(uint32_t seed, uint32_t lin) {
  return mix32(mix32(lin ^ seed) + 0x9E3779B9u);
}

// Stochastic rounding of an f32 value to bf16 (core/quantize.py::
// sr_bfloat16): add the 16 low random bits to the bit pattern, wrapping,
// and keep the top 16.
__device__ __forceinline__ __nv_bfloat16 sr_bfloat16(float v,
                                                     uint32_t bits) {
  const uint32_t u = __float_as_uint(v) + (bits & 0xFFFFu);
  return __ushort_as_bfloat16(static_cast<unsigned short>(u >> 16));
}

// cp.async: a 4- or 16-byte copy from device to shared memory that needs
// no register; the copies of a thread are grouped by commit, and
// cp_async_wait<N> waits until all but the newest N groups have landed.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(at),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned at = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace cs
