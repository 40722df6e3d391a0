// Shared device helpers of the sketch kernels: the depth-way estimators,
// the gathered estimate of one cell, the stochastic rounding of bf16
// cells (repro_torch/core/quantize.py), and cp.async copies from device
// to shared memory.
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

// A sketch cell read as f32: f32 cells as they are, bf16 cells widened.
__device__ __forceinline__ float load_cell(const float* S, size_t at) {
  return S[at];
}
__device__ __forceinline__ float load_cell(const __nv_bfloat16* S,
                                           size_t at) {
  return __bfloat162float(S[at]);
}

// Estimate of item r at column c from a (depth, width, d) sketch of f32
// or bf16 cells: the depth cells at buckets b[j*k + r], read in f32,
// times the signs s[j*k + r] and then the median when s is given, else
// the min (ref.cs_query_ref).
template <typename T>
__device__ __forceinline__ float estimate(const T* __restrict__ S,
                                          const int* __restrict__ b,
                                          const float* __restrict__ s,
                                          int r, int c, int depth, int width,
                                          int d, int k) {
  float v[kMaxDepth];
  for (int j = 0; j < depth; ++j) {
    const float x = load_cell(S, cell(j, b[j * k + r], c, width, d));
    v[j] = s != nullptr ? x * s[j * k + r] : x;
  }
  return s != nullptr ? median(v, depth) : min_of(v, depth);
}

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

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

// Grid of (column blocks, min(n, kMaxGridY)) for n rows of d columns.
inline dim3 grid_for(int n, int d) {
  return dim3((d + kThreads - 1) / kThreads, n < kMaxGridY ? n : kMaxGridY);
}

}  // namespace cs
