// Shared device helpers of the CS-Adam kernels: the depth-way estimators.
//
// Built with --fmad=false, so each add and multiply rounds on its own, in
// the order written, exactly as the plain PyTorch versions
// (repro_torch/core/sketch.py::median_rows, min_rows) round them.
#pragma once

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

}  // namespace cs
