// B3 · cs_ema_tiled: one moment's fused update_read over one sketch, the
// dense-gradient path.
//
// Replaces the TPU kernel src/repro/kernels/cs_ema_tiled.py::cs_ema_tiled
// (body _ema_kernel).  That kernel takes 8 rows a grid step, DMAs their
// depth sketch rows, folds bucket collisions inside the tile through an
// 8x8 equality matmul and writes back, so a tile sees the writes of the
// tiles before it.  CUDA blocks run in no order; this kernel has the
// semantics of the `xla` backend instead: every estimate reads the
// pre-step sketch.  Two launches:
//
//   1. read    over (row r, column c): est_old = cs::estimate (median or
//              min), d = ema_delta(est_old, x) [* mask[r]]; writes d to a
//              (k, d) scratch and est = est_old + d.
//   2. scatter over (hash row, bucket, column): the bucket's rows, sorted
//              stably by bucket on the host side (bucket_csr; cached for
//              the dense row set), add s * d into the cell in row order
//              (cs::bucket_scatter).  Deterministic, no atomics, the
//              order of the CPU index_add_.
//
// ema_delta's three forms (core/sketch.py), picked on the host:
//   form 0 (scale == 1 - beta, Adam):  scale * (x - est)
//   form 1 (beta == 1, Adagrad):       sx
//   form 2 (otherwise, momentum):      (beta - 1) * est + sx
// with sx = x when scale == 1, else scale * x; scale and beta - 1 arrive
// as float32 values rounded from float64 on the host.
//
// Bound on the H100: memory.  The function must read x and write est
// (2 * 4 * k * d bytes) and read and write the sketch once; this design
// also gathers depth cells a row in launch 1, writes and reads back the
// (k, d) scratch, and reads it once per hash row in launch 2.  Threads
// run along d, so a warp moves 128 contiguous bytes of each row.  No
// shared memory or tensor cores: a simple kernel first.
#include "cs_common.cuh"

namespace {

__global__ void ema_read_kernel(const float* __restrict__ S,
                                const int* __restrict__ b,
                                const float* __restrict__ s,
                                const float* __restrict__ x,
                                const float* __restrict__ mask,
                                float* __restrict__ est,
                                float* __restrict__ dout, int depth,
                                int width, int d, int k, int form, int unit,
                                float scale, float bm1) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  for (int r = blockIdx.y; r < k; r += gridDim.y) {
    const size_t rc = (size_t)r * d + c;
    const float e = cs::estimate(S, b, s, r, c, depth, width, d, k);
    const float xv = x[rc];
    const float sx = unit ? xv : scale * xv;
    float dv;
    if (form == 0) {
      dv = scale * (xv - e);
    } else if (form == 1) {
      dv = sx;
    } else {
      dv = bm1 * e + sx;
    }
    if (mask != nullptr) dv = dv * mask[r];
    dout[rc] = dv;
    est[rc] = e + dv;
  }
}

__global__ void ema_scatter_kernel(float* __restrict__ S,
                                   const int* __restrict__ order,
                                   const int* __restrict__ starts,
                                   const float* __restrict__ s,
                                   const float* __restrict__ dv, int depth,
                                   int width, int d, int k) {
  cs::bucket_scatter(S, order, starts, s, dv, depth, width, d, k);
}

}  // namespace

extern "C" int cs_ema_tiled_launch(
    float* S, const int* b, const float* s, const float* x,
    const float* mask, const int* order, const int* starts, float* est,
    float* scratch, int depth, int width, int d, int k, int form, int unit,
    float scale, float bm1, void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (depth < 1 || depth > cs::kMaxDepth || form < 0 || form > 2) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  ema_read_kernel<<<cs::grid_for(k, d), cs::kThreads, 0, st>>>(
      S, b, s, x, mask, est, scratch, depth, width, d, k, form, unit, scale,
      bm1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ema_scatter_kernel<<<cs::grid_for(depth * width, d), cs::kThreads, 0, st>>>(
      S, order, starts, s, scratch, depth, width, d, k);
  return (int)cudaGetLastError();
}
