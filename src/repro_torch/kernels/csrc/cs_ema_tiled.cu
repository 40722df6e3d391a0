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
// bf16 cells (cs_ema_tiled_bf16_launch), the TPU kernel's bf16 branch
// in the reference's _ema_update_read_lowp form (kernels/ops.py): the
// read launch widens the gathered cells to f32; the scatter launch
// visits EVERY cell, sums its bucket's s * d from zero in item order,
// adds the sum to the widened cell and writes
// sr_bfloat16(cell + inc, cell_bits(seed, lin)), lin = (j * width +
// bucket) * d + c as uint32.  An untouched cell adds 0 and rounds to
// itself (only -0 becomes +0, as in the reference).
//
// Bound on the H100: memory.  The function must read x and write est
// (2 * 4 * k * d bytes) and read and write the sketch once; this design
// also gathers depth cells a row in launch 1, writes and reads back the
// (k, d) scratch, and reads it once per hash row in launch 2.  Threads
// run along d, so a warp moves 128 contiguous bytes of each row.  No
// shared memory or tensor cores: a simple kernel first.
#include "cs_common.cuh"

namespace {

template <typename T>
__global__ void ema_read_kernel(const T* __restrict__ S,
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

__global__ void ema_scatter_bf16_kernel(__nv_bfloat16* __restrict__ S,
                                        const int* __restrict__ order,
                                        const int* __restrict__ starts,
                                        const float* __restrict__ s,
                                        const float* __restrict__ dv,
                                        int depth, int width, int d, int k,
                                        uint32_t seed) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const int n_cells = depth * width;
  for (int jw = blockIdx.y; jw < n_cells; jw += gridDim.y) {
    const int j = jw / width;
    const int* st = starts + (size_t)j * (width + 1) + (jw - j * width);
    float inc = 0.0f;
    for (int p = st[0]; p < st[1]; ++p) {
      const int r = order[(size_t)j * k + p];
      const float u = dv[(size_t)r * d + c];
      inc = inc + (s != nullptr ? s[(size_t)j * k + r] * u : u);
    }
    const size_t at = (size_t)jw * d + c;
    S[at] = cs::sr_bfloat16(__bfloat162float(S[at]) + inc,
                            cs::cell_bits(seed, static_cast<uint32_t>(at)));
  }
}

template <typename T>
int launch_read(const T* S, const int* b, const float* s, const float* x,
                const float* mask, float* est, float* scratch, int depth,
                int width, int d, int k, int form, int unit, float scale,
                float bm1, cudaStream_t st) {
  ema_read_kernel<T><<<cs::grid_for(k, d), cs::kThreads, 0, st>>>(
      S, b, s, x, mask, est, scratch, depth, width, d, k, form, unit, scale,
      bm1);
  return (int)cudaGetLastError();
}

bool bad_args(int depth, int form) {
  return depth < 1 || depth > cs::kMaxDepth || form < 0 || form > 2;
}

}  // namespace

extern "C" int cs_ema_tiled_launch(
    float* S, const int* b, const float* s, const float* x,
    const float* mask, const int* order, const int* starts, float* est,
    float* scratch, int depth, int width, int d, int k, int form, int unit,
    float scale, float bm1, void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (bad_args(depth, form)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err = launch_read<float>(S, b, s, x, mask, est, scratch, depth, width,
                               d, k, form, unit, scale, bm1, st);
  if (err != 0) return err;
  ema_scatter_kernel<<<cs::grid_for(depth * width, d), cs::kThreads, 0, st>>>(
      S, order, starts, s, scratch, depth, width, d, k);
  return (int)cudaGetLastError();
}

extern "C" int cs_ema_tiled_bf16_launch(
    void* S, const int* b, const float* s, const float* x, const float* mask,
    const int* order, const int* starts, float* est, float* scratch,
    int depth, int width, int d, int k, int form, int unit, float scale,
    float bm1, unsigned int seed, void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (bad_args(depth, form)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  __nv_bfloat16* cells = static_cast<__nv_bfloat16*>(S);
  int err = launch_read<__nv_bfloat16>(cells, b, s, x, mask, est, scratch,
                                       depth, width, d, k, form, unit, scale,
                                       bm1, st);
  if (err != 0) return err;
  ema_scatter_bf16_kernel<<<cs::grid_for(depth * width, d), cs::kThreads, 0,
                            st>>>(cells, order, starts, s, scratch, depth,
                                  width, d, k, seed);
  return (int)cudaGetLastError();
}
