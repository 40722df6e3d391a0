// B1 · cs_adam_tiled: fused sparse-rows CS-Adam over deduplicated rows,
// one batch for the whole step.
//
// Replaces the TPU kernel src/repro/kernels/cs_adam_tiled.py::cs_adam_tiled
// (body _tiled_kernel).  That kernel gets "batch within a tile, streaming
// across tiles" from the TPU's sequential grid.  CUDA blocks run in no
// order, so this kernel has the semantics of the `xla` backend: every read
// sees the pre-step sketches and every write adds to them.  Each quantity
// is independent per column c of d, so the step splits into two launches:
//
//   1. read   over (row r, column c): gather the depth M rows and V rows by
//             bucket, m_old = signed median, v_old = min,
//             dm = (1-b1)(g - m_old), dv = (1-b2)(g^2 - v_old); write dm, dv
//             to a (k, d) scratch and emit upd = -lr * mhat / (sqrt(vhat) +
//             eps).  Rows r >= n_valid (dedup padding) only write upd = 0.
//   2. scatter over (row r, column c), r < n_valid: M[j, bm] += s * dm and
//             V[j, bv] += dv with fp32 atomicAdd.
//
// The scatter uses atomics, so the order in which colliding rows add into
// one cell varies from run to run (not deterministic).  A collision-free
// batch writes each cell once and is then bit-equal to the plain version
// (cs_adam_tiled.py::cs_adam_tiled_plain).  The TPU kernel's equality-matrix
// matmul existed only to accumulate collisions inside a tile; atomics take
// its place and no matmul is needed.
//
// Bound on the H100: memory.  The step moves about
// 4·d·k_u·(2 + 4·depth) bytes (g and upd, plus a read and a write of depth
// M and V rows) and does a few flops per byte.  Design against that bound:
// threads run along d, so each warp reads and writes 128 contiguous bytes
// of a sketch row; every M/V row is read once in launch 1 and written once
// in launch 2; the (k, d) scratch costs 2 more reads and writes of k·d.
// Rows past n_valid read nothing and write only their zero update;
// n_valid stays a device scalar, so the host never waits.  wgmma, TMA and CUDA graphs are left to
// later work.
#include "cs_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kMaxGridY = 65535;

__global__ void tiled_read_kernel(
    const float* __restrict__ M, const float* __restrict__ V,
    const int* __restrict__ bm, const float* __restrict__ sm,
    const int* __restrict__ bv, const float* __restrict__ g,
    const int* __restrict__ n_valid, float* __restrict__ upd,
    float* __restrict__ dm_out, float* __restrict__ dv_out,
    int depth_m, int width_m, int depth_v, int width_v, int k, int d,
    float lr, float omb1, float omb2, float eps, float bc1, float bc2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const int nv = *n_valid;
  for (int r = blockIdx.y; r < k; r += gridDim.y) {
    const size_t rc = (size_t)r * d + c;
    if (r >= nv) {
      upd[rc] = 0.0f;
      continue;
    }
    const float gv = g[rc];
    float mhat;
    if (M != nullptr) {
      float rows[cs::kMaxDepth];
      for (int j = 0; j < depth_m; ++j) {
        rows[j] = M[cs::cell(j, bm[j * k + r], c, width_m, d)] * sm[j * k + r];
      }
      const float m_old = cs::median(rows, depth_m);
      const float dm = omb1 * (gv - m_old);
      dm_out[rc] = dm;
      mhat = (m_old + dm) / bc1;
    } else {
      mhat = gv;
    }
    float vrows[cs::kMaxDepth];
    for (int j = 0; j < depth_v; ++j) {
      vrows[j] = V[cs::cell(j, bv[j * k + r], c, width_v, d)];
    }
    const float v_old = cs::min_of(vrows, depth_v);
    const float dv = omb2 * (gv * gv - v_old);
    dv_out[rc] = dv;
    const float vhat = fmaxf(v_old + dv, 0.0f) / bc2;
    upd[rc] = (-lr) * mhat / (sqrtf(vhat) + eps);
  }
}

__global__ void tiled_scatter_kernel(
    float* __restrict__ M, float* __restrict__ V,
    const int* __restrict__ bm, const float* __restrict__ sm,
    const int* __restrict__ bv, const int* __restrict__ n_valid,
    const float* __restrict__ dm, const float* __restrict__ dv,
    int depth_m, int width_m, int depth_v, int width_v, int k, int d) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  const int nv = *n_valid < k ? *n_valid : k;
  for (int r = blockIdx.y; r < nv; r += gridDim.y) {
    const size_t rc = (size_t)r * d + c;
    if (M != nullptr) {
      const float x = dm[rc];
      for (int j = 0; j < depth_m; ++j) {
        atomicAdd(&M[cs::cell(j, bm[j * k + r], c, width_m, d)],
                  sm[j * k + r] * x);
      }
    }
    const float y = dv[rc];
    for (int j = 0; j < depth_v; ++j) {
      atomicAdd(&V[cs::cell(j, bv[j * k + r], c, width_v, d)], y);
    }
  }
}

}  // namespace

extern "C" int cs_adam_tiled_launch(
    float* M, float* V, const int* bm, const float* sm, const int* bv,
    const float* g, const int* n_valid, float* upd, float* dm, float* dv,
    int depth_m, int width_m, int depth_v, int width_v, int k, int d,
    float lr, float omb1, float omb2, float eps, float bc1, float bc2,
    void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (depth_v < 1 || depth_v > cs::kMaxDepth ||
      (M != nullptr && (depth_m < 1 || depth_m > cs::kMaxDepth))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 block(kThreads);
  dim3 grid((d + kThreads - 1) / kThreads, k < kMaxGridY ? k : kMaxGridY);
  tiled_read_kernel<<<grid, block, 0, s>>>(
      M, V, bm, sm, bv, g, n_valid, upd, dm, dv, depth_m, width_m, depth_v,
      width_v, k, d, lr, omb1, omb2, eps, bc1, bc2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  tiled_scatter_kernel<<<grid, block, 0, s>>>(
      M, V, bm, sm, bv, n_valid, dm, dv, depth_m, width_m, depth_v, width_v,
      k, d);
  return (int)cudaGetLastError();
}
