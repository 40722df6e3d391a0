// B2 · cs_adam_fused: streaming CS-Adam in exact per-item order (paper
// Alg. 4): item i reads the sketches as items 0..i-1 left them.
//
// Replaces the TPU kernel src/repro/kernels/cs_adam.py::cs_adam_fused (body
// _adam_kernel), which gets its order from the TPU's sequential grid, one
// item per grid step.  Here order matters only within a column: the median,
// the min and every write of item i touch column c of the item's rows and
// nothing else.  So each thread owns one column c, walks the k items in
// order, and does the read-modify-write of its cells itself.  A read after
// the same thread's write to the same address needs no barrier, and no two
// threads share a cell, so the result is bit-equal to the plain version
// (kernels/ref.py::adam_fused_ref), duplicates and collisions included.
//
// Bound on the H100: latency, not bytes.  The bytes are small (g, upd and
// one read and write of each touched sketch row), but item i+1 may read
// what item i wrote, so each thread runs k dependent rounds of
// load -> compute -> store, each costing a trip to L2 or memory.  Design
// against that: 32 threads a block, so the d columns spread over d/32 SMs;
// the depth M and V loads of one item are issued together before any is
// used; no shared memory and no synchronisation.  The kernel cannot go
// faster than k round trips; the batch-parallel B1 is the fast path.
#include "cs_common.cuh"

namespace {

constexpr int kThreads = 32;

__global__ void stream_kernel(
    float* __restrict__ M, float* __restrict__ V,
    const int* __restrict__ bm, const float* __restrict__ sm,
    const int* __restrict__ bv, const float* __restrict__ g,
    float* __restrict__ upd,
    int depth_m, int width_m, int depth_v, int width_v, int k, int d,
    float lr, float omb1, float omb2, float eps, float bc1, float bc2) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= d) return;
  size_t off_m[cs::kMaxDepth], off_v[cs::kMaxDepth];
  float raw_m[cs::kMaxDepth], raw_v[cs::kMaxDepth], rows[cs::kMaxDepth];
  for (int i = 0; i < k; ++i) {
    const float gv = g[(size_t)i * d + c];
    float mhat;
    if (M != nullptr) {
      for (int j = 0; j < depth_m; ++j) {
        off_m[j] = cs::cell(j, bm[j * k + i], c, width_m, d);
        raw_m[j] = M[off_m[j]];
      }
      for (int j = 0; j < depth_m; ++j) rows[j] = raw_m[j] * sm[j * k + i];
      const float m_old = cs::median(rows, depth_m);
      const float dm = omb1 * (gv - m_old);
      for (int j = 0; j < depth_m; ++j) {
        M[off_m[j]] = raw_m[j] + sm[j * k + i] * dm;
      }
      mhat = (m_old + dm) / bc1;
    } else {
      mhat = gv;
    }
    for (int j = 0; j < depth_v; ++j) {
      off_v[j] = cs::cell(j, bv[j * k + i], c, width_v, d);
      raw_v[j] = V[off_v[j]];
    }
    const float v_old = cs::min_of(raw_v, depth_v);
    const float dv = omb2 * (gv * gv - v_old);
    for (int j = 0; j < depth_v; ++j) V[off_v[j]] = raw_v[j] + dv;
    const float vhat = fmaxf(v_old + dv, 0.0f) / bc2;
    upd[(size_t)i * d + c] = (-lr) * mhat / (sqrtf(vhat) + eps);
  }
}

}  // namespace

extern "C" int cs_adam_fused_launch(
    float* M, float* V, const int* bm, const float* sm, const int* bv,
    const float* g, float* upd, int depth_m, int width_m, int depth_v,
    int width_v, int k, int d, float lr, float omb1, float omb2, float eps,
    float bc1, float bc2, void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (depth_v < 1 || depth_v > cs::kMaxDepth ||
      (M != nullptr && (depth_m < 1 || depth_m > cs::kMaxDepth))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  stream_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      M, V, bm, sm, bv, g, upd, depth_m, width_m, depth_v, width_v, k, d,
      lr, omb1, omb2, eps, bc1, bc2);
  return (int)cudaGetLastError();
}
