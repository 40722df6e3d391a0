// B1 · cs_adam_tiled: fused sparse-rows CS-Adam over deduplicated rows,
// one batch for the whole step.
//
// Replaces the TPU kernel src/repro/kernels/cs_adam_tiled.py::cs_adam_tiled
// (body _tiled_kernel).  That kernel gets "batch within a tile, streaming
// across tiles" from the TPU's sequential grid.  CUDA blocks run in no
// order, so this kernel has the semantics of the `xla` backend: every read
// sees the pre-step sketches and every write adds to them.  One call of
// cs_adam_tiled_launch is two launches, after the caller's bucket_csr of
// the stacked M and V buckets:
//
//   1. tiled_read, one block per deduplicated slot u, threads along d (16
//      bytes a thread when d % 4 == 0 and the pointers allow, 4
//      otherwise).  Slots at or past n_valid (dedup padding) read
//      nothing.  Each warp loads the slot's depth M buckets and signs and
//      depth V buckets once (one lane a word, then shuffles); each thread
//      issues all 2·depth sketch-row loads and the gradient row's before
//      any arithmetic (cs::gather_lanes, B4's routine), takes m_old =
//      signed median and v_old = min, writes dm = (1-b1)(g - m_old) and
//      dv = (1-b2)(g^2 - v_old) to a (k, d) scratch and the update
//      -lr·mhat/(sqrt(vhat)+eps).  With the dedup batch's inv and
//      first_pos the update goes straight to the per-input-position
//      output: slot u's at first_pos[u], and block p also writes a zero
//      row at input position p when p is a later duplicate of its id, so
//      every output row is written once and padding slots write nothing.
//      Without them, the update is slot-aligned and padding slots write
//      zero rows.  Where u is the only item of its bucket's run in a hash
//      row (most runs: about 8,100 slots into 10,240 buckets), u is that
//      cell's only reader, and the read writes the new cell itself: the
//      old cell plus s·dm (or dv), the scatter's own operations.
//   2. the run scatter (csrc/cs_update.cu, cs::launch_run_scatter) over
//      that CSR, runs of one item skipped: each (hash row, bucket)'s run
//      of live slots (slot < n_valid) is added into its cell in slot
//      order, starting from the old value, M signed and V unsigned as two
//      targets of one launch, and each cell is written once.
//
// No atomics: deterministic, and in the order of the CPU index_add_, so
// M and V are bit-equal to the plain version (cs_adam_tiled.py::
// cs_adam_tiled_plain) run on the CPU under any collisions.
//
// Bound on the H100: memory.  The step must read the live gradient rows,
// the touched M and V rows and the addressing, and write the touched rows
// and the k output rows.  The two launches move more than that: the read
// gathers each slot's 2·depth rows (a row shared by slots is read again)
// and writes the (2, k_u, d) scratch, and the scatter reads the scratch
// again for each run of two or more, beside the cells it reads and
// writes.  At the main path's shapes each launch runs near the card's
// DRAM rate for its own bytes.  Column slices that would keep the scratch
// in L2 were slower: every slice repeats the scatter's per-run work.
#include "cs_common.cuh"

namespace {

// starts: of the bucket CSR of the stacked M and V buckets, rows [0,
// depth_m) for M and [depth_m, depth_m + depth_v) for V, width w.
template <int DEPTH, int N>
__global__ void tiled_read(
    float* M, float* V, const int* __restrict__ bm,
    const float* __restrict__ sm, const int* __restrict__ bv,
    const float* __restrict__ g, const int* __restrict__ n_valid,
    const int* __restrict__ inv, const int* __restrict__ first_pos,
    const int* __restrict__ starts,
    float* __restrict__ upd, float* __restrict__ dm_out,
    float* __restrict__ dv_out, int depth_m_rt, int width_m, int depth_v_rt,
    int width_v, int w, int k, int d, float lr, float omb1, float omb2,
    float eps, float bc1, float bc2) {
  const int u = blockIdx.x;
  const int nv = min(max(*n_valid, 0), k);
  if (first_pos != nullptr && first_pos[inv[u]] != u) {
    // input position u repeats an earlier id: its output row is zero
    for (int c = threadIdx.x * N; c < d; c += blockDim.x * N) {
      cs::store_lanes<N>(upd + (size_t)u * d + c, cs::Lanes<N>{});
    }
  }
  if (u >= nv) {
    if (first_pos == nullptr) {
      for (int c = threadIdx.x * N; c < d; c += blockDim.x * N) {
        cs::store_lanes<N>(upd + (size_t)u * d + c, cs::Lanes<N>{});
      }
    }
    return;
  }
  const size_t row = first_pos != nullptr ? (size_t)first_pos[u] : u;
  const int depth_m = M != nullptr ? (DEPTH ? DEPTH : depth_m_rt) : 0;
  const int depth_v = DEPTH ? DEPTH : depth_v_rt;
  // lanes [0, depth_m): M buckets, then M signs, then V buckets
  const int lane = threadIdx.x & 31;
  int word = 0;
  if (lane < depth_m) {
    word = bm[(size_t)lane * k + u];
  } else if (lane < 2 * depth_m) {
    word = __float_as_int(sm[(size_t)(lane - depth_m) * k + u]);
  } else if (lane < 2 * depth_m + depth_v) {
    word = bv[(size_t)(lane - 2 * depth_m) * k + u];
  }
  int bmj[cs::kMaxDepth], bvj[cs::kMaxDepth];
  float smj[cs::kMaxDepth], ones[cs::kMaxDepth];
  if (M != nullptr) {
    cs::item_addressing<DEPTH>(word, depth_m, true, 0, bmj, smj);
  }
  cs::item_addressing<DEPTH>(word, depth_v, false, 2 * depth_m, bvj, ones);
  // Does u's bucket hold u alone in a hash row?  Lane j < depth_m asks
  // for M's row j, lane 2 depth_m + j for V's row j (their words are those
  // buckets): a run of one item of the CSR.
  const bool asks = lane < depth_m ||
                    (lane >= 2 * depth_m && lane < 2 * depth_m + depth_v);
  const int crow = !asks ? 0 : lane < depth_m ? lane : lane - depth_m;
  const int* st = starts + (size_t)crow * (w + 1) + (asks ? word : 0);
  const unsigned singles =
      __ballot_sync(0xffffffffu, asks && st[1] - st[0] == 1);
  for (int c = threadIdx.x * N; c < d; c += blockDim.x * N) {
    cs::Lanes<N> mc[cs::kMaxDepth], vc[cs::kMaxDepth];
    if (M != nullptr) {
      cs::gather_lanes<DEPTH, N>(mc, M, bmj, depth_m, width_m, d, c);
    }
    cs::gather_lanes<DEPTH, N>(vc, V, bvj, depth_v, width_v, d, c);
    const cs::Lanes<N> gl = cs::load_lanes<N>(g + (size_t)u * d + c);
    cs::Lanes<N> out, dmv, dvv;
#pragma unroll
    for (int t = 0; t < N; ++t) {
      const float gv = gl.v[t];
      float mhat = gv;
      if (M != nullptr) {
        const float m_old =
            cs::reduce_lane<DEPTH, N>(mc, smj, true, depth_m, t);
        const float dm = omb1 * (gv - m_old);
        dmv.v[t] = dm;
        mhat = (m_old + dm) / bc1;
      }
      const float v_old =
          cs::reduce_lane<DEPTH, N>(vc, ones, false, depth_v, t);
      const float dv = omb2 * (gv * gv - v_old);
      dvv.v[t] = dv;
      const float vhat = fmaxf(v_old + dv, 0.0f) / bc2;
      out.v[t] = (-lr) * mhat / (sqrtf(vhat) + eps);
    }
    if (M != nullptr) cs::store_lanes<N>(dm_out + (size_t)u * d + c, dmv);
    cs::store_lanes<N>(dv_out + (size_t)u * d + c, dvv);
    cs::store_lanes<N>(upd + row * d + c, out);
    // a cell whose run is u alone gets its new value here, as the scatter
    // would add it (the scatter skips runs of one item): the old cell plus
    // s·dm (M) or dv (V)
#pragma unroll
    for (int j = 0; j < cs::kMaxDepth; ++j) {
      if (j < depth_m && (singles >> j & 1u)) {
        cs::Lanes<N> cell;
#pragma unroll
        for (int t = 0; t < N; ++t) cell.v[t] = mc[j].v[t] + smj[j] * dmv.v[t];
        cs::store_lanes<N>(M + cs::cell(j, bmj[j], c, width_m, d), cell);
      }
      if (j < depth_v && (singles >> (2 * depth_m + j) & 1u)) {
        cs::Lanes<N> cell;
#pragma unroll
        for (int t = 0; t < N; ++t) cell.v[t] = vc[j].v[t] + dvv.v[t];
        cs::store_lanes<N>(V + cs::cell(j, bvj[j], c, width_v, d), cell);
      }
    }
  }
}

struct ReadArgs {
  float *M, *V;
  const int* bm;
  const float* sm;
  const int* bv;
  const float* g;
  const int *n_valid, *inv, *first_pos, *starts;
  float *upd, *dm, *dv;
  int depth_m, width_m, depth_v, width_v, w, k, d;
  float lr, omb1, omb2, eps, bc1, bc2;
};

template <int DEPTH, int N>
void launch_read(const ReadArgs& a, cudaStream_t s) {
  tiled_read<DEPTH, N><<<a.k, cs::row_threads(a.d / N), 0, s>>>(
      a.M, a.V, a.bm, a.sm, a.bv, a.g, a.n_valid, a.inv, a.first_pos,
      a.starts, a.upd, a.dm, a.dv, a.depth_m, a.width_m, a.depth_v,
      a.width_v, a.w, a.k, a.d, a.lr, a.omb1, a.omb2, a.eps, a.bc1, a.bc2);
}

bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// One step: the read launch, then the run scatter of both moments.  M, V
// (depth, width, d) f32; bm, sm (depth_m, k), bv (depth_v, k); g (k, d);
// n_valid a device int32 scalar; inv and first_pos (k,) int32 or both
// null; upd (k, d); dm (null without M) and dv (k, d) scratch; order and
// starts the bucket CSR of ``buckets``, the stacked (depth_m + depth_v, k)
// bm and bv (bv alone without M) at width max(width_m, width_v).
extern "C" int cs_adam_tiled_launch(
    float* M, float* V, const int* bm, const float* sm, const int* bv,
    const float* g, const int* n_valid, const int* inv, const int* first_pos,
    float* upd, float* dm, float* dv, const int* order, const int* starts,
    const int* buckets, int depth_m, int width_m, int depth_v, int width_v,
    int k, int d, float lr, float omb1, float omb2, float eps, float bc1,
    float bc2, void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (depth_v < 1 || depth_v > cs::kMaxDepth ||
      (M != nullptr && (depth_m < 1 || depth_m > cs::kMaxDepth)) ||
      2 * (M != nullptr ? depth_m : 0) + depth_v > 32) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = M != nullptr && width_m > width_v ? width_m : width_v;
  const ReadArgs r{M,       V,       bm,      sm,      bv,      g,
                   n_valid, inv,     first_pos, starts, upd,   dm,
                   dv,      depth_m, width_m, depth_v, width_v, w,
                   k,       d,       lr,      omb1,    omb2,    eps,
                   bc1,     bc2};
  const bool vec = d % 4 == 0 && aligned16(M) && aligned16(V) &&
                   aligned16(g) && aligned16(upd) && aligned16(dm) &&
                   aligned16(dv);
  if (depth_v == 3 && (M == nullptr || depth_m == 3)) {
    vec ? launch_read<3, 4>(r, s) : launch_read<3, 1>(r, s);
  } else {
    vec ? launch_read<0, 4>(r, s) : launch_read<0, 1>(r, s);
  }
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  // the read wrote the cells of runs of one item
  const cs::RunScatter sc =
      M != nullptr
          ? cs::RunScatter{M, dm, sm, depth_m, width_m, V, dv, width_v,
                           order, starts, buckets, n_valid,
                           depth_m + depth_v, w, d, d, k, true}
          : cs::RunScatter{V, dv, nullptr, depth_v, width_v, nullptr,
                           nullptr, width_v, order, starts, buckets,
                           n_valid, depth_v, w, d, d, k, true};
  return cs::launch_run_scatter(sc, s);
}
