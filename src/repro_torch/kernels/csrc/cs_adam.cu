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
// Bound on the H100: latency.  The bytes are small (g, upd and one read
// and write of each touched sketch row), but each thread's items form one
// chain.  Most of that chain is not real: an item depends on an earlier
// one only where they share a bucket in a hash row, and then only on the
// last such item, prev[j][i] (bucket_csr, csrc/cs_csr.cu, computed on the
// device by the wrapper).  The design removes the rest:
//
//   * staged addressing: each chain's buckets, signs and prev and the
//     block's g columns of kTile items are copied into shared memory with
//     cp.async, a tile ahead of use, three buffers deep; they do not
//     depend on the sketch;
//   * a window ahead: while item i computes, the depth M and V cells of
//     item i+L are copied into shared memory with cp.async (one group an
//     item, waited for L groups later), so a cell's load is in flight
//     for L items;
//   * forwarded writes: where prev[j][i] >= i-L, an item inside the window
//     wrote the cell after its early load was issued; the value comes
//     from a per-thread ring in shared memory of the last L written
//     values.  Otherwise the early load is current: the thread's own
//     earlier stores to the cell precede it in program order.
//
// Each cell sees the same sequence of f32 read-add-write operations as in
// the plain version.  A block owns 32 columns, so the d columns spread
// over d/32 SMs, and one warp's chain of k items is the whole kernel's
// time.  So the block splits an item's work over three warps: the M chain
// (median, first moment), the V chain (min, second moment), and an update
// warp that takes both estimates a tile later through shared memory and
// does the divisions and the square root, where items do not depend on
// each other.  The depth loops are unrolled so that an item's values stay
// in registers (one kernel for depth 3, one for any depth).
#include "cs_common.cuh"

namespace {

constexpr int kThreads = 32;  // columns a block: one a lane of each warp
constexpr int kTile = 32;     // items staged per tile
constexpr int kBufs = 3;
constexpr int kWindow = 4;  // items between a cell's early load and its use
                            // (kernels/cs_adam.py::WINDOW)

// cs::median and cs::min_of for arrays that must stay in registers: every
// index is a constant once the loops are unrolled.  The same values: depth
// 3 is a+b+c-max-min, other depths the middle of a stable sort (bubble
// here, insertion there: a stable sort has one result), the mean of the
// two middles at even depths.
template <int N>
__device__ __forceinline__ float median_reg(float (&v)[N], int depth) {
  if (depth == 1) return v[0];
  if (N >= 3 && depth == 3) {
    const float hi = fmaxf(fmaxf(v[0], v[1]), v[2]);
    const float lo = fminf(fminf(v[0], v[1]), v[2]);
    return v[0] + v[1] + v[2] - hi - lo;
  }
#pragma unroll
  for (int pass = 0; pass < N - 1; ++pass) {
#pragma unroll
    for (int t = 0; t + 1 < N - pass; ++t) {
      if (t + 1 < depth && v[t] > v[t + 1]) {
        const float x = v[t];
        v[t] = v[t + 1];
        v[t + 1] = x;
      }
    }
  }
  const int mid = depth / 2;
  float lo = v[0], hi = v[0];
#pragma unroll
  for (int t = 0; t < N; ++t) {
    if (t == mid - 1) lo = v[t];
    if (t == mid) hi = v[t];
  }
  return depth % 2 ? hi : 0.5f * (lo + hi);
}

template <int N>
__device__ __forceinline__ float min_reg(const float (&v)[N], int depth) {
  float out = v[0];
#pragma unroll
  for (int j = 1; j < N; ++j) {
    if (j < depth) out = fminf(out, v[j]);
  }
  return out;
}

// The warps of a block meet once a tile at named barrier 1 (0 is
// __syncthreads's), all threads of the block.
__device__ __forceinline__ void tile_barrier() {
  asm volatile("bar.sync 1, %0;" ::"r"(blockDim.x) : "memory");
}

// One warp's chain: the M chain (kM: the signed sketch, the median) or
// the V chain (the Count-Min sketch, the min).  Each item's new estimate
// (m_old + dm, v_old + dv) goes to ``out``, tile n's in buffer n & 1 (and
// with no M chain, g to ``g_out``), for the update warp.  A tile of kTile
// items is staged as rows of kTile words: buckets, signs (M only) and
// prev, depth rows each, then g (kTile x kThreads).
template <bool kM>
__host__ __device__ constexpr int tile_words(int depth) {
  return (kM ? 3 : 2) * depth * kTile + kTile * kThreads;
}

// Shared memory of one chain: three tiles, 2L slots of early loads and L
// slots of written values (L = kWindow).
template <bool kM>
__host__ __device__ constexpr int chain_words(int depth) {
  return 3 * tile_words<kM>(depth) + 3 * kWindow * depth * kThreads;
}

template <int D, bool kM>
__device__ __forceinline__ void run_chain(
    float* __restrict__ S, const int* __restrict__ bk,
    const float* __restrict__ sk, const int* __restrict__ pk,
    const float* __restrict__ g, float* __restrict__ out,
    float* __restrict__ g_out, int* __restrict__ area, int depth_rt,
    int width, int k, int d, float om) {
  const int lane = threadIdx.x % kThreads;
  const int c = blockIdx.x * kThreads + lane;
  const bool on = c < d;
  const int depth = D > 0 ? D : depth_rt;
  const int words = tile_words<kM>(depth);
  constexpr int L = kWindow, mask = L - 1, emask = 2 * L - 1;
  const int n_tiles = (k + kTile - 1) / kTile;
  // tile n: its buckets, signs, prev and g
  auto t_b = [&](int n) { return area + (n % kBufs) * words; };
  auto t_s = [&](int n) {
    return reinterpret_cast<float*>(t_b(n) + depth * kTile);
  };
  auto t_p = [&](int n) { return t_b(n) + (kM ? 2 : 1) * depth * kTile; };
  auto t_g = [&](int n) {
    return reinterpret_cast<float*>(t_p(n) + depth * kTile);
  };
  // early[((a mod 2L) * depth + row) * kThreads + lane]: item a's cells as
  // loaded L items ahead; ring[((p mod L) * depth + row) * kThreads +
  // lane]: the cells as item p wrote them
  float* early = reinterpret_cast<float*>(area + kBufs * words);
  float* ring = early + 2 * L * depth * kThreads;

  auto stage = [&](int n) {  // issue the copies of tile n (none past k)
    const int i0 = n * kTile;
    const int cnt = min(kTile, k - i0);
    if (cnt <= 0) return;
    if (lane < cnt) {
      for (int j = 0; j < depth; ++j) {
        const size_t at = (size_t)j * k + i0 + lane;
        cs::cp_async4(t_b(n) + j * kTile + lane, bk + at);
        if (kM) cs::cp_async4(t_s(n) + j * kTile + lane, sk + at);
        cs::cp_async4(t_p(n) + j * kTile + lane, pk + at);
      }
    }
    if (on) {
      for (int r = 0; r < cnt; ++r) {
        cs::cp_async4(t_g(n) + r * kThreads + lane,
                      g + (size_t)(i0 + r) * d + c);
      }
    }
  };

  // per-depth values in registers: every loop over rows below is
  // unrolled (to kMaxDepth with a guard when D is 0), so each index is a
  // constant; row j's column c starts at at[j]
  constexpr int kD = D > 0 ? D : cs::kMaxDepth;
  float* at[kD];
#pragma unroll
  for (int j = 0; j < kD; ++j) at[j] = S + ((size_t)j * width * d + c);
  auto load_ahead = [&](int a) {  // the early loads of item a's cells
    if (!on || a >= k) return;
    const int* b = t_b(a / kTile) + a % kTile;
    float* e = early + (a & emask) * depth * kThreads + lane;
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      if (j < depth) {
        cs::cp_async4(e + j * kThreads, at[j] + (size_t)b[j * kTile] * d);
      }
    }
  };

  // prologue: tiles 0 and 1, then the cells of items 0..L-1, one group
  // an item
  stage(0);
  stage(1);
  cs::cp_async_commit();
  cs::cp_async_wait<0>();
  __syncwarp();
  for (int a = 0; a < L; ++a) {
    load_ahead(a);
    cs::cp_async_commit();
  }

  float raw[kD] = {}, sg[kD] = {}, rows[kD];
  float* cell[kD];
  for (int i = 0; i < k; ++i) {
    const int n = i / kTile, q = i % kTile;
    // the window: item i+L's loads; at a tile's first item, the tile
    // after it (needed kTile items later, so it lands in time, L < kTile)
    const int a = i + L;
    if (a % kTile == 0) stage(a / kTile + 1);
    load_ahead(a);
    cs::cp_async_commit();
    cs::cp_async_wait<L>();    // item i's loads, issued L groups ago
    __syncwarp();              // and the tiles other lanes copied
    const int* b = t_b(n) + q;
    const int* pv = t_p(n) + q;
    const float* e = early + (i & emask) * depth * kThreads + lane;
    // item i's cells: the early load, or the ring where an item of the
    // window wrote the cell last
#pragma unroll
    for (int j = 0; j < kD; ++j) {
      if (j < depth) {
        cell[j] = at[j] + (size_t)b[j * kTile] * d;
        const int p = pv[j * kTile];
        raw[j] = p >= 0 && p >= i - L
                     ? ring[((p & mask) * depth + j) * kThreads + lane]
                     : e[j * kThreads];
      }
    }
    const int slot = i & mask;
    const float gv = t_g(n)[q * kThreads + lane];
    float est;
    if (kM) {
      const float* s = t_s(n) + q;
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        sg[j] = j < depth ? s[j * kTile] : 0.0f;
        rows[j] = raw[j] * sg[j];
      }
      const float m_old = median_reg(rows, depth);
      const float dmv = om * (gv - m_old);
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        if (j < depth) {
          const float w = raw[j] + sg[j] * dmv;
          ring[(slot * depth + j) * kThreads + lane] = w;
          if (on) *cell[j] = w;
        }
      }
      est = m_old + dmv;
    } else {
      const float v_old = min_reg(raw, depth);
      const float dvv = om * (gv * gv - v_old);
#pragma unroll
      for (int j = 0; j < kD; ++j) {
        if (j < depth) {
          const float w = raw[j] + dvv;
          ring[(slot * depth + j) * kThreads + lane] = w;
          if (on) *cell[j] = w;
        }
      }
      est = v_old + dvv;
    }
    const int at_out = ((n & 1) * kTile + q) * kThreads + lane;
    out[at_out] = est;
    if (g_out != nullptr) g_out[at_out] = gv;
    if (q == kTile - 1 || i == k - 1) tile_barrier();
  }
  cs::cp_async_wait<0>();
}

// The update warp: upd from the chains' estimates, a tile behind them.
// Items do not depend on each other here, so the divisions and the
// square root of one item overlap those of the next.
__device__ __forceinline__ void run_update(
    const float* __restrict__ mh, const float* __restrict__ vh, bool has_m,
    float* __restrict__ upd, int k, int d, float lr, float eps, float bc1,
    float bc2) {
  const int lane = threadIdx.x % kThreads;
  const int c = blockIdx.x * kThreads + lane;
  const int n_tiles = (k + kTile - 1) / kTile;
  for (int r = 0; r <= n_tiles; ++r) {
    if (r > 0 && c < d) {
      const int n = r - 1, i0 = n * kTile, cnt = min(kTile, k - i0);
#pragma unroll 4
      for (int q = 0; q < cnt; ++q) {
        const int at = ((n & 1) * kTile + q) * kThreads + lane;
        const float mhat = has_m ? mh[at] / bc1 : mh[at];
        const float vhat = fmaxf(vh[at], 0.0f) / bc2;
        upd[(size_t)(i0 + q) * d + c] = (-lr) * mhat / (sqrtf(vhat) + eps);
      }
    }
    if (r < n_tiles) tile_barrier();
  }
}

// D > 0: both sketches have depth D (M may be absent); D == 0: any depths
// up to kMaxDepth, read at run time.  Warps of a block: the M chain (when
// M is given), the V chain and the update; the chains write their estimates of tile n into buffer n & 1,
// and the update warp reads them during tile n + 1; all meet at a
// barrier after each tile.  Without M, the V chain passes g as mhat.
template <int D>
__global__ void __launch_bounds__(3 * kThreads) stream_kernel(
    float* __restrict__ M, float* __restrict__ V,
    const int* __restrict__ bm, const float* __restrict__ sm,
    const int* __restrict__ pm, const int* __restrict__ bv,
    const int* __restrict__ pv, const float* __restrict__ g,
    float* __restrict__ upd, int depth_m, int width_m, int depth_v,
    int width_v, int k, int d, float lr, float omb1, float omb2, float eps,
    float bc1, float bc2) {
  extern __shared__ int smem[];
  const bool has_m = M != nullptr;
  float* mh = reinterpret_cast<float*>(smem);
  float* vh = mh + 2 * kTile * kThreads;
  int* area = smem + 4 * kTile * kThreads;
  const int warp = threadIdx.x / kThreads;
  const int dm = D > 0 ? D : depth_m;
  if (has_m && warp == 0) {
    run_chain<D, true>(M, bm, sm, pm, g, mh, nullptr, area, depth_m, width_m,
                       k, d, omb1);
  } else if (warp == (has_m ? 1 : 0)) {
    run_chain<D, false>(V, bv, nullptr, pv, g, vh, has_m ? nullptr : mh,
                        area + (has_m ? chain_words<true>(dm) : 0),
                        depth_v, width_v, k, d, omb2);
  } else {
    run_update(mh, vh, has_m, upd, k, d, lr, eps, bc1, bc2);
  }
}

}  // namespace

// Shared memory of one block: the estimate buffers and each chain's area.
static size_t stream_smem(bool has_m, int dm, int dv) {
  return sizeof(int) * ((size_t)4 * kTile * kThreads +
                        (has_m ? chain_words<true>(dm) : 0) +
                        chain_words<false>(dv));
}

template <int D>
static int launch(float* M, float* V, const int* bm, const float* sm,
                  const int* bv, const int* prev_m, const int* prev_v,
                  const float* g, float* upd, int depth_m, int width_m,
                  int depth_v, int width_v, int k, int d, float lr,
                  float omb1, float omb2, float eps, float bc1, float bc2,
                  cudaStream_t s) {
  const size_t shm = stream_smem(M != nullptr, depth_m, depth_v);
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        stream_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = (M != nullptr ? 3 : 2) * kThreads;
  stream_kernel<D><<<(d + kThreads - 1) / kThreads, threads, shm, s>>>(
      M, V, bm, sm, prev_m, bv, prev_v, g, upd, depth_m, width_m, depth_v,
      width_v, k, d, lr, omb1, omb2, eps, bc1, bc2);
  return (int)cudaGetLastError();
}

// prev_m (depth_m, k) and prev_v (depth_v, k) from bucket_csr of bm and
// bv.
extern "C" int cs_adam_fused_launch(
    float* M, float* V, const int* bm, const float* sm, const int* bv,
    const int* prev_m, const int* prev_v, const float* g, float* upd,
    int depth_m, int width_m, int depth_v, int width_v, int k, int d,
    float lr, float omb1, float omb2, float eps, float bc1, float bc2,
    void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  if (depth_v < 1 || depth_v > cs::kMaxDepth ||
      (M != nullptr && (depth_m < 1 || depth_m > cs::kMaxDepth))) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // depth 3 (SketchHParams' default) fully unrolled, any other depth read
  // at run time
  if (depth_v == 3 && (M == nullptr || depth_m == 3)) {
    return launch<3>(M, V, bm, sm, bv, prev_m, prev_v, g, upd, depth_m,
                     width_m, depth_v, width_v, k, d, lr, omb1, omb2, eps,
                     bc1, bc2, s);
  }
  return launch<0>(M, V, bm, sm, bv, prev_m, prev_v, g, upd, depth_m,
                   width_m, depth_v, width_v, k, d, lr, omb1, omb2, eps, bc1,
                   bc2, s);
}
