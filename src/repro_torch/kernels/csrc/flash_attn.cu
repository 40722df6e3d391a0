// Flash attention over bf16 q, k, v: the forward, and a deterministic
// backward, with the einsum path's f32 precision.
//
// Replaces no TPU kernel: the reference's attention
// (src/repro/models/attention.py::_flash_core) is XLA, and the port's
// plain version (repro_torch/models/attention.py::_FlashCore) forms the
// scores, probabilities and products as f32 einsums over KV chunks, on
// the card's f32 SIMT units, each pass through device memory.  Here one
// block keeps a tile of query rows and streams K/V tiles through shared
// memory (cp.async, two buffers); the products run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulation) and the online softmax
// stays in registers.
//
// Rows.  The g query heads of a GQA group are one row space: row r of
// KV head h is query position r / g, head h * g + r % g, so a block's
// tile of rows shares the group's K/V tiles, and the backward's dK/dV
// block walks every row of its group.  A KV tile wholly past the causal
// frontier of a block's rows is skipped (its masked entries contribute
// exp(-inf) = 0, as the plain version's exp(-1e30 - m) = 0).
//
// Precision.  q, k, v and dout are bf16, whose products are exact in
// f32, so S = q k^T and dP = dO v^T take one MMA each.  P and dS are f32
// values: every product with one of them as an operand takes it as an
// exact three-term bf16 split, hi + mid + lo (each part the rounding of
// what the parts before it leave), three MMAs whose sum is the f32
// product to f32 accumulation: P v, P^T dO, dS k and dS^T q.  The
// softmax scale multiplies the f32 scores after q k^T and dq, dk at the
// end (at head_dim 64, 1/8: the same bits as scaling q first).  exp, the
// running max and sum and lse are f32 with the full-accuracy expf/logf
// (built with --fmad=false, no fast math).  The tensor cores' f32
// accumulation truncates where the f32 units round to nearest, and a
// long chain of MMAs into one accumulator drifts (dK and dV summed over a
// group's 14,336 query rows so read 5.5e-5 of their norm off the plain
// version), so each chain is short: a KV tile's or a query step's products start from
// zero and are added into the f32 sum by the f32 units, as the plain
// version adds a chunk's einsum into its sum.
//
// Backward, no atomics: D = rowsum(dO o) (a warp a row), then one kernel
// a KV tile accumulating dK and dV over the group's query rows, then one
// a query tile accumulating dQ over the KV tiles; both form S and P again
// from lse.  Each sum runs in a fixed order, so two calls give the same
// bits.  The gradients are written in f32 or, for the autograd path,
// rounded to bf16 by the kernels.  The grids hand out the tiles with the
// most work first.
//
// Bound on the H100: the tensor cores (989.4 TFLOP/s bf16) for the
// products of a long sequence; the splits triple the products with P
// or dS, and the expf of every visible score runs on the f32 units.
#include "cs_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 128;  // four warps, sixteen rows each
constexpr int kRows = 64;      // query rows (forward, dQ) or keys (dK/dV)
constexpr int kKeys = 64;      // keys a KV tile

// Query rows a step of the dK/dV kernel: fewer at head_dim 128, where a
// step's products take twice the registers.
template <int HD>
__host__ __device__ constexpr int kv_step_rows() {
  return HD == 64 ? 64 : 32;
}

// Groups of four warps in a block of the dK/dV kernel, each walking every
// G-th step of query rows: two at head_dim 64 (the tile's first keys see
// every row of the group, and two groups halve that walk), one at 128,
// where two groups' buffers and sums would not fit in shared memory.
template <int HD>
__host__ __device__ constexpr int kv_groups() {
  return HD == 64 ? 2 : 1;
}

struct Shape {
  const bf16* q;  // (b, sq, hq, hd)
  const bf16* k;  // (b, skv, hkv, hd)
  const bf16* v;
  int b, sq, skv, hq, hkv, g;
  int causal, q_offset;
  float scale;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d += a b: a (16 x 16, row), b (16 x 8, col), d (16 x 8) f32.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The exact split of two f32 values x0, x1 (the lower and the upper
// column of a fragment register) into hi + mid + lo bf16 parts.
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const bf16 h0 = __float2bfloat16_rn(x0), h1 = __float2bfloat16_rn(x1);
  const float r0 = x0 - __bfloat162float(h0);
  const float r1 = x1 - __bfloat162float(h1);
  const bf16 m0 = __float2bfloat16_rn(r0), m1 = __float2bfloat16_rn(r1);
  const bf16 l0 = __float2bfloat16_rn(r0 - __bfloat162float(m0));
  const bf16 l1 = __float2bfloat16_rn(r1 - __bfloat162float(m1));
  hi = pack(h0, h1);
  mid = pack(m0, m1);
  lo = pack(l0, l1);
}

// The A fragments (hi, mid, lo) of a 16 x 16 f32 operand held as two
// 16 x 8 accumulator tiles c0 (columns 0-7) and c1 (columns 8-15).
__device__ __forceinline__ void split_a(const float (&c0)[4],
                                        const float (&c1)[4],
                                        uint32_t (&h)[4], uint32_t (&m)[4],
                                        uint32_t (&l)[4]) {
  split2(c0[0], c0[1], h[0], m[0], l[0]);
  split2(c0[2], c0[3], h[1], m[1], l[1]);
  split2(c1[0], c1[1], h[2], m[2], l[2]);
  split2(c1[2], c1[3], h[3], m[3], l[3]);
}

// acc (16 x 8 tiles over HD columns) += a (16 x 16 f32, split) times the
// 16 x HD bf16 rows at B (ld elements a row), read transposed.
template <int HD>
__device__ __forceinline__ void mma_split_rows(float (&acc)[HD / 8][4],
                                               const float (&c0)[4],
                                               const float (&c1)[4],
                                               const bf16* B, int ld,
                                               int lane) {
  uint32_t h[4], m[4], l[4];
  split_a(c0, c1, h, m, l);
#pragma unroll
  for (int n2 = 0; n2 < HD / 16; ++n2) {
    uint32_t b[4];
    ldsm_x4_t(b, B + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + n2 * 16 +
                     (lane >> 4) * 8);
    mma(acc[2 * n2], l, b[0], b[1]);
    mma(acc[2 * n2 + 1], l, b[2], b[3]);
    mma(acc[2 * n2], m, b[0], b[1]);
    mma(acc[2 * n2 + 1], m, b[2], b[3]);
    mma(acc[2 * n2], h, b[0], b[1]);
    mma(acc[2 * n2 + 1], h, b[2], b[3]);
  }
}

template <int N>
__device__ __forceinline__ void zero_tiles(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
}

// s (16 rows x N columns) = A rows (16 x HD at A) times the N rows at B
// transposed (both bf16 in shared memory, ld elements a row).
template <int HD, int N>
__device__ __forceinline__ void mma_rows_by_rows(float (&s)[N / 8][4],
                                                 const bf16* A,
                                                 const bf16* B, int ld,
                                                 int lane) {
  zero_tiles(s);
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    ldsm_x4(a, A + (lane & 15) * ld + kk * 16 + (lane >> 4) * 8);
#pragma unroll
    for (int n2 = 0; n2 < N / 16; ++n2) {
      uint32_t b[4];
      ldsm_x4(b, B + (n2 * 16 + (lane & 7) + (lane >> 4) * 8) * ld +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      mma(s[2 * n2], a, b[0], b[1]);
      mma(s[2 * n2 + 1], a, b[2], b[3]);
    }
  }
}

// Offsets (in elements) of query row r and key row j of (batch bi, KV
// head kvh).
__device__ __forceinline__ size_t q_row(const Shape& a, int bi, int kvh,
                                        int r, int hd) {
  const int pos = r / a.g, h = kvh * a.g + r % a.g;
  return (((size_t)bi * a.sq + pos) * a.hq + h) * hd;
}
__device__ __forceinline__ size_t kv_row(const Shape& a, int bi, int kvh,
                                         int j, int hd) {
  return (((size_t)bi * a.skv + j) * a.hkv + kvh) * hd;
}

// The last key that query row r sees; -1 for a row past the end.
__device__ __forceinline__ int key_limit(const Shape& a, int r) {
  if (r >= a.sq * a.g) return -1;
  return a.causal ? min(r / a.g + a.q_offset, a.skv - 1) : a.skv - 1;
}

// Copy ROWS rows of HD bf16 into shared memory (ld HD + 8) by cp.async,
// thread tid of n; rows at or past `limit` are zero-filled.  query
// selects the row map.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* s, const bf16* src,
                                          const Shape& a, int bi, int kvh,
                                          int first, int limit, bool query,
                                          int tid = threadIdx.x,
                                          int n = kThreads) {
  constexpr int LD = HD + 8, CH = HD / 8;
  for (int idx = tid; idx < ROWS * CH; idx += n) {
    const int i = idx / CH, c = idx % CH;
    bf16* dst = s + i * LD + c * 8;
    const int row = first + i;
    if (row < limit) {
      const size_t off = query ? q_row(a, bi, kvh, row, HD)
                               : kv_row(a, bi, kvh, row, HD);
      cs::cp_async16(dst, src + off + c * 8);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// The barrier of group grp's four warps (ids from 1; 0 is
// __syncthreads).
__device__ __forceinline__ void group_sync(int grp) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(grp + 1), "n"(kThreads)
               : "memory");
}

// Two values at element offset off of an f32 or (as_bf16) a bf16 output.
__device__ __forceinline__ void store_pair(void* out, size_t off, float x0,
                                           float x1, int as_bf16) {
  if (as_bf16) {
    *reinterpret_cast<__nv_bfloat162*>(static_cast<bf16*>(out) + off) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    *reinterpret_cast<float2*>(static_cast<float*>(out) + off) =
        make_float2(x0, x1);
  }
}

// KV tiles that the query rows [r0, r0 + kRows) reach.
__device__ __forceinline__ int kv_tiles(const Shape& a, int r0) {
  int n = (a.skv + kKeys - 1) / kKeys;
  if (a.causal) {
    const int last = min(r0 + kRows, a.sq * a.g) - 1;
    n = min(n, (last / a.g + a.q_offset) / kKeys + 1);
  }
  return n;
}

// The first query row of a block of the forward or the dQ kernel: grid
// (b * hkv, row tiles), the last tiles (under a causal mask, those with
// the most KV tiles to walk) handed out first.
__device__ __forceinline__ int first_row() {
  return (gridDim.y - 1 - blockIdx.y) * kRows;
}

// ---------------------------------------------------------------- forward
// Grid (b * hkv, row tiles).  Writes o (f32, q's layout), out (bf16, the
// rounding of o) and lse ((b, hkv, sq * g) f32).
template <int HD>
__global__ void __launch_bounds__(kThreads)
    fwd_kernel(Shape a, float* __restrict__ o, bf16* __restrict__ out,
               float* __restrict__ lse) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kRows * LD;        // two buffers
  bf16* Vs = Ks + 2 * kKeys * LD;    // two buffers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bi = blockIdx.x / a.hkv, kvh = blockIdx.x % a.hkv;
  const int r0 = first_row(), R = a.sq * a.g;
  const int n_tiles = kv_tiles(a, r0);

  load_tile<HD, kRows>(Qs, a.q, a, bi, kvh, r0, R, true);
  load_tile<HD, kKeys>(Ks, a.k, a, bi, kvh, 0, a.skv, false);
  load_tile<HD, kKeys>(Vs, a.v, a, bi, kvh, 0, a.skv, false);
  cs::cp_async_commit();

  int rows[2], lim[2];
  rows[0] = r0 + warp * 16 + (lane >> 2);
  rows[1] = rows[0] + 8;
  lim[0] = key_limit(a, rows[0]);
  lim[1] = key_limit(a, rows[1]);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.0f, 0.0f};
  float acc[HD / 8][4];
  zero_tiles(acc);
  const bf16* Qw = Qs + warp * 16 * LD;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      load_tile<HD, kKeys>(Ks + nb * kKeys * LD, a.k, a, bi, kvh,
                           (t + 1) * kKeys, a.skv, false);
      load_tile<HD, kKeys>(Vs + nb * kKeys * LD, a.v, a, bi, kvh,
                           (t + 1) * kKeys, a.skv, false);
      cs::cp_async_commit();
      cs::cp_async_wait<1>();
    } else {
      cs::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * kKeys * LD;
    const bf16* Vb = Vs + buf * kKeys * LD;

    float s[kKeys / 8][4];
    mma_rows_by_rows<HD, kKeys>(s, Qw, Kb, LD, lane);
    const int j0 = t * kKeys;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int j = j0 + n * 8 + (lane & 3) * 2 + (e & 1);
        float x = s[n][e] * a.scale;
        if (j > lim[e >> 1]) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float base[2], corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      base[i] = m_new == -INFINITY ? 0.0f : m_new;
      corr[i] = expf(m[i] - base[i]);
      m[i] = m_new;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(s[n][e] - base[e >> 1]);
        s[n][e] = p;
        l[e >> 1] += p;
      }
    }
    float part[HD / 8][4];
    zero_tiles(part);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      mma_split_rows<HD>(part, s[2 * kk], s[2 * kk + 1], Vb + kk * 16 * LD,
                         LD, lane);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[n][e] = acc[n][e] * corr[e >> 1] + part[n][e];
      }
    }
    __syncthreads();
  }

  const size_t lse_base = ((size_t)bi * a.hkv + kvh) * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const float den = fmaxf(l[i], 1e-30f);
    const int r = rows[i];
    if (r >= R) continue;
    const size_t off = q_row(a, bi, kvh, r, HD);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      const float x0 = acc[n][2 * i] / den, x1 = acc[n][2 * i + 1] / den;
      *reinterpret_cast<float2*>(o + off + d) = make_float2(x0, x1);
      *reinterpret_cast<__nv_bfloat162*>(out + off + d) =
          __floats2bfloat162_rn(x0, x1);
    }
    if ((lane & 3) == 0) lse[lse_base + r] = m[i] + logf(den);
  }
}

// ------------------------------------------------------------- backward
// D = rowsum(dO o) in lse's layout: a warp a row.
template <int HD>
__global__ void dot_kernel(Shape a, const float* __restrict__ o,
                           const bf16* __restrict__ dout,
                           float* __restrict__ D) {
  const int R = a.sq * a.g;
  const long long row = (long long)blockIdx.x * (blockDim.x >> 5) +
                        (threadIdx.x >> 5);
  if (row >= (long long)a.b * a.hkv * R) return;
  const int lane = threadIdx.x & 31;
  const int r = (int)(row % R);
  const int kvh = (int)((row / R) % a.hkv), bi = (int)(row / R / a.hkv);
  const size_t off = q_row(a, bi, kvh, r, HD);
  float sum = 0.0f;
#pragma unroll
  for (int d = lane; d < HD; d += 32) {
    sum += __bfloat162float(dout[off + d]) * o[off + d];
  }
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, w);
  }
  if (lane == 0) D[row] = sum;
}

// dK and dV of a tile of keys.  Grid (b * hkv, key tiles): the tiles
// with the most query rows to walk are handed out first.  G groups of
// four warps share the tile's K and V; each warp owns sixteen keys, and
// group i takes every G-th step of BQ query rows of the KV head's group
// (each group its own buffers and named barrier): S^T = K Q^T, P^T from
// lse, dP^T = V dO^T, dS^T = P^T (dP^T - D), then the step's P^T dO and
// dS^T Q from zero in registers, added into dV and dK, which each
// thread keeps for its own fragment elements in shared memory.  At the
// end the groups' sums are added in group order: dk (scaled) and dv are
// written in f32, or rounded to bf16 where `bf16_out`.
template <int HD>
__global__ void __launch_bounds__(kThreads * kv_groups<HD>())
    bwd_kv_kernel(Shape a, const bf16* __restrict__ dout,
                  const float* __restrict__ lse,
                  const float* __restrict__ D, void* __restrict__ dk,
                  void* __restrict__ dv, int bf16_out) {
  constexpr int LD = HD + 8, BQ = kv_step_rows<HD>(), G = kv_groups<HD>();
  constexpr int SUMS = (kThreads / 32) * (HD / 8) * 4 * 32;  // a group's dK
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kKeys * LD;
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
  const int grp = threadIdx.x / kThreads, gtid = threadIdx.x % kThreads;
  // the group's two buffers of Q and dO rows, lse, D, key limits, and
  // its dK then dV sums ([warp][column tile][element][lane])
  bf16* Qs = Vs + kKeys * LD + grp * 4 * BQ * LD;
  bf16* dOs = Qs + 2 * BQ * LD;
  float* Ls = reinterpret_cast<float*>(Vs + kKeys * LD + G * 4 * BQ * LD) +
              grp * 6 * BQ;
  float* Ds = Ls + 2 * BQ;
  int* Lims = reinterpret_cast<int*>(Ds + 2 * BQ);
  float* sums = reinterpret_cast<float*>(Vs + kKeys * LD +
                                         G * 4 * BQ * LD) +
                G * 6 * BQ;
  const int bi = blockIdx.x / a.hkv, kvh = blockIdx.x % a.hkv;
  const int j0 = blockIdx.y * kKeys;
  const int R = a.sq * a.g;
  const size_t lse_base = ((size_t)bi * a.hkv + kvh) * R;

  // the first query row that sees key j0
  int r_first = 0;
  if (a.causal) {
    const long long p0 = (long long)j0 - a.q_offset;
    r_first = p0 <= 0 ? 0 : (int)min((long long)R, p0 * a.g);
  }
  const int n_steps = (R + BQ - 1) / BQ, t0 = r_first / BQ + grp;

  auto stage = [&](int t, int buf) {
    const int first = t * BQ;
    load_tile<HD, BQ>(Qs + buf * BQ * LD, a.q, a, bi, kvh, first, R, true,
                      gtid, kThreads);
    load_tile<HD, BQ>(dOs + buf * BQ * LD, dout, a, bi, kvh, first, R,
                      true, gtid, kThreads);
    for (int c = gtid; c < BQ; c += kThreads) {
      const int r = first + c;
      const bool in = r < R;
      Ls[buf * BQ + c] = in ? lse[lse_base + r] : INFINITY;
      Ds[buf * BQ + c] = in ? D[lse_base + r] : 0.0f;
      Lims[buf * BQ + c] = key_limit(a, r);
    }
  };

  load_tile<HD, kKeys>(Ks, a.k, a, bi, kvh, j0, a.skv, false, threadIdx.x,
                       blockDim.x);
  load_tile<HD, kKeys>(Vs, a.v, a, bi, kvh, j0, a.skv, false, threadIdx.x,
                       blockDim.x);
  if (t0 < n_steps) stage(t0, 0);
  cs::cp_async_commit();

  float* dk_sum = sums + grp * 2 * SUMS + warp * (HD / 8) * 4 * 32 + lane;
  float* dv_sum = dk_sum + SUMS;
#pragma unroll
  for (int i = 0; i < (HD / 8) * 4; ++i) {
    dk_sum[i * 32] = dv_sum[i * 32] = 0.0f;
  }
  const int jr[2] = {j0 + warp * 16 + (lane >> 2), j0 + warp * 16 +
                                                        (lane >> 2) + 8};
  const bf16* Kw = Ks + warp * 16 * LD;
  const bf16* Vw = Vs + warp * 16 * LD;
  cs::cp_async_wait<0>();
  __syncthreads();

  for (int t = t0, it = 0; t < n_steps; t += G, ++it) {
    const int buf = it & 1;
    if (t + G < n_steps) {
      stage(t + G, buf ^ 1);
      cs::cp_async_commit();
      cs::cp_async_wait<1>();
    } else {
      cs::cp_async_wait<0>();
    }
    group_sync(grp);
    const bf16* Qb = Qs + buf * BQ * LD;
    const bf16* dOb = dOs + buf * BQ * LD;
    const float* Lb = Ls + buf * BQ;
    const float* Db = Ds + buf * BQ;
    const int* Mb = Lims + buf * BQ;

    float p[BQ / 8][4], ds[BQ / 8][4];
    mma_rows_by_rows<HD, BQ>(p, Kw, Qb, LD, lane);
    mma_rows_by_rows<HD, BQ>(ds, Vw, dOb, LD, lane);
#pragma unroll
    for (int n = 0; n < BQ / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + (lane & 3) * 2 + (e & 1);
        const float pe = jr[e >> 1] <= Mb[c]
                             ? expf(p[n][e] * a.scale - Lb[c])
                             : 0.0f;
        p[n][e] = pe;
        ds[n][e] = pe * (ds[n][e] - Db[c]);
      }
    }
    float part[HD / 8][4];
    zero_tiles(part);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mma_split_rows<HD>(part, p[2 * kk], p[2 * kk + 1],
                         dOb + kk * 16 * LD, LD, lane);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dv_sum[(n * 4 + e) * 32] += part[n][e];
    }
    zero_tiles(part);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk) {
      mma_split_rows<HD>(part, ds[2 * kk], ds[2 * kk + 1],
                         Qb + kk * 16 * LD, LD, lane);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) dk_sum[(n * 4 + e) * 32] += part[n][e];
    }
    group_sync(grp);
  }
  __syncthreads();
  if (grp != 0) return;

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int j = jr[i];
    if (j >= a.skv) continue;
    const size_t off = kv_row(a, bi, kvh, j, HD);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      float x[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // dk0, dk1, dv0, dv1 of (row i, columns d, d + 1)
        const int e = (n * 4 + 2 * i + (u & 1)) * 32 + (u >> 1) * SUMS;
        x[u] = dk_sum[e];
#pragma unroll
        for (int h = 1; h < G; ++h) x[u] += dk_sum[e + h * 2 * SUMS];
      }
      store_pair(dk, off + d, x[0] * a.scale, x[1] * a.scale, bf16_out);
      store_pair(dv, off + d, x[2], x[3], bf16_out);
    }
  }
}

// dQ of a tile of query rows.  Grid (b * hkv, row tiles): S = Q K^T, P
// from lse, dP = dO V^T, dS = P (dP - D), dQ += dS K over the KV tiles
// the rows reach; dq (scaled) is written in q's layout, in f32 or,
// where `bf16_out`, rounded to bf16.
template <int HD>
__global__ void __launch_bounds__(kThreads)
    bwd_q_kernel(Shape a, const bf16* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ D,
                 void* __restrict__ dq, int bf16_out) {
  constexpr int LD = HD + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kRows * LD;
  bf16* Ks = dOs + kRows * LD;       // two buffers
  bf16* Vs = Ks + 2 * kKeys * LD;    // two buffers
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int bi = blockIdx.x / a.hkv, kvh = blockIdx.x % a.hkv;
  const int r0 = first_row(), R = a.sq * a.g;
  const int n_tiles = kv_tiles(a, r0);
  const size_t lse_base = ((size_t)bi * a.hkv + kvh) * R;

  load_tile<HD, kRows>(Qs, a.q, a, bi, kvh, r0, R, true);
  load_tile<HD, kRows>(dOs, dout, a, bi, kvh, r0, R, true);
  load_tile<HD, kKeys>(Ks, a.k, a, bi, kvh, 0, a.skv, false);
  load_tile<HD, kKeys>(Vs, a.v, a, bi, kvh, 0, a.skv, false);
  cs::cp_async_commit();

  int rows[2], lim[2];
  float L[2], Dr[2];
  rows[0] = r0 + warp * 16 + (lane >> 2);
  rows[1] = rows[0] + 8;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lim[i] = key_limit(a, rows[i]);
    const bool in = rows[i] < R;
    L[i] = in ? lse[lse_base + rows[i]] : INFINITY;
    Dr[i] = in ? D[lse_base + rows[i]] : 0.0f;
  }
  float acc[HD / 8][4];
  zero_tiles(acc);
  const bf16* Qw = Qs + warp * 16 * LD;
  const bf16* dOw = dOs + warp * 16 * LD;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      const int nb = (t + 1) & 1;
      load_tile<HD, kKeys>(Ks + nb * kKeys * LD, a.k, a, bi, kvh,
                           (t + 1) * kKeys, a.skv, false);
      load_tile<HD, kKeys>(Vs + nb * kKeys * LD, a.v, a, bi, kvh,
                           (t + 1) * kKeys, a.skv, false);
      cs::cp_async_commit();
      cs::cp_async_wait<1>();
    } else {
      cs::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kb = Ks + buf * kKeys * LD;
    const bf16* Vb = Vs + buf * kKeys * LD;

    float p[kKeys / 8][4], ds[kKeys / 8][4];
    mma_rows_by_rows<HD, kKeys>(p, Qw, Kb, LD, lane);
    mma_rows_by_rows<HD, kKeys>(ds, dOw, Vb, LD, lane);
    const int j0 = t * kKeys;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int j = j0 + n * 8 + (lane & 3) * 2 + (e & 1);
        const float pe =
            j <= lim[i] ? expf(p[n][e] * a.scale - L[i]) : 0.0f;
        ds[n][e] = pe * (ds[n][e] - Dr[i]);
      }
    }
    float part[HD / 8][4];
    zero_tiles(part);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      mma_split_rows<HD>(part, ds[2 * kk], ds[2 * kk + 1],
                         Kb + kk * 16 * LD, LD, lane);
    }
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = rows[i];
    if (r >= R) continue;
    const size_t off = q_row(a, bi, kvh, r, HD);
#pragma unroll
    for (int n = 0; n < HD / 8; ++n) {
      const int d = n * 8 + (lane & 3) * 2;
      store_pair(dq, off + d, acc[n][2 * i] * a.scale,
                 acc[n][2 * i + 1] * a.scale, bf16_out);
    }
  }
}

template <int HD>
constexpr size_t fwd_smem() {
  return (size_t)(kRows + 4 * kKeys) * (HD + 8) * sizeof(bf16);
}
template <int HD>
constexpr size_t bwd_kv_smem() {
  constexpr int BQ = kv_step_rows<HD>(), G = kv_groups<HD>();
  return (size_t)(2 * kKeys + G * 4 * BQ) * (HD + 8) * sizeof(bf16) +
         (size_t)G * 6 * BQ * sizeof(float) +
         (size_t)G * 2 * (kThreads / 32) * (HD / 8) * 4 * 32 * sizeof(float);
}
template <int HD>
constexpr size_t bwd_q_smem() {
  return (size_t)(2 * kRows + 4 * kKeys) * (HD + 8) * sizeof(bf16);
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

Shape shape_of(const void* q, const void* k, const void* v, int b, int sq,
               int skv, int hq, int hkv, int causal, int q_offset,
               float scale) {
  Shape a;
  a.q = static_cast<const bf16*>(q);
  a.k = static_cast<const bf16*>(k);
  a.v = static_cast<const bf16*>(v);
  a.b = b;
  a.sq = sq;
  a.skv = skv;
  a.hq = hq;
  a.hkv = hkv;
  a.g = hq / hkv;
  a.causal = causal;
  a.q_offset = q_offset;
  a.scale = scale;
  return a;
}

bool valid(int b, int sq, int skv, int hq, int hkv, int q_offset) {
  if (b <= 0 || sq <= 0 || skv <= 0 || hkv <= 0 || hq % hkv != 0 ||
      q_offset < 0) {
    return false;
  }
  const long long rows = (long long)sq * (hq / hkv);
  return (rows + kRows - 1) / kRows <= 65535 &&
         (skv + kKeys - 1) / kKeys <= 65535;
}

template <int HD>
int fwd(const Shape& a, float* o, bf16* out, float* lse, cudaStream_t st) {
  const size_t smem = fwd_smem<HD>();
  cudaError_t e = allow_smem(fwd_kernel<HD>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(a.b * a.hkv, (a.sq * a.g + kRows - 1) / kRows);
  fwd_kernel<HD><<<grid, kThreads, smem, st>>>(a, o, out, lse);
  return (int)cudaGetLastError();
}

template <int HD>
int bwd(const Shape& a, const float* o, const bf16* dout, const float* lse,
        float* D, void* dq, void* dk, void* dv, int bf16_out,
        cudaStream_t st) {
  const long long rows = (long long)a.b * a.hkv * a.sq * a.g;
  dot_kernel<HD><<<(unsigned)((rows + 7) / 8), 256, 0, st>>>(a, o, dout, D);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t kv_smem = bwd_kv_smem<HD>();
  e = allow_smem(bwd_kv_kernel<HD>, kv_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 kv_grid(a.b * a.hkv, (a.skv + kKeys - 1) / kKeys);
  bwd_kv_kernel<HD><<<kv_grid, kThreads * kv_groups<HD>(), kv_smem, st>>>(
      a, dout, lse, D, dk, dv, bf16_out);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const size_t q_smem = bwd_q_smem<HD>();
  e = allow_smem(bwd_q_kernel<HD>, q_smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 q_grid(a.b * a.hkv, (a.sq * a.g + kRows - 1) / kRows);
  bwd_q_kernel<HD><<<q_grid, kThreads, q_smem, st>>>(a, dout, lse, D, dq,
                                                     bf16_out);
  return (int)cudaGetLastError();
}

}  // namespace

// q (b, sq, hq, hd), k and v (b, skv, hkv, hd) bf16, contiguous; writes
// o (f32) and out (bf16) in q's layout and lse (b, hkv, sq * hq / hkv).
extern "C" int flash_attn_fwd_launch(const void* q, const void* k,
                                     const void* v, float* o, void* out,
                                     float* lse, int b, int sq, int skv,
                                     int hq, int hkv, int hd, int causal,
                                     int q_offset, float scale,
                                     void* stream) {
  if (!valid(b, sq, skv, hq, hkv, q_offset)) {
    return (int)cudaErrorInvalidValue;
  }
  const Shape a = shape_of(q, k, v, b, sq, skv, hq, hkv, causal, q_offset,
                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf16* ob = static_cast<bf16*>(out);
  if (hd == 64) return fwd<64>(a, o, ob, lse, st);
  if (hd == 128) return fwd<128>(a, o, ob, lse, st);
  return (int)cudaErrorInvalidValue;
}

// The backward of flash_attn_fwd_launch: dout bf16 in q's layout, o and
// lse as the forward wrote them, D scratch of lse's size; writes dq (q's
// layout), dk and dv (k's layout), f32 or, where bf16_out, bf16.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const float* o,
                                     const void* dout, const float* lse,
                                     float* D, void* dq, void* dk, void* dv,
                                     int b, int sq, int skv, int hq, int hkv,
                                     int hd, int causal, int q_offset,
                                     float scale, int bf16_out,
                                     void* stream) {
  if (!valid(b, sq, skv, hq, hkv, q_offset)) {
    return (int)cudaErrorInvalidValue;
  }
  const Shape a = shape_of(q, k, v, b, sq, skv, hq, hkv, causal, q_offset,
                           scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16* dob = static_cast<const bf16*>(dout);
  if (hd == 64) return bwd<64>(a, o, dob, lse, D, dq, dk, dv, bf16_out, st);
  if (hd == 128) return bwd<128>(a, o, dob, lse, D, dq, dk, dv, bf16_out, st);
  return (int)cudaErrorInvalidValue;
}
