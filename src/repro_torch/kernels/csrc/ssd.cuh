// The Mamba2 SSD's chunked scan (B14): the forward and a deterministic
// backward over bf16 x, B, C, with the plain form's f32 precision.
//
// Replaces no TPU kernel: the reference's SSD
// (src/repro/models/mamba.py::ssd_chunked) is XLA einsums, and the port's
// plain form (repro_torch/models/mamba.py::ssd_chunked) runs them as f32
// passes over (b, chunks, heads, L, L) tensors, each through device
// memory (2.1 GB each at granite's 2 x 8,192 tokens, 128 heads, L 256).
// Here the (L, L) matrices live in registers a 64 x 64 tile at a time and
// never reach memory.  The stages follow the SSD paper's decomposition
// (repro_torch/kernels/ssd.py: ssd_fwd_plain, ssd_bwd_plain):
//
//   forward   state_kernel  a block a (b, c, h): the in-chunk cumsum of
//                           la (Acs), w = exp(T - Acs) dt rounded to bf16,
//                           w x rounded to bf16, its product with B: the
//                           chunk's own state term U (p x n)
//             pass_kernel   the state before each chunk (in U's place)
//                           and h_final: h = exp(T) h + U, chunk by chunk
//             scan_kernel   a block a (b, c, h, 64 rows): y = round(M) x
//                           + exp(Acs) C h_before; M's tiles (C B^T times
//                           the decays and dt) are formed in registers,
//                           tiles above the diagonal skipped
//   backward  dstate_kernel V = sum_i exp(Acs_i) dy_i (x) C_i, and the
//                           log-decays' gradient through exp(Acs) C h
//             dpass_kernel  the reverse pass: dU (the gradient of each
//                           chunk's U, in V's place), dh0, and h's share
//                           of the gradient of the chunk's total decay
//             dcb_kernel    C B^T's gradient summed over 16 heads
//             dchunk_kernel a block a (b, c, h, 64 columns): dx, ddt and
//                           the log-decays' gradient from M and w
//             dbc_kernel    dC and dB, summed over the heads (second pass
//                           over dcb_kernel's partial sums)
//             dla_kernel    the reverse cumsum that gives dla
//
// Precision.  x, B and C are bf16, so C B^T and round(M) x take one MMA
// (mma.sync m16n8k16, bf16 in, f32 sums) each; M is formed in f32 and
// rounded to bf16, w and w x are rounded as the plain form rounds them.
// Every product with an f32 operand (C h, dy's products, dU's, the
// gradient of C B^T) takes it as the exact three-term bf16 split hi +
// mid + lo, three MMAs; dC's sum of exp(Acs) dy h has two f32 operands
// and takes the six split products whose sum is the f32 product to f32
// accuracy.  The states recur in f32; exp is the full-accuracy expf
// (built with --fmad=false, no fast math).  Above the diagonal no
// exponent is formed (the plain form zeroes those exponents before its
// exp), so no overflow reaches a gradient.  The backward keeps in f32
// what autograd rounds to bf16 on the plain form: the gradient of M (the
// backward of M's cast) and of w x (the backward of its cast and of the
// bf16 product); dx, dB and dC are each one f32 sum rounded once to
// bf16, where the plain form sums bf16 parts.  Each MMA chain covers one
// 64-wide tile or one head and starts from zero; the f32 units add the
// chains, as the plain form adds its einsums.
//
// No atomics: every sum over heads or tiles runs in a fixed order (dB
// and dC over dcb_kernel's head-group partials, then over the heads in
// order), so two calls give the same bits.
//
// Bound on the H100, at granite's cell (2 x 8,192 tokens, 128 heads of
// 64, n 128, L 256): a forward needs 1.12 GB of traffic (x, dt, la, B, C,
// h0 read once; y, h_final, the states and Acs written once), 0.34 ms at
// 3.35 TB/s, and 0.10 TFLOP of products (0.1 ms), so memory bounds it; a
// backward needs 1.39 GB (0.42 ms) and 0.21 TFLOP.  The design runs
// more products: C B^T again for every head, three MMAs for each split
// f32 operand, six for dC's; about 0.26 TFLOP of mma.sync a forward and
// 1.1 a backward.  Its blocks hold 64-row tiles of one head, two or three to
// an SM, and wait on their loads: the next tile's copy (cp.async, or
// registers for an f32 tile that is split) overlaps the products where
// shared memory allows (scan, dchunk, dbc), and the passes over the
// chunks load eight chunks ahead.
#pragma once

#include "cs_common.cuh"

namespace ssd_cuda {

using bf16 = __nv_bfloat16;

constexpr int kP = 64;            // head dim
constexpr int kT = 64;            // rows of a tile
constexpr int kThreads = 128;     // four warps, sixteen rows each
constexpr int kGroup = 16;        // heads a dcb_kernel block sums
constexpr int kPassThreads = 256; // a pass block: 1,024 state elements
constexpr int kAhead = 8;         // chunks a pass thread loads at once
constexpr int LDX = kP + 8;       // shared row of a 64-wide bf16 tile

struct Args {
  const bf16* x;       // (b, s, h, p)
  const float* dt;     // (b, s, h)
  const float* la;     // (b, s, h)
  const bf16* B;       // (b, s, n)
  const bf16* C;       // (b, s, n)
  const float* h0;     // (b, h, p, n)
  float* y;            // (b, s, h, p)
  float* hT;           // (b, h, p, n)
  float* states;       // (b, c, h, p, n)
  float* Acs;          // (b, c, h, L)
  // backward
  const float* dy;     // (b, s, h, p)
  const float* dhT;    // (b, h, p, n) or null
  bf16* dx;            // or null
  float* ddt;          // or null
  float* dla;          // or null
  bf16* dB;            // or null
  bf16* dC;            // or null
  float* dh0;          // or null
  float* V;            // (b, c, h, p, n): V, then dU
  float* dAq;          // (b, c, h, L)
  float* dTs;          // (b, h, c, slices)
  float* dCB;          // (b, c, groups, L, L)
  float* dA;           // (b, c, h, tiles, L)
  float* dT;           // (b, c, h, tiles)
  int b, s, H, nc, groups;
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

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return pack(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The exact split of x into hi + mid + lo bf16 parts.
__device__ __forceinline__ void split3(float x, bf16& hi, bf16& mid,
                                       bf16& lo) {
  hi = __float2bfloat16_rn(x);
  const float r = x - __bfloat162float(hi);
  mid = __float2bfloat16_rn(r);
  lo = __float2bfloat16_rn(r - __bfloat162float(mid));
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) x[n][0] = x[n][1] = x[n][2] = x[n][3] = 0.0f;
}

template <int N>
__device__ __forceinline__ void add_to(float (&acc)[N][4],
                                       const float (&part)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
  }
}

// acc (16 x N) += A (16 x K) B (K x N), both bf16 in shared memory.
// A's element (m, k) is a[m * lda + k], or a[k * lda + m] where AT; B's
// element (k, n) is b[n * ldb + k], or b[k * ldb + n] where BT.
template <int N, int K, bool AT, bool BT>
__device__ __forceinline__ void mma_ss(float (&acc)[N / 8][4], const bf16* a,
                                       int lda, const bf16* b, int ldb,
                                       int lane) {
  const int r = lane & 7, q = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t af[4];
    if constexpr (AT) {
      ldsm_x4_t(af, a + (kk * 16 + (q >> 1) * 8 + r) * lda + (q & 1) * 8);
    } else {
      ldsm_x4(af, a + ((q & 1) * 8 + r) * lda + kk * 16 + (q >> 1) * 8);
    }
#pragma unroll
    for (int n2 = 0; n2 < N / 16; ++n2) {
      uint32_t bf[4];
      if constexpr (BT) {
        ldsm_x4_t(bf, b + (kk * 16 + (q & 1) * 8 + r) * ldb + n2 * 16 +
                          (q >> 1) * 8);
      } else {
        ldsm_x4(bf, b + (n2 * 16 + (q >> 1) * 8 + r) * ldb + kk * 16 +
                        (q & 1) * 8);
      }
      mma(acc[2 * n2], af, bf[0], bf[1]);
      mma(acc[2 * n2 + 1], af, bf[2], bf[3]);
    }
  }
}

// acc (16 x N) += A (16 x K, fragments in registers) B (as in mma_ss).
template <int N, int K, bool BT>
__device__ __forceinline__ void mma_rs(float (&acc)[N / 8][4],
                                       const uint32_t (&af)[K / 16][4],
                                       const bf16* b, int ldb, int lane) {
  const int r = lane & 7, q = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
#pragma unroll
    for (int n2 = 0; n2 < N / 16; ++n2) {
      uint32_t bf[4];
      if constexpr (BT) {
        ldsm_x4_t(bf, b + (kk * 16 + (q & 1) * 8 + r) * ldb + n2 * 16 +
                          (q >> 1) * 8);
      } else {
        ldsm_x4(bf, b + (n2 * 16 + (q >> 1) * 8 + r) * ldb + kk * 16 +
                        (q & 1) * 8);
      }
      mma(acc[2 * n2], af[kk], bf[0], bf[1]);
      mma(acc[2 * n2 + 1], af[kk], bf[2], bf[3]);
    }
  }
}

// The A fragments of a 16 x K f32 accumulator tile, rounded to bf16.
template <int K>
__device__ __forceinline__ void to_a(uint32_t (&af)[K / 16][4],
                                     const float (&c)[K / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    af[kk][0] = pack2(c[2 * kk][0], c[2 * kk][1]);
    af[kk][1] = pack2(c[2 * kk][2], c[2 * kk][3]);
    af[kk][2] = pack2(c[2 * kk + 1][0], c[2 * kk + 1][1]);
    af[kk][3] = pack2(c[2 * kk + 1][2], c[2 * kk + 1][3]);
  }
}

// ROWS rows of COLS bf16 at g (gld elements a row) into s (COLS + 8 a
// row), by cp.async: the caller commits and waits.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_bf16(bf16* s, const bf16* g,
                                          size_t gld) {
  constexpr int LD = COLS + 8, CH = COLS / 8;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += blockDim.x) {
    const int r = idx / CH, c = idx % CH;
    cs::cp_async16(s + r * LD + c * 8, g + r * gld + c * 8);
  }
}

__device__ __forceinline__ void store4(bf16* s, const bf16 (&v)[4]) {
  *reinterpret_cast<uint2*>(s) = make_uint2(pack(v[0], v[1]),
                                            pack(v[2], v[3]));
}

// Four f32 values split into hi, mid and lo at s, s + plane, s + 2 plane.
__device__ __forceinline__ void store_split(bf16* s, int plane, float4 v) {
  bf16 hi[4], mid[4], lo[4];
  split3(v.x, hi[0], mid[0], lo[0]);
  split3(v.y, hi[1], mid[1], lo[1]);
  split3(v.z, hi[2], mid[2], lo[2]);
  split3(v.w, hi[3], mid[3], lo[3]);
  store4(s, hi);
  store4(s + plane, mid);
  store4(s + 2 * plane, lo);
}

// ROWS rows of COLS f32 at g (gld elements a row), times scale[r] where
// scale is given, split into three bf16 planes of ROWS x (COLS + 8) at s:
// hi, mid, lo.
template <int ROWS, int COLS>
__device__ __forceinline__ void load_split(bf16* s, const float* g,
                                           size_t gld, const float* scale) {
  constexpr int LD = COLS + 8, CH = COLS / 4, PLANE = ROWS * LD;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += blockDim.x) {
    const int r = idx / CH, c = (idx % CH) * 4;
    float4 v = *reinterpret_cast<const float4*>(g + r * gld + c);
    if (scale != nullptr) {
      const float sc = scale[r];
      v.x = sc * v.x;
      v.y = sc * v.y;
      v.z = sc * v.z;
      v.w = sc * v.w;
    }
    store_split(s + r * LD + c, PLANE, v);
  }
}

// acc (16 x N) += A B with A's three planes (a, plane apart) and one
// bf16 B: lo, mid, hi in turn.
template <int N, int K, bool AT, bool BT>
__device__ __forceinline__ void mma_split_a(float (&acc)[N / 8][4],
                                            const bf16* a, int plane,
                                            int lda, const bf16* b, int ldb,
                                            int lane) {
#pragma unroll
  for (int pl = 2; pl >= 0; --pl) {
    mma_ss<N, K, AT, BT>(acc, a + pl * plane, lda, b, ldb, lane);
  }
}

// acc (16 x N) += A B with one bf16 A and B's three planes.
template <int N, int K, bool AT, bool BT>
__device__ __forceinline__ void mma_split_b(float (&acc)[N / 8][4],
                                            const bf16* a, int lda,
                                            const bf16* b, int plane,
                                            int ldb, int lane) {
#pragma unroll
  for (int pl = 2; pl >= 0; --pl) {
    mma_ss<N, K, AT, BT>(acc, a, lda, b + pl * plane, ldb, lane);
  }
}

// A 16 x N accumulator tile to rows row0 + (0..15) of out (f32, ld).
template <int N>
__device__ __forceinline__ void store_acc(float* out, size_t ld,
                                          const float (&acc)[N / 8][4],
                                          int row0, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < N / 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const size_t off = (size_t)(row0 + g + 8 * half) * ld + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + off) =
          make_float2(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// The inclusive cumsum of L values at la (stride apart) by one warp, to
// As (shared) and out: each lane sums L / 32 in order, then the lanes'
// totals are scanned.
template <int L>
__device__ __forceinline__ void chunk_cumsum(float* As, const float* la,
                                             size_t stride, float* out) {
  constexpr int E = L / 32;
  const int lane = threadIdx.x & 31;
  float v[E], run = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += la[(size_t)(lane * E + e) * stride];
    v[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc = o + inc;
  }
  float pre = __shfl_up_sync(0xffffffffu, inc, 1);
  if (lane == 0) pre = 0.0f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const float a = lane == 0 ? v[e] : pre + v[e];
    As[lane * E + e] = a;
    out[lane * E + e] = a;
  }
}

// bf16 elements of scan_kernel's region: h's three planes, or two
// buffers of a B tile and an x tile, whichever is larger.
template <int N>
__host__ __device__ constexpr int scan_region() {
  constexpr int planes = 3 * kP * (N + 8), bufs = 2 * kT * (N + 8 + LDX);
  return planes > bufs ? planes : bufs;
}

// bf16 elements of dchunk_kernel's region: dU's three planes, or two
// buffers of a C tile and dy's three planes, whichever is larger.
template <int N>
__host__ __device__ constexpr int dchunk_region() {
  constexpr int planes = 3 * kP * (N + 8), tiles = 2 * kT * (N + 8) + 3 * kT * LDX;
  return planes > tiles ? planes : tiles;
}

__device__ __forceinline__ size_t row_of(const Args& a, int bi, int c,
                                         int L) {
  return (size_t)bi * a.s + (size_t)c * L;
}

// ----------------------------------------------------------------- forward
// Grid (c, h, b).  U = (round(round(w) x))^T B to a.states, Acs.
template <int L, int N>
__global__ void __launch_bounds__(kThreads) state_kernel(Args a) {
  constexpr int LDN = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ws = reinterpret_cast<bf16*>(smem);           // L x LDX: w x
  bf16* Bs = Ws + L * LDX;                            // L x LDN
  float* As = reinterpret_cast<float*>(Bs + L * LDN);  // L
  float* Wr = As + L;                                  // L: round(w)
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t row0 = row_of(a, bi, c, L);
  const size_t ch = ((size_t)bi * a.nc + c) * a.H + h;
  load_bf16<L, N>(Bs, a.B + row0 * N, N);
  cs::cp_async_commit();
  if (warp == 0) chunk_cumsum<L>(As, a.la + row0 * a.H + h, a.H, a.Acs + ch * L);
  __syncthreads();
  const float T = As[L - 1];
  for (int j = threadIdx.x; j < L; j += kThreads) {
    Wr[j] = round_bf16(expf(T - As[j]) * a.dt[(row0 + j) * a.H + h]);
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < L * (kP / 8); idx += kThreads) {
    const int j = idx / (kP / 8), c8 = (idx % (kP / 8)) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(
        a.x + ((row0 + j) * a.H + h) * kP + c8);
    const bf16* xv = reinterpret_cast<const bf16*>(&v);
    const float w = Wr[j];
    uint4 o;
    uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      ov[e] = pack2(w * __bfloat162float(xv[2 * e]),
                    w * __bfloat162float(xv[2 * e + 1]));
    }
    *reinterpret_cast<uint4*>(Ws + j * LDX + c8) = o;
  }
  cs::cp_async_wait<0>();
  __syncthreads();
  float acc[N / 8][4], part[N / 8][4];
  zero(acc);
#pragma unroll 1
  for (int kt = 0; kt < L / kT; ++kt) {
    zero(part);
    mma_ss<N, kT, true, true>(part, Ws + kt * kT * LDX + warp * 16, LDX,
                              Bs + kt * kT * LDN, LDN, lane);
    add_to(acc, part);
  }
  store_acc<N>(a.states + ch * kP * N, N, acc, warp * 16, lane);
}

// Grid (slices, b * h): each thread four elements of the (p, n) state,
// kAhead chunks' U loaded before any is replaced (a chain of single loads
// would leave the memory idle).  The state before each chunk replaces its
// U; h_final to a.hT.
template <int L, int N>
__global__ void __launch_bounds__(kPassThreads) pass_kernel(Args a) {
  constexpr size_t PN = (size_t)kP * N;
  const int bh = blockIdx.y, bi = bh / a.H, h = bh % a.H;
  const size_t e = ((size_t)blockIdx.x * kPassThreads + threadIdx.x) * 4;
  float4 cur = *reinterpret_cast<const float4*>(a.h0 + bh * PN + e);
#pragma unroll 1
  for (int c0 = 0; c0 < a.nc; c0 += kAhead) {
    float4 u[kAhead];
    float d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < a.nc) {
        const size_t ch = ((size_t)bi * a.nc + c0 + k) * a.H + h;
        u[k] = *reinterpret_cast<const float4*>(a.states + ch * PN + e);
        d[k] = expf(a.Acs[ch * L + L - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < a.nc) {
        const size_t ch = ((size_t)bi * a.nc + c0 + k) * a.H + h;
        *reinterpret_cast<float4*>(a.states + ch * PN + e) = cur;
        cur.x = d[k] * cur.x + u[k].x;
        cur.y = d[k] * cur.y + u[k].y;
        cur.z = d[k] * cur.z + u[k].z;
        cur.w = d[k] * cur.w + u[k].w;
      }
    }
  }
  *reinterpret_cast<float4*>(a.hT + bh * PN + e) = cur;
}

// Grid (row tiles, h, b * c), the tiles with the most work first.
// y = round(M) x + exp(Acs) C h_before for 64 rows i of one head.  Once
// C h_before is formed, the region of h's planes holds two buffers of B
// and x tiles: the next tile's copy overlaps this tile's products.
template <int L, int N>
__global__ void __launch_bounds__(kThreads) scan_kernel(Args a) {
  constexpr int LDN = N + 8, NT = L / kT;
  constexpr int BUF = kT * LDN + kT * LDX;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Cs = reinterpret_cast<bf16*>(smem);   // kT x LDN
  bf16* Rs = Cs + kT * LDN;                   // h's planes, then B/x buffers
  float* As = reinterpret_cast<float*>(Rs + scan_region<N>());  // L
  float* Ds = As + L;                                          // L
  const int it = NT - 1 - blockIdx.x, h = blockIdx.y;
  const int bi = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = row_of(a, bi, c, L);
  const size_t ch = ((size_t)bi * a.nc + c) * a.H + h;
  load_bf16<kT, N>(Cs, a.C + (row0 + it * kT) * N, N);
  cs::cp_async_commit();
  for (int j = threadIdx.x; j < L; j += kThreads) {
    As[j] = a.Acs[ch * L + j];
    Ds[j] = a.dt[(row0 + j) * a.H + h];
  }
  load_split<kP, N>(Rs, a.states + ch * kP * N, N, nullptr);
  cs::cp_async_wait<0>();
  __syncthreads();

  // C h_before (rows i, columns p)
  float q[kP / 8][4];
  zero(q);
  mma_split_b<kP, N, false, false>(q, Cs + warp * 16 * LDN, LDN, Rs,
                                   kP * LDN, LDN, lane);
  __syncthreads();   // h's planes are read

  auto stage = [&](int jt) {
    bf16* Bs = Rs + (jt & 1) * BUF;
    load_bf16<kT, N>(Bs, a.B + (row0 + jt * kT) * N, N);
    load_bf16<kT, kP>(Bs + kT * LDN, a.x + ((row0 + jt * kT) * a.H + h) * kP,
                      (size_t)a.H * kP);
    cs::cp_async_commit();
  };
  stage(0);
  float y[kP / 8][4];
  zero(y);
  const int i0 = it * kT + warp * 16 + g;
#pragma unroll 1
  for (int jt = 0; jt <= it; ++jt) {
    if (jt < it) {
      stage(jt + 1);
      cs::cp_async_wait<1>();
    } else {
      cs::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Bs = Rs + (jt & 1) * BUF;
    const bf16* Xs = Bs + kT * LDN;
    float m[kT / 8][4];
    zero(m);
    mma_ss<kT, N, false, false>(m, Cs + warp * 16 * LDN, LDN, Bs, LDN, lane);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + 8 * (e >> 1);
        const int j = jt * kT + nt * 8 + 2 * t + (e & 1);
        m[nt][e] = j <= i ? expf(As[i] - As[j]) * (m[nt][e] * Ds[j]) : 0.0f;
      }
    }
    uint32_t af[kT / 16][4];
    to_a<kT>(af, m);
    float part[kP / 8][4];
    zero(part);
    mma_rs<kP, kT, true>(part, af, Xs, LDX, lane);
    add_to(y, part);
    __syncthreads();   // this buffer is read before it is loaded again
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + 8 * half;
    const float G = expf(As[i]);
    float* out = a.y + ((row0 + i) * a.H + h) * kP;
#pragma unroll
    for (int nt = 0; nt < kP / 8; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(out + col) =
          make_float2(y[nt][2 * half] + G * q[nt][2 * half],
                      y[nt][2 * half + 1] + G * q[nt][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------- backward
// Grid (c, h, b).  V = sum_i exp(Acs_i) dy_i (x) C_i (p x n) to a.V, and
// dAq_i = exp(Acs_i) sum_p dy_ip (C h_before)_ip.
template <int L, int N>
__global__ void __launch_bounds__(kThreads) dstate_kernel(Args a) {
  constexpr int LDN = N + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Hs = reinterpret_cast<bf16*>(smem);   // three planes kP x LDN
  bf16* Cs = Hs + 3 * kP * LDN;               // kT x LDN
  bf16* Ys = Cs + kT * LDN;                   // three planes kT x LDX
  float* Gs = reinterpret_cast<float*>(Ys + 3 * kT * LDX);  // L
  const int c = blockIdx.x, h = blockIdx.y, bi = blockIdx.z;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = row_of(a, bi, c, L);
  const size_t ch = ((size_t)bi * a.nc + c) * a.H + h;
  for (int j = threadIdx.x; j < L; j += kThreads) {
    Gs[j] = expf(a.Acs[ch * L + j]);
  }
  load_split<kP, N>(Hs, a.states + ch * kP * N, N, nullptr);
  __syncthreads();
  float v[N / 8][4];
  zero(v);
#pragma unroll 1
  for (int kt = 0; kt < L / kT; ++kt) {
    if (kt > 0) __syncthreads();
    load_bf16<kT, N>(Cs, a.C + (row0 + kt * kT) * N, N);
    cs::cp_async_commit();
    load_split<kT, kP>(Ys, a.dy + ((row0 + kt * kT) * a.H + h) * kP,
                       (size_t)a.H * kP, Gs + kt * kT);
    cs::cp_async_wait<0>();
    __syncthreads();
    {
      float part[N / 8][4];
      zero(part);
      mma_split_a<N, kT, true, true>(part, Ys + warp * 16, kT * LDX, LDX, Cs,
                                     LDN, lane);
      add_to(v, part);
    }
    float q[kP / 8][4];
    zero(q);
    mma_split_b<kP, N, false, false>(q, Cs + warp * 16 * LDN, LDN, Hs,
                                     kP * LDN, LDN, lane);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = kt * kT + warp * 16 + g + 8 * half;
      const float* dy = a.dy + ((row0 + i) * a.H + h) * kP;
      float sum = 0.0f;
#pragma unroll
      for (int nt = 0; nt < kP / 8; ++nt) {
        const float2 d = *reinterpret_cast<const float2*>(dy + nt * 8 + 2 * t);
        sum += d.x * q[nt][2 * half];
        sum += d.y * q[nt][2 * half + 1];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (t == 0) a.dAq[ch * L + i] = Gs[i] * sum;
    }
  }
  store_acc<N>(a.V + ch * kP * N, N, v, warp * 16, lane);
}

// Grid (slices, b * h).  The reverse pass, kAhead chunks' V and states
// loaded at once: g = dhT; for each chunk, from the last, dU = g replaces
// V, dTs gets this slice's sum of g h_before, and g = exp(T) g + V.
// dh0 = g at the end.
template <int L, int N>
__global__ void __launch_bounds__(kPassThreads) dpass_kernel(Args a) {
  constexpr size_t PN = (size_t)kP * N;
  __shared__ float red[2][kAhead][kPassThreads / 32];
  const int bh = blockIdx.y, bi = bh / a.H, h = bh % a.H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t e = ((size_t)blockIdx.x * kPassThreads + threadIdx.x) * 4;
  float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (a.dhT != nullptr) g = *reinterpret_cast<const float4*>(a.dhT + bh * PN + e);
#pragma unroll 1
  for (int c0 = a.nc - 1, grp = 0; c0 >= 0; c0 -= kAhead, ++grp) {
    float4 v[kAhead], hb[kAhead];
    float d[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 - k >= 0) {
        const size_t ch = ((size_t)bi * a.nc + c0 - k) * a.H + h;
        v[k] = *reinterpret_cast<const float4*>(a.V + ch * PN + e);
        hb[k] = *reinterpret_cast<const float4*>(a.states + ch * PN + e);
        d[k] = expf(a.Acs[ch * L + L - 1]);
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 - k >= 0) {
        const size_t ch = ((size_t)bi * a.nc + c0 - k) * a.H + h;
        *reinterpret_cast<float4*>(a.V + ch * PN + e) = g;
        float s = g.x * hb[k].x + g.y * hb[k].y + g.z * hb[k].z +
                  g.w * hb[k].w;
#pragma unroll
        for (int w = 16; w > 0; w >>= 1) {
          s += __shfl_xor_sync(0xffffffffu, s, w);
        }
        if (lane == 0) red[grp & 1][k][warp] = s;
        g.x = d[k] * g.x + v[k].x;
        g.y = d[k] * g.y + v[k].y;
        g.z = d[k] * g.z + v[k].z;
        g.w = d[k] * g.w + v[k].w;
      }
    }
    __syncthreads();
    if (threadIdx.x < kAhead && c0 - (int)threadIdx.x >= 0) {
      float sum = 0.0f;
#pragma unroll
      for (int w = 0; w < kPassThreads / 32; ++w) {
        sum += red[grp & 1][threadIdx.x][w];
      }
      a.dTs[((size_t)bh * a.nc + c0 - threadIdx.x) * gridDim.x + blockIdx.x] =
          sum;
    }
  }
  if (a.dh0 != nullptr) *reinterpret_cast<float4*>(a.dh0 + bh * PN + e) = g;
}

// Grid (tile pairs it >= jt, head groups, b * c).  The gradient of C B^T
// on tile (it, jt), summed over the group's heads in order:
// sum_h (dM_ij exp(Acs_i - Acs_j)) dt_j, dM = dy x^T (j <= i).
template <int L>
__global__ void __launch_bounds__(kThreads) dcb_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ys = reinterpret_cast<bf16*>(smem);   // three planes kT x LDX
  bf16* Xs = Ys + 3 * kT * LDX;               // kT x LDX
  float* Ai = reinterpret_cast<float*>(Xs + kT * LDX);   // kT
  float* Aj = Ai + kT;
  float* Dj = Aj + kT;
  int it = 0, jt = blockIdx.x;
  while (jt > it) {
    jt -= it + 1;
    ++it;
  }
  const int grp = blockIdx.y;
  const int bi = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = row_of(a, bi, c, L);
  const int h1 = min(a.H, (grp + 1) * kGroup);
  float acc[kT / 8][4];
  zero(acc);
#pragma unroll 1
  for (int h = grp * kGroup; h < h1; ++h) {
    if (h > grp * kGroup) __syncthreads();
    const size_t ch = ((size_t)bi * a.nc + c) * a.H + h;
    load_bf16<kT, kP>(Xs, a.x + ((row0 + jt * kT) * a.H + h) * kP,
                      (size_t)a.H * kP);
    cs::cp_async_commit();
    load_split<kT, kP>(Ys, a.dy + ((row0 + it * kT) * a.H + h) * kP,
                       (size_t)a.H * kP, nullptr);
    for (int r = threadIdx.x; r < kT; r += kThreads) {
      Ai[r] = a.Acs[ch * L + it * kT + r];
      Aj[r] = a.Acs[ch * L + jt * kT + r];
      Dj[r] = a.dt[(row0 + jt * kT + r) * a.H + h];
    }
    cs::cp_async_wait<0>();
    __syncthreads();
    float dm[kT / 8][4];
    zero(dm);
    mma_split_a<kT, kP, false, false>(dm, Ys + warp * 16 * LDX, kT * LDX,
                                      LDX, Xs, LDX, lane);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = warp * 16 + g + 8 * (e >> 1);
        const int j = nt * 8 + 2 * t + (e & 1);
        if (jt < it || j <= i) {
          acc[nt][e] += (dm[nt][e] * expf(Ai[i] - Aj[j])) * Dj[j];
        }
      }
    }
  }
  store_acc<kT>(a.dCB + (((size_t)blockIdx.z * a.groups + grp) * L +
                         it * kT) * L + jt * kT,
                L, acc, warp * 16, lane);
}

// Grid (column tiles, h, b * c), the tiles with the most work first.  For
// 64 columns j of one head: dwx = B dU^T, dx = sum_i round(M)^T dy +
// dwx round(w), ddt, and the log-decays' gradient: the rows' sums of
// d(dec) for the tiles i (+) and the columns' and w's for j (-) to
// a.dA[.., jt, :], w's share of the total decay's to a.dT.
template <int L, int N>
__global__ void __launch_bounds__(kThreads) dchunk_kernel(Args a) {
  constexpr int LDN = N + 8, NT = L / kT;
  constexpr int R = dchunk_region<N>();
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Bs = reinterpret_cast<bf16*>(smem);   // kT x LDN: B_j
  bf16* Xs = Bs + kT * LDN;                   // kT x LDX: x_j
  bf16* Rs = Xs + kT * LDX;                   // dU planes, then C_i, dy_i
  bf16* Ys = Rs + 2 * kT * LDN;               // after C's two buffers
  float* As = reinterpret_cast<float*>(Rs + R);   // L
  float* Rows = As + L;                            // L
  float* Ds = Rows + L;                            // kT
  float* Cols = Ds + kT;                           // 4 x kT
  float* Tv = Cols + 4 * kT;                       // kT
  const int jt = blockIdx.x, h = blockIdx.y;
  const int bi = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = row_of(a, bi, c, L);
  const size_t ch = ((size_t)bi * a.nc + c) * a.H + h;
  load_bf16<kT, N>(Bs, a.B + (row0 + jt * kT) * N, N);
  load_bf16<kT, kP>(Xs, a.x + ((row0 + jt * kT) * a.H + h) * kP,
                    (size_t)a.H * kP);
  cs::cp_async_commit();
  for (int j = threadIdx.x; j < L; j += kThreads) {
    As[j] = a.Acs[ch * L + j];
    Rows[j] = 0.0f;
  }
  for (int j = threadIdx.x; j < kT; j += kThreads) {
    Ds[j] = a.dt[(row0 + jt * kT + j) * a.H + h];
  }
  load_split<kP, N>(Rs, a.V + ch * kP * N, N, nullptr);
  // each thread's share of an i-tile's dy, held in registers while the
  // tile before it is used: rows r4 + 8 k at column c4
  const int r4 = threadIdx.x >> 4, c4 = (threadIdx.x & 15) * 4;
  float4 yv[8];
  auto fetch = [&](int it) {
    const float* src = a.dy + ((row0 + it * kT + r4) * a.H + h) * kP + c4;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      yv[k] = *reinterpret_cast<const float4*>(src + (size_t)8 * k * a.H * kP);
    }
  };
  auto stage_c = [&](int it) {
    load_bf16<kT, N>(Rs + ((it - jt) & 1) * kT * LDN,
                     a.C + (row0 + it * kT) * N, N);
    cs::cp_async_commit();
  };
  fetch(jt);
  cs::cp_async_wait<0>();
  __syncthreads();

  const float T = As[L - 1];
  int jl[2];
  float ex[2], wr[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    jl[half] = warp * 16 + g + 8 * half;
    ex[half] = expf(T - As[jt * kT + jl[half]]);
    wr[half] = round_bf16(ex[half] * Ds[jl[half]]);
  }
  // dwx (rows j, columns p), then dx = dwx round(w), dw = sum_p dwx x
  float dx[kP / 8][4];
  zero(dx);
  mma_split_b<kP, N, false, false>(dx, Bs + warp * 16 * LDN, LDN, Rs,
                                   kP * LDN, LDN, lane);
  float dw[2] = {0.0f, 0.0f};
#pragma unroll
  for (int nt = 0; nt < kP / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int half = e >> 1, col = nt * 8 + 2 * t + (e & 1);
      dw[half] += dx[nt][e] * __bfloat162float(Xs[jl[half] * LDX + col]);
      dx[nt][e] = dx[nt][e] * wr[half];
    }
  }
  float dd[2], ddt[2] = {0.0f, 0.0f}, rs[2] = {0.0f, 0.0f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    dw[half] += __shfl_xor_sync(0xffffffffu, dw[half], 1);
    dw[half] += __shfl_xor_sync(0xffffffffu, dw[half], 2);
    dd[half] = (dw[half] * Ds[jl[half]]) * ex[half];
  }
  __syncthreads();   // the dU planes are read
  stage_c(jt);

#pragma unroll 1
  for (int it = jt; it < NT; ++it) {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      store_split(Ys + (r4 + 8 * k) * LDX + c4, kT * LDX, yv[k]);
    }
    if (it + 1 < NT) {
      stage_c(it + 1);
      fetch(it + 1);
      cs::cp_async_wait<1>();
    } else {
      cs::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Cs = Rs + ((it - jt) & 1) * kT * LDN;
    float cb[kT / 8][4], dm[kT / 8][4];
    zero(cb);
    zero(dm);
    mma_ss<kT, N, false, false>(cb, Bs + warp * 16 * LDN, LDN, Cs, LDN, lane);
    mma_split_b<kT, kP, false, false>(dm, Xs + warp * 16 * LDX, LDX, Ys,
                                      kT * LDX, LDX, lane);
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1;
        const int j = jt * kT + jl[half];
        const int i = it * kT + nt * 8 + 2 * t + (e & 1);
        float m = 0.0f, ddec = 0.0f;
        if (i >= j) {
          const float E = expf(As[i] - As[j]);
          const float X = cb[nt][e] * Ds[jl[half]];
          const float gm = dm[nt][e];
          m = E * X;
          ddec = (gm * X) * E;
          ddt[half] += (gm * E) * cb[nt][e];
          rs[half] += ddec;
        }
        cb[nt][e] = m;
        dm[nt][e] = ddec;
      }
    }
    // the columns' sums of d(dec) over this warp's sixteen rows j
#pragma unroll
    for (int nt = 0; nt < kT / 8; ++nt) {
#pragma unroll
      for (int par = 0; par < 2; ++par) {
        float s = dm[nt][par] + dm[nt][2 + par];
        s += __shfl_xor_sync(0xffffffffu, s, 4);
        s += __shfl_xor_sync(0xffffffffu, s, 8);
        s += __shfl_xor_sync(0xffffffffu, s, 16);
        if (g == 0) Cols[warp * kT + nt * 8 + 2 * t + par] = s;
      }
    }
    uint32_t af[kT / 16][4];
    to_a<kT>(af, cb);
    float part[kP / 8][4];
    zero(part);
#pragma unroll
    for (int pl = 2; pl >= 0; --pl) {
      mma_rs<kP, kT, true>(part, af, Ys + pl * kT * LDX, LDX, lane);
    }
    add_to(dx, part);
    __syncthreads();
    for (int i = threadIdx.x; i < kT; i += kThreads) {
      Rows[it * kT + i] =
          ((Cols[i] + Cols[kT + i]) + Cols[2 * kT + i]) + Cols[3 * kT + i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    ddt[half] += __shfl_xor_sync(0xffffffffu, ddt[half], 1);
    ddt[half] += __shfl_xor_sync(0xffffffffu, ddt[half], 2);
    rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 1);
    rs[half] += __shfl_xor_sync(0xffffffffu, rs[half], 2);
    const int j = jt * kT + jl[half];
    if (t == 0) {
      if (a.ddt != nullptr) {
        a.ddt[(row0 + j) * a.H + h] = ddt[half] + dw[half] * ex[half];
      }
      Rows[j] = (Rows[j] - rs[half]) - dd[half];
      Tv[jl[half]] = dd[half];
    }
    if (a.dx != nullptr) {
      bf16* out = a.dx + ((row0 + j) * a.H + h) * kP;
#pragma unroll
      for (int nt = 0; nt < kP / 8; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(out + nt * 8 + 2 * t) =
            __floats2bfloat162_rn(dx[nt][2 * half], dx[nt][2 * half + 1]);
      }
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < L; l += kThreads) {
    a.dA[(ch * NT + jt) * L + l] = Rows[l];
  }
  if (threadIdx.x == 0) {
    float sum = 0.0f;
    for (int j = 0; j < kT; ++j) sum += Tv[j];
    a.dT[ch * NT + jt] = sum;
  }
}

// Grid (row tiles, N / 64 column halves, b * c).  DB false: dC = dCB B +
// sum_h (exp(Acs) dy)_h h_before_h; DB true: dB = dCB^T C + sum_h
// (round(round(w) x))_h dU_h; dCB the head groups' partials summed in
// order.  Each f32 sum is rounded once to bf16.
template <int L, int N, bool DB>
__global__ void __launch_bounds__(kThreads) dbc_kernel(Args a) {
  constexpr int NT = L / kT, PLANE = kT * LDX;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* As3 = reinterpret_cast<bf16*>(smem);   // three planes: A side
  bf16* Bp = As3 + 3 * PLANE;                   // three planes: B side
  const int rt = blockIdx.x, n0 = blockIdx.y * 64;
  const int bi = blockIdx.z / a.nc, c = blockIdx.z % a.nc;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = row_of(a, bi, c, L);
  float acc[8][4], part[8][4];
  zero(acc);

  // over the chunk's tiles: the gradient of C B^T
  const int k0 = DB ? rt : 0, k1 = DB ? NT - 1 : rt;
#pragma unroll 1
  for (int kt = k0; kt <= k1; ++kt) {
    if (kt > k0) __syncthreads();
    load_bf16<kT, 64>(Bp, (DB ? a.C : a.B) + (row0 + kt * kT) * N + n0, N);
    cs::cp_async_commit();
    const int ti = DB ? kt : rt, tj = DB ? rt : kt;
    const float* src = a.dCB + ((size_t)blockIdx.z * a.groups * L + ti * kT) *
                                   L + tj * kT;
    for (int idx = threadIdx.x; idx < kT * kT / 4; idx += kThreads) {
      const int r = idx / (kT / 4), col = (idx % (kT / 4)) * 4;
      float4 s = *reinterpret_cast<const float4*>(src + (size_t)r * L + col);
      for (int grp = 1; grp < a.groups; ++grp) {
        const float4 o = *reinterpret_cast<const float4*>(
            src + ((size_t)grp * L + r) * L + col);
        s.x += o.x;
        s.y += o.y;
        s.z += o.z;
        s.w += o.w;
      }
      store_split(As3 + r * LDX + col, PLANE, s);
    }
    cs::cp_async_wait<0>();
    __syncthreads();
    zero(part);
    if constexpr (DB) {
      mma_split_a<64, kT, true, true>(part, As3 + warp * 16, PLANE, LDX, Bp,
                                      LDX, lane);
    } else {
      mma_split_a<64, kT, false, true>(part, As3 + warp * 16 * LDX, PLANE,
                                       LDX, Bp, LDX, lane);
    }
    add_to(acc, part);
  }

  // over the heads: the states' terms.  Each thread holds its share of
  // the next head's tiles in registers while this head's products run:
  // f32 rows r4 + 8 k at column c4, x's bf16 rows r8 + 16 k at c8.
  const int r4 = threadIdx.x >> 4, c4 = (threadIdx.x & 15) * 4;
  const int r8 = threadIdx.x >> 3, c8 = (threadIdx.x & 7) * 8;
  const size_t rows = row0 + rt * kT;
  float4 pb[8], pa[8];
  uint4 px[4];
  float sa[8], sd[4], sT = 0.0f;
  auto fetch = [&](int h) {
    const size_t ch = ((size_t)bi * a.nc + c) * a.H + h;
    const float* bsrc = (DB ? a.V : a.states) + ch * kP * N + n0 + c4;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      pb[k] = *reinterpret_cast<const float4*>(bsrc + (size_t)(r4 + 8 * k) * N);
    }
    if constexpr (DB) {
      sT = a.Acs[ch * L + L - 1];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = r8 + 16 * k;
        px[k] = *reinterpret_cast<const uint4*>(
            a.x + ((rows + r) * a.H + h) * kP + c8);
        sa[k] = a.Acs[ch * L + rt * kT + r];
        sd[k] = a.dt[(rows + r) * a.H + h];
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int r = r4 + 8 * k;
        pa[k] = *reinterpret_cast<const float4*>(
            a.dy + ((rows + r) * a.H + h) * kP + c4);
        sa[k] = a.Acs[ch * L + rt * kT + r];
      }
    }
  };
  // the held tiles to shared memory: the B side split; dC's A side
  // exp(Acs) dy split, dB's round(round(w) x)
  auto put = [&]() {
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      store_split(Bp + (r4 + 8 * k) * LDX + c4, PLANE, pb[k]);
    }
    if constexpr (DB) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float w = round_bf16(expf(sT - sa[k]) * sd[k]);
        const bf16* xv = reinterpret_cast<const bf16*>(&px[k]);
        uint4 o;
        uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          ov[e] = pack2(w * __bfloat162float(xv[2 * e]),
                        w * __bfloat162float(xv[2 * e + 1]));
        }
        *reinterpret_cast<uint4*>(As3 + (r8 + 16 * k) * LDX + c8) = o;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float G = expf(sa[k]);
        const float4 v = make_float4(G * pa[k].x, G * pa[k].y, G * pa[k].z,
                                     G * pa[k].w);
        store_split(As3 + (r4 + 8 * k) * LDX + c4, PLANE, v);
      }
    }
  };
  fetch(0);
#pragma unroll 1
  for (int h = 0; h < a.H; ++h) {
    __syncthreads();
    put();
    if (h + 1 < a.H) fetch(h + 1);
    __syncthreads();
    zero(part);
    const bf16* A0 = As3 + warp * 16 * LDX;
    if constexpr (DB) {
      mma_split_b<64, kP, false, true>(part, A0, LDX, Bp, PLANE, LDX, lane);
    } else {
      // the six split products whose sum is the f32 product: lo hi, hi
      // lo, mid mid, mid hi, hi mid, hi hi
      constexpr int pa[6] = {2, 0, 1, 1, 0, 0}, pb[6] = {0, 2, 1, 0, 1, 0};
#pragma unroll
      for (int k = 0; k < 6; ++k) {
        mma_ss<64, kP, false, true>(part, A0 + pa[k] * PLANE, LDX,
                                    Bp + pb[k] * PLANE, LDX, lane);
      }
    }
    add_to(acc, part);
  }

  bf16* out = (DB ? a.dB : a.dC) + (row0 + rt * kT + warp * 16) * N + n0;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      *reinterpret_cast<__nv_bfloat162*>(out + (g + 8 * half) * N + nt * 8 +
                                         2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * half], acc[nt][2 * half + 1]);
    }
  }
}

// A warp a (b, c, h): dA = the tiles' partials + dAq, the total decay's
// gradient (w's share and the states') onto its last position, and dla =
// its reverse cumsum over the chunk.
template <int L>
__global__ void __launch_bounds__(kThreads) dla_kernel(Args a, int slices) {
  constexpr int E = L / 32, NT = L / kT;
  const long long wid = (long long)blockIdx.x * (kThreads / 32) +
                        (threadIdx.x >> 5);
  if (wid >= (long long)a.b * a.nc * a.H) return;
  const int lane = threadIdx.x & 31;
  const size_t ch = (size_t)wid;
  const int h = (int)(ch % a.H), c = (int)((ch / a.H) % a.nc);
  const int bi = (int)(ch / a.H / a.nc);
  float v[E];
#pragma unroll
  for (int e = 0; e < E; ++e) {
    const int l = lane * E + e;
    float s = a.dA[ch * NT * L + l];
    for (int jt = 1; jt < NT; ++jt) s += a.dA[(ch * NT + jt) * L + l];
    v[e] = s + a.dAq[ch * L + l];
  }
  if (lane == 31) {
    float dT = 0.0f;
    for (int jt = 0; jt < NT; ++jt) dT += a.dT[ch * NT + jt];
    float st = 0.0f;
    const float* ts = a.dTs + (((size_t)bi * a.H + h) * a.nc + c) * slices;
    for (int k = 0; k < slices; ++k) st += ts[k];
    v[E - 1] += dT + expf(a.Acs[ch * L + L - 1]) * st;
  }
  // the reverse inclusive cumsum: each lane from its last value down,
  // then the lanes' totals from the last lane down
  float run = 0.0f;
#pragma unroll
  for (int e = E - 1; e >= 0; --e) {
    run += v[e];
    v[e] = run;
  }
  float inc = run;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float o = __shfl_down_sync(0xffffffffu, inc, d);
    if (lane + d < 32) inc = o + inc;
  }
  float post = __shfl_down_sync(0xffffffffu, inc, 1);
  if (lane == 31) post = 0.0f;
  const size_t row0 = row_of(a, bi, c, L);
#pragma unroll
  for (int e = 0; e < E; ++e) {
    a.dla[(row0 + lane * E + e) * a.H + h] = lane == 31 ? v[e] : post + v[e];
  }
}

template <class K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Launch kernel on grid with `bytes` of dynamic shared memory, after
// allowing them; returns the first error.
template <class K>
cudaError_t launch(K kernel, dim3 grid, int threads, size_t bytes,
                   cudaStream_t st, const Args& a) {
  cudaError_t e = allow_smem(kernel, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<grid, threads, bytes, st>>>(a);
  return cudaGetLastError();
}

template <int L, int N>
int fwd(const Args& a, cudaStream_t st) {
  constexpr int LDN = N + 8, NT = L / kT;
  const size_t b_state = (size_t)L * (LDX + LDN) * 2 + 2 * L * 4;
  const size_t b_scan = (size_t)(kT * LDN + scan_region<N>()) * 2 + 2 * L * 4;
  cudaError_t e = launch(state_kernel<L, N>, dim3(a.nc, a.H, a.b), kThreads,
                         b_state, st, a);
  if (e != cudaSuccess) return (int)e;
  pass_kernel<L, N><<<dim3(kP * N / (4 * kPassThreads), a.b * a.H),
                      kPassThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = launch(scan_kernel<L, N>, dim3(NT, a.H, a.b * a.nc), kThreads, b_scan,
             st, a);
  return (int)e;
}

template <int L, int N>
int bwd(const Args& a, cudaStream_t st) {
  constexpr int LDN = N + 8, NT = L / kT;
  const int slices = kP * N / (4 * kPassThreads);
  const size_t b_dstate = (size_t)(3 * kP * LDN + kT * LDN + 3 * kT * LDX) * 2 +
                          L * 4;
  const size_t b_dcb = (size_t)4 * kT * LDX * 2 + 3 * kT * 4;
  const size_t b_dchunk = (size_t)(kT * LDN + kT * LDX + dchunk_region<N>()) *
                              2 + (2 * L + 6 * kT) * 4;
  const size_t b_dbc = (size_t)6 * kT * LDX * 2;
  const dim3 chunks(a.nc, a.H, a.b), tiles(NT, a.H, a.b * a.nc);
  cudaError_t e = launch(dstate_kernel<L, N>, chunks, kThreads, b_dstate, st, a);
  if (e != cudaSuccess) return (int)e;
  dpass_kernel<L, N><<<dim3(slices, a.b * a.H), kPassThreads, 0, st>>>(a);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  if (a.dB != nullptr || a.dC != nullptr) {
    e = launch(dcb_kernel<L>, dim3(NT * (NT + 1) / 2, a.groups, a.b * a.nc),
               kThreads, b_dcb, st, a);
    if (e != cudaSuccess) return (int)e;
  }
  e = launch(dchunk_kernel<L, N>, tiles, kThreads, b_dchunk, st, a);
  if (e != cudaSuccess) return (int)e;
  const dim3 halves(NT, N / 64, a.b * a.nc);
  if (a.dC != nullptr) {
    e = launch(dbc_kernel<L, N, false>, halves, kThreads, b_dbc, st, a);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.dB != nullptr) {
    e = launch(dbc_kernel<L, N, true>, halves, kThreads, b_dbc, st, a);
    if (e != cudaSuccess) return (int)e;
  }
  if (a.dla != nullptr) {
    const long long warps = (long long)a.b * a.nc * a.H;
    dla_kernel<L><<<(unsigned)((warps + 3) / 4), kThreads, 0, st>>>(a, slices);
    e = cudaGetLastError();
  }
  return (int)e;
}

}  // namespace ssd_cuda
