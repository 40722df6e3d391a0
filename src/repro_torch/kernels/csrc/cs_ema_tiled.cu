// B3 · cs_ema_tiled: one moment's fused update_read over one sketch, the
// dense-gradient path, in column slices that keep the sketch slice and
// the scratch in L2.
//
// Replaces the TPU kernel src/repro/kernels/cs_ema_tiled.py::cs_ema_tiled
// (body _ema_kernel, pallas_call at :201), f32 cells and the bf16 branch.
// That kernel takes 8 rows a grid step, DMAs their depth sketch rows,
// folds bucket collisions inside the tile through an 8x8 equality matmul
// and writes back, so a tile sees the writes of the tiles before it.
// CUDA blocks run in no order; this kernel has the semantics of the
// `xla` backend instead: every estimate reads the pre-step sketch.
//
// Bound on the H100: bytes.  The function must read x and write est
// (4 B each a cell of the (k, d) table), read and write the sketch once,
// and read the addressing: at the dense path's shapes (k = 151,936,
// d = 896, a (3, 10,240, 896) sketch) 1,313,532,416 B for f32 cells,
// 0.392 ms at 3.35 TB/s, and 1,203,431,936 B, 0.359 ms, for bf16 cells.
//
// Every column is independent: est_old[r, c] reads column c of the
// sketch, d[r, c] needs est_old[r, c] and x[r, c], and the cell (j, w, c)
// takes column c of d.  So a call runs in slices of C columns, each done
// in full before the next, two launches a slice on one stream:
//
//   1. ema_read over (row r, column of the slice): est_old = the median
//      (signed) or min of the depth cells, d = ema_delta(est_old, x)
//      [* mask[r]]; writes est = est_old + d, and d into a scratch of
//      one slice, (k, C), reused by every slice.
//   2. ema_scatter over (hash row j, bucket w, column of the slice): the
//      bucket's items, listed in item order by the stable bucket CSR
//      (bucket_csr, cached for the dense row set), add s * d into the
//      cell one after another, starting from the old cell.  No atomics,
//      deterministic, in the order of the CPU index_add_.
//
// Stream order keeps scatter(i) ahead of read(i + 1)'s reuse of the
// scratch, and read(i) sees the pre-step sketch: scatters before it
// wrote other columns.  Every launch after a call's first is made with
// programmatic stream serialization (PDL): it starts while the one
// before drains and waits (griddepcontrol.wait) only before it touches
// what that one wrote, so the 56 launches leave no gaps between them.
//
// What the slices do about the costs of the whole-width design (a read
// launch of 1.58 ms and a scatter of 0.71 ms on the H100):
//   * the gathers of launch 1 run over a sketch slice of depth * width * C
//     cells (3.9 MB of f32 at C = 32), which the 50 MB L2 holds, where
//     they ran over the whole 110 MB sketch and came largely from DRAM;
//   * the scratch that carries d to launch 2 is one slice, 19.4 MB at
//     C = 32, where it was the whole (k, d) 544.5 MB; launch 2 reads it
//     three times (once a hash row) just after launch 1 wrote it, from L2
//     where those reads came from DRAM;
//   * x and est pass once with evict-first hints (__ldcs, __stcs) so the
//     stream does not push the slice out of L2;
//   * 16-byte accesses (4 columns a thread: float4, or 4 bf16 cells in
//     8 bytes) where d, C and the pointers allow; 4 bytes otherwise;
//   * the scatter loads a batch of kBatch items (indices, then signs and
//     scratch rows) before it adds them, by volatile loads: with plain
//     loads ptxas kept 32 registers and issued each load next to its
//     add.
// DRAM then sees x, est and the sketch once, about the bound's bytes.
// What is left: x and est move in 128-byte pieces of rows 3,584 bytes
// apart, which the card's DRAM serves at about 1.8 TB/s (a plain copy of
// x into est in such slices), and L2 serves the gathers and the three
// scratch reads of every item.
//
// C is chosen by the wrapper (cs_ema_tiled.slice_cols): the widest slice,
// a multiple of 32 columns (else of 4), whose scratch plus sketch slice
// fits 24 MiB, about half of L2, so that the slice stays there beside the
// x and est stream; one slice when the whole call fits.  At the dense
// path's shapes C = 32: 28 slices, 56 launches a call.  Of the widths
// tried on the H100 (16 to 64), 32 was the fastest: narrower slices move
// x and est in smaller pieces, wider ones no longer keep the scratch in
// L2 (the scatter slows by a third at 64).
//
// ema_delta's three forms (core/sketch.py), picked on the host:
//   form 0 (scale == 1 - beta, Adam):  scale * (x - est)
//   form 1 (beta == 1, Adagrad):       sx
//   form 2 (otherwise, momentum):      (beta - 1) * est + sx
// with sx = x when scale == 1, else scale * x; scale and beta - 1 arrive
// as float32 values rounded from float64 on the host.
//
// bf16 cells (cs_ema_tiled_bf16_launch), the reference's
// _ema_update_read_lowp form (kernels/ops.py): launch 1 widens the
// gathered cells to f32; launch 2 visits EVERY cell of the slice, sums
// its bucket's s * d from zero in item order, adds the sum to the
// widened cell and writes sr_bfloat16(cell + inc, cell_bits(seed, lin)),
// lin = (j * width + bucket) * d + c as uint32 with c the GLOBAL column,
// so every cell is re-rounded once a call whatever the slicing.  An
// untouched cell adds 0 and rounds to itself (only -0 becomes +0, as in
// the reference).
#include "cs_common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kBatch = 8;        // scatter: items whose loads go together
constexpr int kMaxBlocks = 1 << 20;
constexpr int kRead = 1, kScatter = 2;  // the launches of a slice

// VEC consecutive columns of one row, in f32.
template <int VEC>
struct Vec {
  float v[VEC];
};

// Loads of VEC cells or values widened to f32: f32 as they are, bf16
// widened; VEC = 4 is one 16-byte (f32) or 8-byte (bf16) access.
template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const float* p) {
  Vec<VEC> o;
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    o.v[0] = t.x;
    o.v[1] = t.y;
    o.v[2] = t.z;
    o.v[3] = t.w;
  } else {
    o.v[0] = *p;
  }
  return o;
}
__device__ __forceinline__ float widen(uint32_t bits) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)bits));
}
template <int VEC>
__device__ __forceinline__ Vec<VEC> load(const __nv_bfloat16* p) {
  Vec<VEC> o;
  if constexpr (VEC == 4) {
    const uint2 t = *reinterpret_cast<const uint2*>(p);
    o.v[0] = widen(t.x & 0xFFFFu);
    o.v[1] = widen(t.x >> 16);
    o.v[2] = widen(t.y & 0xFFFFu);
    o.v[3] = widen(t.y >> 16);
  } else {
    o.v[0] = __bfloat162float(*p);
  }
  return o;
}

// Loads that ptxas keeps in program order (volatile asm), so the loads
// of a batch are issued together.  Plain weak loads: the scratch they
// read was written by the launch before.
__device__ __forceinline__ int load_volatile(const int* p) {
  int v;
  asm volatile("ld.global.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ float load_volatile(const float* p) {
  float v;
  asm volatile("ld.global.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
}
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_volatile(const float* p) {
  Vec<VEC> o;
  if constexpr (VEC == 4) {
    asm volatile("ld.global.v4.f32 {%0, %1, %2, %3}, [%4];"
                 : "=f"(o.v[0]), "=f"(o.v[1]), "=f"(o.v[2]), "=f"(o.v[3])
                 : "l"(p));
  } else {
    o.v[0] = load_volatile(p);
  }
  return o;
}

// Programmatic dependent launch: every launch of a call after its first
// may start while the one before drains; it waits here, before touching
// what that one writes, until it has finished and its writes are
// visible.  A no-op for a launch made without the attribute.
__device__ __forceinline__ void wait_prior_grid() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// x read once, evict-first.
template <int VEC>
__device__ __forceinline__ Vec<VEC> load_stream(const float* p) {
  Vec<VEC> o;
  if constexpr (VEC == 4) {
    const float4 t = __ldcs(reinterpret_cast<const float4*>(p));
    o.v[0] = t.x;
    o.v[1] = t.y;
    o.v[2] = t.z;
    o.v[3] = t.w;
  } else {
    o.v[0] = __ldcs(p);
  }
  return o;
}

template <int VEC>
__device__ __forceinline__ void store(float* p, const Vec<VEC>& a) {
  if constexpr (VEC == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(a.v[0], a.v[1], a.v[2],
                                                a.v[3]);
  } else {
    *p = a.v[0];
  }
}

// est written once, evict-first.
template <int VEC>
__device__ __forceinline__ void store_stream(float* p, const Vec<VEC>& a) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<float4*>(p),
           make_float4(a.v[0], a.v[1], a.v[2], a.v[3]));
  } else {
    __stcs(p, a.v[0]);
  }
}

// VEC bf16 cells at linear index `at` rounded from the f32 sums.
template <int VEC>
__device__ __forceinline__ void store_rounded(__nv_bfloat16* S, size_t at,
                                             const Vec<VEC>& a,
                                             uint32_t seed) {
  uint32_t h[VEC];
#pragma unroll
  for (int t = 0; t < VEC; ++t) {
    h[t] = __bfloat16_as_ushort(cs::sr_bfloat16(
        a.v[t], cs::cell_bits(seed, static_cast<uint32_t>(at + t))));
  }
  if constexpr (VEC == 4) {
    *reinterpret_cast<uint2*>(S + at) =
        make_uint2(h[0] | h[1] << 16, h[2] | h[3] << 16);
  } else {
    S[at] = __ushort_as_bfloat16((unsigned short)h[0]);
  }
}

// Launch 1 of a slice: columns [c0, c0 + n) of every row.  DEPTH is 3
// (the dense path's sketches, the median in registers) or 0 (any depth
// up to cs::kMaxDepth, read from depth_rt).
template <typename Cell, int VEC, int DEPTH>
__global__ void __launch_bounds__(kBlock)
    ema_read(const Cell* __restrict__ S, const int* __restrict__ b,
             const float* __restrict__ s, const float* __restrict__ x,
             const float* __restrict__ mask, float* __restrict__ est,
             float* __restrict__ dout, int depth_rt, int width, int d,
             int k, int c0, int n, int form, int unit, float scale,
             float bm1) {
  const int depth = DEPTH ? DEPTH : depth_rt;
  const int nq = n / VEC;
  const long long total = (long long)k * nq;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(i / nq);
    const int c = (int)(i - (long long)r * nq) * VEC;
    int bj[cs::kMaxDepth];
    float sj[cs::kMaxDepth];
#pragma unroll
    for (int j = 0; j < cs::kMaxDepth; ++j) {
      if (j < depth) {
        bj[j] = b[(size_t)j * k + r];
        sj[j] = s != nullptr ? s[(size_t)j * k + r] : 1.0f;
      }
    }
    const Vec<VEC> xv = load_stream<VEC>(x + (size_t)r * d + c0 + c);
    const float m = mask != nullptr ? mask[r] : 1.0f;
    Vec<VEC> cells[cs::kMaxDepth];
#pragma unroll
    for (int j = 0; j < cs::kMaxDepth; ++j) {
      if (j < depth) {
        cells[j] = load<VEC>(S + cs::cell(j, bj[j], c0 + c, width, d));
      }
    }
    Vec<VEC> dv, ev;
#pragma unroll
    for (int t = 0; t < VEC; ++t) {
      float v[cs::kMaxDepth];
#pragma unroll
      for (int j = 0; j < cs::kMaxDepth; ++j) {
        if (j < depth) {
          v[j] = s != nullptr ? cells[j].v[t] * sj[j] : cells[j].v[t];
        }
      }
      const float e = s != nullptr ? cs::median(v, depth)
                                   : cs::min_of(v, depth);
      const float xt = xv.v[t];
      const float sx = unit ? xt : scale * xt;
      float dt;
      if (form == 0) {
        dt = scale * (xt - e);
      } else if (form == 1) {
        dt = sx;
      } else {
        dt = bm1 * e + sx;
      }
      if (mask != nullptr) dt = dt * m;
      dv.v[t] = dt;
      ev.v[t] = e + dt;
    }
    store_stream<VEC>(est + (size_t)r * d + c0 + c, ev);
    wait_prior_grid();  // the scatter before has read the scratch
    store<VEC>(dout + (size_t)r * n + c, dv);
  }
}

// Launch 2 of a slice: cells (j, w, c0 .. c0 + n) from the (k, n)
// scratch dv.  f32 cells start from the old cell and skip empty buckets;
// bf16 cells sum from zero and every cell is re-rounded.  A thread takes
// its bucket's items kBatch at a time: the batch's indices, then their
// signs and scratch values, by volatile loads, which ptxas issues in
// program order before the adds (plain loads went one or two at a time
// next to their adds), then adds them in item order.
template <typename Cell, int VEC>
__global__ void __launch_bounds__(kBlock)
    ema_scatter(Cell* __restrict__ S, const int* __restrict__ order,
                const int* __restrict__ starts,
                const float* __restrict__ s, const float* __restrict__ dv,
                int depth, int width, int d, int k, int c0, int n,
                uint32_t seed) {
  constexpr bool kBf16 = sizeof(Cell) == 2;
  wait_prior_grid();  // the read launch before has written the scratch
  const int nq = n / VEC;
  const long long total = (long long)depth * width * nq;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const int jw = (int)(i / nq);
    const int c = (int)(i - (long long)jw * nq) * VEC;
    const int j = jw / width;
    const int* st = starts + (size_t)j * (width + 1) + (jw - j * width);
    const int lo = st[0], hi = st[1];
    if (!kBf16 && lo == hi) continue;
    const size_t at = (size_t)jw * d + c0 + c;
    Vec<VEC> acc;
    if constexpr (kBf16) {
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc.v[t] = 0.0f;
    } else {
      acc = load<VEC>(S + at);
    }
    const int* ord = order + (size_t)j * k;
    const float* sg = s != nullptr ? s + (size_t)j * k : nullptr;
    for (int p = lo; p < hi; p += kBatch) {
      int rr[kBatch];
      float ss[kBatch];
      Vec<VEC> vv[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        rr[u] = load_volatile(ord + (p + u < hi ? p + u : hi - 1));
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        ss[u] = sg != nullptr ? load_volatile(sg + rr[u]) : 1.0f;
        vv[u] = load_volatile<VEC>(dv + (size_t)rr[u] * n + c);
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (p + u < hi) {
#pragma unroll
          for (int t = 0; t < VEC; ++t) {
            acc.v[t] = acc.v[t] + (sg != nullptr ? ss[u] * vv[u].v[t]
                                                 : vv[u].v[t]);
          }
        }
      }
    }
    if constexpr (kBf16) {
      const Vec<VEC> old = load<VEC>(S + at);
#pragma unroll
      for (int t = 0; t < VEC; ++t) acc.v[t] = old.v[t] + acc.v[t];
      store_rounded<VEC>(S, at, acc, seed);
    } else {
      store<VEC>(S + at, acc);
    }
  }
}

// At least one block: an empty grid is a launch error, an idle block is
// not.
unsigned blocks_for(long long threads) {
  const long long blocks = (threads + kBlock - 1) / kBlock;
  return (unsigned)(blocks < 1 ? 1 : blocks < kMaxBlocks ? blocks
                                                        : kMaxBlocks);
}

bool aligned(const void* p, size_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

struct Args {
  const int* b;
  const float* s;
  const float* x;
  const float* mask;
  const int* order;
  const int* starts;
  float* est;
  float* scratch;
  int depth, width, d, k, form, unit;
  float scale, bm1;
};

// One launch of `threads` threads on `st`.  `early`: with programmatic
// stream serialization, so that it may start while the launch before it
// drains (the kernels wait for it in wait_prior_grid); the first launch
// of a call goes without, after all work before the call.
template <typename... Params, typename... Actual>
int launch_kernel(void (*kernel)(Params...), long long threads, bool early,
                  cudaStream_t st, Actual... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks_for(threads));
  cfg.blockDim = dim3(kBlock);
  cfg.stream = st;
  cfg.attrs = &attr;
  cfg.numAttrs = early ? 1 : 0;
  return (int)cudaLaunchKernelEx(&cfg, kernel, args...);
}

template <typename Cell, int VEC, int DEPTH>
int read_slice(const Cell* S, const Args& a, int c0, int n, bool early,
               cudaStream_t st) {
  return launch_kernel(ema_read<Cell, VEC, DEPTH>, (long long)a.k * (n / VEC),
                       early, st, S, a.b, a.s, a.x, a.mask, a.est,
                       a.scratch, a.depth, a.width, a.d, a.k, c0, n, a.form,
                       a.unit, a.scale, a.bm1);
}

// The slices of the d columns, `slice` columns each (the last may be
// narrower), with the launches that `parts` names.
template <typename Cell, int VEC>
int run_slices(Cell* S, const Args& a, int slice, int parts, uint32_t seed,
               cudaStream_t st) {
  bool early = false;
  for (int c0 = 0; c0 < a.d; c0 += slice) {
    const int n = a.d - c0 < slice ? a.d - c0 : slice;
    if (parts & kRead) {
      const int err = a.depth == 3
                          ? read_slice<Cell, VEC, 3>(S, a, c0, n, early, st)
                          : read_slice<Cell, VEC, 0>(S, a, c0, n, early, st);
      if (err != 0) return err;
      early = true;
    }
    if (parts & kScatter) {
      const int err = launch_kernel(
          ema_scatter<Cell, VEC>,
          (long long)a.depth * a.width * (n / VEC), early, st, S, a.order,
          a.starts, a.s, a.scratch, a.depth, a.width, a.d,
          a.k, c0, n, seed);
      if (err != 0) return err;
      early = true;
    }
  }
  return 0;
}

template <typename Cell>
int launch(Cell* S, const Args& a, int slice, int parts, uint32_t seed,
           void* stream) {
  if (a.k <= 0 || a.d <= 0) return (int)cudaGetLastError();
  if (a.depth < 1 || a.depth > cs::kMaxDepth || a.form < 0 || a.form > 2 ||
      slice < 1 || parts < 1 || parts > 3) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = a.d % 4 == 0 && slice % 4 == 0 &&
                   aligned(S, 4 * sizeof(Cell)) && aligned(a.x, 16) &&
                   aligned(a.est, 16) && aligned(a.scratch, 16);
  return vec ? run_slices<Cell, 4>(S, a, slice, parts, seed, st)
             : run_slices<Cell, 1>(S, a, slice, parts, seed, st);
}

}  // namespace

// S (depth, width, d) f32 in place; b, s (depth, k); x, est (k, d);
// mask (k) or null; order, starts the bucket CSR of b; scratch (k,
// slice) f32.  Runs the slices of `slice` columns: parts 1 the read
// launches, 2 the scatters, 3 both.
extern "C" int cs_ema_tiled_launch(
    float* S, const int* b, const float* s, const float* x,
    const float* mask, const int* order, const int* starts, float* est,
    float* scratch, int depth, int width, int d, int k, int form, int unit,
    float scale, float bm1, int slice, int parts, void* stream) {
  const Args a{b,     s,     x, mask, order, starts, est,   scratch,
               depth, width, d, k,    form,  unit,   scale, bm1};
  return launch<float>(S, a, slice, parts, 0u, stream);
}

// As cs_ema_tiled_launch with S bf16 and the uint32 rounding seed.
extern "C" int cs_ema_tiled_bf16_launch(
    void* S, const int* b, const float* s, const float* x, const float* mask,
    const int* order, const int* starts, float* est, float* scratch,
    int depth, int width, int d, int k, int form, int unit, float scale,
    float bm1, int slice, int parts, unsigned int seed, void* stream) {
  const Args a{b,     s,     x, mask, order, starts, est,   scratch,
               depth, width, d, k,    form,  unit,   scale, bm1};
  return launch<__nv_bfloat16>(static_cast<__nv_bfloat16*>(S), a, slice,
                               parts, seed, stream);
}
