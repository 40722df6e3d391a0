// B5 · cs_update: batch UPDATE of a count-sketch, a signed scatter-add of
// (k, d) rows where duplicate buckets accumulate.
//
// Replaces the TPU kernel src/repro/kernels/cs_update.py::cs_update (body
// _update_kernel).  The TPU has no atomics: it sorts the items by bucket
// and walks them on its sequential grid, seeding a bucket's row from the
// old sketch at the first item and accumulating the rest.  Here the same
// stable sort (bucket_csr, csrc/cs_csr.cu) lists each (hash row, bucket)'s
// items in item order, a run of sorted positions, and every run is added
// into its sketch row starting from the row's old value, one item after
// another in item order, and written once.  No atomics, deterministic,
// and in the order of the CPU index_add_: bit-equal to the plain version
// ref.cs_update_ref run on the CPU.
//
// Bound on the H100: bytes (each touched sketch row read and written
// once, each item's row read once per hash row, mostly from L2), but two
// latencies stand in the way, and one launch has a role for each:
//
//   * short runs (fewer than kLong items, most of a zipf batch): the grid
//     runs over the depth * k sorted positions, kPositions to a block; a
//     position starts a run when starts[j][bucket] equals it, so the host
//     sizes the grid without reading anything back, and a block whose
//     positions start no run exits.  Each warp of the block adds one run
//     at a time along d (float4 when d % 4 == 0 and the pointers allow):
//     its lanes fetch the run's item indices and signs once, and the item
//     rows of kCols column groups are loaded together, independent of the
//     adds.  Most runs hold one to three items, so a run costs about two
//     memory latencies, and the eight warps of a block add eight runs at
//     once (a block adding one run at a time with all its threads left
//     the card waiting on one run after another).
//   * long runs (the zipf head: 1,500 items in one bucket): a column's
//     adds are one chain, and one block keeps too few rows in flight for
//     it (Little's law: a run's bytes over the rows in flight times the
//     latency).  So the long runs are found from starts by blocks of
//     their own, one warp for each 32-column slice on its own SM, each
//     with a ring of about 64 rows in flight.  Those blocks come first in
//     the grid and run beside the short runs.  A block scans kChunk
//     buckets strided across the width, so neighbouring long runs go to
//     different blocks: a dedup sum's heaviest slots are its first ones.
//
// The same launch is every colliding sum of the port on the card: B1's
// scatter (M signed and V unsigned as two targets of one launch, each
// run cut at the first dedup padding slot, n_valid, runs of one item
// left to B1's read), the dedup segment sum (depth 1 over dedup's own
// sort), core/sketch.py::update and DenseStore.accumulate (depth 1 over
// the table's rows).
#include "cs_common.cuh"

namespace {

constexpr int kThreads = 256;   // a block: 8 warps
constexpr int kCols = 2;        // short runs: column groups a warp adds at once
constexpr int kLong = 16;       // a run this long or longer is a long run
constexpr int kChunk = 256;     // buckets a long-run block scans
constexpr int kLongStages = 3;  // long runs: batches of 32 rows in the ring
constexpr int kPositions = 16;  // sorted positions a short-run block tests
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float add_signed(float acc, float s, float u) {
  return acc + s * u;
}
__device__ __forceinline__ float4 add_signed(float4 acc, float s, float4 u) {
  acc.x = acc.x + s * u.x;
  acc.y = acc.y + s * u.y;
  acc.z = acc.z + s * u.z;
  acc.w = acc.w + s * u.w;
  return acc;
}

__device__ __forceinline__ void copy(float* smem, const float* gmem) {
  cs::cp_async4(smem, gmem);
}
__device__ __forceinline__ void copy(float4* smem, const float4* gmem) {
  cs::cp_async16(smem, gmem);
}

// A short run order[lo..hi) (fewer than kLong <= 32 items) of one hash row
// added into the sketch row ``row`` by one warp; T is float or float4.
// Lane i fetches item i's index and sign once; then the warp walks the
// row kCols groups of 32 columns at a time, each item's cells of those
// columns loaded independently of the adds, which go from the old cell,
// one item after another in item order.
template <typename T>
__device__ __forceinline__ void add_short_run(
    T* __restrict__ row, const T* __restrict__ x, const int* __restrict__ ord,
    const float* __restrict__ sj, int lo, int hi, int ncols) {
  static_assert(kLong <= 32, "a short run's items must fit one warp");
  const int lane = threadIdx.x & 31;
  const int n = hi - lo;
  int r_lane = 0;
  float s_lane = 1.0f;
  if (lane < n) {
    r_lane = ord[lo + lane];
    if (sj != nullptr) s_lane = sj[r_lane];
  }
  // every lane takes every pass: the shuffles below need the whole warp
  for (int c0 = lane; c0 - lane < ncols; c0 += 32 * kCols) {
    T acc[kCols];
#pragma unroll
    for (int g = 0; g < kCols; ++g) {
      if (c0 + 32 * g < ncols) acc[g] = row[c0 + 32 * g];
    }
#pragma unroll 4
    for (int i = 0; i < n; ++i) {
      const int r = __shfl_sync(kAll, r_lane, i);
      const float sg = __shfl_sync(kAll, s_lane, i);
      const T* xr = x + (size_t)r * ncols;
#pragma unroll
      for (int g = 0; g < kCols; ++g) {
        if (c0 + 32 * g < ncols) {
          acc[g] = add_signed(acc[g], sg, __ldg(xr + c0 + 32 * g));
        }
      }
    }
#pragma unroll
    for (int g = 0; g < kCols; ++g) {
      if (c0 + 32 * g < ncols) row[c0 + 32 * g] = acc[g];
    }
  }
}

// A long run order[lo..hi) added into ``row`` by one warp, for the 32
// columns of one slice (a lane's column c).  The warp streams the item
// rows in batches of 32 through a ring of kLongStages batches: the
// indices of a batch are fetched a batch before their rows are copied,
// and the rows kLongStages-1 batches before their adds, so about 64 rows
// a lane are in flight.  ``sgn`` holds the signs of four batches.
template <typename T>
__device__ __forceinline__ void add_long_run(
    T* __restrict__ row, const T* __restrict__ x, const int* __restrict__ ord,
    const float* __restrict__ sj, int lo, int hi, int ncols, int c, T* ring,
    float* sgn) {
  const int lane = threadIdx.x;
  const bool on = c < ncols;
  const int n = hi - lo, batches = (n + 31) / 32;
  T acc;
  if (on) acc = row[c];
  int r_next = 0;
  float s_next = 1.0f;
  auto fetch = [&](int bi) {  // lane's item of batch bi, without waiting
    const int q = bi * 32 + lane;
    r_next = q < n ? ord[lo + q] : 0;
    s_next = q < n && sj != nullptr ? sj[r_next] : 1.0f;
  };
  auto issue = [&](int bi) {  // copy batch bi with the fetched indices
    if (bi < batches) {
      sgn[(bi & 3) * 32 + lane] = s_next;
      for (int t = 0; t < 32; ++t) {
        const int r = __shfl_sync(kAll, r_next, t);
        if (on && bi * 32 + t < n) {
          copy(&ring[((bi % kLongStages) * 32 + t) * 32 + lane],
               &x[(size_t)r * ncols + c]);
        }
      }
    }
    cs::cp_async_commit();
  };
  for (int bi = 0; bi < kLongStages - 1; ++bi) {
    fetch(bi);
    issue(bi);
  }
  fetch(kLongStages - 1);
  for (int bi = 0; bi < batches; ++bi) {
    issue(bi + kLongStages - 1);
    fetch(bi + kLongStages);
    cs::cp_async_wait<kLongStages - 1>();  // batch bi has landed
    __syncwarp();                           // and its signs
    const int m = min(32, n - bi * 32);
    for (int t = 0; t < m; ++t) {
      acc = add_signed(acc, sgn[(bi & 3) * 32 + t],
                       ring[((bi % kLongStages) * 32 + t) * 32 + lane]);
    }
  }
  cs::cp_async_wait<0>();
  if (on) row[c] = acc;
}

// What the scatter adds where: hash rows [0, depth0) add the rows of x0
// (times the signs s0 of each row, when s0 is given) into S0; rows
// [depth0, depth) add the rows of x1, unsigned, into S1 (B1 scatters M
// and V in one launch; a plain update has depth0 = depth).
// In units of T: S0 and S1 hold rows of ld, x0 and x1 rows of ncols.
template <typename T>
struct Targets {
  T* S0;
  const T* x0;
  const float* s0;
  int depth0, width0;
  T* S1;
  const T* x1;
  int width1, ld;
};

// Hash row j's sketch rows, item rows and signs.
template <typename T>
__device__ __forceinline__ void target_of(const Targets<T>& t, int j, int k,
                                          T*& S, const T*& x,
                                          const float*& s) {
  if (j < t.depth0) {
    S = t.S0 + (size_t)j * t.width0 * t.ld;
    x = t.x0;
    s = t.s0 != nullptr ? t.s0 + (size_t)j * k : nullptr;
  } else {
    S = t.S1 + (size_t)(j - t.depth0) * t.width1 * t.ld;
    x = t.x1;
    s = nullptr;
  }
}

// The end of the run ord[lo..hi) cut before its first item at or past
// nv.  A run's items ascend, so its live items come first: one load when
// the last item is live, else a binary search.
__device__ __forceinline__ int live_end(const int* __restrict__ ord, int lo,
                                        int hi, int nv) {
  if (lo < hi && ord[hi - 1] < nv) return hi;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ord[mid] < nv) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// One launch, two roles.  Blocks [0, long_blocks): (hash row j, chunk of
// kChunk buckets, slice of 32 columns); warp 0 finds the long runs of its
// chunk from ``starts`` and adds each for its slice.  The other blocks:
// (hash row j, kPositions sorted positions); a position starts a run when
// starts[j][bucket] equals it, and the block's warps add the short runs
// that start in its range, a run a warp.
// With ``n_valid``, items at or past it add nothing: each run is cut at
// its first such item, and a run is long or short by its live length.
// With ``skip_single``, runs of one item are skipped (B1's read writes
// those cells).
template <typename T>
__global__ void run_scatter(Targets<T> tg, const int* __restrict__ order,
                            const int* __restrict__ starts,
                            const int* __restrict__ buckets,
                            const int* __restrict__ n_valid, int width,
                            int ncols, int k, int long_blocks,
                            bool skip_single) {
  __shared__ float s_sgn[4 * 32];        // long runs: signs of 4 batches
  __shared__ int s_run[kPositions][3];  // bucket, lo, hi
  __shared__ int s_runs;
  extern __shared__ float4 s_ring[];
  T* ring = reinterpret_cast<T*>(s_ring);
  const int nv = n_valid != nullptr ? min(max(*n_valid, 0), k) : k;
  T* S;
  const T* x;
  const float* sj;
  if (blockIdx.x < long_blocks) {
    if (threadIdx.x >= 32) return;
    const int slices = (ncols + 31) / 32;
    const int chunks = (width + kChunk - 1) / kChunk;
    const int j = blockIdx.x / (chunks * slices);
    const int rem = blockIdx.x - j * chunks * slices;
    const int chunk = rem / slices, slice = rem - chunk * slices;
    const int* st = starts + (size_t)j * (width + 1);
    const int* ord = order + (size_t)j * k;
    target_of(tg, j, k, S, x, sj);
    // the chunk's buckets are strided, chunk + m * chunks: the heavy
    // slots of a dedup sum are neighbours and go to different blocks
    for (int m0 = 0; m0 < kChunk; m0 += 32) {
      const int b = chunk + (m0 + (int)threadIdx.x) * chunks;
      const int lo = b < width ? st[b] : 0;
      int hi = b < width ? st[b + 1] : 0;
      if (n_valid != nullptr && hi - lo >= kLong) {
        hi = live_end(ord, lo, hi, nv);
      }
      unsigned longs = __ballot_sync(kAll, hi - lo >= kLong);
      while (longs) {
        const int t = __ffs(longs) - 1;
        longs &= longs - 1;
        add_long_run(S + (size_t)__shfl_sync(kAll, b, t) * tg.ld, x, ord, sj,
                     __shfl_sync(kAll, lo, t), __shfl_sync(kAll, hi, t),
                     ncols, slice * 32 + (int)threadIdx.x, ring, s_sgn);
      }
    }
    return;
  }
  const int per_row = (k + kPositions - 1) / kPositions;
  const int bid = blockIdx.x - long_blocks;
  const int j = bid / per_row;
  const int p0 = (bid - j * per_row) * kPositions;
  const int* ord = order + (size_t)j * k;
  const int* st = starts + (size_t)j * (width + 1);
  if (threadIdx.x == 0) s_runs = 0;
  __syncthreads();
  const int p = p0 + threadIdx.x;
  if (threadIdx.x < kPositions && p < k) {
    const int bucket = buckets[(size_t)j * k + ord[p]];
    if (st[bucket] == p && !(skip_single && st[bucket + 1] == p + 1)) {
      int hi = st[bucket + 1];  // p starts its bucket's run
      if (n_valid != nullptr) hi = live_end(ord, p, hi, nv);
      if (hi > p && hi - p < kLong) {
        const int at = atomicAdd(&s_runs, 1);  // runs touch distinct cells
        s_run[at][0] = bucket;
        s_run[at][1] = p;
        s_run[at][2] = hi;
      }
    }
  }
  __syncthreads();
  const int runs = s_runs;
  target_of(tg, j, k, S, x, sj);
  for (int r = threadIdx.x / 32; r < runs; r += blockDim.x / 32) {
    add_short_run(S + (size_t)s_run[r][0] * tg.ld, x, ord, sj, s_run[r][1],
                  s_run[r][2], ncols);
  }
}

}  // namespace

namespace cs {

int launch_run_scatter(const RunScatter& a, cudaStream_t st) {
  if (a.k <= 0 || a.ncols <= 0) return (int)cudaGetLastError();
  if (a.depth0 < 0 || a.depth0 > a.depth ||
      (a.depth0 < a.depth && a.S1 == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const bool vec = a.ncols % 4 == 0 && a.ld % 4 == 0 && aligned(a.S0) &&
                   aligned(a.x0) && aligned(a.S1) && aligned(a.x1);
  const int ncols = vec ? a.ncols / 4 : a.ncols;
  const int ld = vec ? a.ld / 4 : a.ld;
  const long long long_blocks = (long long)a.depth *
                                ((a.width + kChunk - 1) / kChunk) *
                                ((ncols + 31) / 32);
  const long long blocks = long_blocks + (long long)a.depth *
                                             ((a.k + kPositions - 1) /
                                              kPositions);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const size_t ring =
      (size_t)kLongStages * 32 * 32 * (vec ? sizeof(float4) : sizeof(float));
  const cudaError_t e = cudaFuncSetAttribute(
      vec ? (const void*)run_scatter<float4> : (const void*)run_scatter<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring);
  if (e != cudaSuccess) return (int)e;
  if (vec) {
    const Targets<float4> tg{reinterpret_cast<float4*>(a.S0),
                             reinterpret_cast<const float4*>(a.x0), a.s0,
                             a.depth0, a.width0,
                             reinterpret_cast<float4*>(a.S1),
                             reinterpret_cast<const float4*>(a.x1), a.width1,
                             ld};
    run_scatter<float4><<<(unsigned)blocks, kThreads, ring, st>>>(
        tg, a.order, a.starts, a.buckets, a.n_valid, a.width, ncols, a.k,
        (int)long_blocks, a.skip_single);
  } else {
    const Targets<float> tg{a.S0, a.x0, a.s0, a.depth0, a.width0,
                            a.S1, a.x1, a.width1, ld};
    run_scatter<float><<<(unsigned)blocks, kThreads, ring, st>>>(
        tg, a.order, a.starts, a.buckets, a.n_valid, a.width, ncols, a.k,
        (int)long_blocks, a.skip_single);
  }
  return (int)cudaGetLastError();
}

}  // namespace cs

// S (depth, width, d) f32 in place; order (depth, k) and starts (depth,
// width + 1) from bucket_csr of buckets (depth, k); s (depth, k) or null;
// delta (k, d).
extern "C" int cs_update_launch(float* S, const int* order, const int* starts,
                                const int* buckets, const float* s,
                                const float* delta, int depth, int width,
                                int d, int k, void* stream) {
  const cs::RunScatter a{S,     delta,  s,       depth,   width, nullptr,
                         nullptr, width, order,  starts,  buckets, nullptr,
                         depth, width,  d,       d,       k,       false};
  return cs::launch_run_scatter(a, static_cast<cudaStream_t>(stream));
}
