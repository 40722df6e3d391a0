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
//     position
//     starts a run when starts[j][bucket] equals it, so the host sizes the
//     grid without reading anything back, and a block whose positions
//     start no run exits.  The block adds its runs with all threads along
//     d (float4 when d % 4 == 0 and the pointers allow), reads a run's
//     item indices and signs once into shared memory, and copies the item
//     rows with cp.async into a ring, kStages-1 groups of kGroup rows ahead
//     of the adds, so the loads are in flight together whatever the
//     compiler schedules.
//   * long runs (the zipf head: 1,500 items in one bucket): a column's
//     adds are one chain, and one block keeps too few rows in flight for
//     it (Little's law: a run's bytes over the rows in flight times the
//     latency).  So the long runs are found from starts by blocks of
//     their own, one warp for each 32-column slice on its own SM, each
//     with a ring of about 64 rows in flight.  Those blocks come first in
//     the grid and run beside the short runs.
#include "cs_common.cuh"

namespace {

constexpr int kBatch = 128;     // short runs: item indices staged at a time
constexpr int kGroup = 4;       // short runs: rows a cp.async group copies
constexpr int kStages = 4;      // short runs: groups in a thread's ring
constexpr int kLong = 64;       // a run this long or longer is a long run
constexpr int kChunk = 256;     // buckets a long-run block scans
constexpr int kLongStages = 3;  // long runs: batches of 32 rows in the ring
constexpr int kMaxThreads = 512;  // so that the ring fits: 128 KB of float4
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

// A short run order[lo..hi) of hash row j added into the sketch row
// ``row``.  Every thread of the block calls it; T is float or float4.
// Each thread copies its own columns of the item rows into its slots of
// ``ring`` (kStages * kGroup rows), kStages-1 groups ahead of the adds.
template <typename T>
__device__ __forceinline__ void add_short_run(
    T* __restrict__ row, const T* __restrict__ x, const int* __restrict__ ord,
    const float* __restrict__ sj, int lo, int hi, int ncols, int* s_row,
    float* s_sign, T* ring) {
  for (int c0 = 0; c0 < ncols; c0 += blockDim.x) {
    const int c = c0 + threadIdx.x;
    const bool on = c < ncols;
    T acc;
    if (on) acc = row[c];
    for (int q0 = lo; q0 < hi; q0 += kBatch) {
      const int n = min(kBatch, hi - q0);
      __syncthreads();  // the previous batch is consumed
      for (int t = threadIdx.x; t < n; t += blockDim.x) {
        const int r = ord[q0 + t];
        s_row[t] = r;
        s_sign[t] = sj != nullptr ? sj[r] : 1.0f;
      }
      __syncthreads();
      if (!on) continue;
      const int groups = (n + kGroup - 1) / kGroup;
      auto issue = [&](int gi) {
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          const int q = gi * kGroup + t;
          if (gi < groups && q < n) {
            copy(&ring[((gi % kStages) * kGroup + t) * blockDim.x +
                       threadIdx.x],
                 &x[(size_t)s_row[q] * ncols + c]);
          }
        }
        cs::cp_async_commit();
      };
      for (int gi = 0; gi < kStages - 1; ++gi) issue(gi);
      for (int gi = 0; gi < groups; ++gi) {
        issue(gi + kStages - 1);
        cs::cp_async_wait<kStages - 1>();  // group gi has landed
#pragma unroll
        for (int t = 0; t < kGroup; ++t) {
          const int q = gi * kGroup + t;
          if (q < n) {
            acc = add_signed(acc, s_sign[q],
                             ring[((gi % kStages) * kGroup + t) * blockDim.x +
                                  threadIdx.x]);
          }
        }
      }
      cs::cp_async_wait<0>();
    }
    if (on) row[c] = acc;
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

// One launch, two roles.  Blocks [0, long_blocks): (hash row j, chunk of
// kChunk buckets, slice of 32 columns); warp 0 finds the long runs of its
// chunk from ``starts`` and adds each for its slice.  The other blocks:
// (hash row j, kPositions sorted positions); a position starts a run when
// starts[j][bucket] equals it, and the block adds the short runs that
// start in its range, one after another, with all its threads along d.
template <typename T>
__global__ void run_scatter(T* __restrict__ S, const T* __restrict__ x,
                            const int* __restrict__ order,
                            const int* __restrict__ starts,
                            const int* __restrict__ buckets,
                            const float* __restrict__ s, int width,
                            int ncols, int k, int long_blocks) {
  __shared__ int s_row[kBatch];
  __shared__ float s_sign[kBatch];
  __shared__ int s_run[kPositions][3];  // bucket, lo, hi
  __shared__ int s_runs;
  extern __shared__ float4 s_ring[];
  T* ring = reinterpret_cast<T*>(s_ring);
  if (blockIdx.x < long_blocks) {
    if (threadIdx.x >= 32) return;
    const int slices = (ncols + 31) / 32;
    const int chunks = (width + kChunk - 1) / kChunk;
    const int j = blockIdx.x / (chunks * slices);
    const int rem = blockIdx.x - j * chunks * slices;
    const int chunk = rem / slices, slice = rem - chunk * slices;
    const int* st = starts + (size_t)j * (width + 1);
    const int end = min(width, (chunk + 1) * kChunk);
    for (int b0 = chunk * kChunk; b0 < end; b0 += 32) {
      const int b = b0 + threadIdx.x;
      const int lo = b < end ? st[b] : 0, hi = b < end ? st[b + 1] : 0;
      unsigned longs = __ballot_sync(kAll, hi - lo >= kLong);
      while (longs) {
        const int t = __ffs(longs) - 1;
        longs &= longs - 1;
        add_long_run(S + ((size_t)j * width + b0 + t) * ncols, x,
                     order + (size_t)j * k,
                     s != nullptr ? s + (size_t)j * k : nullptr,
                     __shfl_sync(kAll, lo, t), __shfl_sync(kAll, hi, t),
                     ncols, slice * 32 + (int)threadIdx.x, ring,
                     reinterpret_cast<float*>(s_row));
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
    if (st[bucket] == p) {  // p starts its bucket's run
      const int hi = st[bucket + 1];
      if (hi - p < kLong) {
        const int at = atomicAdd(&s_runs, 1);  // runs touch distinct cells
        s_run[at][0] = bucket;
        s_run[at][1] = p;
        s_run[at][2] = hi;
      }
    }
  }
  __syncthreads();
  const int runs = s_runs;
  const float* sj = s != nullptr ? s + (size_t)j * k : nullptr;
  for (int r = 0; r < runs; ++r) {
    add_short_run(S + ((size_t)j * width + s_run[r][0]) * ncols, x, ord, sj,
                  s_run[r][1], s_run[r][2], ncols, s_row, s_sign, ring);
  }
}

}  // namespace

// S (depth, width, d) f32 in place; order (depth, k) and starts (depth,
// width + 1) from bucket_csr of buckets (depth, k); s (depth, k) or null;
// delta (k, d).
extern "C" int cs_update_launch(float* S, const int* order, const int* starts,
                                const int* buckets, const float* s,
                                const float* delta, int depth, int width,
                                int d, int k, void* stream) {
  if (k <= 0 || d <= 0) return (int)cudaGetLastError();
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = d % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(S) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(delta) % 16 == 0;
  const int ncols = vec ? d / 4 : d;
  const long long long_blocks = (long long)depth *
                                ((width + kChunk - 1) / kChunk) *
                                ((ncols + 31) / 32);
  const long long blocks =
      long_blocks + (long long)depth * ((k + kPositions - 1) / kPositions);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int warps32 = (ncols + 31) / 32 * 32;
  // at least one warp: the first kPositions threads test the positions
  const int threads = warps32 < kMaxThreads ? warps32 : kMaxThreads;
  const size_t cell = vec ? sizeof(float4) : sizeof(float);
  const size_t short_ring = (size_t)kStages * kGroup * threads * cell;
  const size_t long_ring = (size_t)kLongStages * 32 * 32 * cell;
  const size_t ring = short_ring > long_ring ? short_ring : long_ring;
  const cudaError_t e = cudaFuncSetAttribute(
      vec ? (const void*)run_scatter<float4> : (const void*)run_scatter<float>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)ring);
  if (e != cudaSuccess) return (int)e;
  if (vec) {
    run_scatter<float4><<<(unsigned)blocks, threads, ring, st>>>(
        reinterpret_cast<float4*>(S), reinterpret_cast<const float4*>(delta),
        order, starts, buckets, s, width, ncols, k, (int)long_blocks);
  } else {
    run_scatter<float><<<(unsigned)blocks, threads, ring, st>>>(
        S, delta, order, starts, buckets, s, width, ncols, k,
        (int)long_blocks);
  }
  return (int)cudaGetLastError();
}
