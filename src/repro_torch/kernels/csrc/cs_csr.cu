// bucket_csr: the items of each hash row grouped by bucket, stably, and
// for each item the last earlier item of its hash row in the same bucket.
//
// Serves B5 (cs_update) and B3 (cs_ema_tiled), whose scatters add each
// bucket's items in item order, and B2 (cs_adam_fused), which forwards a
// cell's value from the item that wrote it last.  The TPU kernels sort
// with the XLA sort before their pallas_call; here one block a hash row
// builds the CSR in three steps, in shared memory when the bucket
// counters fit (width <= 48K buckets; wider rows keep them in device
// memory, in scratch the wrapper allocates):
//
//   1. a histogram of the row's buckets, shared atomics;
//   2. an exclusive scan of the counts over the block: ``starts``;
//   3. a stable placement, kChunk items a chunk, in rounds: in round r,
//      warp 0 walks chunk r-1, while the other warps rank chunk r and
//      write ``order`` for chunk r-2 (three chunk buffers in shared
//      memory).  Ranking: a warp loads a 32-item group's buckets and
//      ranks each lane among the lanes of its bucket (__match_any_sync,
//      __popc(peers & lanemask_lt)) and counts them.  The walk: for each
//      group in order, every lane reads its bucket's cursor, the group's
//      first lane advances it by the group's size, and the lane's
//      position, cursor + rank, goes to shared memory; __syncwarp orders
//      one step's cursors before the next step's.  The walk is the
//      serial part, a few shared-memory operations a group, and the rest
//      of the block works beside it.
//
// With ``prev`` requested, a last pass over the sorted positions writes
// prev[order[p]] = order[p-1] where position p-1 holds the same bucket,
// else -1.  The integers equal those of the plain form (torch.sort,
// stable, then searchsorted; kernels/cs_update.py::bucket_csr_plain).
//
// Bound on the H100: the placement is one warp's chain of k/32 steps
// (a shared cursor read and written a step); the bytes (buckets read
// three times, order, starts and prev written once) are a few hundred
// KB.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSharedBuckets = 48 * 1024;  // cursors kept in shared memory
constexpr int kChunk = 1024;               // items placed per chunk
constexpr int kRankBits = 6;               // rank < 32 < 2^kRankBits

__device__ __forceinline__ unsigned lanemask_lt() {
  unsigned m;
  asm("mov.u32 %0, %%lanemask_lt;" : "=r"(m));
  return m;
}

// Exclusive prefix of x over the block, in thread order; *total gets the
// block's sum.  Every thread of the block calls it.
__device__ int block_exclusive_scan(int x, int* warp_sums, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) warp_sums[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int w = warp_sums[lane];
    int wi = w;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, wi, o);
      if (lane >= o) wi += y;
    }
    warp_sums[lane] = wi - w;
    if (lane == 31) warp_sums[kWarps] = wi;
  }
  __syncthreads();
  *total = warp_sums[kWarps];
  return warp_sums[warp] + incl - x;
}

// kShared: the bucket cursors in shared memory, else in scratch
template <bool kShared>
__global__ void __launch_bounds__(kThreads)
csr_kernel(const int* __restrict__ buckets, int* __restrict__ order,
           int* __restrict__ starts, int* __restrict__ prev,
           int* __restrict__ scratch, int width, int k) {
  extern __shared__ int smem[];
  __shared__ int warp_sums[kWarps + 1];
  const int j = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int* b = buckets + (size_t)j * k;
  int* ord = order + (size_t)j * k;
  int* st = starts + (size_t)j * (width + 1);
  int* cur = kShared ? smem : scratch + (size_t)j * width;
  // chunk x's buckets in sb(x), their rank | count << kRankBits and then
  // their positions in sp(x)
  int* chunk_buf = smem + (kShared ? width : 0);
  auto sb = [&](int x) { return chunk_buf + (x % 3) * 2 * kChunk; };
  auto sp = [&](int x) { return sb(x) + kChunk; };

  // 1. histogram
  for (int w = tid; w < width; w += kThreads) cur[w] = 0;
  __syncthreads();
#pragma unroll 4
  for (int i = tid; i < k; i += kThreads) atomicAdd(&cur[b[i]], 1);
  __syncthreads();

  // 2. exclusive scan: each thread a contiguous span of buckets
  const int per = (width + kThreads - 1) / kThreads;
  const int lo = min(tid * per, width), hi = min(lo + per, width);
  int sum = 0;
  for (int w = lo; w < hi; ++w) sum += cur[w];
  int total;
  int run = block_exclusive_scan(sum, warp_sums, &total);
  for (int w = lo; w < hi; ++w) {
    const int c = cur[w];
    st[w] = run;
    cur[w] = run;
    run += c;
  }
  if (tid == 0) st[width] = total;
  __syncthreads();

  // 3. stable placement, in rounds
  const unsigned lt = lanemask_lt();
  const int chunks = (k + kChunk - 1) / kChunk;
  const int warp = tid / 32;
  for (int r = 0; r <= chunks + 1; ++r) {
    if (warp == 0) {
      const int x = r - 1;  // walk chunk x
      if (x >= 0 && x < chunks) {
        const int n = min(kChunk, k - x * kChunk);
        const int* bx = sb(x);
        int* px = sp(x);
        for (int s0 = 0; s0 < n; s0 += 32) {
          const int t = s0 + lane;
          const int bi = t < n ? bx[t] : -1;
          const int info = t < n ? px[t] : 0;
          const int rank = info & ((1 << kRankBits) - 1);
          const int base = bi >= 0 ? cur[bi] : 0;
          __syncwarp();  // every lane has read its cursor
          if (bi >= 0 && rank == 0) cur[bi] = base + (info >> kRankBits);
          if (bi >= 0) px[t] = base + rank;
          __syncwarp();
        }
      }
    } else {
      if (r < chunks) {  // rank chunk r, a 32-item group a warp
        const int c0 = r * kChunk, n = min(kChunk, k - c0);
        int* bx = sb(r);
        int* px = sp(r);
        for (int g = warp - 1; g * 32 < n; g += kWarps - 1) {
          const int t = g * 32 + lane;
          const int bi = t < n ? b[c0 + t] : -1;
          const unsigned peers = __match_any_sync(0xffffffffu, bi);
          if (t < n) {
            bx[t] = bi;
            px[t] = __popc(peers & lt) | __popc(peers) << kRankBits;
          }
        }
      }
      if (r >= 2) {  // write order for chunk r-2
        const int c0 = (r - 2) * kChunk, n = min(kChunk, k - c0);
        const int* px = sp(r - 2);
        for (int t = tid - 32; t < n; t += kThreads - 32) {
          ord[px[t]] = c0 + t;
        }
      }
    }
    __syncthreads();
  }
  if (prev == nullptr) return;

  // prev: the item before in sorted order, where it shares the bucket
  int* pv = prev + (size_t)j * k;
  for (int p = tid; p < k; p += kThreads) {
    const int i = ord[p];
    int q = -1;
    if (p > 0) {
      const int h = ord[p - 1];
      if (b[h] == b[i]) q = h;
    }
    pv[i] = q;
  }
}

}  // namespace

// buckets (depth, k) int32 in [0, width); order (depth, k), starts
// (depth, width + 1) and, when not null, prev (depth, k) int32 out;
// scratch (depth, width) int32 when width > kSharedBuckets
// (cs_update.py::SHARED_BUCKETS), else null.
extern "C" int bucket_csr_launch(const int* buckets, int* order, int* starts,
                                 int* prev, int* scratch, int depth,
                                 int width, int k, void* stream) {
  if (depth <= 0 || width <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if ((width > kSharedBuckets) != (scratch != nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t chunk = 3 * 2 * kChunk * sizeof(int);
  if (scratch != nullptr) {
    csr_kernel<false><<<depth, kThreads, chunk, s>>>(
        buckets, order, starts, prev, scratch, width, k);
    return (int)cudaGetLastError();
  }
  const size_t shm = (size_t)width * sizeof(int) + chunk;
  if (shm > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        csr_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shm);
    if (e != cudaSuccess) return (int)e;
  }
  csr_kernel<true><<<depth, kThreads, shm, s>>>(buckets, order, starts, prev,
                                                nullptr, width, k);
  return (int)cudaGetLastError();
}
