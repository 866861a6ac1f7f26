// KE4: first-occurrence dictionary intern of small-range integers
// (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py device_dict_build's device work:
// a range table of first occurrences (.at[off].min), an argsort of it, a
// rank scatter and the index gather.  Each value's offset
// off = low lane - lo (mod 2^32, below rng <= 2^24) claims its first
// occurrence; the distinct offsets rank by their first occurrence, which
// is the argsort order of the table because its entries are distinct; each
// value's index is its offset's rank.  No sort of the values, and nothing
// leaves the kernels but order, dsize and indices.
//
// Bound on the H100: memory (the values read and the indices written, the
// range table touched).  The parent made six launches (fill, first, a flag
// scan over the values, the scan's tile sums, place, gather), read the
// values four times, and claimed first occurrences with one atomicMin a
// value: repeats of a hot value, which are what makes a column a
// dictionary column, queued on a few L2 lines (263 us on an H100 80GB
// HBM3 for a page of 1.25M values over a range of 6).  Now first
// occurrences are reduced before they reach device memory:
//
// * rng <= R (the wrapper's small range, encode.dict_small_range, 2,048:
//   a block's table fits shared memory), three launches:
//   1. init: first[r] = n, and a block counter zeroed;
//   2. first: each block takes a contiguous run of values (8,192 of them
//      at 16 a thread, more past 528 blocks) and keeps its own
//      first-occurrence table in shared memory.  A thread reads the table
//      before it claims: once a value has occurred in the block, the
//      table holds an earlier index and no atomic follows, so a hot value
//      costs a few shared atomics a block.  The block then claims each
//      offset it saw with one global atomicMin.  The last block to finish
//      (the counter) ranks the table: it sorts (first, offset) pairs in
//      shared memory (a bitonic sort of the next power of two >= rng
//      keys), writes order, dsize and the rank of each offset over
//      `first`;
//   3. gather: each block stages the rank table in shared memory and
//      writes indices[i] = rank[off[i]].
//   The values are read twice; no flag scan, no n-long scratch.  The
//   global claims and the one-block sort grow with the range: on uniform
//   values on an H100 this path was no faster than the flag scan below
//   at 4,096, hence R.
// * rng > R, the parent's flag scan: fill, first (a warp elects the lowest
//   lane of each distinct offset with __match_any_sync before the global
//   atomicMin, which removes a hot value's contention), an inclusive scan
//   of first-occurrence flags per 1,024-value tile, a scan of the tile
//   sums, place (order and ranks), gather.

#include "common.cuh"

namespace {

constexpr int kTile = 1024;
constexpr int kSmallMax = 2048;     // largest small range (shared table)
constexpr int kSmallThreads = 512;
constexpr int kPerThread = 16;      // values a thread of `first` takes
constexpr int kMaxBlocks = 528;     // 4 blocks a streaming multiprocessor

__device__ __forceinline__ uint32_t offset_of(const uint32_t* flat,
                                              int lanes, int64_t i,
                                              uint32_t lo_lane) {
  return __ldg(flat + i * lanes) - lo_lane;
}

__global__ void fill_kernel(int32_t* __restrict__ first, int64_t rng,
                            int32_t n, int32_t* __restrict__ counter) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
  for (int64_t r = t0; r < rng; r += stride) first[r] = n;
  if (t0 == 0 && counter != nullptr) *counter = 0;
}

__global__ void __launch_bounds__(kSmallThreads)
first_small_kernel(const uint32_t* __restrict__ flat, int lanes, int32_t n,
                   uint32_t lo_lane, int32_t rng, int64_t chunk,
                   int32_t* __restrict__ first,
                   int32_t* __restrict__ counter,
                   int32_t* __restrict__ dsize,
                   int32_t* __restrict__ order) {
  // the block's table, then (in the last block) the sort's keys
  __shared__ unsigned long long s_buf[kSmallMax];
  __shared__ bool s_last;
  int32_t* s_first = reinterpret_cast<int32_t*>(s_buf);
  for (int r = threadIdx.x; r < rng; r += kSmallThreads) s_first[r] = n;
  __syncthreads();
  const int64_t a = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t b = a + chunk < n ? a + chunk : n;
  // no warp election here: the table holds an earlier index for all but
  // a value's first few repeats in the block, so reading it first skips
  // nearly every atomic, and __match_any_sync made this kernel slower on
  // an H100 (the more so, the more distinct values a warp holds)
  for (int64_t i = a + threadIdx.x; i < b; i += kSmallThreads) {
    const uint32_t off = offset_of(flat, lanes, i, lo_lane);
    if (off < static_cast<uint32_t>(rng) &&
        s_first[off] > static_cast<int32_t>(i)) {
      atomicMin(s_first + off, static_cast<int32_t>(i));
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rng; r += kSmallThreads) {
    if (s_first[r] < n) atomicMin(first + r, s_first[r]);
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    s_last = atomicAdd(counter, 1) == static_cast<int32_t>(gridDim.x) - 1;
  }
  __syncthreads();
  if (!s_last) return;
  // The last block: every claim is in `first`.  Keys (first << 32 | off)
  // sort present offsets into first-occurrence order, absent ones last.
  __threadfence();
  int p = 1;
  while (p < rng) p <<= 1;
  for (int r = threadIdx.x; r < p; r += kSmallThreads) {
    const int32_t f = r < rng ? __ldcg(first + r) : n;
    s_buf[r] = f < n ? (static_cast<unsigned long long>(f) << 32) |
                           static_cast<uint32_t>(r)
                     : ~0ull;
  }
  __syncthreads();
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < p / 2; t += kSmallThreads) {
        const int lo = 2 * t - (t & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long x = s_buf[lo], y = s_buf[hi];
        if ((x > y) == ((lo & size) == 0)) {
          s_buf[lo] = y;
          s_buf[hi] = x;
        }
      }
      __syncthreads();
    }
  }
  // present keys sort first: dsize is where they end
  for (int r = threadIdx.x; r < p; r += kSmallThreads) {
    const unsigned long long key = s_buf[r];
    if (key != ~0ull) {
      const int32_t off = static_cast<int32_t>(key & 0xffffffffu);
      order[r] = off;
      first[off] = r;  // the rank table, over the first-occurrence table
      if (r + 1 == p || s_buf[r + 1] == ~0ull) *dsize = r + 1;
    } else if (r == 0) {
      *dsize = 0;
    }
  }
}

__global__ void __launch_bounds__(kSmallThreads)
gather_small_kernel(const uint32_t* __restrict__ flat, int lanes, int32_t n,
                    uint32_t lo_lane, int32_t rng,
                    const int32_t* __restrict__ rank,
                    int32_t* __restrict__ indices) {
  __shared__ int32_t s_rank[kSmallMax];
  for (int r = threadIdx.x; r < rng; r += kSmallThreads) {
    s_rank[r] = __ldg(rank + r);
  }
  __syncthreads();
  const int64_t a =
      static_cast<int64_t>(blockIdx.x) * kSmallThreads * kPerThread;
#pragma unroll 4
  for (int u = 0; u < kPerThread; ++u) {
    const int64_t i = a + u * kSmallThreads + threadIdx.x;
    if (i < n) {
      const uint32_t off = offset_of(flat, lanes, i, lo_lane);
      indices[i] = off < static_cast<uint32_t>(rng) ? s_rank[off] : 0;
    }
  }
}

// The lowest lane holding each distinct offset of a warp's 32 values (lanes
// hold consecutive indices, so that lane holds its offset's first index in
// the warp) claims it with one global atomicMin.
__global__ void first_kernel(const uint32_t* __restrict__ flat, int lanes,
                             int32_t n, uint32_t lo_lane, uint32_t rng,
                             int32_t* __restrict__ first) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) & ~int64_t{31};
       base < n; base += stride) {
    const int64_t i = base + lane;
    const bool ok = i < n;
    const unsigned act = __ballot_sync(0xffffffffu, ok);
    if (ok) {
      const uint32_t off = offset_of(flat, lanes, i, lo_lane);
      const unsigned peers = __match_any_sync(act, off);
      if (lane == __ffs(peers) - 1 && off < rng) {
        atomicMin(first + off, static_cast<int32_t>(i));
      }
    }
  }
}

// one tile of kTile values a block: the inclusive scan of the flags
__global__ void scan_kernel(const uint32_t* __restrict__ flat, int lanes,
                            int32_t n, uint32_t lo_lane,
                            const int32_t* __restrict__ first,
                            int32_t* __restrict__ incl,
                            int32_t* __restrict__ tile_sums) {
  __shared__ int smem[32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTile + threadIdx.x;
  int f = 0;
  if (i < n) {
    f = __ldg(first + offset_of(flat, lanes, i, lo_lane)) ==
        static_cast<int32_t>(i);
  }
  const int x = tpq::block_inclusive_scan<int>(f, smem);
  if (i < n) incl[i] = x;
  if (threadIdx.x == kTile - 1) tile_sums[blockIdx.x] = x;
}

// one block: tile_sums becomes each tile's exclusive offset, *dsize the
// total; each thread walks a contiguous run of tiles
__global__ void sums_kernel(int32_t* __restrict__ tile_sums,
                            int64_t n_tiles, int32_t* __restrict__ dsize) {
  __shared__ int smem[32];
  const int64_t per = (n_tiles + kTile - 1) / kTile;
  const int64_t a = static_cast<int64_t>(threadIdx.x) * per;
  const int64_t b = a + per < n_tiles ? a + per : n_tiles;
  int local = 0;
  for (int64_t t = a; t < b; ++t) local += tile_sums[t];
  const int inclusive = tpq::block_inclusive_scan<int>(local, smem);
  int run = inclusive - local;
  for (int64_t t = a; t < b; ++t) {
    const int v = tile_sums[t];
    tile_sums[t] = run;
    run += v;
  }
  if (threadIdx.x == kTile - 1) *dsize = inclusive;
}

__global__ void place_kernel(const uint32_t* __restrict__ flat, int lanes,
                             int32_t n, uint32_t lo_lane,
                             const int32_t* __restrict__ incl,
                             const int32_t* __restrict__ tile_sums,
                             int32_t* __restrict__ rank,
                             int32_t* __restrict__ order) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int base = __ldg(tile_sums + i / kTile);
    const int x = __ldg(incl + i);
    const int prev = (i % kTile) ? __ldg(incl + i - 1) : 0;
    if (x != prev) {  // a first occurrence: its rank is x - 1
      const uint32_t off = offset_of(flat, lanes, i, lo_lane);
      order[base + x - 1] = static_cast<int32_t>(off);
      rank[off] = base + x - 1;
    }
  }
}

__global__ void gather_kernel(const uint32_t* __restrict__ flat, int lanes,
                              int32_t n, uint32_t lo_lane,
                              const int32_t* __restrict__ rank,
                              int32_t* __restrict__ indices) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    indices[i] = __ldg(rank + offset_of(flat, lanes, i, lo_lane));
  }
}

}  // namespace

// flat holds n * lanes words whose low lanes less lo_lane fall in
// [0, rng); small: the wrapper's small range R (<= 2,048).  Scratch:
// first rng words, counter 1; above R also incl n and tile_sums
// ceil(n / 1024).  Out: dsize 1 word, order min(n, rng) (the first dsize
// used), indices n.
extern "C" int tpq_dict_build(const void* flat, int lanes, int64_t n,
                              uint32_t lo_lane, int64_t rng, int small,
                              void* first, void* counter, void* incl,
                              void* tile_sums, void* dsize, void* order,
                              void* indices, void* stream) {
  if (small < 1 || small > kSmallMax) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0 && rng > 0) {
    constexpr int kThreads = 256;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* in = static_cast<const uint32_t*>(flat);
    const int32_t nn = static_cast<int32_t>(n);
    int32_t* tbl = static_cast<int32_t*>(first);
    int32_t* ds = static_cast<int32_t*>(dsize);
    int32_t* ord = static_cast<int32_t*>(order);
    int32_t* idx = static_cast<int32_t*>(indices);
    if (rng <= small) {
      const int32_t r = static_cast<int32_t>(rng);
      int32_t* cnt = static_cast<int32_t*>(counter);
      const int64_t per_block = static_cast<int64_t>(kSmallThreads) *
                                kPerThread;
      int64_t blocks = (n + per_block - 1) / per_block;
      if (blocks > kMaxBlocks) blocks = kMaxBlocks;
      const int64_t chunk = ((n + blocks - 1) / blocks + 31) & ~int64_t{31};
      blocks = (n + chunk - 1) / chunk;
      fill_kernel<<<tpq::grid_for(rng, kThreads), kThreads, 0, s>>>(
          tbl, rng, nn, cnt);
      first_small_kernel<<<static_cast<unsigned>(blocks), kSmallThreads, 0,
                           s>>>(in, lanes, nn, lo_lane, r, chunk, tbl, cnt,
                                ds, ord);
      gather_small_kernel<<<tpq::grid_for(n, kSmallThreads * kPerThread),
                            kSmallThreads, 0, s>>>(in, lanes, nn, lo_lane, r,
                                                   tbl, idx);
    } else {
      int32_t* sc = static_cast<int32_t*>(incl);
      int32_t* sums = static_cast<int32_t*>(tile_sums);
      const int64_t n_tiles = (n + kTile - 1) / kTile;
      fill_kernel<<<tpq::grid_for(rng, kThreads), kThreads, 0, s>>>(
          tbl, rng, nn, nullptr);
      first_kernel<<<tpq::grid_for(n, kThreads), kThreads, 0, s>>>(
          in, lanes, nn, lo_lane, static_cast<uint32_t>(rng), tbl);
      scan_kernel<<<static_cast<unsigned>(n_tiles), kTile, 0, s>>>(
          in, lanes, nn, lo_lane, tbl, sc, sums);
      sums_kernel<<<1, kTile, 0, s>>>(sums, n_tiles, ds);
      place_kernel<<<tpq::grid_for(n, kThreads), kThreads, 0, s>>>(
          in, lanes, nn, lo_lane, sc, sums, tbl, ord);
      gather_kernel<<<tpq::grid_for(n, kThreads), kThreads, 0, s>>>(
          in, lanes, nn, lo_lane, tbl, idx);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
