// KE4: first-occurrence dictionary intern of small-range integers
// (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py device_dict_build's device work:
// a range table of first occurrences (.at[off].min), an argsort of it, a
// rank scatter and the index gather.  Each value's offset
// off = low lane - lo (mod 2^32, below rng <= 2^24) claims its first
// occurrence with atomicMin; value i is a first occurrence when the
// table holds i at its offset; an exclusive scan of those flags in index
// order gives each first occurrence its rank, which is the argsort order
// of the table because its entries are distinct.  So:
//   1. first[r] = n, then atomicMin(first[off[i]], i);
//   2. flag[i] = first[off[i]] == i, inclusive scan per 1024-value tile;
//   3. a scan of the tile sums (one block) and the dictionary size;
//   4. order[rank] = off and rank[off] = rank for every first occurrence
//      (the rank table reuses `first`, which step 4 no longer reads);
//   5. indices[i] = rank[off[i]].
// No sort, and nothing leaves the kernel but order, dsize and indices.
//
// Bound on the H100: memory (the values read and the indices written,
// the range table touched).  The atomics of step 1 contend only on
// repeated values, and repeats of a hot value are what makes a column a
// dictionary column: a later PR may first reduce within a warp.

#include "common.cuh"

namespace {

constexpr int kTile = 1024;

__device__ __forceinline__ uint32_t offset_of(const uint32_t* flat,
                                              int lanes, int64_t i,
                                              uint32_t lo_lane) {
  return __ldg(flat + i * lanes) - lo_lane;
}

__global__ void fill_kernel(int32_t* __restrict__ first, int64_t rng,
                            int32_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < rng; r += stride) {
    first[r] = n;
  }
}

__global__ void first_kernel(const uint32_t* __restrict__ flat, int lanes,
                             int32_t n, uint32_t lo_lane,
                             int32_t* __restrict__ first) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    atomicMin(first + offset_of(flat, lanes, i, lo_lane),
              static_cast<int32_t>(i));
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
// [0, rng); scratch: first rng words, incl n, tile_sums ceil(n / 1024);
// out: dsize 1 word, order min(n, rng) (the first dsize used), indices n.
extern "C" int tpq_dict_build(const void* flat, int lanes, int64_t n,
                              uint32_t lo_lane, int64_t rng, void* first,
                              void* incl, void* tile_sums, void* dsize,
                              void* order, void* indices, void* stream) {
  if (n > 0 && rng > 0) {
    constexpr int kThreads = 256;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* in = static_cast<const uint32_t*>(flat);
    const int32_t nn = static_cast<int32_t>(n);
    int32_t* tbl = static_cast<int32_t*>(first);
    int32_t* sc = static_cast<int32_t*>(incl);
    int32_t* sums = static_cast<int32_t*>(tile_sums);
    const int64_t n_tiles = (n + kTile - 1) / kTile;
    fill_kernel<<<tpq::grid_for(rng, kThreads), kThreads, 0, s>>>(tbl, rng,
                                                                  nn);
    first_kernel<<<tpq::grid_for(n, kThreads), kThreads, 0, s>>>(
        in, lanes, nn, lo_lane, tbl);
    scan_kernel<<<static_cast<unsigned>(n_tiles), kTile, 0, s>>>(
        in, lanes, nn, lo_lane, tbl, sc, sums);
    sums_kernel<<<1, kTile, 0, s>>>(sums, n_tiles,
                                    static_cast<int32_t*>(dsize));
    place_kernel<<<tpq::grid_for(n, kThreads), kThreads, 0, s>>>(
        in, lanes, nn, lo_lane, sc, sums, tbl, static_cast<int32_t*>(order));
    gather_kernel<<<tpq::grid_for(n, kThreads), kThreads, 0, s>>>(
        in, lanes, nn, lo_lane, tbl, static_cast<int32_t*>(indices));
  }
  return static_cast<int>(cudaGetLastError());
}
