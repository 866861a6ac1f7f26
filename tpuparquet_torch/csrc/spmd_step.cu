// KS2: the SPMD dictionary decode step, one mesh slot's share (sm_90a).
//
// Replaces tpuparquet/shard/mesh.py decode_step_spmd (a shard_map of
// kernels/hybrid.py expand_hybrid_core, vmapped over the units of an "rg"
// block, then a dictionary gather and all-gathers over "sp" and "rg").  A
// slot (r, s) of the (rg, sp) mesh decodes the units of rg block r at the
// value positions [pos0, pos0 + n_pos) of its sp slice: for each unit u
// and position i,
//   run    = searchsorted(run_ends[u], i, side="right"), clamped to R - 1
//   within = i - (run > 0 ? run_ends[u][run - 1] : 0)
//   index  = run_is_rle[u][run] ? run_value[u][run]
//            : lane clip(run_bp_start[u][run] + within, 0, n_bp - 1) of
//              unit u's bit-packed words at width max(width, 1)
//   out[unit0 + u][i][:] = dictionary[min(index, D - 1)][:]
// and writes them straight into its place in the (U, count, lanes) output,
// so the all-gathers reduce to copies between the mesh's distinct devices
// (none where the slots share one card).  Every JAX implicit clamp is
// explicit here.
//
// Bound on the H100: memory, and almost all of it the output.  A value
// writes 4 * lanes bytes and reads width / 8 bytes of packed lanes; the
// run tables (13 bytes a run) and the dictionary are small.  At phase 4's
// shape (8 units of 2^21 positions, 8 lanes) the output is 512 MiB, ten
// times the L2.
//
// The parent ran one thread per (unit, position): a 64-bit division, a
// binary search of a dozen dependent loads over the unit's run ends, and
// `lanes` scalar stores, each `lanes * 4` bytes from its neighbour's, so
// one warp-wide store touched 32 sectors to write 128 bytes (0.89 TB/s).
// This design gives a block a tile of `tile` consecutive positions of one
// unit (blockIdx.y; no division a value):
// - Two warps find the runs of the tile's first and last positions at
//   once, each by a 32-way search over the unit's run ends (a round of 32
//   loads narrows the range 32-fold, so 3 rounds for 32,768 runs).  The
//   runs between them, with each run's start, RLE flag and value or
//   bit-packed start, are staged in shared memory with coalesced loads.
//   Positions past the unit's last run end take run R - 1 through the
//   same clamp, RLE padding run or the real last run, so the tile that
//   holds a unit's end meets every padding run of its row; past
//   kStageRuns runs (a short unit beside one of thousands of runs) its
//   threads search device memory in that range instead.
// - Each thread takes positions of the tile, finds its run by bisection
//   in the staged slice, and writes the clamped dictionary index to
//   shared memory, one word a position.
// - The tile's output, `tile * lanes` contiguous words, is written in
//   16-byte streaming stores on the output's own 16-byte boundaries
//   (word e is lane e mod lanes of position e / lanes), with scalar heads
//   and tails where a slot's share starts off a boundary.  The
//   dictionary is staged in shared memory when it holds at most
//   kDictWords words, and read through the cache otherwise.
// One launch a call; nothing to zero first.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 512;     // positions a block can hold
constexpr int kStageRuns = 512;   // runs a tile stages in shared memory
constexpr int kDictWords = 2048;  // dictionary words staged (8 KiB)

// kLanes: the dictionary's lanes at compile time (0: `lanes_rt`).  The
// 8 lanes of phase 6d's lane groups compile with the count fixed, so a
// word's position and lane are shifts and 4 lanes of an entry are one
// 16-byte load; other lane counts divide at run time, which was markedly
// slower on the card at 8 lanes.
template <int kLanes>
__global__ void __launch_bounds__(kThreads) spmd_tile_kernel(
    const uint32_t* __restrict__ bw, int64_t row_words,
    const int32_t* __restrict__ run_ends, const uint8_t* __restrict__ is_rle,
    const uint32_t* __restrict__ run_value,
    const int32_t* __restrict__ bp_start, int R,
    const uint32_t* __restrict__ dict, int64_t D, int lanes_rt,
    int64_t pos0, int64_t n_pos, int tile, int wu, int64_t n_bp,
    uint32_t* __restrict__ out, int64_t count, int64_t unit0) {
  __shared__ uint32_t s_idx[kMaxTile];
  __shared__ int32_t s_start[kStageRuns], s_end[kStageRuns];
  __shared__ uint32_t s_word[kStageRuns];  // RLE: the value; else bp_start
  __shared__ uint8_t s_rle[kStageRuns];
  __shared__ __align__(16) uint32_t s_dict[kDictWords];
  __shared__ int s_run[2];

  const int lanes = kLanes > 0 ? kLanes : lanes_rt;
  const int64_t u = blockIdx.y;
  const int64_t t0 = pos0 + static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t left = pos0 + n_pos - t0;
  const int nt = static_cast<int>(left < tile ? left : tile);
  const int32_t* ends = run_ends + u * R;
  const int64_t row = u * R;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // the runs of the tile's first and last positions, two warps at once,
  // while the other warps stage the dictionary
  if (warp < 2) {
    const int64_t x = warp == 0 ? t0 : t0 + nt - 1;
    const int r = tpq::warp_upper_bound(ends, R, x, lane);
    if (lane == 0) s_run[warp] = r < R - 1 ? r : R - 1;
  }
  const int64_t d_words = D * lanes;
  const bool dict_staged = d_words <= kDictWords;
  if (dict_staged) {
    for (int k = threadIdx.x; k < d_words; k += kThreads) {
      s_dict[k] = __ldg(dict + k);
    }
  }
  __syncthreads();
  const int rf = s_run[0];
  const int nr = s_run[1] - rf + 1;
  const bool staged = nr <= kStageRuns;
  if (staged) {
    for (int j = threadIdx.x; j < nr; j += kThreads) {
      const int r = rf + j;
      const bool rle = __ldg(is_rle + row + r) != 0;
      s_end[j] = __ldg(ends + r);
      s_start[j] = r > 0 ? __ldg(ends + r - 1) : 0;
      s_rle[j] = rle;
      s_word[j] = rle ? __ldg(run_value + row + r)
                      : static_cast<uint32_t>(__ldg(bp_start + row + r));
    }
    __syncthreads();
  }

  // each position's clamped dictionary index into shared memory: its run
  // is the first of [rf, rf + nr - 1) whose end passes it, else the last
  const uint32_t* words = bw + u * row_words;
  const int64_t d_last = D - 1;
  for (int k = threadIdx.x; k < nt; k += kThreads) {
    const int64_t i = t0 + k;
    int64_t start;
    bool rle;
    uint32_t w;
    if (staged) {
      int lo = 0, hi = nr - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (static_cast<int64_t>(s_end[mid]) <= i) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      start = s_start[lo];
      rle = s_rle[lo] != 0;
      w = s_word[lo];
    } else {
      int lo = rf, hi = rf + nr - 1;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (static_cast<int64_t>(__ldg(ends + mid)) <= i) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      start = lo > 0 ? __ldg(ends + lo - 1) : 0;
      rle = __ldg(is_rle + row + lo) != 0;
      w = rle ? __ldg(run_value + row + lo)
              : static_cast<uint32_t>(__ldg(bp_start + row + lo));
    }
    uint32_t idx = w;
    if (!rle) {
      int64_t p = static_cast<int64_t>(static_cast<int32_t>(w)) + (i - start);
      p = p < 0 ? 0 : (p > n_bp - 1 ? n_bp - 1 : p);
      idx = tpq::unpack_lane(words, p, wu);
    }
    s_idx[k] = static_cast<int64_t>(idx) < d_last
                   ? idx
                   : static_cast<uint32_t>(d_last);
  }
  __syncthreads();

  // the tile's words out: scalar head up to a 16-byte boundary, 16-byte
  // streaming stores, scalar tail
  const uint32_t* dsrc = dict_staged ? s_dict : dict;
  uint32_t* dst = out + ((unit0 + u) * count + t0) * lanes;
  const int nw = nt * lanes;
  int head = static_cast<int>(
      (4 - ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3)) & 3);
  head = head < nw ? head : nw;
  const int body = (nw - head) >> 2;
  const int tail = head + 4 * body;
  const int n_scalar = head + nw - tail;  // at most 6
  for (int k = threadIdx.x; k < n_scalar; k += kThreads) {
    const int e = k < head ? k : tail + (k - head);
    const int p = e / lanes;
    __stcs(dst + e, dsrc[static_cast<int64_t>(s_idx[p]) * lanes +
                         (e - p * lanes)]);
  }
  if (kLanes > 0 && kLanes % 4 == 0 && head == 0 && dict_staged) {
    // a chunk is 4 lanes of one entry: one 16-byte shared-memory load
    for (int c = threadIdx.x; c < body; c += kThreads) {
      const int e = 4 * c;
      const int p = e / lanes;
      __stcs(reinterpret_cast<uint4*>(dst + e),
             *reinterpret_cast<const uint4*>(
                 s_dict + s_idx[p] * lanes + (e - p * lanes)));
    }
    return;
  }
  for (int c = threadIdx.x; c < body; c += kThreads) {
    const int e = head + 4 * c;
    int p = e / lanes;
    int l = e - p * lanes;
    uint32_t v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      v[q] = dsrc[static_cast<int64_t>(s_idx[p]) * lanes + l];
      if (++l == lanes) {
        l = 0;
        ++p;
      }
    }
    __stcs(reinterpret_cast<uint4*>(dst + e),
           make_uint4(v[0], v[1], v[2], v[3]));
  }
}

}  // namespace

// `out` is the whole (U, count, lanes) output; this launch writes units
// [unit0, unit0 + n_units) at positions [pos0, pos0 + n_pos).  The unit
// arrays hold the n_units rows of this slot's rg block.  `wu` is
// max(width, 1).  `tile` (1..512 positions a block) comes from the
// wrapper (gather.spmd_tile_positions); n_units <= 65535 and lanes <=
// 2^20.
extern "C" int tpq_spmd_step(const void* bw, int64_t row_words,
                             const void* run_ends, const void* is_rle,
                             const void* run_value, const void* bp_start,
                             int R, const void* dict, int64_t D, int lanes,
                             int64_t n_units, int64_t pos0, int64_t n_pos,
                             int tile, int wu, int64_t n_bp, void* out,
                             int64_t count, int64_t unit0, void* stream) {
  if (tile < 1 || tile > kMaxTile || n_units > 65535 || lanes < 1 ||
      lanes > (1 << 20)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_units > 0 && n_pos > 0) {
    const dim3 grid(static_cast<unsigned>((n_pos + tile - 1) / tile),
                    static_cast<unsigned>(n_units));
    const auto kernel =
        lanes == 8 ? &spmd_tile_kernel<8> : &spmd_tile_kernel<0>;
    kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bw), row_words,
        static_cast<const int32_t*>(run_ends),
        static_cast<const uint8_t*>(is_rle),
        static_cast<const uint32_t*>(run_value),
        static_cast<const int32_t*>(bp_start), R,
        static_cast<const uint32_t*>(dict), D, lanes, pos0, n_pos, tile, wu,
        n_bp, static_cast<uint32_t*>(out), count, unit0);
  }
  return static_cast<int>(cudaGetLastError());
}
