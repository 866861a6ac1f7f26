// K2: RLE/bit-packed hybrid run expansion from a packed run table (sm_90a).
//
// Replaces tpuparquet/kernels/hybrid.py expand_hybrid_core / expand_hybrid
// and decode.py _expand_tbl / expand_tbl (XLA-jitted in the JAX package),
// the expansion of level and dictionary-index streams whose run table the
// host planner did not collapse into one bit-packed run (a single run is
// K1's).  A dictionary page whose index stream is a run table expands it
// here, and K3 gathers from the result.  For output slot i of the packed
// (4, R) table (rows run_ends, is_rle, value, bp_start; the layout of
// tpuparquet/kernels/hybrid.py pack_plan):
//   run    = searchsorted(run_ends, i, side="right"), clamped to R - 1
//   within = i - (run > 0 ? run_ends[run - 1] : 0)
//   RLE run: value[run]; else lane clip(bp_start[run] + within, 0, nbp - 1)
// with the ends and bp_start read as int32.  JAX clamps those gathers
// silently; here every clamp is explicit.
//
// Bound on the H100: memory.  Per output slot it writes 4 bytes and reads
// at most w/8 bytes of packed lanes; the run table (16 bytes a run) is
// small.  The JAX version materialised every unpacked lane first and then
// gathered from it; this kernel unpacks a slot's lane where it needs it.
//
// One thread a slot would run a chain of about 9 dependent loads (a
// binary search of the run ends in device memory, the run's flag, its
// value or start, its packed words) for one 4-byte store, though almost
// every neighbouring slot lies in the same run.  So a block owns a tile
// of 2,048 consecutive slots and searches once for all of them:
// - The block finds the runs of the tile's first and last slots and
//   stages the runs between them (each run's start, end, flag and value or
//   bp_start) in shared memory.  A table of at most 32 runs (the planner
//   pads every shorter table to 32) takes one round of loads: warp 0
//   reads the whole table, a lane a run, and counts the ends at or below
//   each slot by a ballot, the last round of a 32-way search.  A longer
//   table takes two warps' 32-way searches of the ends (as KS2 and K5 do),
//   then the staging; past kStageRuns runs in a tile (a run-dense level
//   stream, a corrupt table) the threads search device memory in the same
//   range instead.  Staging tables of up to 256 runs whole, or tiles of
//   4,096 slots, was slower on the card.
// - Thread t of a warp holds slots 4t..4t+3 of the warp's 128-slot row,
//   2 rows a thread, 1,024 slots apart, as K1 lays out its lanes.  It
//   bisects for its first slot's run and walks forward for the other
//   three.  Four slots of one RLE run take its value; four slots of one
//   bit-packed run whose lanes need no clamp unpack together
//   (tpq::unpack4 at a templated width, as K1 does); other slots one by
//   one (tpq::unpack1).
// - A thread's 4 slots go out as one 16-byte store, so a warp's row is
//   one contiguous 512-byte store; slots past the count are stored one by
//   one.
// One launch a call, nothing to zero first.

#include <array>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                     // slots a thread holds a row
constexpr int kRowSlots = kThreads * kVec;  // 1,024 slots a block's row
constexpr int kRows = 2;                    // rows a thread holds
constexpr int kTile = kRowSlots * kRows;    // 2,048 slots a block
constexpr int kStageRuns = 256;             // runs a tile stages
constexpr unsigned kFull = 0xffffffffu;

// The tile's runs [rf, rf + nr) staged in shared memory: run j starts at
// bound[j] and ends at bound[j + 1]; word[j] is its value (RLE) or its
// bp_start (bit-packed).
struct Staged {
  const int32_t* bound;
  const uint32_t* word;
  const uint8_t* rle;
  __device__ int64_t end(int j) const { return bound[j + 1]; }
  __device__ int64_t start(int j) const { return bound[j]; }
  __device__ bool is_rle(int j) const { return rle[j] != 0; }
  __device__ uint32_t value(int j) const { return word[j]; }
  __device__ int64_t bp_start(int j) const {
    return static_cast<int32_t>(word[j]);
  }
};

// The same runs read from the table in device memory.
struct Global {
  const int32_t* ends;  // run_ends + rf
  const uint32_t* table;  // the (4, R) table, columns offset by rf
  int R, rf;
  __device__ int64_t end(int j) const { return __ldg(ends + j); }
  __device__ int64_t start(int j) const {
    return rf + j > 0 ? __ldg(ends + j - 1) : 0;
  }
  __device__ bool is_rle(int j) const { return __ldg(table + R + j) != 0u; }
  __device__ uint32_t value(int j) const { return __ldg(table + 2 * R + j); }
  __device__ int64_t bp_start(int j) const {
    return static_cast<int32_t>(__ldg(table + 3 * R + j));
  }
};

// Slots i0..i0+3 from runs [0, nr) of `runs`, whose range holds the run
// of every slot of the tile: run k < nr - 1 ends before end(k), run nr - 1
// takes the rest (the clamp to R - 1 included).
template <int W, typename Runs>
__device__ __forceinline__ uint4 expand4(const Runs& runs, int nr,
                                         int64_t i0,
                                         const uint32_t* __restrict__ words,
                                         int64_t nbp) {
  int lo = 0, hi = nr - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (runs.end(mid) <= i0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  int run[kVec];
  run[0] = lo;
#pragma unroll
  for (int v = 1; v < kVec; ++v) {
    while (lo < nr - 1 && runs.end(lo) <= i0 + v) ++lo;
    run[v] = lo;
  }
  if (run[0] == run[kVec - 1]) {
    const int j = run[0];
    if (runs.is_rle(j)) {
      const uint32_t x = runs.value(j);
      return make_uint4(x, x, x, x);
    }
    const int64_t pos = runs.bp_start(j) + (i0 - runs.start(j));
    if (pos >= 0 && pos + kVec <= nbp) {
      const uint64_t bit = static_cast<uint64_t>(pos) * W;
      const uint32_t* p = words + (bit >> 5);
      return tpq::unpack4<W>([p](int k) { return __ldg(p + k); },
                             static_cast<uint32_t>(bit & 31));
    }
  }
  uint32_t x[kVec];
#pragma unroll
  for (int v = 0; v < kVec; ++v) {
    const int j = run[v];
    if (runs.is_rle(j)) {
      x[v] = runs.value(j);
    } else {
      int64_t pos = runs.bp_start(j) + (i0 + v - runs.start(j));
      pos = pos < 0 ? 0 : (pos > nbp - 1 ? nbp - 1 : pos);
      const uint64_t bit = static_cast<uint64_t>(pos) * W;
      x[v] = tpq::unpack1<W>(words + (bit >> 5),
                             static_cast<uint32_t>(bit & 31));
    }
  }
  return make_uint4(x[0], x[1], x[2], x[3]);
}

// W = max(width, 1), the width the bit-packed lanes are read at.
template <int W>
__global__ void __launch_bounds__(kThreads) expand_kernel(
    const uint32_t* __restrict__ words, const uint32_t* __restrict__ table,
    int R, uint32_t* __restrict__ out, int64_t cnt, int64_t nbp) {
  __shared__ int32_t s_bound[kStageRuns + 1];
  __shared__ uint32_t s_word[kStageRuns];
  __shared__ uint8_t s_rle[kStageRuns];
  __shared__ int s_run[2];

  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t rest = cnt - base;
  const int left = static_cast<int>(rest < kTile ? rest : kTile);
  const auto* ends = reinterpret_cast<const int32_t*>(table);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  int rf, nr;
  bool staged;
  if (R <= 32) {
    // a table of at most 32 runs: warp 0 loads it whole in one round,
    // counts the ends at or below the tile's first and last slots (the
    // runs' searchsorted, clamped to R - 1), and stages the runs between
    if (warp == 0) {
      const bool in = lane < R;
      const int32_t e = in ? __ldg(ends + lane) : 0;
      const uint32_t fl = in ? __ldg(table + R + lane) : 0u;
      const uint32_t va = in ? __ldg(table + 2 * R + lane) : 0u;
      const uint32_t bs = in ? __ldg(table + 3 * R + lane) : 0u;
      int first = __popc(__ballot_sync(kFull, in && e <= base));
      int last = __popc(__ballot_sync(kFull, in && e <= base + left - 1));
      first = first < R - 1 ? first : R - 1;
      last = last < R - 1 ? last : R - 1;
      last = last >= first ? last : first;
      const int32_t prev = __shfl_up_sync(kFull, e, 1);
      if (lane >= first && lane <= last) {
        s_bound[lane - first + 1] = e;
        s_rle[lane - first] = fl != 0u;
        s_word[lane - first] = fl != 0u ? va : bs;
      }
      if (lane == first) s_bound[0] = first > 0 ? prev : 0;
      if (lane == 0) {
        s_run[0] = first;
        s_run[1] = last;
      }
    }
    __syncthreads();
    rf = s_run[0];
    nr = s_run[1] - rf + 1;
    staged = true;
  } else {
    // the runs of the tile's first and last slots, two warps at once
    if (warp < 2) {
      const int r = tpq::warp_upper_bound(
          ends, R, base + (warp ? left - 1 : 0), lane);
      if (lane == 0) s_run[warp] = r < R - 1 ? r : R - 1;
    }
    __syncthreads();
    rf = s_run[0];
    nr = s_run[1] >= rf ? s_run[1] - rf + 1 : 1;  // ends must rise
    staged = nr <= kStageRuns;
    if (staged) {
      for (int j = threadIdx.x; j < nr; j += kThreads) {
        const int r = rf + j;
        const bool rle = __ldg(table + R + r) != 0u;
        s_bound[j + 1] = __ldg(ends + r);
        s_rle[j] = rle;
        s_word[j] = __ldg(table + (rle ? 2 : 3) * R + r);
      }
      if (threadIdx.x == 0) s_bound[0] = rf > 0 ? __ldg(ends + rf - 1) : 0;
      __syncthreads();
    }
  }
  const Staged st{s_bound, s_word, s_rle};
  const Global gl{ends + rf, table + rf, R, rf};
  uint32_t* to = out + base;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r * kRowSlots + kVec * static_cast<int>(threadIdx.x);
    if (i >= left) break;
    const uint4 v = staged ? expand4<W>(st, nr, base + i, words, nbp)
                           : expand4<W>(gl, nr, base + i, words, nbp);
    tpq::store4(to, i, left, v);
  }
}

using Kernel = void (*)(const uint32_t*, const uint32_t*, int, uint32_t*,
                        int64_t, int64_t);

template <int... W>
constexpr std::array<Kernel, sizeof...(W)> kernels(
    std::integer_sequence<int, W...>) {
  return {{&expand_kernel<W + 1>...}};
}

// kernels by width, 1..32
const auto kKernels = kernels(std::make_integer_sequence<int, 32>());

}  // namespace

// `wu` is max(w, 1): a width-0 stream unpacks its (zero) words at width 1,
// as expand_hybrid_core does.  `tile` (slots a block,
// hybrid.hybrid_tile_slots) must equal the compiled tile.
extern "C" int tpq_expand_hybrid(const void* words, const void* table, int R,
                                 void* out, int64_t cnt, int wu, int64_t nbp,
                                 int tile, void* stream) {
  if (tile != kTile || wu < 1 || wu > 32 || R < 1 || nbp < 1 ||
      (reinterpret_cast<uintptr_t>(words) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(table) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (cnt > 0) {
    kKernels[wu - 1]<<<tpq::grid_for(cnt, kTile), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words),
        static_cast<const uint32_t*>(table), R, static_cast<uint32_t*>(out),
        cnt, nbp);
  }
  return static_cast<int>(cudaGetLastError());
}
