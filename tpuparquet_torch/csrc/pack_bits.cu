// KE1: LSB-first bit packing at widths 1..64 (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py pack_u32_device, pack_u64_device
// and the delta encoder's _pack_masked32/_pack_masked64 with the gather
// alo[sel_dev] before them: a block of 32 values of w bits (a miniblock)
// occupies exactly w u32 words, and word j of a block ORs the values
// whose bits overlap [32j, 32j + 32) (the _pack_tables rule).  Values
// past `count` pack as 0 and bits above w are masked off; lanes past the
// inputs (n_in) read as 0.  With `sel`, block b packs the 32 lanes of
// miniblock sel[b], so the delta encoder packs the miniblocks of one
// width without a gathered copy.
//
// Bound on the H100: memory (each value read once, each word written
// once).  The delta encoder's width classes are a few thousand to about
// ten thousand miniblocks, a single wave, so a warp's chain of dependent
// rounds before its stores is the time.  The design:
// - One warp per miniblock: lane L holds value L, read by one coalesced
//   128-byte load (two above width 32).  A warp takes kPerWarp = 4
//   miniblocks (encode.pack_warp_miniblocks, passed by the wrapper and
//   checked), a block of 256 threads 32: lane k loads the warp's k-th
//   `sel` entry once and a shuffle hands it to the warp, then every
//   miniblock's loads go out before any word is built, and the 4
//   miniblocks' words are built side by side (a miniblock past the
//   class packs zeros and stores nothing).  chip_smoke.encode_variants
//   times 1-8 miniblocks a warp in blocks of 64-256 threads.
// - The width is a template parameter (1-64, one kernel each, picked
//   from a table in tpq_pack_bits), so each lane's bit offsets, masks
//   and shift counts come from constants.
// - Words are built in registers.  Up to width 32, lane L's value lands
//   in word floor(32 L / w) and, when it straddles, spills into the next;
//   the values that start in one word (at most ceil(32 / w)) OR together
//   in a segmented doubling scan of shuffles, and lane j takes word j
//   from the first lane of its segment and the spill of the lane before
//   it: at most 7 shuffles at width 1, 2 at width 32.  Above width 32,
//   word j lies in at most two values, and lane j shuffles them in
//   (two rounds of 32 words).  Every shift count stays below the width
//   of its operand (a shift by 32 of a 32-bit word is undefined).
// - Lanes 0..w-1 store the miniblock's w words as one coalesced row.
// One launch a call, nothing to zero first.

#include <array>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerWarp = 4;  // miniblocks a warp
constexpr unsigned kAll = 0xffffffffu;

// Word `lane` (lane < W) of a miniblock of 32 W-bit values, lane L
// holding value L (already masked to W bits), 1 <= W <= 32.
template <int W>
__device__ __forceinline__ uint32_t build_word(uint32_t v, int lane) {
  const int p = lane * W;  // the value's first bit in the miniblock
  const int sh = p & 31;
  uint32_t part = v << sh;
  // the bits past the word's end (sh >= 1 whenever the value straddles)
  const uint32_t spill = sh + W > 32 ? v >> (32 - sh) : 0u;
  // the last lane whose value starts in the same word
  const int seg_end = min(31, ((p >> 5) * 32 + 31) / W);
  constexpr int kSeg = (32 + W - 1) / W;  // values that start in a word
#pragma unroll
  for (int d = 1; d < kSeg; d <<= 1) {
    const uint32_t y = __shfl_down_sync(kAll, part, d);
    if (lane + d <= seg_end) part |= y;
  }
  // the first lane whose value starts in word `lane`; the lane before it
  // straddles into the word when its spill is not 0
  const int f = (32 * lane + W - 1) / W;
  const uint32_t head = __shfl_sync(kAll, part, f & 31);
  const uint32_t carry = __shfl_sync(kAll, spill, (f + 31) & 31);
  return head | (f > 0 ? carry : 0u);
}

// Words `lane` and `lane + 32` (those below W) of a miniblock of 32
// W-bit values, 32 < W <= 64, lane L holding value L as (lo, hi).
template <int W>
__device__ __forceinline__ void store_words64(uint32_t lo, uint32_t hi,
                                              int lane, bool live,
                                              uint32_t* __restrict__ o) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = lane + 32 * r;
    const int i0 = 32 * j / W;     // the value that holds the word's bit 0
    const int s = 32 * j - i0 * W;  // at its bit s (0 <= s < W)
    const uint32_t xl = __shfl_sync(kAll, lo, i0 & 31);
    const uint32_t xh = __shfl_sync(kAll, hi, i0 & 31);
    const uint32_t nl = __shfl_sync(kAll, lo, (i0 + 1) & 31);
    uint32_t word = static_cast<uint32_t>(
        ((static_cast<uint64_t>(xh) << 32) | xl) >> s);
    // the word runs into value i0 + 1 (never past value 31 when j < W)
    if (s + 32 > W) word |= nl << (W - s);
    if (j < W && live) o[j] = word;
  }
}

template <int W>
__global__ void __launch_bounds__(kThreads) pack_kernel(
    const uint32_t* __restrict__ lo, const uint32_t* __restrict__ hi,
    int64_t n_in, const int32_t* __restrict__ sel, int64_t count,
    int64_t nb, uint32_t* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int64_t b0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kPerWarp;
  if (b0 >= nb) return;  // the whole warp
  // lane k < kPerWarp: the source miniblock of the warp's k-th block
  int64_t mine = 0;
  if (lane < kPerWarp && b0 + lane < nb) {
    mine = sel != nullptr ? static_cast<int64_t>(__ldg(sel + b0 + lane))
                          : b0 + lane;
  }
  // every miniblock's loads before any word is built
  uint32_t vlo[kPerWarp], vhi[kPerWarp];
#pragma unroll
  for (int k = 0; k < kPerWarp; ++k) {
    const int64_t src = __shfl_sync(kAll, mine, k) * 32 + lane;
    const int64_t b = b0 + k;
    vlo[k] = 0u;
    vhi[k] = 0u;
    if (b < nb && b * 32 + lane < count &&
        static_cast<uint64_t>(src) < static_cast<uint64_t>(n_in)) {
      vlo[k] = __ldg(lo + src);
      if constexpr (W > 32) vhi[k] = __ldg(hi + src);
    }
  }
  // the miniblocks' words, built side by side (a block past nb packs
  // zeros and stores nothing)
#pragma unroll
  for (int k = 0; k < kPerWarp; ++k) {
    const int64_t b = b0 + k;
    uint32_t* o = out + b * W;
    if constexpr (W <= 32) {
      const uint32_t word = build_word<W>(vlo[k] & tpq::lane_mask<W>(), lane);
      if (lane < W && b < nb) o[lane] = word;
    } else {
      store_words64<W>(vlo[k], vhi[k] & tpq::lane_mask<W - 32>(), lane,
                       b < nb, o);
    }
  }
}

using Kernel = void (*)(const uint32_t*, const uint32_t*, int64_t,
                        const int32_t*, int64_t, int64_t, uint32_t*);

template <int... W>
constexpr std::array<Kernel, sizeof...(W)> kernels(
    std::integer_sequence<int, W...>) {
  return {{&pack_kernel<W + 1>...}};
}

// kernels by width - 1, widths 1..64
const auto kKernels = kernels(std::make_integer_sequence<int, 64>());

}  // namespace

// lo (and hi when width > 32) hold n_in lanes; sel, when not null, holds
// ceil(count / 32) miniblock indices; out ceil(count / 32) * width words.
// `per_warp` (miniblocks a warp, encode.pack_warp_miniblocks) must equal
// the compiled kPerWarp.
extern "C" int tpq_pack_bits(const void* lo, const void* hi, int64_t n_in,
                             const void* sel, int64_t count, int width,
                             int per_warp, void* out, void* stream) {
  if (width < 1 || width > 64 || per_warp != kPerWarp ||
      (width > 32 && hi == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t nb = (count + 31) / 32;
  if (nb > 0) {
    kKernels[width - 1]<<<tpq::grid_for(nb, kWarps * kPerWarp), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        n_in, static_cast<const int32_t*>(sel), count, nb,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
