// K4: definition levels -> (validity mask, packed-value position) (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py levels_to_validity (XLA-jitted):
//   mask      = def == max_def
//   positions = max(cumsum(mask) - 1, 0)
// positions[i] is the index of slot i's value in the packed non-null
// buffer (the gather index that inflates packed values to record slots).
// The counts are int32, as the JAX cumsum's are.
//
// Bound on the H100: memory, 4 bytes read and 5 written a slot.
//
// The parent made three launches (a block count of the flags, one block
// scanning the block counts, a second pass over every slot that wrote
// one bool and one int32 a thread), so it read the def levels twice.
// This design is one launch after one memset:
// - A lane holds 4 consecutive slots a row, loaded as one 16-byte vector
//   (from two aligned vectors, word-shifted, where the def levels start
//   off a 16-byte boundary, as a slice of a slab or a torch.cat output
//   can); a warp's row covers 128 slots and a lane 8 rows, so a tile of
//   8 warps covers 8,192 slots.  Each lane keeps only its 4 flag bits a
//   row.
// - The lane's counts are packed 8 bits a row into one word for every 4
//   rows (a row's warp total is at most 128), so two 5-step shuffle scans
//   give every row's prefix; warps add up through shared memory.
// - A single-pass scan with decoupled look-back (tpq::look_back, shared
//   with KS3): a tile's status and its 32-bit count share one 64-bit
//   word.  Tiles go in block order, so a tile waits only on tiles of lower
//   block index, which the hardware dispatches before it (as CUB's
//   single-pass scan assumes); KS3's atomic ticket put an L2 round trip
//   before every tile's loads and was slower here on the card.  At the
//   main path's 2^21 slots the 256 tiles all run at once.
// - The mask goes out as one 4-byte store of 4 bools a lane, before the
//   scan waits on its predecessors, and the positions, after it, as one
//   16-byte store, so a warp's row writes 128 and 512 contiguous bytes;
//   the wrapper places `positions` at a 16-byte boundary and `mask` at a
//   4-byte one.  Slots past n (the short tail) load and store one by
//   one.

#include "common.cuh"

namespace {

using tpq::u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                    // slots a lane holds a row
constexpr int kRows = 8;                   // rows a lane holds
constexpr int kRow = 32 * kVec;            // 128 slots a warp's row
constexpr int kWarpSpan = kRow * kRows;    // 1,024 slots a warp
constexpr int kTile = kWarps * kWarpSpan;  // 8,192 slots a tile
constexpr int kPacks = kRows / 4;          // words of 4 rows' counts
constexpr unsigned kFull = 0xffffffffu;

// Slots j0..j0+3's flags (def == max_def) as 4 bits.  `a` is def's offset
// in words from a 16-byte boundary; for a != 0 the slots lie in the
// aligned vectors at def + j0 - a and the next one, which holds slot
// j0 + 4 - a <= j0 + 3, so both are loaded only for a whole group.
__device__ __forceinline__ uint32_t flags4(const int32_t* __restrict__ def,
                                           int64_t n, int a, int max_def,
                                           int64_t j0) {
  if (j0 + kVec <= n) {
    uint4 v;
    if (a == 0) {
      v = __ldg(reinterpret_cast<const uint4*>(def + j0));
    } else {
      const auto* q = reinterpret_cast<const uint4*>(def + j0 - a);
      v = tpq::select16(__ldg(q), __ldg(q + 1), 4 * a);
    }
    const auto m = static_cast<uint32_t>(max_def);
    return static_cast<uint32_t>(v.x == m) |
           static_cast<uint32_t>(v.y == m) << 1 |
           static_cast<uint32_t>(v.z == m) << 2 |
           static_cast<uint32_t>(v.w == m) << 3;
  }
  uint32_t f = 0;
#pragma unroll
  for (int k = 0; k < kVec; ++k) {
    if (j0 + k < n && __ldg(def + j0 + k) == max_def) f |= 1u << k;
  }
  return f;
}

__global__ void __launch_bounds__(kThreads)
    validity_kernel(const int32_t* __restrict__ def, int64_t n, int max_def,
                    int a, u64* words, uint8_t* __restrict__ mask,
                    int32_t* __restrict__ positions) {
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t = blockIdx.x;
  // first slot of each of the lane's rows: v0 + row * kRow
  const int64_t v0 =
      t * kTile + static_cast<int64_t>(warp) * kWarpSpan + kVec * lane;

  uint32_t f[kRows];
  uint32_t packed[kPacks] = {};  // the lane's count a row, 8 bits a row
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    f[row] = flags4(def, n, a, max_def, v0 + row * kRow);
    packed[row / 4] |= static_cast<uint32_t>(__popc(f[row]))
                       << (8 * (row % 4));
  }
  // the mask needs no prefix: it goes out before the scan waits
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    const int64_t j0 = v0 + row * kRow;
    const uint32_t fr = f[row];
    if (j0 + kVec <= n) {
      *reinterpret_cast<uint32_t*>(mask + j0) =
          (fr & 1u) | ((fr >> 1) & 1u) << 8 | ((fr >> 2) & 1u) << 16 |
          ((fr >> 3) & 1u) << 24;
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (j0 + k < n) mask[j0 + k] = static_cast<uint8_t>((fr >> k) & 1u);
      }
    }
  }
  uint32_t ex[kPacks], tot[kPacks];
  uint32_t warp_total = 0;
#pragma unroll
  for (int k = 0; k < kPacks; ++k) {
    uint32_t inc = packed[k];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const uint32_t y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    ex[k] = inc - packed[k];  // the lane's exclusive count a row
    tot[k] = __shfl_sync(kFull, inc, 31);  // the warp's a row
#pragma unroll
    for (int b = 0; b < 4; ++b) warp_total += (tot[k] >> (8 * b)) & 255;
  }
  if (lane == 0) s_warp[warp] = warp_total;
  __syncthreads();
  uint32_t warp_ex = 0, tile_sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const uint32_t y = s_warp[w];
    if (w < warp) warp_ex += y;
    tile_sum += y;
  }
  if (threadIdx.x == 0) {
    tpq::store_word(words + t,
                    (t == 0 ? tpq::kPrefix : tpq::kAggregate) | tile_sum);
  }
  if (warp == 0 && t > 0) {
    const uint32_t prefix = tpq::look_back(words, t, lane);
    if (lane == 0) {
      s_prefix = prefix;
      tpq::store_word(words + t, tpq::kPrefix | (prefix + tile_sum));
    }
  }
  __syncthreads();

  uint32_t c = (t > 0 ? s_prefix : 0u) + warp_ex;  // slots before the row
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    const int64_t j0 = v0 + row * kRow;
    const uint32_t fr = f[row];
    const uint32_t base = c + ((ex[row / 4] >> (8 * (row % 4))) & 255);
    c += (tot[row / 4] >> (8 * (row % 4))) & 255;
    // inclusive counts of the 4 slots, less one, clamped at 0
    int32_t p[kVec];
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      const auto v = static_cast<int32_t>(
                         base + __popc(fr & ((2u << k) - 1u))) - 1;
      p[k] = v > 0 ? v : 0;
    }
    if (j0 + kVec <= n) {
      *reinterpret_cast<int4*>(positions + j0) =
          make_int4(p[0], p[1], p[2], p[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (j0 + k < n) positions[j0 + k] = p[k];
      }
    }
  }
}

}  // namespace

// n slots; `tile` must be 8,192 (decode.validity_tile_slots).  `positions`
// is 16-byte aligned, `mask` 4-byte aligned, and `words` 8-byte aligned
// with one 8-byte word a tile of ceil(n / tile), which this call zeroes.
extern "C" int tpq_levels_to_validity(const void* def, int64_t n, int max_def,
                                      int tile, void* words, void* mask,
                                      void* positions, void* stream) {
  const auto dp = reinterpret_cast<uintptr_t>(def);
  if (tile != kTile || (dp & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(positions) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(mask) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(words) & 7) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n > 0) {
    const auto s = static_cast<cudaStream_t>(stream);
    const int64_t tiles = (n + kTile - 1) / kTile;
    const cudaError_t rc = cudaMemsetAsync(words, 0, 8 * tiles, s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    validity_kernel<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
        static_cast<const int32_t*>(def), n, max_def,
        static_cast<int>((dp >> 2) & 3), static_cast<u64*>(words),
        static_cast<uint8_t*>(mask), static_cast<int32_t*>(positions));
  }
  return static_cast<int>(cudaGetLastError());
}
