// K7: the delta rebuild's scan, mod 2^32 or mod 2^64 (sm_90a).
//
// Replaces the tail of tpuparquet/kernels/decode.py expand_delta_i32 and
// expand_delta_i64 (XLA-jitted): the per-block min_delta repeat
// (_repeat_md), the lane add (_add64) and the prefix sum (jnp.cumsum, or
// lax.associative_scan in _scan64_interleaved).  With term(k) = d[k] +
// md[k / block_size] for k < n_deltas and 0 past it, output position p
// (0 <= p < total = n_deltas + 1) is the exclusive scan
//
//   out[p] = first + term(0) + ... + term(p - 1)
//
// The i64 form reads the deltas and min_deltas as (lo, hi) u32 lanes and
// writes the interleaved (lo, hi) words, the little-endian u64 layout of
// a DeviceColumn INT64.  Sums are unsigned 64-bit: their native wrap is
// _add64's carry arithmetic, and the low 32 bits of a u64 sum are the u32
// sum the i32 form needs, so one kernel serves both widths.
//
// Bound on the H100: memory.  The function reads 4 or 8 bytes of delta
// and writes 4 or 8 bytes of value a position (16 bytes for int64); a
// page of a million values moves about 16 MB, some 5 us at 3.35 TB/s, so
// launches, extra passes over the deltas, per-value integer divisions and
// the store pattern decide its time.  The design is a single-pass scan
// with decoupled look-back (Merrill and Garland, 2016):
// - One kernel launch, after one memset of the look-back flags and tile
//   counter.  A CTA of 256 threads takes a tile of 4,096 positions,
//   numbered by an atomic counter in the order CTAs start, so a tile only
//   waits on tiles that run.  Each lane holds 16 positions as 8 rows of 2
//   consecutive ones; a warp's row covers 64 positions, so each load (8
//   bytes a lane from dlo and from dhi) and each store (16 bytes a lane of
//   int64 values, 8 of int32) is one contiguous stretch across the warp.
//   A layout of 4 positions a lane, whose int64 values go out as two
//   16-byte stores that each fill half of every sector, stored markedly
//   slower on the card.  Delta pointers that are not 8-byte aligned and
//   the stream's tail take scalar loads.
// - The deltas are read once, into registers; the lane's min_delta block
//   comes from one 64-bit division a thread, then steps forward as the
//   positions cross block_size (a block under 64 positions divides once a
//   row).
// - Warp scans (shuffles) and one shared-memory pass give each position
//   its prefix inside the tile and the tile's sum.  Warp 1 publishes that
//   sum behind a flag while warp 0 looks back over its predecessors'
//   flags, 32 a step, adding sums until it meets a tile whose inclusive
//   prefix is published.  The CTA then stores, and warp 0 publishes the
//   tile's inclusive prefix.  Value first, __threadfence(), flag after;
//   the reader loads the flag with acquire order, so it sees the value.
//   Waiting warps back off between polls.  The sums are u64 and wrap, so
//   their order does not matter and the result is exact.
// - The values are written once.

#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 2;                     // positions a lane holds a row
constexpr int kRows = 8;                    // rows a lane holds
constexpr int kRow = 32 * kVec;             // 64 positions a warp's row
constexpr int kWarpSpan = kRow * kRows;     // 512 positions a warp
constexpr int kTile = kWarps * kWarpSpan;   // 4,096 positions a CTA
constexpr unsigned kFull = 0xffffffffu;

// Look-back status of a tile, in its flag word (zeroed before the launch)
constexpr uint32_t kNone = 0, kAggregate = 1, kPrefix = 2;

// Two consecutive u32 words from `src` at position p (p even), 0 at and
// past n.  `vec`: src is 8-byte aligned.
__device__ __forceinline__ void load2(const uint32_t* __restrict__ src,
                                      int64_t p, int64_t n, bool vec,
                                      uint32_t (&v)[kVec]) {
  if (vec && p + kVec <= n) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(src + p));
    v[0] = w.x;
    v[1] = w.y;
  } else {
#pragma unroll
    for (int q = 0; q < kVec; ++q) v[q] = p + q < n ? __ldg(src + p + q) : 0u;
  }
}

// Move (b, r), a position's min_delta block and its offset in it, `step`
// positions forward.  Divides only when block_size < step.
__device__ __forceinline__ void advance(int64_t& b, int64_t& r, int64_t step,
                                        int64_t block_size) {
  r += step;
  if (r >= block_size) {
    if (r - block_size < block_size) {
      r -= block_size;
      ++b;
    } else {
      const int64_t q = r / block_size;
      b += q;
      r -= q * block_size;
    }
  }
}

template <bool kWide>
__device__ __forceinline__ u64 min_delta(const uint32_t* __restrict__ md_lo,
                                         const uint32_t* __restrict__ md_hi,
                                         int64_t b) {
  u64 m = __ldg(md_lo + b);
  if (kWide) m |= static_cast<u64>(__ldg(md_hi + b)) << 32;
  return m;
}

__device__ __forceinline__ void publish(volatile u64* vals,
                                        volatile uint32_t* flags,
                                        int64_t tile, u64 v,
                                        uint32_t status) {
  vals[tile] = v;
  __threadfence();
  flags[tile] = status;
}

// A flag word, read with acquire order: the loads after it see what its
// writer stored before its __threadfence().
__device__ __forceinline__ uint32_t load_acquire(const volatile uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Warp 0 of tile `tile` > 0: the sum of every term before the tile.  Lane
// L watches tile top - L; the window moves back 32 tiles until it holds a
// published inclusive prefix (tile 0 always publishes one).  While a tile
// in the window has published nothing, the warp sleeps briefly before it
// polls again: every waiting tile polls the same few lines of flags.
__device__ __forceinline__ u64 look_back(const volatile uint32_t* flags,
                                         const volatile u64* agg,
                                         const volatile u64* incl,
                                         int64_t tile, int lane) {
  u64 prefix = 0;
  for (int64_t top = tile - 1;; top -= 32) {
    const int64_t p = top - lane;
    uint32_t st;
    for (;;) {
      st = p >= 0 ? load_acquire(flags + p) : kPrefix;
      if (!__any_sync(kFull, st == kNone)) break;
      __nanosleep(64);
    }
    u64 v = 0;
    if (p >= 0) v = st == kPrefix ? incl[p] : agg[p];
    const unsigned done = __ballot_sync(kFull, st == kPrefix);
    if (done && lane > __ffs(done) - 1) v = 0;  // behind the nearest prefix
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
    prefix += v;
    if (done) return prefix;
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const uint32_t* __restrict__ dlo,
                const uint32_t* __restrict__ dhi,
                const uint32_t* __restrict__ md_lo,
                const uint32_t* __restrict__ md_hi, int64_t block_size,
                int64_t n, u64 first, bool vec_lo, bool vec_hi,
                uint32_t* __restrict__ counter, volatile uint32_t* flags,
                volatile u64* agg, volatile u64* incl,
                uint32_t* __restrict__ out) {
  __shared__ int64_t s_tile;
  __shared__ u64 s_warp[kWarps];
  __shared__ u64 s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_tile = atomicAdd(counter, 1u);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t total = n + 1;
  const int64_t base =
      tile * kTile + static_cast<int64_t>(warp) * kWarpSpan + kVec * lane;

  // every row's deltas in flight before any arithmetic
  uint32_t lo[kRows][kVec], hi[kRows][kVec];
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    load2(dlo, base + row * kRow, n, vec_lo, lo[row]);
    if (kWide) load2(dhi, base + row * kRow, n, vec_hi, hi[row]);
  }

  // terms, then each position's exclusive prefix inside the warp
  u64 t[kRows][kVec];
  int64_t b = base / block_size;
  int64_t r = base - b * block_size;
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    const int64_t p0 = base + row * kRow;
    if (row > 0) advance(b, r, kRow, block_size);
    int64_t bq = b, rq = r;
    u64 m = p0 < n ? min_delta<kWide>(md_lo, md_hi, bq) : 0;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      u64 d = lo[row][q];
      if (kWide) d |= static_cast<u64>(hi[row][q]) << 32;
      t[row][q] = p0 + q < n ? d + m : 0;
      if (q + 1 < kVec && ++rq == block_size) {
        rq = 0;
        ++bq;
        if (p0 + q + 1 < n) m = min_delta<kWide>(md_lo, md_hi, bq);
      }
    }
  }
  u64 carry = 0;
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    u64 s = 0;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const u64 x = t[row][q];
      t[row][q] = s;
      s += x;
    }
    u64 inc = s;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const u64 y = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += y;
    }
    const u64 lane_ex = carry + inc - s;
#pragma unroll
    for (int q = 0; q < kVec; ++q) t[row][q] += lane_ex;
    carry += __shfl_sync(kFull, inc, 31);
  }

  // the tile's sum and each warp's offset in it
  if (lane == 0) s_warp[warp] = carry;
  __syncthreads();
  u64 warp_ex = 0, tile_sum = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const u64 x = s_warp[w];
    if (w < warp) warp_ex += x;
    tile_sum += x;
  }

  // Warp 1 publishes the tile's sum (tile 0: its inclusive prefix) while
  // warp 0 looks back; the CTA stores as soon as the prefix is known, and
  // warp 0 publishes the tile's inclusive prefix after, so neither
  // __threadfence() holds the tile's stores
  if (warp == 1 && lane == 0)
    publish(tile == 0 ? incl : agg, flags, tile, tile_sum,
            tile == 0 ? kPrefix : kAggregate);
  u64 prefix = 0;
  if (warp == 0 && tile > 0) {
    prefix = look_back(flags, agg, incl, tile, lane);
    if (lane == 0) s_prefix = prefix;
  }
  __syncthreads();
  if (warp == 0 && lane == 0 && tile > 0)
    publish(incl, flags, tile, prefix + tile_sum, kPrefix);
  const u64 off = first + (tile > 0 ? s_prefix : 0) + warp_ex;

#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    const int64_t p0 = base + row * kRow;
    const u64 v0 = off + t[row][0], v1 = off + t[row][1];
    if (kWide) {
      u64* o = reinterpret_cast<u64*>(out) + p0;
      if (p0 + kVec <= total) {
        *reinterpret_cast<ulonglong2*>(o) = make_ulonglong2(v0, v1);
      } else if (p0 < total) {
        o[0] = v0;
      }
    } else if (p0 + kVec <= total) {
      *reinterpret_cast<uint2*>(out + p0) =
          make_uint2(static_cast<uint32_t>(v0), static_cast<uint32_t>(v1));
    } else if (p0 < total) {
      out[p0] = static_cast<uint32_t>(v0);
    }
  }
}

bool aligned8(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 7) == 0;
}

}  // namespace

// n_deltas = total - 1 >= 0 values of d; `wide` selects the i64 form
// (dhi and md_hi unused by the i32 form); md holds
// ceil(n_deltas / block_size) entries, block_size >= 1.  `out` holds total
// (i32) or 2 * total (i64) u32 words and is 16-byte aligned.  `scratch` is
// 16-byte aligned and holds, with T = ceil(total / 4096) tiles, 4 words
// for the tile counter, T flag words rounded up to a multiple of 4, then T
// u64 tile sums and T u64 inclusive prefixes: 4 + round4(T) + 4T words, of
// which the first 4 + round4(T) are zeroed here.
extern "C" int tpq_delta_scan(const void* dlo, const void* dhi,
                              const void* md_lo, const void* md_hi, int wide,
                              int64_t block_size, int64_t n_deltas,
                              uint64_t first, void* scratch, void* out,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n_deltas + 1 + kTile - 1) / kTile;
  const int64_t flag_words = (tiles + 3) / 4 * 4;
  auto* words = static_cast<uint32_t*>(scratch);
  const cudaError_t rc =
      cudaMemsetAsync(words, 0, (4 + flag_words) * sizeof(uint32_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  auto* agg = reinterpret_cast<u64*>(words + 4 + flag_words);
  auto* incl = agg + tiles;
  const auto* lo = static_cast<const uint32_t*>(dlo);
  const auto* hi = static_cast<const uint32_t*>(dhi);
  const auto* mlo = static_cast<const uint32_t*>(md_lo);
  const auto* mhi = static_cast<const uint32_t*>(md_hi);
  const unsigned grid = static_cast<unsigned>(tiles);
  if (wide) {
    scan_kernel<true><<<grid, kThreads, 0, s>>>(
        lo, hi, mlo, mhi, block_size, n_deltas, static_cast<u64>(first),
        aligned8(lo), aligned8(hi), words, words + 4, agg, incl,
        static_cast<uint32_t*>(out));
  } else {
    scan_kernel<false><<<grid, kThreads, 0, s>>>(
        lo, nullptr, mlo, nullptr, block_size, n_deltas,
        static_cast<u64>(first), aligned8(lo), false, words, words + 4, agg,
        incl, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
