// Device helpers shared by the decode kernels (sm_90a).
//
// Buffers of u32 words arrive as int32 torch tensors and are read here as
// uint32_t: the bits are the same, and the kernels never do signed
// arithmetic on them.  Every product that can pass 2^31 (bit offsets
// lane * width, value offsets idx * lanes) is taken in 64 bits.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tpq {

// Lane `lane` of an LSB-first stream of `w`-bit values (1 <= w <= 32).
// A value straddles two words when shift + w > 32; its high part is then
// `next << (32 - shift)`, a shift count in 1..31.  The shift by 32 that a
// naive formula would take for shift == 0 is undefined in CUDA as in C,
// so the straddle term is gated exactly as the JAX package gates it
// (tpuparquet/kernels/bitunpack.py, _unpack_block_math).  A straddling
// value never ends past its own 32-value block, so words[word + 1] is in
// the buffer whenever it is read.
__device__ __forceinline__ uint32_t unpack_lane(
    const uint32_t* __restrict__ words, int64_t lane, int w) {
  const uint64_t bit = static_cast<uint64_t>(lane) * static_cast<uint64_t>(w);
  const uint64_t word = bit >> 5;
  const uint32_t sh = static_cast<uint32_t>(bit & 31);
  uint32_t v = __ldg(words + word) >> sh;
  if (sh + static_cast<uint32_t>(w) > 32u) {
    v |= __ldg(words + word + 1) << (32u - sh);
  }
  return w == 32 ? v : (v & ((1u << w) - 1u));
}

// The mask of a W-bit value (1 <= W <= 32), with no shift by 32.
template <int W>
__host__ __device__ constexpr uint32_t lane_mask() {
  return W == 32 ? 0xffffffffu : (1u << (W & 31)) - 1u;
}

// Four consecutive lanes of an LSB-first stream of W-bit values, W fixed
// at compile time (1 <= W <= 32), the first of them starting at bit `sh`
// (0..31) of word 0.  `word(k)` returns word k; only the words that hold
// the lanes' sh + 4W bits are asked for (at most (4W + 62) / 32 of them),
// so a caller whose lanes lie in the stream reads no word past its end.
// The words are funnel-shifted into a window that starts at the first
// lane's bit, from which each lane is a shift and a mask by constants.
template <int W, typename Word>
__device__ __forceinline__ uint4 unpack4(Word word, uint32_t sh) {
  constexpr int kMax = (4 * W + 62) / 32;  // words the 4 lanes can span
  constexpr int kWin = (4 * W + 31) / 32;  // words of the aligned window
  const int n = static_cast<int>((sh + 4 * W - 1) >> 5) + 1;
  uint32_t w[kMax + 1];
#pragma unroll
  for (int k = 0; k < kMax; ++k) w[k] = k < n ? word(k) : 0u;
  w[kMax] = 0u;
  uint32_t a[kWin + 1];
#pragma unroll
  for (int k = 0; k < kWin; ++k) a[k] = __funnelshift_r(w[k], w[k + 1], sh);
  a[kWin] = 0u;
  uint32_t v[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int q = (j * W) >> 5;
    v[j] = __funnelshift_r(a[q], a[q + 1], (j * W) & 31) & lane_mask<W>();
  }
  return make_uint4(v[0], v[1], v[2], v[3]);
}

// One lane of the same stream, starting at bit `sh` (0..31) of p[0]; the
// next word is read only when the lane straddles into it.
template <int W>
__device__ __forceinline__ uint32_t unpack1(const uint32_t* __restrict__ p,
                                            uint32_t sh) {
  const uint32_t hi = sh + W > 32u ? __ldg(p + 1) : 0u;
  return __funnelshift_r(__ldg(p), hi, sh) & lane_mask<W>();
}

// Inclusive prefix sum of `x` over the block (blockDim.x a multiple of 32,
// at most 1024).  Every thread of the block must call it.  `smem` holds 32
// values of T (int for counts; unsigned long long for the sums mod 2^64 of
// the delta scan, whose unsigned adds wrap as the reference's lane adds).
template <typename T>
__device__ __forceinline__ T block_inclusive_scan(T x, T* smem) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    const T y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) smem[wid] = x;
  __syncthreads();
  if (wid == 0) {
    T s = lane < static_cast<int>(blockDim.x >> 5) ? smem[lane] : T(0);
    for (int o = 1; o < 32; o <<= 1) {
      const T y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    smem[lane] = s;
  }
  __syncthreads();
  if (wid > 0) x += smem[wid - 1];
  __syncthreads();  // smem may be reused by the caller's next scan
  return x;
}

// The 16 bytes from byte `off` of the 16-byte vectors x, y (off < 16).
__device__ __forceinline__ uint4 select16(uint4 x, uint4 y, uint32_t off) {
  const uint32_t k = off >> 2, sh = (off & 3) * 8;
  const uint32_t u0 = k == 0 ? x.x : k == 1 ? x.y : k == 2 ? x.z : x.w;
  const uint32_t u1 = k == 0 ? x.y : k == 1 ? x.z : k == 2 ? x.w : y.x;
  const uint32_t u2 = k == 0 ? x.z : k == 1 ? x.w : k == 2 ? y.x : y.y;
  const uint32_t u3 = k == 0 ? x.w : k == 1 ? y.x : k == 2 ? y.y : y.z;
  const uint32_t u4 = k == 0 ? y.x : k == 1 ? y.y : k == 2 ? y.z : y.w;
  return make_uint4(__funnelshift_r(u0, u1, sh), __funnelshift_r(u1, u2, sh),
                    __funnelshift_r(u2, u3, sh), __funnelshift_r(u3, u4, sh));
}

// The bytes of word a below `keep` (0..4), the rest from word b.
__device__ __forceinline__ uint32_t merge(uint32_t a, uint32_t b, int keep) {
  if (keep >= 4) return a;
  if (keep <= 0) return b;
  const uint32_t m = (1u << (8 * keep)) - 1u;
  return (a & m) | (b & ~m);
}

// A single-pass scan with decoupled look-back (Merrill and Garland,
// 2016) over tiles numbered in the order their blocks start.  A tile's
// word holds its status in the high half (0 none, as the caller's memset
// leaves it; kAggregate; kPrefix) and its 32-bit sum or inclusive prefix
// in the low half, so one store publishes both and no fence orders them.
using u64 = unsigned long long;
constexpr u64 kAggregate = 1ull << 32, kPrefix = 2ull << 32;

__device__ __forceinline__ u64 load_word(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_word(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// Warp 0 of tile `tile` > 0: the sum (mod 2^32) of every slot before the
// tile.  Lane L watches tile top - L; the window moves back 32 tiles
// until it holds a published inclusive prefix (tile 0 always publishes
// one).  While a tile in the window has published nothing, the warp
// sleeps briefly.  Every lane of the warp must call it.
__device__ __forceinline__ uint32_t look_back(const u64* words, int64_t tile,
                                              int lane) {
  uint32_t prefix = 0;
  for (int64_t top = tile - 1;; top -= 32) {
    const int64_t p = top - lane;
    u64 w;
    for (;;) {
      w = p >= 0 ? load_word(words + p) : kPrefix;
      if (!__any_sync(0xffffffffu, (w >> 32) == 0)) break;
      __nanosleep(32);
    }
    const unsigned done = __ballot_sync(0xffffffffu, (w >> 32) == 2);
    uint32_t v = static_cast<uint32_t>(w);
    if (done && lane > __ffs(done) - 1) v = 0;  // behind the nearest prefix
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    prefix += v;
    if (done) return prefix;
  }
}

// #{k < R : ends[k] <= x} for non-decreasing ends (searchsorted
// side="right"), by one warp: every lane calls it and gets it.  A round
// probes the last index of 32 equal segments of the open range [lo, hi);
// the lanes whose probe is <= x are a prefix, and their count leaves one
// segment open.  KS2, K5 and K2 search their run ends with it.
__device__ __forceinline__ int warp_upper_bound(
    const int32_t* __restrict__ ends, int R, int64_t x, int lane) {
  int64_t lo = 0, hi = R;
  while (lo < hi) {
    const int64_t step = (hi - lo + 31) >> 5;
    const int64_t k = lo + (lane + 1) * step - 1;
    const bool le = k < hi && static_cast<int64_t>(__ldg(ends + k)) <= x;
    const int64_t n = __popc(__ballot_sync(0xffffffffu, le));
    const int64_t top = lo + (n + 1) * step - 1;
    lo += n * step;
    hi = top < hi ? top : hi;
  }
  return static_cast<int>(lo);
}

// Outputs i..i+3 of a tile whose first `left` outputs exist: one 16-byte
// store (out + i on a 16-byte boundary), or one by one past `left`.
__device__ __forceinline__ void store4(uint32_t* __restrict__ out, int i,
                                       int left, uint4 v) {
  if (i + 4 <= left) {
    *reinterpret_cast<uint4*>(out + i) = v;
  } else {
    const uint32_t x[4] = {v.x, v.y, v.z, v.w};
    for (int k = 0; i + k < left; ++k) out[i + k] = x[k];
  }
}

inline unsigned grid_for(int64_t n, int threads) {
  const int64_t blocks = (n + threads - 1) / threads;
  return static_cast<unsigned>(blocks > 0 ? blocks : 1);
}

}  // namespace tpq
