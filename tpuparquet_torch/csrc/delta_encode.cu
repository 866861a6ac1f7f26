// KE3: the first device phase of DELTA_BINARY_PACKED encode (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py _delta_phase1_i64 and
// _delta_phase1_i32: over blocks of 128 deltas v[g + 1] - v[g], each
// block's signed minimum (the lanes past the last delta take the type's
// maximum first, so they never win), the adjusted deltas
// delta - minimum (those lanes 0), and the unsigned maximum of each
// 32-delta miniblock, from which the host picks the packing widths.  The
// int32 entry wraps at 32 bits, as cpu/delta.py does, so a full-range
// column packs at width 32, not 33.  64-bit deltas are taken as uint64_t
// differences and reinterpreted (signed overflow is undefined in C).
//
// Bound on the H100: memory.  The function reads each value once and
// writes each adjusted delta once (16 bytes a value for int64, plus a
// word or two a block); a page of 1.5M int64 values moves about 25 MB,
// some 7.5 us at 3.35 TB/s.  What the design does about it:
// - Each lane loads its values once: lane L of a block holds values
//   128 b + 4L .. 4L + 3 as one 16-byte load (int32) or two (int64), so a
//   warp's loads and stores are whole coalesced vectors.  v[g + 1] of a
//   lane's last delta comes from the next lane by __shfl_down_sync; lane
//   31 takes it from lane 0 of the next block, which the warp already
//   holds, or, after the warp's last block, with one extra load.  An
//   unaligned input or the stream's tail takes scalar 4-byte loads.
// - Each warp takes 4 consecutive blocks and issues all their loads
//   before any reduction, so 64 (int32) or 128 (int64) bytes a lane are
//   in flight; a CTA of 8 warps covers 32 blocks (4,096 deltas).
// - A block's minimum is one warp-wide min; a miniblock is 8 lanes, so its
//   maximum is three xor-shuffle steps.  The adjusted deltas go out as
//   16-byte stores into the lo (and hi) planes that KE1 reads.

#include "common.cuh"

namespace {

using u64 = unsigned long long;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlock = 128;    // deltas a block
constexpr int kVec = 4;        // consecutive values a lane holds a block
constexpr int kPerWarp = 4;    // blocks a warp
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__device__ __forceinline__ T warp_min(T x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kFull, x, o);
    x = y < x ? y : x;
  }
  return x;
}

// the maximum over the 8 lanes of a miniblock
template <typename T>
__device__ __forceinline__ T miniblock_max(T x) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(kFull, x, o);
    x = y > x ? y : x;
  }
  return x;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Value i of the stream (int32: one word; int64: two interleaved words).
template <typename T>
__device__ __forceinline__ T value(const uint32_t* __restrict__ flat,
                                   int64_t i) {
  if constexpr (sizeof(T) == 4) {
    return __ldg(flat + i);
  } else {
    return static_cast<u64>(__ldg(flat + 2 * i)) |
           static_cast<u64>(__ldg(flat + 2 * i + 1)) << 32;
  }
}

// Values i .. i + 3 (i a multiple of 4), 0 at and past count.  `vec`:
// flat is 16-byte aligned.
template <typename T>
__device__ __forceinline__ void load4(const uint32_t* __restrict__ flat,
                                      int64_t i, int64_t count, bool vec,
                                      T (&v)[kVec]) {
  if (vec && i + kVec <= count) {
    if constexpr (sizeof(T) == 4) {
      const uint4 w = __ldg(reinterpret_cast<const uint4*>(flat + i));
      v[0] = w.x;
      v[1] = w.y;
      v[2] = w.z;
      v[3] = w.w;
    } else {
      const auto* p = reinterpret_cast<const uint4*>(flat + 2 * i);
      const uint4 a = __ldg(p), b = __ldg(p + 1);
      v[0] = a.x | static_cast<u64>(a.y) << 32;
      v[1] = a.z | static_cast<u64>(a.w) << 32;
      v[2] = b.x | static_cast<u64>(b.y) << 32;
      v[3] = b.z | static_cast<u64>(b.w) << 32;
    }
  } else {
#pragma unroll
    for (int q = 0; q < kVec; ++q)
      v[q] = i + q < count ? value<T>(flat, i + q) : T(0);
  }
}

__device__ __forceinline__ void store4(uint32_t* __restrict__ dst,
                                       const uint32_t (&a)[kVec]) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(a[0], a[1], a[2], a[3]);
}

// T: uint32_t (int32 values) or u64 (int64); S its signed twin.  min_hi,
// mx_hi and ahi are unused for int32.
template <typename T, typename S>
__global__ void __launch_bounds__(kThreads)
    delta_phase1(const uint32_t* __restrict__ flat, int64_t count, int64_t nb,
                 bool vec, uint32_t* __restrict__ min_lo,
                 uint32_t* __restrict__ min_hi, uint32_t* __restrict__ mx_lo,
                 uint32_t* __restrict__ mx_hi, uint32_t* __restrict__ alo,
                 uint32_t* __restrict__ ahi) {
  constexpr S kMax = static_cast<S>(~T(0) >> 1);
  constexpr bool kWide = sizeof(T) == 8;
  const int lane = threadIdx.x & 31;
  const int64_t blk0 =
      (static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5)) *
      kPerWarp;
  if (blk0 >= nb) return;  // the whole warp
  const int64_t nd = count - 1;

  // every block's values in flight before any reduction
  T v[kPerWarp][kVec];
#pragma unroll
  for (int k = 0; k < kPerWarp; ++k)
    load4<T>(flat, (blk0 + k) * kBlock + kVec * lane, count, vec, v[k]);
  const int64_t e = (blk0 + kPerWarp) * kBlock;  // after the last block
  const T extra = lane == 31 && e < count ? value<T>(flat, e) : T(0);

#pragma unroll
  for (int k = 0; k < kPerWarp; ++k) {
    const int64_t blk = blk0 + k;
    if (blk >= nb) break;  // the whole warp
    // v[g + 1] of the lane's last delta; kn: the next block (unrolled)
    constexpr int kLast = kPerWarp - 1;
    const int kn = k < kLast ? k + 1 : kLast;
    T nxt = __shfl_down_sync(kFull, v[k][0], 1);
    const T next0 = __shfl_sync(kFull, v[kn][0], 0);
    if (lane == 31) nxt = k < kLast ? next0 : extra;
    const int64_t g0 = blk * kBlock + kVec * lane;
    S d[kVec];
    S mn = kMax;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      const T b = q + 1 < kVec ? v[k][q + 1 < kVec ? q + 1 : 0] : nxt;
      d[q] = g0 + q < nd ? static_cast<S>(b - v[k][q]) : kMax;
      mn = d[q] < mn ? d[q] : mn;
    }
    mn = warp_min(mn);
    T a[kVec];
    T top = 0;
#pragma unroll
    for (int q = 0; q < kVec; ++q) {
      a[q] = g0 + q < nd ? static_cast<T>(d[q]) - static_cast<T>(mn) : T(0);
      top = a[q] > top ? a[q] : top;
    }
    top = miniblock_max(top);
    uint32_t lo[kVec];
#pragma unroll
    for (int q = 0; q < kVec; ++q) lo[q] = static_cast<uint32_t>(a[q]);
    store4(alo + g0, lo);
    if (kWide) {
      uint32_t hi[kVec];
#pragma unroll
      for (int q = 0; q < kVec; ++q)
        hi[q] = static_cast<uint32_t>(static_cast<u64>(a[q]) >> 32);
      store4(ahi + g0, hi);
    }
    if ((lane & 7) == 0) {
      const int64_t m = blk * 4 + (lane >> 3);
      mx_lo[m] = static_cast<uint32_t>(top);
      if (kWide) mx_hi[m] = static_cast<uint32_t>(static_cast<u64>(top) >> 32);
    }
    if (lane == 0) {
      min_lo[blk] = static_cast<uint32_t>(mn);
      if (kWide)
        min_hi[blk] = static_cast<uint32_t>(static_cast<u64>(mn) >> 32);
    }
  }
}

}  // namespace

// flat holds count (is32) or 2 * count lanes, count >= 2, at any 4-byte
// alignment; nb the blocks of 128 deltas; min_* nb words, mx_* 4 * nb,
// alo/adj and ahi 128 * nb, each 16-byte aligned.  The int32 entry fills
// min_lo, mx_lo and alo and ignores the *_hi.
extern "C" int tpq_delta_encode(const void* flat, int64_t count, int is32,
                                int64_t nb, void* min_lo, void* min_hi,
                                void* mx_lo, void* mx_hi, void* alo,
                                void* ahi, void* stream) {
  if (nb > 0) {
    const unsigned grid = tpq::grid_for(nb, kWarps * kPerWarp);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const auto* in = static_cast<const uint32_t*>(flat);
    auto* a = static_cast<uint32_t*>(min_lo);
    auto* b = static_cast<uint32_t*>(min_hi);
    auto* c = static_cast<uint32_t*>(mx_lo);
    auto* d = static_cast<uint32_t*>(mx_hi);
    auto* lo = static_cast<uint32_t*>(alo);
    auto* hi = static_cast<uint32_t*>(ahi);
    if (is32) {
      delta_phase1<uint32_t, int32_t><<<grid, kThreads, 0, s>>>(
          in, count, nb, aligned16(in), a, b, c, d, lo, hi);
    } else {
      delta_phase1<u64, long long><<<grid, kThreads, 0, s>>>(
          in, count, nb, aligned16(in), a, b, c, d, lo, hi);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
