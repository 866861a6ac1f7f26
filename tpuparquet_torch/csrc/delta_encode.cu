// KE3: the first device phase of DELTA_BINARY_PACKED encode (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py _delta_phase1_i64 and
// _delta_phase1_i32: over blocks of 128 deltas v[g + 1] - v[g], each
// block's signed minimum (the lanes past the last delta take the type's
// maximum first, so they never win), the adjusted deltas
// delta - minimum (those lanes 0), and the unsigned maximum of each
// 32-delta miniblock, from which the host picks the packing widths.  The
// int32 entry wraps at 32 bits, as cpu/delta.py does, so a full-range
// column packs at width 32, not 33.
//
// Bound on the H100: memory (the values read once, the adjusted deltas
// written once).  One warp per block: lane L holds deltas 32m + L
// (m = 0..3), so each miniblock is one warp-wide max, the block minimum
// one warp-wide min, and reads and writes coalesce.  64-bit deltas are
// taken as uint64_t differences and reinterpreted (signed overflow is
// undefined in C).

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ T warp_min(T x) {
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y < x ? y : x;
  }
  return x;
}

template <typename T>
__device__ __forceinline__ T warp_max(T x) {
  for (int o = 16; o > 0; o >>= 1) {
    const T y = __shfl_xor_sync(0xffffffffu, x, o);
    x = y > x ? y : x;
  }
  return x;
}

__global__ void delta_phase1_i32(const uint32_t* __restrict__ flat,
                                 int64_t count, int64_t nb,
                                 int32_t* __restrict__ mins,
                                 uint32_t* __restrict__ mx,
                                 uint32_t* __restrict__ adj) {
  const int lane = threadIdx.x & 31;
  const int64_t nd = count - 1;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t blk =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       blk < nb; blk += n_warps) {
    int32_t d[4];
    int32_t mn = INT32_MAX;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int64_t g = blk * 128 + 32 * m + lane;
      d[m] = g < nd ? static_cast<int32_t>(__ldg(flat + g + 1) -
                                           __ldg(flat + g))
                    : INT32_MAX;
      mn = d[m] < mn ? d[m] : mn;
    }
    mn = warp_min(mn);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int64_t g = blk * 128 + 32 * m + lane;
      const uint32_t a = g < nd ? static_cast<uint32_t>(d[m]) -
                                      static_cast<uint32_t>(mn)
                                : 0u;
      adj[g] = a;
      const uint32_t top = warp_max(a);
      if (lane == 0) mx[blk * 4 + m] = top;
    }
    if (lane == 0) mins[blk] = mn;
  }
}

__global__ void delta_phase1_i64(const uint32_t* __restrict__ flat,
                                 int64_t count, int64_t nb,
                                 uint32_t* __restrict__ min_lo,
                                 uint32_t* __restrict__ min_hi,
                                 uint32_t* __restrict__ mx_lo,
                                 uint32_t* __restrict__ mx_hi,
                                 uint32_t* __restrict__ alo,
                                 uint32_t* __restrict__ ahi) {
  const int lane = threadIdx.x & 31;
  const int64_t nd = count - 1;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t blk =
           (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
       blk < nb; blk += n_warps) {
    long long d[4];
    long long mn = INT64_MAX;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int64_t g = blk * 128 + 32 * m + lane;
      if (g < nd) {
        const uint64_t a = static_cast<uint64_t>(__ldg(flat + 2 * g)) |
                           static_cast<uint64_t>(__ldg(flat + 2 * g + 1))
                               << 32;
        const uint64_t b = static_cast<uint64_t>(__ldg(flat + 2 * g + 2)) |
                           static_cast<uint64_t>(__ldg(flat + 2 * g + 3))
                               << 32;
        d[m] = static_cast<long long>(b - a);
      } else {
        d[m] = INT64_MAX;
      }
      mn = d[m] < mn ? d[m] : mn;
    }
    mn = warp_min(mn);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int64_t g = blk * 128 + 32 * m + lane;
      const unsigned long long a =
          g < nd ? static_cast<unsigned long long>(d[m]) -
                       static_cast<unsigned long long>(mn)
                 : 0ull;
      alo[g] = static_cast<uint32_t>(a);
      ahi[g] = static_cast<uint32_t>(a >> 32);
      const unsigned long long top = warp_max(a);
      if (lane == 0) {
        mx_lo[blk * 4 + m] = static_cast<uint32_t>(top);
        mx_hi[blk * 4 + m] = static_cast<uint32_t>(top >> 32);
      }
    }
    if (lane == 0) {
      min_lo[blk] = static_cast<uint32_t>(mn);
      min_hi[blk] = static_cast<uint32_t>(static_cast<uint64_t>(mn) >> 32);
    }
  }
}

}  // namespace

// flat holds count (is32) or 2 * count lanes, count >= 2, nb the blocks
// of 128 deltas; min_* nb words, mx_* 4 * nb, alo/adj and ahi 128 * nb.
// The int32 entry fills min_lo, mx_lo and alo and ignores the *_hi.
extern "C" int tpq_delta_encode(const void* flat, int64_t count, int is32,
                                int64_t nb, void* min_lo, void* min_hi,
                                void* mx_lo, void* mx_hi, void* alo,
                                void* ahi, void* stream) {
  if (nb > 0) {
    constexpr int kThreads = 256;  // 8 warps, one block of deltas each
    const unsigned grid = tpq::grid_for(nb * 32, kThreads);
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const uint32_t* in = static_cast<const uint32_t*>(flat);
    if (is32) {
      delta_phase1_i32<<<grid, kThreads, 0, s>>>(
          in, count, nb, static_cast<int32_t*>(min_lo),
          static_cast<uint32_t*>(mx_lo), static_cast<uint32_t*>(alo));
    } else {
      delta_phase1_i64<<<grid, kThreads, 0, s>>>(
          in, count, nb, static_cast<uint32_t*>(min_lo),
          static_cast<uint32_t*>(min_hi), static_cast<uint32_t*>(mx_lo),
          static_cast<uint32_t*>(mx_hi), static_cast<uint32_t*>(alo),
          static_cast<uint32_t*>(ahi));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
