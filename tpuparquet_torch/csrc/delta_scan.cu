// K7: the delta rebuild's scan, mod 2^32 or mod 2^64 (sm_90a).
//
// Replaces the tail of tpuparquet/kernels/decode.py expand_delta_i32 and
// expand_delta_i64 (XLA-jitted): the per-block min_delta repeat
// (_repeat_md), the lane add (_add64) and the inclusive prefix sum
// (jnp.cumsum, or lax.associative_scan in _scan64_interleaved):
//
//   out[0]   = first
//   out[k+1] = out[k] + d[k] + md[k / block_size]     (k < n_deltas)
//
// The i64 form reads the deltas and min_deltas as (lo, hi) u32 lanes and
// writes the interleaved (lo, hi) words, which is the little-endian u64
// layout of a DeviceColumn INT64.  Sums are unsigned 64-bit: their native
// wrap is _add64's carry arithmetic, and the low 32 bits of a u64 sum are
// the u32 sum the i32 form needs, so one kernel serves both widths.
//
// Bound on the H100: memory (4 or 8 bytes read and written per value, one
// u64 add each).  A prefix scan spans blocks, and blocks neither run in
// order nor share state, so it runs as K4 does: (1) each block sums its
// values, (2) one block scans those sums into block offsets, (3) each
// block scans its values again and writes them with its offset.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

using u64 = unsigned long long;

// d[k] + md[k / block_size], or 0 past the end.  `wide` is passed, not
// inferred from dhi: an empty stream's buffers may have null pointers.
__device__ __forceinline__ u64 term(const uint32_t* __restrict__ dlo,
                                    const uint32_t* __restrict__ dhi,
                                    const uint32_t* __restrict__ md_lo,
                                    const uint32_t* __restrict__ md_hi,
                                    bool wide, int64_t block_size, int64_t k,
                                    int64_t n) {
  if (k >= n) return 0;
  const int64_t b = k / block_size;
  u64 d = __ldg(dlo + k);
  u64 m = __ldg(md_lo + b);
  if (wide) {
    d |= static_cast<u64>(__ldg(dhi + k)) << 32;
    m |= static_cast<u64>(__ldg(md_hi + b)) << 32;
  }
  return d + m;
}

__global__ void sum_kernel(const uint32_t* __restrict__ dlo,
                           const uint32_t* __restrict__ dhi,
                           const uint32_t* __restrict__ md_lo,
                           const uint32_t* __restrict__ md_hi, bool wide,
                           int64_t block_size, int64_t n,
                           u64* __restrict__ block_sums) {
  __shared__ u64 smem[32];
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const u64 incl = tpq::block_inclusive_scan(
      term(dlo, dhi, md_lo, md_hi, wide, block_size, k, n), smem);
  if (threadIdx.x == kThreads - 1) block_sums[blockIdx.x] = incl;
}

// One block: exclusive scan of block_sums in place, 1024 entries a round.
__global__ void scan_sums_kernel(u64* __restrict__ block_sums, int64_t nb) {
  __shared__ u64 smem[32];
  __shared__ u64 carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nb; base += kThreads) {
    const int64_t j = base + threadIdx.x;
    const u64 x = j < nb ? block_sums[j] : 0;
    const u64 incl = tpq::block_inclusive_scan(x, smem);
    const u64 c = carry;
    if (j < nb) block_sums[j] = c + incl - x;
    __syncthreads();
    if (threadIdx.x == kThreads - 1) carry = c + incl;
    __syncthreads();
  }
}

__global__ void write_kernel(const uint32_t* __restrict__ dlo,
                             const uint32_t* __restrict__ dhi,
                             const uint32_t* __restrict__ md_lo,
                             const uint32_t* __restrict__ md_hi, bool wide,
                             int64_t block_size, int64_t n, u64 first,
                             const u64* __restrict__ block_offsets,
                             uint32_t* __restrict__ out) {
  __shared__ u64 smem[32];
  const int64_t k = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const u64 incl = tpq::block_inclusive_scan(
      term(dlo, dhi, md_lo, md_hi, wide, block_size, k, n), smem);
  if (k == 0) {
    out[0] = static_cast<uint32_t>(first);
    if (wide) out[1] = static_cast<uint32_t>(first >> 32);
  }
  if (k < n) {
    const u64 v = first + __ldg(block_offsets + blockIdx.x) + incl;
    if (wide) {
      out[2 * (k + 1)] = static_cast<uint32_t>(v);
      out[2 * (k + 1) + 1] = static_cast<uint32_t>(v >> 32);
    } else {
      out[k + 1] = static_cast<uint32_t>(v);
    }
  }
}

}  // namespace

// n_deltas = total - 1 >= 0 values of d; `wide` selects the i64 form
// (dhi and md_hi unused by the i32 form); md holds
// ceil(n_deltas / block_size) entries.  `block_sums` is caller-allocated
// scratch of ceil(n_deltas / 1024) (at least 1) u64; out holds total (i32)
// or 2 * total (i64) u32 words.
extern "C" int tpq_delta_scan(const void* dlo, const void* dhi,
                              const void* md_lo, const void* md_hi, int wide,
                              int64_t block_size, int64_t n_deltas,
                              uint64_t first, void* block_sums, void* out,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const unsigned nb = tpq::grid_for(n_deltas, kThreads);
  const auto* lo = static_cast<const uint32_t*>(dlo);
  const auto* hi = static_cast<const uint32_t*>(dhi);
  const auto* mlo = static_cast<const uint32_t*>(md_lo);
  const auto* mhi = static_cast<const uint32_t*>(md_hi);
  auto* sums = static_cast<u64*>(block_sums);
  sum_kernel<<<nb, kThreads, 0, s>>>(lo, hi, mlo, mhi, wide != 0, block_size,
                                     n_deltas, sums);
  scan_sums_kernel<<<1, kThreads, 0, s>>>(sums, nb);
  write_kernel<<<nb, kThreads, 0, s>>>(lo, hi, mlo, mhi, wide != 0, block_size,
                                       n_deltas, static_cast<u64>(first), sums,
                                       static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
