// K9: dictionary page decode, BYTE_ARRAY values (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py page_dict_bytes_tbl and
// dict_gather_bytes (XLA-jitted).  For one page of `icnt` index slots, of
// which the first `non_null` are values:
//   1. idx[i] = clip(int32(index i), 0, max(n_dict - 1, 0)), the index
//      unpacked from one bit-packed run of width iw (width 0: all 0; a
//      run-table stream arrives expanded by K2, as a run of width 32);
//   2. out_offsets = [0, inclusive scan of (i < non_null ? len[idx[i]] : 0)]
//      with len = the diffs of the staged (padded) dictionary offsets;
//   3. for every output byte b < cap: v = min(#{out_offsets[1..] <= b},
//      icnt - 1), src = clip(dict_offsets[idx[v]] + b - out_offsets[v], 0,
//      dict_size - 1), out[b] = dict_data[src] (zeros for an empty
//      dictionary blob).
// All sums are int32 and wrap as the reference's int32 cumsum does (they
// are taken in uint32 here, where wrapping is defined).  The bytes past
// the values' end are what those clamps give, as in the reference.
//
// Bound on the H100: memory.  The function reads the packed indices, the
// dictionary (small; it stays in L2) and writes cap bytes, about 10 per
// value for config 4's vendor column.  Steps 1-2 are K4's multi-block
// scan (one block sum each, one block scanning the sums, then each block
// scans again with its offset), keeping the clipped indices in scratch so
// step 3 need not unpack them again.  Step 3 is the reference's own
// design, one thread per output byte with a binary search over
// out_offsets (about 21 probes on a 1.5M-value page, mostly in L2); a
// copy per value is the later redesign.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int32_t clip_index(uint32_t raw, int64_t n_dict) {
  const int32_t v = static_cast<int32_t>(raw);
  const int64_t hi = n_dict - 1 > 0 ? n_dict - 1 : 0;
  return v < 0 ? 0 : (v > hi ? static_cast<int32_t>(hi) : v);
}

__device__ __forceinline__ uint32_t value_len(const int32_t* doffs,
                                              int32_t k) {
  return static_cast<uint32_t>(__ldg(doffs + k + 1)) -
         static_cast<uint32_t>(__ldg(doffs + k));
}

__global__ void index_kernel(const int32_t* __restrict__ doffs,
                             int64_t n_dict,
                             const uint32_t* __restrict__ words, int iw,
                             int64_t non_null, int64_t icnt,
                             int32_t* __restrict__ idx,
                             uint32_t* __restrict__ block_sums) {
  __shared__ uint32_t smem[32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  uint32_t contrib = 0;
  if (i < icnt) {
    const uint32_t raw = iw > 0 ? tpq::unpack_lane(words, i, iw) : 0u;
    const int32_t k = clip_index(raw, n_dict);
    idx[i] = k;
    if (i < non_null) contrib = value_len(doffs, k);
  }
  const uint32_t incl = tpq::block_inclusive_scan(contrib, smem);
  if (threadIdx.x == kThreads - 1) block_sums[blockIdx.x] = incl;
}

// One block: exclusive scan of the block sums in place, 1024 a round.
__global__ void scan_sums_kernel(uint32_t* __restrict__ block_sums,
                                 int64_t nb) {
  __shared__ uint32_t smem[32];
  __shared__ uint32_t carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nb; base += kThreads) {
    const int64_t j = base + threadIdx.x;
    const uint32_t x = j < nb ? block_sums[j] : 0u;
    const uint32_t incl = tpq::block_inclusive_scan(x, smem);
    const uint32_t c = carry;
    if (j < nb) block_sums[j] = c + incl - x;
    __syncthreads();
    if (threadIdx.x == kThreads - 1) carry = c + incl;
    __syncthreads();
  }
}

__global__ void offsets_kernel(const int32_t* __restrict__ doffs,
                               const int32_t* __restrict__ idx,
                               int64_t non_null, int64_t icnt,
                               const uint32_t* __restrict__ block_offsets,
                               int32_t* __restrict__ out_offsets) {
  __shared__ uint32_t smem[32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const uint32_t contrib =
      i < non_null ? value_len(doffs, __ldg(idx + i)) : 0u;
  const uint32_t incl = tpq::block_inclusive_scan(contrib, smem);
  if (i < icnt) {
    out_offsets[i + 1] =
        static_cast<int32_t>(__ldg(block_offsets + blockIdx.x) + incl);
  }
  if (i == 0) out_offsets[0] = 0;
}

__global__ void gather_kernel(const int32_t* __restrict__ doffs,
                              const uint8_t* __restrict__ ddata,
                              int64_t dsize, const int32_t* __restrict__ idx,
                              const int32_t* __restrict__ out_offsets,
                              int64_t icnt, uint8_t* __restrict__ out,
                              int64_t cap) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       b < cap; b += stride) {
    if (dsize == 0) {
      out[b] = 0;
      continue;
    }
    const int32_t bb = static_cast<int32_t>(b);
    // upper bound of bb in out_offsets[1 .. icnt]
    int64_t lo = 0, hi = icnt;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(out_offsets + 1 + mid) <= bb) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t v = lo < icnt - 1 ? lo : icnt - 1;
    const uint32_t within =
        static_cast<uint32_t>(bb) - static_cast<uint32_t>(__ldg(out_offsets + v));
    const int32_t src = static_cast<int32_t>(
        static_cast<uint32_t>(__ldg(doffs + __ldg(idx + v))) + within);
    const int64_t s = src < 0 ? 0 : (src >= dsize ? dsize - 1 : src);
    out[b] = __ldg(ddata + s);
  }
}

}  // namespace

// `idx` (icnt int32), `out_offsets` (icnt + 1 int32) and `block_sums`
// (ceil(icnt / 1024) int32) are caller-allocated scratch; iw == 0: every
// index is 0 (words unused, may be null).
extern "C" int tpq_dict_bytes(const void* dict_offsets, int64_t n_offsets,
                              const void* dict_data, int64_t dict_size,
                              const void* words, int iw, int64_t non_null,
                              int64_t icnt, void* idx, void* out_offsets,
                              void* block_sums, void* out, int64_t cap,
                              void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* doffs = static_cast<const int32_t*>(dict_offsets);
  auto* ix = static_cast<int32_t*>(idx);
  auto* oo = static_cast<int32_t*>(out_offsets);
  auto* sums = static_cast<uint32_t*>(block_sums);
  if (icnt > 0) {
    const unsigned nb = tpq::grid_for(icnt, kThreads);
    index_kernel<<<nb, kThreads, 0, s>>>(
        doffs, n_offsets - 1, static_cast<const uint32_t*>(words), iw,
        non_null, icnt, ix, sums);
    scan_sums_kernel<<<1, kThreads, 0, s>>>(sums, nb);
    offsets_kernel<<<nb, kThreads, 0, s>>>(doffs, ix, non_null, icnt, sums,
                                           oo);
  }
  if (cap > 0 && icnt > 0) {
    constexpr int kGatherThreads = 256;
    gather_kernel<<<tpq::grid_for(cap, kGatherThreads), kGatherThreads, 0,
                    s>>>(doffs, static_cast<const uint8_t*>(dict_data),
                         dict_size, ix, oo, icnt,
                         static_cast<uint8_t*>(out), cap);
  }
  return static_cast<int>(cudaGetLastError());
}
