// KS1: packed non-null values -> one value per record slot (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py scatter_to_dense (XLA-jitted),
// the densify step of shard/scan.py gather_column:
//   out[i * lanes + l] = mask[i] ? packed[positions[i] * lanes + l] : 0
// over the n record slots, then zeros up to the row length `out_len` (the
// unit's row of the gathered block, padded to the longest unit).  A null
// mask pointer means every slot is valid, a null positions pointer the
// identity (a column without nulls); an empty `packed` gathers nothing and
// writes zeros, as the reference's no-gather branch.
//
// Bound on the H100: memory.  Per output word it reads at most one packed
// word (the mask byte and position are shared by the value's lanes and
// hit L1) and writes one.  One thread per output word; the mask is read
// before the packed buffer, so a null slot never reads it, and a position
// is clamped into [0, n_packed - 1] as JAX clamps its gather, so no slot
// reads outside the buffer.

#include "common.cuh"

namespace {

__global__ void scatter_dense_kernel(const uint32_t* __restrict__ packed,
                                     int64_t n_packed,
                                     const uint8_t* __restrict__ mask,
                                     const int32_t* __restrict__ positions,
                                     int64_t n, int lanes,
                                     uint32_t* __restrict__ out,
                                     int64_t out_len) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n_words = n * lanes;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       o < out_len; o += stride) {
    uint32_t v = 0u;
    if (o < n_words && n_packed > 0) {
      const int64_t i = o / lanes;
      const int l = static_cast<int>(o - i * lanes);
      if (mask == nullptr || __ldg(mask + i) != 0) {
        int64_t p = positions == nullptr
                        ? i
                        : static_cast<int64_t>(__ldg(positions + i));
        p = p < 0 ? 0 : (p > n_packed - 1 ? n_packed - 1 : p);
        v = __ldg(packed + p * lanes + l);
      }
    }
    out[o] = v;
  }
}

}  // namespace

extern "C" int tpq_scatter_dense(const void* packed, int64_t n_packed,
                                 const void* mask, const void* positions,
                                 int64_t n, int lanes, void* out,
                                 int64_t out_len, void* stream) {
  if (out_len > 0) {
    constexpr int kThreads = 256;
    scatter_dense_kernel<<<tpq::grid_for(out_len, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(packed), n_packed,
        static_cast<const uint8_t*>(mask),
        static_cast<const int32_t*>(positions), n, lanes,
        static_cast<uint32_t*>(out), out_len);
  }
  return static_cast<int>(cudaGetLastError());
}
