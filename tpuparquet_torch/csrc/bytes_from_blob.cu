// K10: PLAIN BYTE_ARRAY values out of a device-resident page blob (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py plain_bytes_from_blob (XLA-jitted).
// The blob is K8's expansion of a snappy page (it never visits the host);
// PLAIN records there are (u32 length, bytes), so value v's bytes start at
// blob byte pos + out_offsets[v] + 4 * (v + 1): pos skips a V1 page's level
// bytes, and 4 * (v + 1) the length prefixes up to and including v's own.
// For every output byte b < total:
//   v   = min(#{out_offsets[1..n-1] <= b}, n - 2)   (n = out_offsets length,
//         padded by the host with the values' byte count)
//   src = clip(pos + out_offsets[v] + 4 * (v + 1) + (b - out_offsets[v]),
//              0, blob_size - 1)
// in int32 arithmetic (taken in uint32 here, where wrapping is defined), as
// the reference computes it; an empty blob gives zeros.
//
// Bound on the H100: memory.  The function reads the values' bytes out of
// the blob and the offsets, and writes `total` bytes.  One thread per
// output byte with a binary search over the offsets (which stay in L2) is
// the reference's design; a copy per value is the later redesign.

#include "common.cuh"

namespace {

__global__ void bytes_from_blob_kernel(const uint8_t* __restrict__ blob,
                                       int64_t blob_size,
                                       const int32_t* __restrict__ offs,
                                       int64_t n_offs, int32_t pos,
                                       uint8_t* __restrict__ out,
                                       int64_t total) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t n_ends = n_offs - 1;  // the search runs over offs[1..]
  for (int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       b < total; b += stride) {
    if (blob_size == 0) {
      out[b] = 0;
      continue;
    }
    const int32_t bb = static_cast<int32_t>(b);
    int64_t lo = 0, hi = n_ends;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (__ldg(offs + 1 + mid) <= bb) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int64_t v = lo < n_offs - 2 ? lo : n_offs - 2;
    const uint32_t o = static_cast<uint32_t>(__ldg(offs + v));
    const int32_t src = static_cast<int32_t>(
        static_cast<uint32_t>(pos) + o +
        4u * (static_cast<uint32_t>(v) + 1u) + (static_cast<uint32_t>(bb) - o));
    const int64_t s = src < 0 ? 0 : (src >= blob_size ? blob_size - 1 : src);
    out[b] = __ldg(blob + s);
  }
}

}  // namespace

extern "C" int tpq_bytes_from_blob(const void* blob, int64_t blob_size,
                                   const void* out_offsets, int64_t n_offs,
                                   int pos, void* out, int64_t total,
                                   void* stream) {
  if (total > 0) {
    constexpr int kThreads = 256;
    bytes_from_blob_kernel<<<tpq::grid_for(total, kThreads), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blob), blob_size,
        static_cast<const int32_t*>(out_offsets), n_offs,
        static_cast<int32_t>(pos), static_cast<uint8_t*>(out), total);
  }
  return static_cast<int>(cudaGetLastError());
}
