// K13: FIXED_LEN_BYTE_ARRAY rows -> u32 lane words (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py flba_bytes_to_lanes: `count` rows
// of L bytes, back to back (here K8's expansion of a front-coded
// DELTA_BYTE_ARRAY page), become count values of lanes = ceil(L / 4)
// little-endian u32 words; word i * lanes + j gathers bytes
// raw[i * L + 4j + b] for 4j + b < L and is zero past L.  The reference
// reshapes to (count, L), zero-pads each row to whole lanes and combines
// bytes into words, which XLA fuses into one pass.
//
// Bound on the H100: memory.  Each input byte is read once and each
// output word written once, with a few shifts and ors a word.  One thread
// per output word reads its (at most four) bytes: neighbouring threads
// read neighbouring bytes of the same or the next row and write
// neighbouring words, so reads and writes coalesce without staging rows
// in shared memory.  A later change may fuse this pass into K8's final
// gather, as K8 already emits words for fixed-width PLAIN pages.

#include "common.cuh"

namespace {

__global__ void flba_to_lanes_kernel(const uint8_t* __restrict__ raw,
                                     int64_t count, int L, int lanes,
                                     uint32_t* __restrict__ out) {
  const int64_t n = count * lanes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < n; t += stride) {
    const int64_t i = t / lanes;
    const int j = static_cast<int>(t - i * lanes);
    const uint8_t* row = raw + i * L;
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int s = 4 * j + b;
      if (s < L) {
        word |= static_cast<uint32_t>(__ldg(row + s)) << (8 * b);
      }
    }
    out[t] = word;
  }
}

}  // namespace

// raw holds at least count * L bytes (checked by the caller); out
// count * lanes words.
extern "C" int tpq_flba_to_lanes(const void* raw, int64_t count, int L,
                                 int lanes, void* out, void* stream) {
  if (count > 0) {
    constexpr int kThreads = 256;
    flba_to_lanes_kernel<<<tpq::grid_for(count * lanes, kThreads), kThreads,
                           0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(raw), count, L, lanes,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
