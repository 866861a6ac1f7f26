// K12: BYTE_STREAM_SPLIT page -> u32 lane words (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py bss_to_lanes: k byte streams of
// count bytes (stream b holds byte b of every value) become count values
// of `lanes` little-endian u32 words; word i * lanes + l gathers bytes
// raw[(4l + b) * count + i] for b < 4, zero where 4l + b >= k.  The
// reference is a transpose of the (k, count) byte matrix, a zero pad and
// a byte-to-word combine, which XLA fuses.
//
// Bound on the H100: memory.  Each input byte is read once and each
// output word written once, with four shifts and ors a word.  One thread
// per output word reads its (at most four) bytes from four streams:
// neighbouring threads read neighbouring bytes of each stream and write
// neighbouring words, so both sides coalesce without staging the
// transpose in shared memory (a tiled transpose is the later refinement).

#include "common.cuh"

namespace {

__global__ void bss_to_lanes_kernel(const uint8_t* __restrict__ raw,
                                    int64_t count, int k, int lanes,
                                    uint32_t* __restrict__ out) {
  const int64_t n = count * lanes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < n; t += stride) {
    const int64_t i = t / lanes;
    const int l = static_cast<int>(t - i * lanes);
    uint32_t word = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int s = 4 * l + b;
      if (s < k) {
        word |= static_cast<uint32_t>(__ldg(raw + s * count + i)) << (8 * b);
      }
    }
    out[t] = word;
  }
}

}  // namespace

// raw holds at least k * count bytes; out count * lanes words.
extern "C" int tpq_bss_to_lanes(const void* raw, int64_t count, int k,
                                int lanes, void* out, void* stream) {
  if (count > 0) {
    constexpr int kThreads = 256;
    bss_to_lanes_kernel<<<tpq::grid_for(count * lanes, kThreads), kThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(raw), count, k, lanes,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
