// KE2: u32 lane words -> BYTE_STREAM_SPLIT streams (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py bss_encode_device, the inverse of
// K12: out[s * count + i] is byte s of row i's 4 * lanes little-endian
// bytes, for s < k.  The reference splits the words into bytes, keeps
// the first k of each row and transposes the (count, k) byte matrix.
//
// Bound on the H100: memory (k * count bytes read and written once).
// One thread writes four consecutive bytes of one stream as one u32 word
// where the stream's position is word-aligned, so neighbouring threads
// write neighbouring words of a stream; each reads the four rows' word
// that holds byte s.  Unaligned stream starts (count not a multiple of
// 4) and the stream's last partial word are written byte by byte.

#include "common.cuh"

namespace {

__global__ void bss_encode_kernel(const uint32_t* __restrict__ flat,
                                  int64_t count, int k, int lanes,
                                  int64_t groups,
                                  uint8_t* __restrict__ out) {
  const int64_t n = groups * k;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < n; t += stride) {
    const int s = static_cast<int>(t / groups);
    const int64_t i0 = (t - static_cast<int64_t>(s) * groups) * 4;
    const int l = s >> 2;
    const int sh = 8 * (s & 3);
    const int nv = count - i0 < 4 ? static_cast<int>(count - i0) : 4;
    uint32_t word = 0;
    for (int r = 0; r < nv; ++r) {
      word |= ((__ldg(flat + (i0 + r) * lanes + l) >> sh) & 0xFFu)
              << (8 * r);
    }
    uint8_t* dst = out + static_cast<int64_t>(s) * count + i0;
    if (nv == 4 && (reinterpret_cast<uintptr_t>(dst) & 3) == 0) {
      *reinterpret_cast<uint32_t*>(dst) = word;
    } else {
      for (int r = 0; r < nv; ++r) dst[r] = (word >> (8 * r)) & 0xFFu;
    }
  }
}

}  // namespace

// flat holds count * lanes words; out k * count bytes (k <= 4 * lanes).
extern "C" int tpq_bss_encode(const void* flat, int64_t count, int k,
                              int lanes, void* out, void* stream) {
  if (count > 0) {
    constexpr int kThreads = 256;
    const int64_t groups = (count + 3) / 4;
    bss_encode_kernel<<<tpq::grid_for(groups * k, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(flat), count, k, lanes, groups,
        static_cast<uint8_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
