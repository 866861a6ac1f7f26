// K6: unpack LSB-first w-bit values, 33 <= w <= 64, into (lo, hi) u32
// lanes (sm_90a).
//
// Replaces tpuparquet/kernels/bitunpack.py unpack_u64 (XLA-jitted, with
// its static tables plan_tables64 and the gated shift _chunk32) for the
// widths above 32; width 0 and widths up to 32 stay in the wrapper (zeros,
// or K1 plus a zero hi lane), exactly as the JAX function branches.
//
// Layout: a block of 32 consecutive values spans exactly w u32 words, and
// value j of a block starts at bit j*w of it, so its 64 bits lie in up to
// three consecutive words widx, widx+1, widx+2.  The reference clamps the
// second and third index to the block's last word (w - 1), which keeps
// every read inside the block; the clamped word only ever supplies bits
// that the shift or the final mask discards.  The kernel keeps the clamp
// so that it reads exactly the words the reference reads.
//
// Bound on the H100: memory.  Each value costs w/8 bytes read and 8 bytes
// written, and a handful of integer operations.  One thread per value;
// neighbouring threads read neighbouring words, so loads and the two
// output streams coalesce.

#include "common.cuh"

namespace {

// 32 bits starting `shift` bits into w_lo; shift == 0 gated so that no
// shift by 32 is taken (undefined in CUDA as in C).
__device__ __forceinline__ uint32_t chunk32(uint32_t w_lo, uint32_t w_hi,
                                            uint32_t shift) {
  return shift ? (w_lo >> shift) | (w_hi << (32u - shift)) : w_lo;
}

__global__ void unpack_u64_kernel(const uint32_t* __restrict__ words,
                                  uint32_t* __restrict__ lo,
                                  uint32_t* __restrict__ hi, int64_t count,
                                  int width) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const uint32_t hi_mask =
      width < 64 ? (1u << (width - 32)) - 1u : 0xffffffffu;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < count; i += stride) {
    const uint32_t* blk = words + (i >> 5) * width;
    const int bit = static_cast<int>(i & 31) * width;
    const int widx = bit >> 5;
    const uint32_t shift = static_cast<uint32_t>(bit & 31);
    const int widx2 = min(widx + 1, width - 1);
    const int widx3 = min(widx + 2, width - 1);
    const uint32_t w1 = __ldg(blk + widx);
    const uint32_t w2 = __ldg(blk + widx2);
    const uint32_t w3 = __ldg(blk + widx3);
    lo[i] = chunk32(w1, w2, shift);
    hi[i] = chunk32(w2, w3, shift) & hi_mask;
  }
}

}  // namespace

// `words` holds ceil(count / 32) * width u32 words; 33 <= width <= 64.
extern "C" int tpq_unpack_u64(const void* words, void* lo, void* hi,
                              int64_t count, int width, void* stream) {
  if (count > 0) {
    constexpr int kThreads = 256;
    unpack_u64_kernel<<<tpq::grid_for(count, kThreads), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<uint32_t*>(lo),
        static_cast<uint32_t*>(hi), count, width);
  }
  return static_cast<int>(cudaGetLastError());
}
