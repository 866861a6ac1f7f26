// KE1: LSB-first bit packing at widths 1..64 (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py pack_u32_device, pack_u64_device
// and the delta encoder's _pack_masked32/_pack_masked64 with the gather
// alo[sel_dev] before them: a block of 32 values of w bits occupies
// exactly w u32 words, and word j of a block ORs the values whose bits
// overlap [32j, 32j + 32) (the _pack_tables rule).  Values past `count`
// pack as 0 and bits above w are masked off; lanes past the inputs
// (n_in) read as 0.  With `sel`, block b packs the 32 lanes of miniblock
// sel[b], so the delta encoder packs the miniblocks of one width without
// a gathered copy.
//
// Bound on the H100: memory.  Each value is read once per word it
// touches (at most twice, three times at widths above 32) and each word
// written once, with a shift and an or a value.  One thread per output
// word: neighbouring threads write neighbouring words and read
// neighbouring values.  Each value is widened to 64 bits first, so every
// shift count is below 64 (a shift by 32 of a 32-bit word, which the
// straddle would take, is undefined in C).

#include "common.cuh"

namespace {

__global__ void pack_bits_kernel(const uint32_t* __restrict__ lo,
                                 const uint32_t* __restrict__ hi,
                                 int64_t n_in,
                                 const int32_t* __restrict__ sel,
                                 int64_t count, int w, int64_t n_words,
                                 uint32_t* __restrict__ out) {
  const uint32_t lomask = w >= 32 ? 0xFFFFFFFFu : ((1u << w) - 1u);
  const uint32_t himask =
      w >= 64 ? 0xFFFFFFFFu : (w > 32 ? ((1u << (w - 32)) - 1u) : 0u);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < n_words; t += stride) {
    const int64_t b = t / w;
    const int j = static_cast<int>(t - b * w);
    const int64_t base =
        sel != nullptr ? static_cast<int64_t>(__ldg(sel + b)) * 32 : b * 32;
    const int bit0 = 32 * j;
    const int i0 = bit0 / w;
    const int i1 = min((bit0 + 31) / w, 31);
    uint32_t acc = 0;
    for (int i = i0; i <= i1; ++i) {
      if (b * 32 + i >= count) break;
      const int64_t src = base + i;
      if (src >= n_in) continue;
      uint64_t v = __ldg(lo + src) & lomask;
      if (w > 32) v |= static_cast<uint64_t>(__ldg(hi + src) & himask) << 32;
      const int off = i * w - bit0;  // -(w - 1) .. 31
      acc |= off >= 0 ? static_cast<uint32_t>(v << off)
                      : static_cast<uint32_t>(v >> (-off));
    }
    out[t] = acc;
  }
}

}  // namespace

// lo (and hi when width > 32) hold n_in lanes; sel, when not null, holds
// ceil(count / 32) miniblock indices; out ceil(count / 32) * width words.
extern "C" int tpq_pack_bits(const void* lo, const void* hi, int64_t n_in,
                             const void* sel, int64_t count, int width,
                             void* out, void* stream) {
  const int64_t n_words = (count + 31) / 32 * width;
  if (n_words > 0) {
    constexpr int kThreads = 256;
    pack_bits_kernel<<<tpq::grid_for(n_words, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        n_in, static_cast<const int32_t*>(sel), count, width, n_words,
        static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
