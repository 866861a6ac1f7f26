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
// output word written once; the work is a few shifts a word.  What held
// the first design back was not the bytes but the instructions: one
// thread a word, a 64-bit division to find its row and four 1-byte loads
// to gather it.  The design, by row length:
//
// * L % 4 == 0 (the page's L = 16): the output bytes are the input bytes,
//   so the kernel is a copy of count * L bytes.  Each thread stores four
//   16-byte vectors to the output (which the wrapper allocates, so it is
//   16-byte aligned) and loads the 16-byte-aligned vectors of `raw` that
//   hold them: where `raw` itself is not 16-byte aligned (a view into a
//   larger buffer), the next vector too, and funnel shifts pick the
//   bytes.  The at most 12 bytes past the last whole vector go out as
//   words.
// * L % 4 != 0 and the caller's tile of R rows (R > 0, a multiple of
//   16, so the tile's bytes start on a 16-byte boundary whenever `raw`
//   does): a block takes a tile.  It loads the tile's bytes into shared
//   memory as 16-byte vectors (the aligned vectors that cover the tile,
//   each input byte read once), then each thread builds four
//   consecutive words from two shared-memory words each, with 32-bit row
//   and lane indices inside the tile, and stores them as one 16-byte
//   vector (the tile's output starts 64-byte aligned).  The wrapper
//   (kernels/decode.py, flba_tile_rows) owns R: the largest multiple of
//   16 whose rows fit 16 KiB.
// * L % 4 != 0 and R == 0 (rows past 1,024 bytes, where 16 do not fit a
//   tile): one thread a word, gathering its bytes from device memory.
//
// The tile load uses vector loads, not the TMA: the page's shape (L = 16)
// takes the copy, which stages nothing, so a bulk copy into shared memory
// has no call on the main path to win.  chip_smoke.py's phase 4 times
// the tiles against one thread a word at decimal widths of 5, 6 and 7
// bytes.  Each call is one launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                 // 16-byte vectors a thread
constexpr int kSmemBytes = 48 * 1024;    // shared memory of one block

// A 16-byte vector of `raw` at byte offset 16 * v from `src`, where src =
// base + a and base is 16-byte aligned: base's vectors v and v + 1
// (only when a != 0) shifted right by a bytes.
template <int kWordShift>
__device__ __forceinline__ uint4 shifted(const uint4* __restrict__ base,
                                         int64_t v, int bits) {
  const uint4 lo = __ldg(base + v);
  if (kWordShift == 0 && bits == 0) return lo;
  const uint4 hi = __ldg(base + v + 1);
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  return make_uint4(__funnelshift_r(w[kWordShift], w[kWordShift + 1], bits),
                    __funnelshift_r(w[kWordShift + 1], w[kWordShift + 2],
                                    bits),
                    __funnelshift_r(w[kWordShift + 2], w[kWordShift + 3],
                                    bits),
                    __funnelshift_r(w[kWordShift + 3], w[kWordShift + 4],
                                    bits));
}

// L % 4 == 0: copy n bytes (a multiple of 4) from raw = base + 4 *
// kWordShift + bits / 8 to the 16-byte-aligned out.
template <int kWordShift>
__global__ void __launch_bounds__(kThreads)
flba_copy_kernel(const uint8_t* __restrict__ raw,
                 const uint4* __restrict__ base, int bits, int64_t n,
                 uint32_t* __restrict__ out) {
  const int64_t nvec = n >> 4;
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * (kThreads * kVecs) +
                     threadIdx.x;
  uint4 x[kVecs];
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int64_t v = v0 + u * kThreads;
    if (v < nvec) x[u] = shifted<kWordShift>(base, v, bits);
  }
  uint4* out4 = reinterpret_cast<uint4*>(out);
#pragma unroll
  for (int u = 0; u < kVecs; ++u) {
    const int64_t v = v0 + u * kThreads;
    if (v < nvec) out4[v] = x[u];
  }
  // the words past the last whole vector (n % 16 bytes, at most 3 words)
  if (blockIdx.x == 0 && threadIdx.x < ((n & 15) >> 2)) {
    const int64_t w = (nvec << 2) + threadIdx.x;
    const uint8_t* p = raw + 4 * w;
    out[w] = static_cast<uint32_t>(__ldg(p)) |
             static_cast<uint32_t>(__ldg(p + 1)) << 8 |
             static_cast<uint32_t>(__ldg(p + 2)) << 16 |
             static_cast<uint32_t>(__ldg(p + 3)) << 24;
  }
}

// Shared memory of a tile of R rows: the tile's aligned vectors, and
// one word of slack for the second word a partial last lane may read
// (its bits are masked off).
inline size_t tile_smem(int R, int L) {
  return (static_cast<size_t>(R) * L / 16 + 2) * 16;
}

// L % 4 != 0, R > 0: one tile of R rows a block.
__global__ void __launch_bounds__(kThreads)
flba_tile_kernel(const uint8_t* __restrict__ raw, int64_t count, int L,
                 int lanes, int R, uint32_t* __restrict__ out) {
  extern __shared__ uint4 tile[];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * R;
  const int rows = static_cast<int>(count - r0 < R ? count - r0 : R);
  const uint8_t* start = raw + r0 * L;
  const int a = static_cast<int>(reinterpret_cast<uintptr_t>(start) & 15);
  const uint4* src = reinterpret_cast<const uint4*>(start - a);
  const int nload = (a + rows * L + 15) >> 4;
  for (int v = threadIdx.x; v < nload; v += kThreads) {
    tile[v] = __ldg(src + v);
  }
  __syncthreads();

  const uint32_t* sm = reinterpret_cast<const uint32_t*>(tile);
  const int nw = rows * lanes;
  uint32_t* dst = out + r0 * lanes;
  for (int w0 = 4 * threadIdx.x; w0 < nw; w0 += 4 * kThreads) {
    int r = w0 / lanes;
    int j = w0 - r * lanes;
    uint32_t word[4] = {0, 0, 0, 0};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (w0 + q < nw) {  // words past the tile would read past its bytes
        const int off = a + r * L + 4 * j;
        const int nb = L - 4 * j < 4 ? L - 4 * j : 4;
        uint32_t v = __funnelshift_r(sm[off >> 2], sm[(off >> 2) + 1],
                                     8 * (off & 3));
        if (nb < 4) v &= (1u << (8 * nb)) - 1u;
        word[q] = v;
      }
      if (++j == lanes) {
        j = 0;
        ++r;
      }
    }
    if (w0 + 4 <= nw) {
      *reinterpret_cast<uint4*>(dst + w0) =
          make_uint4(word[0], word[1], word[2], word[3]);
    } else {
      for (int q = 0; w0 + q < nw; ++q) dst[w0 + q] = word[q];
    }
  }
}

// L % 4 != 0, R == 0: one thread a word.
__global__ void flba_wide_kernel(const uint8_t* __restrict__ raw,
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
      if (s < L) word |= static_cast<uint32_t>(__ldg(row + s)) << (8 * b);
    }
    out[t] = word;
  }
}

}  // namespace

// raw holds at least count * L bytes (checked by the caller); out
// count * lanes words, 16-byte aligned (the caller allocates it).  R is
// the rows of a tile when L % 4 != 0, 0 for one thread a word; a copy
// (L % 4 == 0) ignores it.
extern "C" int tpq_flba_to_lanes(const void* raw, int64_t count, int L,
                                 int lanes, int R, void* out,
                                 void* stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15) return cudaErrorInvalidValue;
  if (L % 4 != 0 && (R < 0 || R % 16 != 0 ||
                     (R > 0 && tile_smem(R, L) > kSmemBytes))) {
    return cudaErrorInvalidValue;
  }
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(raw);
  uint32_t* o = static_cast<uint32_t*>(out);
  if (L % 4 == 0) {
    const int64_t n = count * L;
    const int a = static_cast<int>(reinterpret_cast<uintptr_t>(r) & 15);
    const uint4* base = reinterpret_cast<const uint4*>(r - a);
    const int bits = 8 * (a & 3);
    const unsigned grid = tpq::grid_for(n >> 4, kThreads * kVecs);
    switch (a >> 2) {
      case 0: flba_copy_kernel<0><<<grid, kThreads, 0, st>>>(r, base, bits,
                                                            n, o); break;
      case 1: flba_copy_kernel<1><<<grid, kThreads, 0, st>>>(r, base, bits,
                                                            n, o); break;
      case 2: flba_copy_kernel<2><<<grid, kThreads, 0, st>>>(r, base, bits,
                                                            n, o); break;
      default: flba_copy_kernel<3><<<grid, kThreads, 0, st>>>(r, base, bits,
                                                             n, o);
    }
  } else if (R > 0) {
    flba_tile_kernel<<<tpq::grid_for(count, R), kThreads, tile_smem(R, L),
                       st>>>(r, count, L, lanes, R, o);
  } else {
    flba_wide_kernel<<<tpq::grid_for(count * lanes, kThreads), kThreads, 0,
                       st>>>(r, count, L, lanes, o);
  }
  return static_cast<int>(cudaGetLastError());
}
