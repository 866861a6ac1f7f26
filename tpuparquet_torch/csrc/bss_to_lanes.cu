// K12: BYTE_STREAM_SPLIT page -> u32 lane words (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py bss_to_lanes: k byte streams of
// count bytes (stream b holds byte b of every value) become count values
// of `lanes` little-endian u32 words; word i * lanes + l gathers bytes
// raw[(4l + b) * count + i] for b < 4, zero where 4l + b >= k.  The
// reference is a transpose of the (k, count) byte matrix, a zero pad and
// a byte-to-word combine, which XLA fuses.
//
// Bound on the H100: memory (k * count bytes read, 4 * lanes * count
// written, each once).  The first design had one thread a word and four
// 1-byte loads from four streams: a load instruction for every input
// byte, each using a quarter of its sectors.  This one is a tiled
// transpose through shared memory, the inverse of KE2
// (csrc/bss_encode.cu):
//
// * A block takes a tile of T consecutive rows, T a multiple of 16 that
//   the wrapper (kernels/decode.py, bss_lanes_tile_rows) owns: the
//   largest whose vectors (at most T / 16 + 1 a stream) take one round of
//   kVecs loads a thread, so 4,080 rows of floats and 2,032 of doubles.
//   KE2's rule (4,096 and 2,048) takes a second round for the last few
//   vectors, which was slower on the card (PERF.md).
// * Each stream's segment of the tile, from raw + s * count + i0, is
//   loaded as the aligned 16-byte vectors that cover it, kVecs in flight
//   a thread, and stored verbatim into the stream's shared-memory row of
//   T + kPad bytes, where it starts at byte d_s = (raw + s * count + i0)
//   & 15.  A stream starts off a 16-byte boundary whenever count is no
//   multiple of 16 (or raw is a view); its segment then costs one vector
//   more, which the neighbouring tile reads too.  Vectors never leave the
//   16-byte chunks that hold the segment's bytes.  (One bulk copy a
//   stream by the Tensor Memory Accelerator, completed on an mbarrier,
//   was slower on the card: PERF.md.)
// * A thread takes 4 rows.  For each lane it reads 4 rows of each of the
//   lane's 4 streams as one u32 (two aligned shared-memory words
//   funnel-shifted by d_s & 3), and a 4 x 4 byte transpose (the 8
//   __byte_perm of K5, csrc/planes_to_words.cu) makes the 4 rows' words;
//   bytes of streams >= k are 0.
// * With 1 to 4 lanes (compiled), the 4 rows' words of all lanes are
//   4 * lanes consecutive output words on a 16-byte boundary: `lanes`
//   16-byte chunks.  At 1 lane a warp's stores are 512 consecutive bytes.
//   At 2 to 4 a thread's own chunks would fill half of each 32-byte
//   sector a store instruction touches, so a full warp stages its
//   32 * lanes chunks in shared memory (swizzled against bank conflicts)
//   and stores them in 512-byte instructions.  Only the last tile's last
//   rows % 4 rows go word by word.
// * Wider rows (FIXED_LEN_BYTE_ARRAY past 16 bytes) take a (4 rows, lane)
//   item a thread, lanes fastest, so a warp's word stores are coalesced.
//   Where the streams of all lanes do not fit kSmemBytes at T rows, the
//   lanes split over gridDim.y and each block loads only its own lanes'
//   streams (at T = 16 from 257 lanes, 1,025 bytes a value, on).
//
// Each call is one launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;               // 16-byte loads in flight a thread
constexpr int kSmemBytes = 48 * 1024;  // stream rows of one block
constexpr int kPad = 32;               // a stream row is T + kPad bytes

// Copies the aligned 16-byte vectors that cover streams s0 .. s0 + ns - 1
// over rows i0 .. i0 + rows - 1 into shared memory: stream s0 + j's row
// i0 + r is then sm[j * stride + d + r], d = (raw + s * count + i0) & 15.
__device__ __forceinline__ void load_tile(const uint8_t* __restrict__ raw,
                                          int64_t count, int64_t i0,
                                          int rows, int s0, int ns,
                                          int stride, uint8_t* sm) {
  const int per = (stride - kPad) / 16 + 1;  // the most a segment needs
  const int total = ns * per;
  for (int v0 = 0; v0 < total; v0 += kThreads * kVecs) {
    uint4 x[kVecs];
    int at[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int v = v0 + u * kThreads + threadIdx.x;
      at[u] = -1;
      if (v < total) {
        const int j = v / per;
        const int m = v - j * per;
        const uint8_t* seg = raw + (s0 + j) * count + i0;
        const int d = static_cast<int>(reinterpret_cast<uintptr_t>(seg) & 15);
        if (16 * m < d + rows) {
          x[u] = __ldg(reinterpret_cast<const uint4*>(seg - d) + m);
          at[u] = j * stride + 16 * m;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      if (at[u] >= 0) *reinterpret_cast<uint4*>(sm + at[u]) = x[u];
    }
  }
}

// Rows r .. r + 3 (r a multiple of 4) of a shared-memory stream row whose
// segment starts at byte d, as one little-endian u32.  The second word
// lies inside the row's T + kPad bytes.
__device__ __forceinline__ uint32_t rows4(const uint8_t* row, int d, int r) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + ((d + r) & ~3));
  return __funnelshift_r(w[0], w[1], 8 * (d & 3));
}

// x[b] holds stream b's bytes of 4 rows; w[j] becomes row j's word.
__device__ __forceinline__ void transpose4(const uint32_t x[4],
                                           uint32_t w[4]) {
  const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t hi01 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t hi23 = __byte_perm(x[2], x[3], 0x7362);
  w[0] = __byte_perm(lo01, lo23, 0x5410);
  w[1] = __byte_perm(lo01, lo23, 0x7632);
  w[2] = __byte_perm(hi01, hi23, 0x5410);
  w[3] = __byte_perm(hi01, hi23, 0x7632);
}

// The shared-memory slot of a warp's staged 16-byte chunk `at` (thread t
// writes chunks t * L .. t * L + L - 1, then reads 32q + t): a quarter
// warp's 8 writes land on 8 distinct 16-byte bank groups.  At odd L the
// writes already do; at L = 2 and 4 the chunk's low bits take an XOR of
// at / 8.
template <int L>
__device__ __forceinline__ int swizzle(int at) {
  return L % 2 ? at : at ^ ((at >> 3) & (L - 1));
}

// kLanes: 1 to 4, one group of lanes a block; or 0 for `lanes` at run
// time in groups of `group` lanes over gridDim.y.
template <int kLanes>
__global__ void __launch_bounds__(kThreads)
bss_to_lanes_kernel(const uint8_t* __restrict__ raw, int64_t count, int k,
                    int lanes_rt, int T, int group,
                    uint32_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem);
  const int lanes = kLanes ? kLanes : lanes_rt;
  const int stride = T + kPad;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * T;
  const int rows = static_cast<int>(count - i0 < T ? count - i0 : T);
  const int l0 = blockIdx.y * group;
  const int nl = lanes - l0 < group ? lanes - l0 : group;
  const int s0 = 4 * l0;
  const int ns = k - s0 < 4 * nl ? k - s0 : 4 * nl;
  load_tile(raw, count, i0, rows, s0, ns, stride, sm);
  __syncthreads();

  // stream s0 + j's segment starts at byte (r15 + j * c15) & 15 of its row
  const int r15 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(raw) + s0 * count + i0) & 15);
  const int c15 = static_cast<int>(count & 15);
  const int groups = (rows + 3) >> 2;
  if constexpr (kLanes > 0) {
    constexpr int L = kLanes;
    const int lane = threadIdx.x & 31;
    uint4* stage = reinterpret_cast<uint4*>(sm + ns * stride) +
                   (threadIdx.x >> 5) * 32 * L;  // the warp's staged chunks
    for (int g = threadIdx.x; g < groups; g += kThreads) {
      uint32_t w[L][4];
#pragma unroll
      for (int l = 0; l < L; ++l) {
        uint32_t x[4];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int s = 4 * l + b;
          x[b] = s < k ? rows4(sm + s * stride, (r15 + s * c15) & 15, 4 * g)
                       : 0u;
        }
        transpose4(x, w[l]);
      }
      // row 4g + j's lane l is word (i0 + 4g) * L + j * L + l: the rows'
      // words are L 16-byte chunks
      uint4 o[L];
#pragma unroll
      for (int q = 0; q < L; ++q) {
        uint32_t e[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) e[c] = w[(4 * q + c) % L][(4 * q + c) / L];
        o[q] = make_uint4(e[0], e[1], e[2], e[3]);
      }
      const int base = g - lane;  // the warp's first group
      if (L > 1 && 4 * (base + 32) <= rows) {
        // the warp's 32 * L chunks are contiguous: staged through shared
        // memory, each store instruction writes 512 consecutive bytes
#pragma unroll
        for (int q = 0; q < L; ++q) stage[swizzle<L>(lane * L + q)] = o[q];
        __syncwarp();
        uint4* dst = reinterpret_cast<uint4*>(out + (i0 + 4 * base) * L);
#pragma unroll
        for (int q = 0; q < L; ++q) {
          dst[32 * q + lane] = stage[swizzle<L>(32 * q + lane)];
        }
        __syncwarp();
      } else if (4 * g + 4 <= rows) {
        uint4* dst = reinterpret_cast<uint4*>(out + (i0 + 4 * g) * L);
#pragma unroll
        for (int q = 0; q < L; ++q) dst[q] = o[q];
      } else {
        uint32_t* dst = out + (i0 + 4 * g) * L;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (4 * g + j < rows) {
#pragma unroll
            for (int l = 0; l < L; ++l) dst[j * L + l] = w[l][j];
          }
        }
      }
    }
  } else {
    const int items = groups * nl;
    for (int x0 = threadIdx.x; x0 < items; x0 += kThreads) {
      const int g = x0 / nl;
      const int l = l0 + (x0 - g * nl);
      uint32_t x[4], w[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int j = 4 * l + b - s0;
        x[b] = j < ns ? rows4(sm + j * stride, (r15 + j * c15) & 15, 4 * g)
                      : 0u;
      }
      transpose4(x, w);
      uint32_t* dst = out + (i0 + 4 * g) * lanes + l;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (4 * g + j < rows) dst[static_cast<int64_t>(j) * lanes] = w[j];
      }
    }
  }
}

using Kernel = void (*)(const uint8_t*, int64_t, int, int, int, int,
                        uint32_t*);

// kernels by compiled lane count (0: lanes at run time)
const Kernel kKernels[5] = {
    &bss_to_lanes_kernel<0>, &bss_to_lanes_kernel<1>, &bss_to_lanes_kernel<2>,
    &bss_to_lanes_kernel<3>, &bss_to_lanes_kernel<4>};

}  // namespace

// raw holds at least k * count bytes (k <= 4 * lanes); out count * lanes
// words on a 16-byte boundary; T rows a tile, a multiple of 16.
extern "C" int tpq_bss_to_lanes(const void* raw, int64_t count, int k,
                                int lanes, int T, void* out, void* stream) {
  if (T < 16 || T % 16 != 0 || 4 * (T + kPad) > kSmemBytes || k < 1 ||
      k > 4 * lanes) {
    return cudaErrorInvalidValue;
  }
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  // 1 to 4 lanes take the compiled kernel, whose block holds all the
  // streams and each warp's 32 * lanes staged chunks (at 2 to 4 lanes),
  // where these fit; other blocks hold the streams of `group` lanes
  const int stage = lanes > 1 ? kThreads * 16 * lanes : 0;
  const bool compiled =
      lanes <= 4 && 4 * lanes * (T + kPad) + stage <= kSmemBytes;
  int group = compiled ? lanes : kSmemBytes / (4 * (T + kPad));
  if (group > lanes) group = lanes;
  const dim3 grid(tpq::grid_for(count, T), (lanes + group - 1) / group);
  const int streams = 4 * group < k ? 4 * group : k;
  const size_t smem =
      static_cast<size_t>(streams) * (T + kPad) + (compiled ? stage : 0);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* r = static_cast<const uint8_t*>(raw);
  uint32_t* o = static_cast<uint32_t*>(out);
  const Kernel kernel = kKernels[compiled ? lanes : 0];
  kernel<<<grid, kThreads, smem, st>>>(r, count, k, lanes, T, group, o);
  return static_cast<int>(cudaGetLastError());
}
