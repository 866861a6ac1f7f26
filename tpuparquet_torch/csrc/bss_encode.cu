// KE2: u32 lane words -> BYTE_STREAM_SPLIT streams (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py bss_encode_device, the inverse of
// K12: out[s * count + i] is byte s of row i's 4 * lanes little-endian
// bytes, for s < k.  The reference splits the words into bytes, keeps
// the first k of each row and transposes the (count, k) byte matrix.
//
// Bound on the H100: memory (count * 4 * lanes bytes read, k * count
// written, each once).  The first design had one thread a stream and
// four rows: each input word was loaded by four threads, one for each of
// its bytes, and a stream whose start s * count was not 4-byte aligned
// went out byte by byte.  This one is a tiled transpose through shared
// memory:
//
// * A block takes a tile of T consecutive rows, T a multiple of 16 that
//   the wrapper (kernels/encode.py, bss_tile_rows) owns: the largest
//   with T * 4 * lanes <= 16 KiB (at least 16), so 4,096 rows of floats
//   and 2,048 of doubles.  It loads the tile's words as 16-byte
//   vectors (the aligned vectors that cover it, so a `flat` that starts
//   off a 16-byte boundary costs at most one extra vector at each end),
//   four in flight a thread, each input byte read once.
// * Each byte goes to shared memory, into row s of the tile's stream
//   rows.  A row is T + 16 bytes long, and stream s's bytes start at byte
//   (out + s * count + i0) % 16 of it, the alignment of the tile's segment
//   of stream s in the output.  For 1 and 2 lanes (the template's
//   constants) the threads of a warp write one stream row each
//   instruction, at neighbouring bytes, so the scatter does not serialise
//   on banks.
// * Each stream's segment then goes out as 16-byte vector stores on the
//   output's own 16-byte boundaries, read from shared memory at the same
//   alignment; only the at most 15 bytes before the first boundary and 15
//   after the last are stored byte by byte.  So an unaligned stream start
//   (count not a multiple of 16) costs 30 byte stores a tile, not a byte
//   store a row.
// * Rows wider than the shared-memory budget holds for all k streams
//   split the streams over gridDim.y; each such block reads the whole
//   tile and keeps its streams.  At 1 to 16 lanes one block holds all.
//
// Each call is one launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 4;                // 16-byte loads in flight a thread
constexpr int kSmemBytes = 48 * 1024;   // stream rows of one block

// kLanes: 1 or 2, or 0 for `lanes` at run time.
template <int kLanes>
__global__ void __launch_bounds__(kThreads)
bss_encode_kernel(const uint32_t* __restrict__ flat, int64_t count, int k,
                  int lanes_rt, int T, int group, uint8_t* __restrict__ out) {
  extern __shared__ uint4 smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(smem);
  const int lanes = kLanes ? kLanes : lanes_rt;
  const int stride = T + 16;
  const int64_t i0 = static_cast<int64_t>(blockIdx.x) * T;
  const int rows = static_cast<int>(count - i0 < T ? count - i0 : T);
  const int s0 = blockIdx.y * group;
  const int s1 = k - s0 < group ? k : s0 + group;
  // stream s's segment of this tile starts at out + s * count + i0, at
  // byte (o15 + s * c15) % 16 of a 16-byte vector
  const int o15 = static_cast<int>(
      (reinterpret_cast<uintptr_t>(out) + static_cast<uintptr_t>(i0)) & 15);
  const int c15 = static_cast<int>(count & 15);

  const uint32_t* start = flat + i0 * lanes;
  const int a = static_cast<int>((reinterpret_cast<uintptr_t>(start) & 15)
                                 >> 2);
  const uint4* src = reinterpret_cast<const uint4*>(start - a);
  const int nw = rows * lanes;
  const int nvec = (a + nw + 3) >> 2;
  for (int v0 = 0; v0 < nvec; v0 += kThreads * kVecs) {
    uint4 x[kVecs];
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int v = v0 + u * kThreads + threadIdx.x;
      if (v < nvec) x[u] = __ldg(src + v);
    }
#pragma unroll
    for (int u = 0; u < kVecs; ++u) {
      const int v = v0 + u * kThreads + threadIdx.x;
      if (v >= nvec) continue;
      const uint32_t words[4] = {x[u].x, x[u].y, x[u].z, x[u].w};
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int wi = 4 * v + q - a;
        if (wi < 0 || wi >= nw) continue;
        const int r = wi / lanes;
        const int l = wi - r * lanes;
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int s = 4 * l + b;
          if (s >= s0 && s < s1) {
            sm[(s - s0) * stride + ((o15 + s * c15) & 15) + r] =
                static_cast<uint8_t>(words[q] >> (8 * b));
          }
        }
      }
    }
  }
  __syncthreads();

  // the 16-byte-aligned body of each stream's segment
  const int vps = T >> 4;
  const int ns = s1 - s0;
  for (int x = threadIdx.x; x < ns * vps; x += kThreads) {
    const int si = x / vps;
    const int m = x - si * vps;
    const int s = s0 + si;
    const int d = (o15 + s * c15) & 15;
    const int h = rows < ((16 - d) & 15) ? rows : ((16 - d) & 15);
    if (m < ((rows - h) >> 4)) {
      // d + h is 0 or 16 here, so both addresses are 16-byte aligned
      *reinterpret_cast<uint4*>(out + s * count + i0 + h + 16 * m) =
          *reinterpret_cast<const uint4*>(sm + si * stride + d + h + 16 * m);
    }
  }
  // the head (before the first boundary) and the tail (after the last)
  for (int x = threadIdx.x; x < ns * 32; x += kThreads) {
    const int si = x >> 5;
    const int j = x & 31;
    const int s = s0 + si;
    const int d = (o15 + s * c15) & 15;
    const int h = rows < ((16 - d) & 15) ? rows : ((16 - d) & 15);
    const int body_end = h + (((rows - h) >> 4) << 4);
    const int p = j < 16 ? j : body_end + j - 16;
    if (j < 16 ? j < h : p < rows) {
      out[s * count + i0 + p] = sm[si * stride + d + p];
    }
  }
}

}  // namespace

// flat holds count * lanes words (4-byte aligned); out k * count bytes
// (k <= 4 * lanes); T rows a tile, a multiple of 16.
extern "C" int tpq_bss_encode(const void* flat, int64_t count, int k,
                              int lanes, int T, void* out, void* stream) {
  if (T < 16 || T % 16 != 0 || T + 16 > kSmemBytes) {
    return cudaErrorInvalidValue;
  }
  if (count <= 0) return static_cast<int>(cudaGetLastError());
  int group = kSmemBytes / (T + 16);
  if (group > k) group = k;
  const dim3 grid(tpq::grid_for(count, T), (k + group - 1) / group);
  const size_t smem = static_cast<size_t>(group) * (T + 16);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint32_t* f = static_cast<const uint32_t*>(flat);
  uint8_t* o = static_cast<uint8_t*>(out);
  if (lanes == 1) {
    bss_encode_kernel<1><<<grid, kThreads, smem, st>>>(f, count, k, lanes,
                                                       T, group, o);
  } else if (lanes == 2) {
    bss_encode_kernel<2><<<grid, kThreads, smem, st>>>(f, count, k, lanes,
                                                       T, group, o);
  } else {
    bss_encode_kernel<0><<<grid, kThreads, smem, st>>>(f, count, k, lanes,
                                                       T, group, o);
  }
  return static_cast<int>(cudaGetLastError());
}
