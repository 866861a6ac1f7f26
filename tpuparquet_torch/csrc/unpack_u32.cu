// K1: unpack LSB-first w-bit values into u32 lanes (sm_90a).
//
// Replaces tpuparquet/kernels/bitunpack.py unpack_u32_pallas (the Pallas
// kernel, _unpack_kernel / _unpack_block_unrolled) and its XLA twin
// unpack_u32, which the JAX decode path calls from the single-run fast
// path of its stream expansion (decode.py _expand_stream).
//
// Bound on the H100: memory.  Each output lane costs 4 bytes written and
// w/8 bytes read, a few integer operations apiece, far below the card's
// operation rate.  The TPU kernel tiled (n_blocks, w) word rows into VMEM
// with static per-width shift tables.
//
// One thread a lane would spend a 64-bit multiply, shifts and masks by a
// run-time width, and a 4-byte store on every lane.  So a block owns a
// tile of 2,048 consecutive lanes (64 w words):
// - The width is a template parameter (1-32; 0 is a fill of zeros in the
//   same launch), chosen by one table lookup in tpq_unpack_u32, so every
//   shift and mask is a constant.
// - Thread t of a warp holds lanes 4t..4t+3 of the warp's 128-lane row,
//   so the warp's row is one contiguous 512-byte store of 16 bytes a
//   thread; a thread takes 2 rows, 1,024 lanes apart.
// - The 4 lanes' 4w bits come from the words that hold them
//   (tpq::unpack4, common.cuh), funnel-shifted into a window from which
//   each lane is a constant shift and mask, read straight through the
//   read-only cache (neighbouring threads share words, which the cache
//   serves).  Staging the tile's words in shared memory first, with
//   16-byte loads, was slower at every width on the card.  Offsets inside
//   a tile are 32-bit; only the tile's base is 64-bit.
// - A thread's 4 lanes lie in one 32-lane block of the stream, so a
//   thread whose first lane is below the count reads only words below
//   ceil(count / 32) * w, the stream's end; lanes past the count (the
//   tail) are stored one by one.  `words` may start at any 4-byte
//   boundary; `out` must start at a 16-byte one.
// One launch a call, nothing to zero first.

#include <array>
#include <utility>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 4;                      // lanes a thread holds a row
constexpr int kRowLanes = kThreads * kVec;   // 1,024 lanes a block's row
constexpr int kRows = 2;                     // rows a thread holds
constexpr int kTile = kRowLanes * kRows;     // 2,048 lanes a block

// W in 1..32: each thread reads its rows' words through the read-only
// cache; W == 0 stores zeros.
template <int W>
__global__ void __launch_bounds__(kThreads) unpack_kernel(
    const uint32_t* __restrict__ words, uint32_t* __restrict__ out,
    int64_t count) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t rest = count - base;
  const int left = static_cast<int>(rest < kTile ? rest : kTile);
  const uint32_t* tw = words + base / 32 * W;
  uint32_t* to = out + base;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int i = r * kRowLanes + kVec * static_cast<int>(threadIdx.x);
    if (i >= left) break;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (W > 0) {
      const uint32_t bit = static_cast<uint32_t>(i) * W;
      const uint32_t* p = tw + (bit >> 5);
      v = tpq::unpack4<W>([p](int k) { return __ldg(p + k); }, bit & 31);
    }
    tpq::store4(to, i, left, v);
  }
}

using Kernel = void (*)(const uint32_t*, uint32_t*, int64_t);

template <int... W>
constexpr std::array<Kernel, sizeof...(W)> kernels(
    std::integer_sequence<int, W...>) {
  return {{&unpack_kernel<W>...}};
}

// kernels by width, 0..32
const auto kKernels = kernels(std::make_integer_sequence<int, 33>());

}  // namespace

// `tile` (lanes a block, bitunpack.unpack_tile_lanes) must equal the
// compiled tile.
extern "C" int tpq_unpack_u32(const void* words, void* out, int64_t count,
                              int width, int tile, void* stream) {
  if (tile != kTile || width < 0 || width > 32 ||
      (reinterpret_cast<uintptr_t>(words) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (count > 0) {
    kKernels[width]<<<tpq::grid_for(count, kTile), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(words), static_cast<uint32_t*>(out),
        count);
  }
  return static_cast<int>(cudaGetLastError());
}
