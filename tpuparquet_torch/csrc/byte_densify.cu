// KS3: a BYTE_ARRAY unit densified into its row of the gathered block
// (sm_90a).
//
// Replaces the densify of tpuparquet/shard/scan.py gather_byte_column
// (XLA-jitted jnp ops per unit, then jnp.pad):
//   dl[i]     = mask[i] ? offsets[positions[i] + 1] - offsets[positions[i]]
//                       : 0
//   out_offs  = [0, cumsum(dl)], edge-padded to L entries (the byte total)
//   out_data  = the unit's value bytes, zero-padded to B
// A null value slot is a zero-length value: its bytes are already absent
// from the packed data, so the data row is the packed bytes as they are
// and only the offsets re-derive.  A null mask pointer means every slot is
// valid, a null positions pointer the identity.  Every position is clamped
// into [0, n_packed - 1], as JAX clamps its gather.  Offsets and sums are
// int32 and wrap as the reference's do (its device runs without 64-bit
// integers); the wrapper refuses a unit of 2^31 bytes or more.
//
// Bound on the H100: memory.  A slot reads a mask byte, a position and
// two offsets and writes four bytes; each data byte is read once and
// written once.  The data row does not depend on the running sum at all.
//
// The parent made three launches (a block sum of the lengths, one block
// scanning the block sums, a second pass over every slot that wrote the
// offsets and copied the data one byte a thread behind both).  This
// design is one launch after one memset:
// - Out_offs[j] is the exclusive prefix of slot j over L slots, those at
//   and past n of length 0, so the edge padding is the same scan.  Slot j
//   stands at virtual slot j + a, where a is out_offs' offset in words
//   from a 16-byte boundary, so every lane's 4 consecutive virtual slots
//   store as one aligned 16-byte vector.
// - Tiles of 2,048 virtual slots (8 warps, each lane 2 rows of 4) are
//   numbered by an atomic ticket in the order blocks start, so a tile only
//   waits on tiles that run.  Each slot's mask, position and two offsets
//   are read once, into registers, and stay there from the tile's
//   reduction to its stores.  The kernel is held to 40 registers, so 6
//   blocks share an SM; tiles of 4,096 slots (76 registers, 3 blocks an
//   SM) were slower on the card.
// - A single-pass scan with decoupled look-back (Merrill and Garland,
//   2016), as K7's: a tile's status and its 32-bit sum share one 64-bit
//   word, published by one store, so no fence orders them; warp 0 looks
//   back 32 tiles a step until it meets a published inclusive prefix
//   (tpq::look_back in common.cuh, which K4 shares).
// - Between publishing its sum and looking back, every block copies a
//   share of the data row, so the copy fills the scan's waits: 16-byte
//   stores on out_data's own boundaries, each from one or two aligned
//   16-byte loads of the data funnel-shifted into place (K10's idiom), the
//   bytes past nb zeroed in the same stores, byte heads and tails only at
//   the row's ends.  Blocks past the scan's tiles, where the data row
//   needs them, only copy.

#include "common.cuh"

namespace {

using tpq::u64;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                    // slots a lane holds a row
constexpr int kRows = 2;                   // rows a lane holds
constexpr int kRow = 32 * kVec;            // 128 slots a warp's row
constexpr int kWarpSpan = kRow * kRows;    // 256 slots a warp
constexpr int kTile = kWarps * kWarpSpan;  // 2,048 slots a tile
constexpr int kBlocksPerSM = 6;            // the launch bound
constexpr int64_t kCopyChunks = 4096;      // most 16-byte chunks a block
constexpr int kCopyBatch = 4;              // chunks a thread has in flight
constexpr unsigned kFull = 0xffffffffu;

// The 16 bytes of out_data from byte b (>= head): the data's bytes there,
// zero past nb.  `shift` is (data + head) mod 16, so they begin `shift`
// bytes into an aligned vector of the data; only vectors that hold a byte
// below nb are loaded.
__device__ __forceinline__ uint4 chunk_at(const uint8_t* __restrict__ data,
                                          int64_t nb, int64_t b,
                                          uint32_t shift) {
  const uint4 zero = make_uint4(0, 0, 0, 0);
  if (b >= nb) return zero;
  const auto* src = reinterpret_cast<const uint4*>(data + b - shift);
  uint4 v = __ldg(src);
  if (shift) {
    v = tpq::select16(v, b - shift + 16 < nb ? __ldg(src + 1) : zero, shift);
  }
  if (b + 16 > nb) {
    const int keep = static_cast<int>(nb - b);
    v = make_uint4(tpq::merge(v.x, 0, keep), tpq::merge(v.y, 0, keep - 4),
                   tpq::merge(v.z, 0, keep - 8),
                   tpq::merge(v.w, 0, keep - 12));
  }
  return v;
}

// Out_data's 16-byte chunks [c0, c1), chunk c at byte head + 16c, each
// thread with kCopyBatch of them in flight.
__device__ __forceinline__ void copy_chunks(const uint8_t* __restrict__ data,
                                            int64_t nb,
                                            uint8_t* __restrict__ out,
                                            int64_t head, uint32_t shift,
                                            int64_t c0, int64_t c1) {
  for (int64_t c = c0 + threadIdx.x; c < c1; c += kCopyBatch * kThreads) {
    uint4 v[kCopyBatch];
#pragma unroll
    for (int q = 0; q < kCopyBatch; ++q) {
      const int64_t cq = c + q * kThreads;
      v[q] = cq < c1 ? chunk_at(data, nb, head + 16 * cq, shift)
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int q = 0; q < kCopyBatch; ++q) {
      const int64_t cq = c + q * kThreads;
      if (cq < c1) *reinterpret_cast<uint4*>(out + head + 16 * cq) = v[q];
    }
  }
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    densify_kernel(const int32_t* __restrict__ offsets, int64_t n_packed,
                   const uint8_t* __restrict__ mask,
                   const int32_t* __restrict__ positions, int64_t n, int a,
                   bool vec_mask, bool vec_pos, int64_t n_scan,
                   uint32_t* __restrict__ counter, u64* words,
                   uint32_t* __restrict__ out_offs, int64_t L,
                   const uint8_t* __restrict__ data, int64_t nb,
                   uint8_t* __restrict__ out_data, int64_t B, int64_t head,
                   uint32_t shift, int64_t n_chunks, int64_t per_block) {
  __shared__ int64_t s_ticket;
  __shared__ uint32_t s_warp[kWarps];
  __shared__ uint32_t s_prefix;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) s_ticket = atomicAdd(counter, 1u);
  __syncthreads();
  const int64_t t = s_ticket;
  const bool scan = t < n_scan;
  // first virtual slot of each of the lane's rows: v0 + row * kRow
  const int64_t v0 =
      t * kTile + static_cast<int64_t>(warp) * kWarpSpan + kVec * lane;

  // the lengths, each slot's inputs read once
  uint32_t x[kRows][kVec];
  uint32_t warp_ex = 0, tile_sum = 0;
  if (scan) {
    int64_t p[kRows][kVec];
    bool live[kRows][kVec];
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      const int64_t j0 = v0 + row * kRow - a;
      const bool full = j0 >= 0 && j0 + kVec <= n;
      uchar4 m = make_uchar4(1, 1, 1, 1);
      if (mask != nullptr && full && vec_mask) {
        m = __ldg(reinterpret_cast<const uchar4*>(mask + j0));
      }
      int4 q = make_int4(0, 0, 0, 0);
      if (positions != nullptr && full && vec_pos) {
        q = __ldg(reinterpret_cast<const int4*>(positions + j0));
      }
      const uint8_t mv[kVec] = {m.x, m.y, m.z, m.w};
      const int32_t qv[kVec] = {q.x, q.y, q.z, q.w};
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const int64_t j = j0 + k;
        bool ok = j >= 0 && j < n && n_packed > 0;
        if (ok && mask != nullptr) {
          ok = (full && vec_mask ? mv[k] : __ldg(mask + j)) != 0;
        }
        int64_t pj = j;
        if (ok && positions != nullptr) {
          pj = full && vec_pos ? qv[k] : __ldg(positions + j);
        }
        pj = pj < 0 ? 0 : (pj > n_packed - 1 ? n_packed - 1 : pj);
        p[row][k] = pj;
        live[row][k] = ok;
      }
    }
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        x[row][k] = live[row][k]
                        ? static_cast<uint32_t>(__ldg(offsets + p[row][k] + 1)) -
                              static_cast<uint32_t>(__ldg(offsets + p[row][k]))
                        : 0u;
      }
    }
    // each slot's exclusive prefix inside the warp, then the tile's sum
    uint32_t carry = 0;
#pragma unroll
    for (int row = 0; row < kRows; ++row) {
      uint32_t s = 0;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        const uint32_t y = x[row][k];
        x[row][k] = s;
        s += y;
      }
      uint32_t inc = s;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t y = __shfl_up_sync(kFull, inc, o);
        if (lane >= o) inc += y;
      }
      const uint32_t lane_ex = carry + inc - s;
#pragma unroll
      for (int k = 0; k < kVec; ++k) x[row][k] += lane_ex;
      carry += __shfl_sync(kFull, inc, 31);
    }
    if (lane == 0) s_warp[warp] = carry;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t y = s_warp[w];
      if (w < warp) warp_ex += y;
      tile_sum += y;
    }
    if (threadIdx.x == 0) {
      tpq::store_word(words + t,
                      (t == 0 ? tpq::kPrefix : tpq::kAggregate) | tile_sum);
    }
  }

  // the block's share of the data row, while its predecessors publish
  const int64_t c0 = t * per_block;
  const int64_t c1 = c0 + per_block < n_chunks ? c0 + per_block : n_chunks;
  copy_chunks(data, nb, out_data, head, shift, c0, c1);
  if (t == 0) {  // the bytes before the first chunk and after the last
    const int64_t tail = head + 16 * n_chunks;
    for (int64_t k = threadIdx.x; k < head + (B - tail); k += kThreads) {
      const int64_t b = k < head ? k : tail + (k - head);
      out_data[b] = b < nb ? __ldg(data + b) : static_cast<uint8_t>(0);
    }
  }
  if (!scan) return;

  if (warp == 0 && t > 0) {
    const uint32_t prefix = tpq::look_back(words, t, lane);
    if (lane == 0) {
      s_prefix = prefix;
      tpq::store_word(words + t, tpq::kPrefix | (prefix + tile_sum));
    }
  }
  __syncthreads();
  const uint32_t off = (t > 0 ? s_prefix : 0u) + warp_ex;
#pragma unroll
  for (int row = 0; row < kRows; ++row) {
    const int64_t j0 = v0 + row * kRow - a;
    const uint4 v = make_uint4(off + x[row][0], off + x[row][1],
                               off + x[row][2], off + x[row][3]);
    if (j0 >= 0 && j0 + kVec <= L) {
      *reinterpret_cast<uint4*>(out_offs + j0) = v;
    } else {
      const uint32_t vv[kVec] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        if (j0 + k >= 0 && j0 + k < L) out_offs[j0 + k] = vv[k];
      }
    }
  }
}

}  // namespace

// n slots over n_packed values; L >= n + 1 and B >= n_bytes.  `tile` must
// be 2,048 (gather.densify_tile_slots).  `scratch` is 16-byte aligned and
// holds 16 bytes for the ticket counter, then one 8-byte word a tile of
// ceil((L + 3) / tile); the ones this call uses are zeroed here.
extern "C" int tpq_byte_densify(const void* offsets, int64_t n_packed,
                                const void* mask, const void* positions,
                                int64_t n, int tile, void* scratch,
                                void* out_offs, int64_t L, const void* data,
                                int64_t n_bytes, void* out_data, int64_t B,
                                void* stream) {
  if (tile != kTile) return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto oo = reinterpret_cast<uintptr_t>(out_offs);
  const int a = static_cast<int>((oo >> 2) & 3);
  const int64_t n_scan = (L + a + kTile - 1) / kTile;
  const cudaError_t rc = cudaMemsetAsync(scratch, 0, 16 + 8 * n_scan, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const auto od = reinterpret_cast<uintptr_t>(out_data);
  int64_t head = static_cast<int64_t>((16 - (od & 15)) & 15);
  head = head < B ? head : B;
  const int64_t n_chunks = (B - head) / 16;
  int64_t blocks = (n_chunks + kCopyChunks - 1) / kCopyChunks;
  blocks = blocks > n_scan ? blocks : n_scan;
  const int64_t per_block = (n_chunks + blocks - 1) / blocks;
  const auto dp = reinterpret_cast<uintptr_t>(data);
  const auto mp = reinterpret_cast<uintptr_t>(mask);
  const auto pp = reinterpret_cast<uintptr_t>(positions);
  auto* counter = static_cast<uint32_t*>(scratch);
  densify_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int32_t*>(offsets), n_packed,
      static_cast<const uint8_t*>(mask),
      static_cast<const int32_t*>(positions), n, a,
      ((mp - a) & 3) == 0, (((pp >> 2) - a) & 3) == 0 && (pp & 3) == 0,
      n_scan, counter, reinterpret_cast<u64*>(counter + 4),
      static_cast<uint32_t*>(out_offs), L,
      static_cast<const uint8_t*>(data), n_bytes,
      static_cast<uint8_t*>(out_data), B, head,
      static_cast<uint32_t>((dp + head) & 15), n_chunks, per_block);
  return static_cast<int>(cudaGetLastError());
}
