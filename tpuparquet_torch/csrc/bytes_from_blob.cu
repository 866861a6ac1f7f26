// K10: PLAIN BYTE_ARRAY values out of a device-resident page blob (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py plain_bytes_from_blob (XLA-jitted).
// The blob is K8's expansion of a snappy page (it never visits the host);
// PLAIN records there are (u32 length, bytes), so value v's bytes start at
// blob byte pos + out_offsets[v] + 4 * (v + 1): pos skips a V1 page's level
// bytes, and 4 * (v + 1) the length prefixes up to and including v's own.
// For every output byte b < total:
//   v   = min(#{out_offsets[1..n-1] <= b}, n - 2)   (n = out_offsets length,
//         padded by the host with the values' byte count)
//   src = clip(pos + out_offsets[v] + 4 * (v + 1) + (b - out_offsets[v]),
//              0, blob_size - 1)
// in int32 arithmetic (taken in uint32 here, where wrapping is defined), as
// the reference computes it; an empty blob gives zeros.  out_offsets[v]
// cancels, so src = b + d(v) with d(v) = pos + 4 * (v + 1): the output is
// the blob shifted by d, and d steps by 4 at each value's end (by 4 times
// the run past a run of empty values, which no byte selects).
//
// Bound on the H100: memory.  The function reads the values' bytes out of
// the blob and the offsets, and writes `total` bytes.  The parent ran one
// thread per output byte with a binary search over the whole offsets
// array (about 19 levels of L2 loads for the url page) before loading one
// byte: it was bound by those loads, at 3% of the bound.  Here a block
// takes a tile of output bytes (the wrapper's tile, decode.blob_tile_bytes)
// and reads each input once, all of a tile's loads in flight together:
//   1. warps 0 and 1 find the tile's first and last value with a 32-way
//      search over the offsets (five rounds of one warp load for 2^21
//      values);
//   2. in one round of loads (each thread's loads all in flight before it
//      stores any), the block copies the ends of the values that meet the
//      tile (up to tile / 4 of them) and the blob span their bytes come
//      from (at most twice the tile, as 16-byte vectors) into shared
//      memory;
//   3. each thread builds 16-byte output chunks from shared memory: it
//      bisects the staged ends for the chunk's first value, then takes two
//      aligned vectors, funnel-shifted by the source's offset mod 16, for
//      each value the chunk meets (one, or two across a value's end,
//      merged by a byte mask), and stores one 16-byte vector.
// What does not fit that shape goes byte by byte from device memory,
// stepping to the next value with a galloping search: chunks that meet
// three or more values, bytes whose source the clip moves (a chunk that
// clips whole is its last byte 16 times), the last partial chunk, and
// tiles with more ends than shared memory holds (runs of empty or very
// short values; a chunk inside one value there is still one copy).  One
// launch a call, no memset, no scratch.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxTile = 16384;  // bytes

constexpr int kStageUnroll = 4;  // span vectors a thread loads at once

// Shared memory of a tile of T bytes: the blob span (2T + 32 bytes) and
// the ends (T / 4 words).
__host__ __device__ constexpr int smem_bytes(int tile) {
  return 2 * tile + 32 + tile;
}

// #{e[j] <= x : 0 <= j < m} for sorted e, by a 32-way search in which each
// lane probes one position a round; every lane of the warp calls it and
// gets the answer.
__device__ int64_t warp_upper_bound(const int32_t* __restrict__ e,
                                    int64_t m, int32_t x) {
  const int lane = threadIdx.x & 31;
  int64_t lo = 0, hi = m;  // the answer lies in [lo, hi]
  while (hi - lo > 32) {
    const int64_t step = (hi - lo + 31) / 32;
    const int64_t p = lo + lane * step;
    const int c = __popc(__ballot_sync(0xffffffffu,
                                       p < hi && __ldg(e + p) <= x));
    if (c == 0) return lo;
    lo += (c - 1) * step + 1;
    hi = lo - 1 + step < hi ? lo - 1 + step : hi;
  }
  const int64_t p = lo + lane;
  return lo + __popc(__ballot_sync(0xffffffffu,
                                   p < hi && __ldg(e + p) <= x));
}

// One output byte at source b + d, clipped into the blob.
__device__ __forceinline__ uint32_t byte_at(const uint8_t* __restrict__ blob,
                                            int64_t blob_size, uint32_t b,
                                            uint32_t d) {
  const int64_t s = static_cast<int32_t>(b + d);
  return __ldg(blob + (s < 0 ? 0 : (s >= blob_size ? blob_size - 1 : s)));
}

// Whether `len` bytes from source b + d are in the blob unclipped (and
// their int32 sources do not wrap).
__device__ __forceinline__ bool unclipped(int64_t blob_size, uint32_t b,
                                          uint32_t d, int len) {
  const int64_t s = static_cast<int32_t>(b + d);
  return s >= 0 && s + len <= blob_size && s + len - 1 <= INT32_MAX;
}

using tpq::merge;
using tpq::select16;

// 16 bytes from byte o of the staged span (whose vectors hold o + 15).
__device__ __forceinline__ uint4 span16(const uint4* span, int o) {
  const uint4 x = span[o >> 4];
  const uint4 y = (o & 15) ? span[(o >> 4) + 1] : x;
  return select16(x, y, static_cast<uint32_t>(o & 15));
}

// #{S[j] <= b : 0 <= j < k}, by bisection.
__device__ __forceinline__ int64_t upper_bound(const int32_t* S, int64_t k,
                                               int64_t b) {
  int64_t lo = 0, hi = k;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (S[mid] <= b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// #{S[j] <= b} for j >= from, knowing S[from - 1] <= b: gallop, then
// bisect (one load when the next end lies past b).
__device__ __forceinline__ int64_t gallop(const int32_t* S, int64_t k,
                                          int64_t from, int64_t b) {
  int64_t lo = from, hi = from, step = 1;
  while (hi < k && S[hi] <= b) {
    lo = hi + 1;
    hi += step;
    step <<= 1;
  }
  if (hi > k) hi = k;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (S[mid] <= b) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads, 6)
bytes_from_blob_kernel(const uint8_t* __restrict__ blob, int64_t blob_size,
                       const int32_t* __restrict__ offs, int64_t n_offs,
                       uint32_t pos, uint8_t* __restrict__ out,
                       int64_t total, int tile) {
  extern __shared__ uint4 s_mem[];
  uint4* s_span = s_mem;  // 2 * tile + 32 bytes
  int32_t* s_ends = reinterpret_cast<int32_t*>(s_mem + (2 * tile + 32) / 16);
  __shared__ int64_t s_v[2];
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile;
  const int64_t t1 = t0 + tile < total ? t0 + tile : total;
  const int n_chunks = static_cast<int>((t1 - t0 + 15) >> 4);
  if (blob_size == 0) {
    for (int q = threadIdx.x; q < n_chunks; q += kThreads) {
      const int64_t c = t0 + 16 * static_cast<int64_t>(q);
      if (c + 16 <= t1) {
        *reinterpret_cast<uint4*>(out + c) = make_uint4(0, 0, 0, 0);
      } else {
        for (int64_t b = c; b < t1; ++b) out[b] = 0;
      }
    }
    return;
  }
  const int32_t* ends = offs + 1;  // ends[v] = out_offsets[v + 1]
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int64_t x = warp == 0 ? t0 : t1 - 1;
    int64_t v = warp_upper_bound(ends, n_offs - 1, static_cast<int32_t>(x));
    if (v > n_offs - 2) v = n_offs - 2;
    if ((threadIdx.x & 31) == 0) s_v[warp] = v;
  }
  __syncthreads();
  // Inside the tile, v(b) = v_lo + #{S[j] <= b : j < k} with S = the ends
  // from v_lo on: every earlier end lies at or before t0, and S[k] (if v_hi
  // was not clamped) past t1 - 1.
  const int64_t v_lo = s_v[0];
  const int64_t k = s_v[1] - v_lo;
  const bool staged = k <= tile / 4;
  const int32_t* S = staged ? s_ends : ends + v_lo;
  // The tile's sources run from t0 + d(v_lo) to t1 - 1 + d(v_hi), at most
  // tile + 4k bytes; stage them when no clip or int32 wrap touches them.
  const int64_t src_lo = t0 + pos + 4 * (v_lo + 1);
  const int64_t src_hi = t1 - 1 + pos + 4 * (v_lo + k + 1);
  const bool in_span = staged && src_hi < blob_size && src_hi <= INT32_MAX;
  // the span's first vector: the aligned one holding blob byte src_lo
  const int64_t span0 =
      static_cast<int64_t>(
          (reinterpret_cast<uintptr_t>(blob + src_lo) & ~uintptr_t{15}) -
          reinterpret_cast<uintptr_t>(blob));
  // one round of loads: a thread's first end and first kStageUnroll span
  // vectors are all in flight before it stores any
  int32_t e0 = 0;
  if (staged && threadIdx.x < k) e0 = __ldg(ends + v_lo + threadIdx.x);
  if (in_span) {
    const uint4* g = reinterpret_cast<const uint4*>(blob + span0);
    const int n_vec = static_cast<int>((src_hi - span0) >> 4) + 1;
    for (int i0 = threadIdx.x; i0 < n_vec; i0 += kThreads * kStageUnroll) {
      uint4 r[kStageUnroll];
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        if (i0 + u * kThreads < n_vec) r[u] = __ldg(g + i0 + u * kThreads);
      }
#pragma unroll
      for (int u = 0; u < kStageUnroll; ++u) {
        if (i0 + u * kThreads < n_vec) s_span[i0 + u * kThreads] = r[u];
      }
    }
  }
  if (staged) {
    if (threadIdx.x < k) s_ends[threadIdx.x] = e0;
    for (int j = threadIdx.x + kThreads; j < k; j += kThreads) {
      s_ends[j] = __ldg(ends + v_lo + j);
    }
  }
  __syncthreads();
  constexpr int64_t kNone = INT64_MAX;
  for (int q = threadIdx.x; q < n_chunks; q += kThreads) {
    const int64_t c = t0 + 16 * static_cast<int64_t>(q);
    const int len = t1 - c < 16 ? static_cast<int>(t1 - c) : 16;
    int64_t j = upper_bound(S, k, c);
    int64_t next = j < k ? S[j] : kNone;  // the current value's end
    uint32_t d = pos + 4u * static_cast<uint32_t>(v_lo + j + 1);
    if (len == 16 && in_span) {
      // the chunk's first value, and the next one if its end lies inside
      const uint4 a = span16(s_span, static_cast<int>(c + d - span0));
      if (c + 16 <= next) {
        *reinterpret_cast<uint4*>(out + c) = a;
        continue;
      }
      const int64_t j1 = gallop(S, k, j + 1, next);
      if ((j1 < k ? S[j1] : kNone) >= c + 16) {
        const uint32_t d1 = pos + 4u * static_cast<uint32_t>(v_lo + j1 + 1);
        const uint4 b = span16(s_span, static_cast<int>(c + d1 - span0));
        const int r = static_cast<int>(next - c);  // a's bytes, 1..15
        *reinterpret_cast<uint4*>(out + c) =
            make_uint4(merge(a.x, b.x, r), merge(a.y, b.y, r - 4),
                       merge(a.z, b.z, r - 8), merge(a.w, b.w, r - 12));
        continue;
      }
    } else if (len == 16 && c + 16 <= next &&
               static_cast<int32_t>(static_cast<uint32_t>(c) + d) >=
                   blob_size &&
               c + 15 + d <= INT32_MAX) {
      // every source clips to the blob's last byte
      const uint32_t x = __ldg(blob + blob_size - 1) * 0x01010101u;
      *reinterpret_cast<uint4*>(out + c) = make_uint4(x, x, x, x);
      continue;
    } else if (len == 16 && c + 16 <= next &&
               unclipped(blob_size, static_cast<uint32_t>(c), d, 16)) {
      const int64_t s = static_cast<int32_t>(static_cast<uint32_t>(c) + d);
      const uintptr_t at = reinterpret_cast<uintptr_t>(blob + s);
      const uint4* p = reinterpret_cast<const uint4*>(at & ~uintptr_t{15});
      const uint32_t o = static_cast<uint32_t>(at & 15);
      const uint4 x = __ldg(p);
      *reinterpret_cast<uint4*>(out + c) = select16(x, o ? __ldg(p + 1) : x,
                                                    o);
      continue;
    }
    // byte by byte: the clip, three or more values, the partial chunk
    uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
    for (int t = 0; t < 16; ++t) {
      const int64_t b = c + t;
      if (t < len) {
        if (b >= next) {
          j = gallop(S, k, j + 1, b);
          next = j < k ? S[j] : kNone;
          d = pos + 4u * static_cast<uint32_t>(v_lo + j + 1);
        }
        w[t >> 2] |= byte_at(blob, blob_size, static_cast<uint32_t>(b), d)
                     << (8 * (t & 3));
      }
    }
    if (len == 16) {
      *reinterpret_cast<uint4*>(out + c) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int t = 0; t < 16; ++t) {
        if (t < len) out[c + t] = static_cast<uint8_t>(w[t >> 2] >> (8 * (t & 3)));
      }
    }
  }
}

}  // namespace

// tile: output bytes a block takes, a multiple of 16 up to 16 KiB
// (decode.blob_tile_bytes); out must be 16-byte aligned.
extern "C" int tpq_bytes_from_blob(const void* blob, int64_t blob_size,
                                   const void* out_offsets, int64_t n_offs,
                                   int pos, void* out, int64_t total,
                                   int tile, void* stream) {
  if (tile <= 0 || tile > kMaxTile || tile % 16 ||
      n_offs < 2 || (reinterpret_cast<uintptr_t>(out) & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static const cudaError_t opted = cudaFuncSetAttribute(
      bytes_from_blob_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(kMaxTile));
  if (opted != cudaSuccess) return static_cast<int>(opted);
  if (total > 0) {
    bytes_from_blob_kernel<<<tpq::grid_for(total, tile), kThreads,
                             smem_bytes(tile),
                             static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(blob), blob_size,
        static_cast<const int32_t*>(out_offsets), n_offs,
        static_cast<uint32_t>(pos), static_cast<uint8_t*>(out), total, tile);
  }
  return static_cast<int>(cudaGetLastError());
}
