// K5: lane / byte-plane transport -> flat u32 lane words (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py planes_to_words and its run
// expansion _rle_expand (XLA-jitted).  The host ships each u32 lane of a
// PLAIN fixed-width page one of three ways (kernels/device.py
// _plan_plane_words):
//   raw32  lane j of a slab of raw words:   raw32[j * count + i]
//   rle32  a run table slice (start, n_runs) of int32 run ends and u32
//          values: the run of value i is the number of ends <= i
//          (searchsorted side="right"), clamped to n_runs - 1
//   bytes  four byte planes at shifts 0/8/16/24, each raw8 (a slab of
//          bytes) or rle8 (a run table slice with u8 values)
// The static spec of the reference (a tuple, one jit per spec) arrives
// here as a small descriptor passed by value with the launch.
//
// Bound on the H100: memory, the raw slabs read once and the words
// written once; the run tables are small.
//
// The parent gave each output word its own thread: a 64-bit division, a
// descriptor indexed by a lane known only at run time, both kinds of
// lane in every warp of a 2-lane page, and a binary search of the run
// ends in device memory for every word and every run plane.  Here a
// block owns a tile of 2,048 consecutive values for every lane:
// - The lane count is a template parameter (1-4), and each thread holds
//   2 rows of 4 consecutive values (the rows 1,024 values apart) and
//   loops over the lanes itself, so a lane's kind is uniform across the
//   block and its descriptor is read at a constant index.
// - A raw32 lane reads a row's 4 values as one 16-byte vector and a raw8
//   plane as one 4-byte word, issued first, so that they fly during the
//   searches; a slab that starts off the vector's boundary (count % 4 !=
//   0, or a buffer view) reads the two aligned vectors around the values
//   and shifts them into place.
// - For each run table the tile touches, two warps find the runs of the
//   tile's first and last values by 32-way searches (as KS2 does), and
//   the block stages the ends and values between them in shared memory.
//   A table that is one run over the tile gives a constant; otherwise
//   each thread bisects for its row's first value's run and walks
//   forward for the other three.  Tables whose runs do not fit the
//   shared pool are bisected and walked in device memory, in the same
//   range.
// - A bytes lane keeps each plane as one word of the 4 values' bytes and
//   turns the 4 planes into the 4 values' words by a 4 x 4 byte transpose
//   (8 byte permutes).
// - A thread's 4 values x lanes words are contiguous in the output; a
//   warp passes its row's words through shared memory so that each store
//   instruction writes 512 contiguous bytes (16 bytes a thread).  Rows
//   that end past the count store a thread's words directly, and the last
//   values word by word.
// One launch a call; nothing to zero first.

#include "common.cuh"

namespace {

constexpr int kMaxLanes = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                      // values a thread holds a row
constexpr int kRows = 2;                     // rows a thread holds
constexpr int kRowValues = kThreads * kVec;  // 1,024 values a block's row
constexpr int kTile = kRowValues * kRows;    // 2,048 values a block
constexpr int kTables = 4 * kMaxLanes;       // run tables a tile can touch
constexpr int kPool = 2048;                  // run entries staged a tile
enum Kind { kRaw32 = 0, kRle32 = 1, kBytes = 2, kRaw8 = 3, kRle8 = 4 };

// One lane: kind with its (a, b) = (slab, 0) or (start, n_runs); for
// kBytes, four sub-entries (kRaw8 or kRle8) in the same form.
struct Lane {
  int32_t kind, a, b;
  int32_t sub_kind[4], sub_a[4], sub_b[4];
};

struct Spec {
  Lane lane[kMaxLanes];
};

// The values of the runs of i0 .. i0 + 3 (each clamped to `last`, the
// tile's last value) from runs [0, nr) of a table slice: `ends` and
// `vals` start at the tile's first run, whose range holds every run the
// tile meets.  Run k < nr - 1 ends before ends[k]; run nr - 1 takes the
// rest, as the clamp to n_runs - 1 does.
template <typename E, typename V>
__device__ __forceinline__ void runs4(const E* ends, const V* vals, int nr,
                                      int64_t i0, int64_t last,
                                      uint32_t (&out)[kVec]) {
  int lo = 0, hi = nr - 1;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(ends[mid]) <= i0) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  out[0] = vals[lo];
#pragma unroll
  for (int v = 1; v < kVec; ++v) {
    const int64_t i = i0 + v < last ? i0 + v : last;
    while (lo < nr - 1 && static_cast<int64_t>(ends[lo]) <= i) ++lo;
    out[v] = vals[lo];
  }
}

// Four consecutive u32 words from p (4-byte aligned), all in the buffer.
__device__ __forceinline__ uint4 load4_words(const uint32_t* p) {
  const uint32_t m = static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) &
                                           15);
  const auto* q = reinterpret_cast<const uint4*>(
      reinterpret_cast<uintptr_t>(p) - m);
  const uint4 x = __ldg(q);
  return m ? tpq::select16(x, __ldg(q + 1), m) : x;
}

// Four consecutive bytes from p (any alignment), all in the buffer, as
// one little-endian word.
__device__ __forceinline__ uint32_t load4_bytes(const uint8_t* p) {
  const uint32_t m =
      static_cast<uint32_t>(reinterpret_cast<uintptr_t>(p) & 3);
  const auto* q = reinterpret_cast<const uint32_t*>(
      reinterpret_cast<uintptr_t>(p) - m);
  const uint32_t x = __ldg(q);
  return m ? __funnelshift_r(x, __ldg(q + 1), 8 * m) : x;
}

struct Tables {
  const int32_t* e32;
  const uint32_t* v32;
  const int32_t* e8;
  const uint8_t* v8;
};

// Table q of the tile (lane q / 4; plane q % 4 of a bytes lane, 0 of an
// rle32 lane): whether it is a run table, and its slice.
__device__ __forceinline__ bool table_of(const Spec& spec, int q, int& start,
                                         int& n_runs, bool& wide) {
  const Lane& ln = spec.lane[q >> 2];
  const int t = q & 3;
  if (ln.kind == kRle32 && t == 0) {
    start = ln.a;
    n_runs = ln.b;
    wide = true;
    return true;
  }
  if (ln.kind == kBytes && ln.sub_kind[t] == kRle8) {
    start = ln.sub_a[t];
    n_runs = ln.sub_b[t];
    wide = false;
    return true;
  }
  return false;
}

// Runs a tile meets in a table, from its first and last value's runs (at
// least 1, should the ends be out of order).
__device__ __forceinline__ int runs_of(const int (&r)[2]) {
  return r[1] > r[0] ? r[1] - r[0] + 1 : 1;
}

template <int L>
__global__ void __launch_bounds__(kThreads)
    planes_kernel(const uint32_t* __restrict__ raw32, Tables tb,
                  const uint8_t* __restrict__ raw8, Spec spec, int64_t count,
                  uint32_t* __restrict__ out) {
  __shared__ int32_t s_end[kPool];
  __shared__ uint32_t s_val[kPool];
  __shared__ int s_run[kTables][2];
  __shared__ uint4 s_out[kWarps][32 * L];  // a warp's row of words
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t last = (t0 + kTile < count ? t0 + kTile : count) - 1;
  // the thread's first value a row: i0 + r * kRowValues
  const int64_t i0 = t0 + kVec * threadIdx.x;

  // the raw lanes' and planes' words first, so their loads fly during the
  // searches: a raw32 lane's 4 words, or a bytes lane's raw8 planes as
  // one word each (byte v of value i + v)
  uint32_t pre[L][4][kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t i = i0 + r * kRowValues;
    if (i > last) continue;
    const bool whole = i + kVec <= count;
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const Lane& ln = spec.lane[l];
      if (ln.kind == kRaw32) {
        const uint32_t* p = raw32 + static_cast<int64_t>(ln.a) * count + i;
        if (whole) {
          const uint4 v = load4_words(p);
          pre[l][0][r] = v.x;
          pre[l][1][r] = v.y;
          pre[l][2][r] = v.z;
          pre[l][3][r] = v.w;
        } else {
#pragma unroll
          for (int v = 0; v < kVec; ++v) {
            pre[l][v][r] = i + v <= last ? __ldg(p + v) : 0u;
          }
        }
      } else if (ln.kind == kBytes) {
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if (ln.sub_kind[t] != kRaw8) continue;
          const uint8_t* p =
              raw8 + static_cast<int64_t>(ln.sub_a[t]) * count + i;
          pre[l][t][r] =
              whole ? load4_bytes(p)
                    : (__ldg(p) | (i + 1 <= last ? __ldg(p + 1) << 8 : 0u) |
                       (i + 2 <= last ? __ldg(p + 2) << 16 : 0u));
        }
      }
    }
  }

  // the runs of the tile's first and last values in every run table:
  // search 2s and 2s + 1 of the s-th table go to warps 2s and 2s + 1
  // (mod kWarps)
  {
    int s = 0;
#pragma unroll
    for (int q = 0; q < 4 * L; ++q) {
      int start, n_runs;
      bool wide;
      if (!table_of(spec, q, start, n_runs, wide)) continue;
#pragma unroll
      for (int end = 0; end < 2; ++end) {
        if (warp == (2 * s + end) % kWarps) {
          const int32_t* e = (wide ? tb.e32 : tb.e8) + start;
          const int r =
              tpq::warp_upper_bound(e, n_runs, end ? last : t0, lane);
          if (lane == 0) s_run[q][end] = r < n_runs - 1 ? r : n_runs - 1;
        }
      }
      ++s;
    }
  }
  __syncthreads();
  // stage each table's runs of the tile, in table order, while they fit
  {
    int used = 0;
#pragma unroll
    for (int q = 0; q < 4 * L; ++q) {
      int start, n_runs;
      bool wide;
      if (!table_of(spec, q, start, n_runs, wide)) continue;
      const int rf = s_run[q][0];
      const int nr = runs_of(s_run[q]);
      if (used + nr > kPool) continue;
      for (int j = threadIdx.x; j < nr; j += kThreads) {
        const int64_t r = static_cast<int64_t>(start) + rf + j;
        s_end[used + j] = __ldg((wide ? tb.e32 : tb.e8) + r);
        s_val[used + j] = wide ? __ldg(tb.v32 + r)
                               : static_cast<uint32_t>(__ldg(tb.v8 + r));
      }
      used += nr;
    }
  }
  __syncthreads();

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int64_t i = i0 + r * kRowValues;
    // the warp's row of 128 values, all below count: its stores go
    // through shared memory, 512 contiguous bytes an instruction
    const int64_t row0 = i - kVec * lane;
    if (row0 > last) break;  // warp-uniform: so are the rows after it
    uint32_t w[L][kVec] = {};
    if (i <= last) {
      int used = 0;  // the pool's layout, as staged above
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const Lane& ln = spec.lane[l];
        if (ln.kind == kRaw32) {
#pragma unroll
          for (int v = 0; v < kVec; ++v) w[l][v] = pre[l][v][r];
          continue;
        }
        // plane t of the 4 values packed in x[t], byte v of value i + v's
        // (an rle32 lane: one plane of whole words, straight into w[l])
        uint32_t x[4] = {};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          const int q = 4 * l + t;
          int start, n_runs;
          bool wide;
          if (table_of(spec, q, start, n_runs, wide)) {
            const int rf = s_run[q][0];
            const int nr = runs_of(s_run[q]);
            uint32_t b[kVec];
            if (used + nr <= kPool) {
              if (nr == 1) {  // one run over the tile
                b[0] = b[1] = b[2] = b[3] = s_val[used];
              } else {
                runs4(s_end + used, s_val + used, nr, i, last, b);
              }
              used += nr;
            } else {  // not staged: the same range in device memory
              const int64_t k = static_cast<int64_t>(start) + rf;
              if (wide) {
                runs4(tb.e32 + k, tb.v32 + k, nr, i, last, b);
              } else {
                runs4(tb.e8 + k, tb.v8 + k, nr, i, last, b);
              }
            }
            if (wide) {
#pragma unroll
              for (int v = 0; v < kVec; ++v) w[l][v] = b[v];
            } else {
              x[t] = b[0] | b[1] << 8 | b[2] << 16 | b[3] << 24;
            }
          } else if (ln.kind == kBytes) {  // a raw8 plane
            x[t] = pre[l][t][r];
          }
        }
        if (ln.kind == kBytes) {  // a 4 x 4 byte transpose
          const uint32_t lo01 = __byte_perm(x[0], x[1], 0x5140);
          const uint32_t hi01 = __byte_perm(x[0], x[1], 0x7362);
          const uint32_t lo23 = __byte_perm(x[2], x[3], 0x5140);
          const uint32_t hi23 = __byte_perm(x[2], x[3], 0x7362);
          w[l][0] = __byte_perm(lo01, lo23, 0x5410);
          w[l][1] = __byte_perm(lo01, lo23, 0x7632);
          w[l][2] = __byte_perm(hi01, hi23, 0x5410);
          w[l][3] = __byte_perm(hi01, hi23, 0x7632);
        }
      }
    }
    // value i + v's lane l is word (i + v) * L + l: the thread's 4 * L
    // words are contiguous and start on a 16-byte boundary
    uint4 o[L];
#pragma unroll
    for (int s = 0; s < L; ++s) {
      uint32_t e[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = 4 * s + k;
        e[k] = w[x % L][x / L];
      }
      o[s] = make_uint4(e[0], e[1], e[2], e[3]);
    }
    if (row0 + 32 * kVec <= count) {
      uint4* row = reinterpret_cast<uint4*>(out + row0 * L);
#pragma unroll
      for (int s = 0; s < L; ++s) s_out[warp][lane * L + s] = o[s];
      __syncwarp();
#pragma unroll
      for (int s = 0; s < L; ++s) {
        row[32 * s + lane] = s_out[warp][32 * s + lane];
      }
      __syncwarp();
    } else if (i + kVec <= count) {
#pragma unroll
      for (int s = 0; s < L; ++s) {
        *reinterpret_cast<uint4*>(out + i * L + 4 * s) = o[s];
      }
    } else if (i <= last) {
#pragma unroll
      for (int v = 0; v < kVec; ++v) {
        if (i + v <= last) {
#pragma unroll
          for (int l = 0; l < L; ++l) out[(i + v) * L + l] = w[l][v];
        }
      }
    }
  }
}

}  // namespace

// `tile` must be 2,048 (decode.planes_tile_values).  `spec` is a host
// array of lanes * 15 int32: per lane kind, a, b, then
// sub_kind[4], sub_a[4], sub_b[4] (the kinds of the enum above).  It is
// copied into the launch's parameters, so it need only live for the call.
// Every slab and table slice lies in its buffer, and each table slice
// holds n_runs >= 1 non-decreasing ends (the wrapper checks the bounds).
extern "C" int tpq_planes_to_words(const void* raw32, const void* e32,
                                   const void* v32, const void* raw8,
                                   const void* e8, const void* v8,
                                   const int32_t* spec, int64_t count,
                                   int lanes, int tile, void* out,
                                   void* stream) {
  if (lanes < 1 || lanes > kMaxLanes ||
      tile != kTile ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0 ||
      (reinterpret_cast<uintptr_t>(raw32) & 3) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Spec s{};
  for (int l = 0; l < lanes; ++l) {
    const int32_t* e = spec + 15 * l;
    Lane& ln = s.lane[l];
    ln.kind = e[0];
    ln.a = e[1];
    ln.b = e[2];
    for (int t = 0; t < 4; ++t) {
      ln.sub_kind[t] = e[3 + t];
      ln.sub_a[t] = e[7 + t];
      ln.sub_b[t] = e[11 + t];
    }
  }
  if (count > 0) {
    const Tables tb{static_cast<const int32_t*>(e32),
                    static_cast<const uint32_t*>(v32),
                    static_cast<const int32_t*>(e8),
                    static_cast<const uint8_t*>(v8)};
    const auto* r32 = static_cast<const uint32_t*>(raw32);
    const auto* r8 = static_cast<const uint8_t*>(raw8);
    auto* o = static_cast<uint32_t*>(out);
    const unsigned grid = tpq::grid_for(count, kTile);
    const auto st = static_cast<cudaStream_t>(stream);
    switch (lanes) {
      case 1:
        planes_kernel<1><<<grid, kThreads, 0, st>>>(r32, tb, r8, s, count, o);
        break;
      case 2:
        planes_kernel<2><<<grid, kThreads, 0, st>>>(r32, tb, r8, s, count, o);
        break;
      case 3:
        planes_kernel<3><<<grid, kThreads, 0, st>>>(r32, tb, r8, s, count, o);
        break;
      default:
        planes_kernel<4><<<grid, kThreads, 0, st>>>(r32, tb, r8, s, count, o);
        break;
    }
  }
  return static_cast<int>(cudaGetLastError());
}
