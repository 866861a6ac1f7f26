// K9: dictionary page decode, BYTE_ARRAY values (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py page_dict_bytes_tbl and
// dict_gather_bytes (XLA-jitted).  For one page of `icnt` index slots, of
// which the first `non_null` are values:
//   1. idx[i] = clip(int32(index i), 0, max(n_dict - 1, 0)), the index
//      unpacked from one bit-packed run of width iw (width 0: all 0; a
//      run-table stream arrives expanded by K2, as a run of width 32);
//   2. out_offsets = [0, inclusive scan of (i < non_null ? len[idx[i]] : 0)]
//      with len = the diffs of the staged (padded) dictionary offsets;
//   3. for every output byte b < cap: v = min(#{out_offsets[1..] <= b},
//      icnt - 1), src = clip(dict_offsets[idx[v]] + b - out_offsets[v], 0,
//      dict_size - 1), out[b] = dict_data[src] (zeros for an empty
//      dictionary blob).
// All sums are int32 and wrap as the reference's int32 cumsum does (they
// are taken in uint32 here, where wrapping is defined).  The bytes past
// the values' end are what those clamps give, as in the reference: every
// b >= out_offsets[icnt] takes v = icnt - 1, a null slot past non_null
// included, whose unpacked index still picks the source.
//
// Precondition: the selected lengths are >= 0 and their sum is < 2^31
// (true for a dictionary as the planner stages it: an index past the
// real entries clamps onto zero padding of length 0), so the output
// offsets rise.  Then the values of a block own one contiguous output
// range, and a per-block search finds what the reference's global search
// finds.
//
// Two launches, 4096 values a block:
//   sums:  each block unpacks its indices, gathers their lengths and
//          writes their sum;
//   copy:  each block adds up the sums before it (and all of them: the
//          values' end), unpacks its indices again (w bits a value, read
//          from the packed stream, not a scratch array), scans their
//          lengths into its output offsets and keeps them with the
//          values' dictionary starts in shared memory.  Its threads then
//          stride over the block's output range 16 bytes at a time (one
//          uint4 store): one search over the block's offsets (12 probes
//          in shared memory) finds a unit's first value, the next follow
//          by stepping, and a word that lies in one value or straddles
//          the end of one is one or two 4-byte reads of the dictionary
//          (L2-resident; two aligned loads and a funnel shift each), not
//          four byte reads behind a divergent branch.  A value longer
//          than the block's share is fine: the threads split it; empty
//          values own no bytes.  The bytes past the values' end (the
//          bucket's tail) are split evenly over all blocks.
//
// Bound on the H100: memory.  The function reads the packed indices, the
// dictionary (small; it stays in L2) and writes cap bytes, about 10 a
// value for config 4's vendor column.  This design reads the packed
// indices twice (iw / 8 bytes a value each time) and the block sums once
// per block; the reference's design (one thread per output byte, a
// 21-probe search of out_offsets in L2) kept idx and out_offsets in
// device memory between four launches.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;
constexpr int kPer = 4;                      // values a thread owns
constexpr int kValues = kThreads * kPer;     // values a block owns

__device__ __forceinline__ int32_t index_at(const uint32_t* words, int iw,
                                            int64_t i, int64_t n_dict) {
  const int32_t v =
      static_cast<int32_t>(iw > 0 ? tpq::unpack_lane(words, i, iw) : 0u);
  const int64_t hi = n_dict - 1 > 0 ? n_dict - 1 : 0;
  return v < 0 ? 0 : (v > hi ? static_cast<int32_t>(hi) : v);
}

__device__ __forceinline__ uint32_t value_len(const int32_t* doffs,
                                              int32_t k) {
  return static_cast<uint32_t>(__ldg(doffs + k + 1)) -
         static_cast<uint32_t>(__ldg(doffs + k));
}

// Sum of x over the block, returned to every thread.
__device__ __forceinline__ uint32_t block_total(uint32_t x, uint32_t* sm) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  if (lane == 0) sm[wid] = x;
  __syncthreads();
  uint32_t s = lane < static_cast<int>(blockDim.x >> 5) ? sm[lane] : 0u;
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  __syncthreads();  // sm may be reused
  return s;
}

// The values whose bytes a range holds: offs[v] .. offs[v + 1] is value
// v's output range and starts[v] its first dictionary byte.
struct Values {
  const int32_t* offs;
  const int32_t* starts;
  int nv;
  const uint8_t* ddata;
  int64_t dsize;

  // the first value from v on whose end is past b (the reference's search)
  __device__ __forceinline__ int find(int v, int32_t b) const {
    int hi = nv - 1;
    while (v < hi) {
      const int mid = (v + hi) >> 1;
      if (offs[mid + 1] <= b) {
        v = mid + 1;
      } else {
        hi = mid;
      }
    }
    return v;
  }

  __device__ __forceinline__ void step(int& v, int32_t b) const {
    while (v < nv - 1 && offs[v + 1] <= b) ++v;
  }

  // the dictionary byte of output byte b in value v, before the clamp
  __device__ __forceinline__ int32_t source(int v, int32_t b) const {
    const uint32_t within = static_cast<uint32_t>(b) -
                            static_cast<uint32_t>(offs[v]);
    return static_cast<int32_t>(static_cast<uint32_t>(starts[v]) + within);
  }

  // output byte b, v stepped to its value; clamped as the reference
  // clamps it
  __device__ __forceinline__ uint32_t byte(int& v, int32_t b) const {
    step(v, b);
    if (dsize == 0) return 0u;
    const int32_t src = source(v, b);
    return __ldg(ddata + (src < 0 ? 0 : (src >= dsize ? dsize - 1 : src)));
  }

  // dictionary bytes src .. src + 3 as a little-endian word (all four in
  // the dictionary): two aligned words and a funnel shift (each aligned
  // word holds one of the four bytes, so neither reads outside the
  // dictionary's allocation)
  __device__ __forceinline__ uint32_t read4(int32_t src) const {
    const auto a = reinterpret_cast<uintptr_t>(ddata + src);
    const auto* wp = reinterpret_cast<const uint32_t*>(a & ~uintptr_t{3});
    const uint32_t sh = static_cast<uint32_t>(a & 3) * 8;
    return __funnelshift_r(__ldg(wp), sh ? __ldg(wp + 1) : 0u, sh);
  }

  // output bytes b .. b + 3 as a little-endian word, v stepped to the
  // value of the last.  The bytes of one value, or of two (the word
  // straddles one value's end), come as one or two dictionary words;
  // a word that needs a clamp or spans three values goes byte by byte.
  __device__ __forceinline__ uint32_t word(int& v, int32_t b) const {
    step(v, b);
    const int32_t src = source(v, b);
    if (dsize >= 4 && src >= 0 && src <= dsize - 4) {
      // the last value runs on past its end: the reference's clamp
      const int32_t e = v == nv - 1 ? INT32_MAX : offs[v + 1];
      if (e - b >= 4) return read4(src);
      const int n = e - b;  // 1 to 3 bytes from v, the rest from the next
      int u = v;
      step(u, e);
      const int32_t e2 = u == nv - 1 ? INT32_MAX : offs[u + 1];
      const int32_t src2 = source(u, e);
      if (e2 - b >= 4 && src2 >= 0 && src2 <= dsize - 4) {
        v = u;
        return (read4(src) & ((1u << (8 * n)) - 1)) |
               (read4(src2) << (8 * n));
      }
    }
    uint32_t x = 0;
    for (int c = 0; c < 4; ++c) x |= byte(v, b + c) << (8 * c);
    return x;
  }
};

// Write out[lo, hi): whole 16-byte units by the block's threads (one
// search finds a unit's first value, the next follow by stepping), the
// bytes outside them by its first 32 threads.
__device__ __forceinline__ void write_range(uint8_t* out, int32_t lo,
                                            int32_t hi, const Values& vals) {
  if (lo >= hi) return;
  const int32_t u_lo = (lo + 15) >> 4, u_hi = hi >> 4;
  for (int32_t u = u_lo + threadIdx.x; u < u_hi; u += blockDim.x) {
    const int32_t b0 = u << 4;
    int v = vals.find(0, b0);
    uint32_t w[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = vals.word(v, b0 + 4 * q);
    reinterpret_cast<uint4*>(out)[u] = make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (threadIdx.x < 32) {
    const int t = threadIdx.x;
    int32_t p, lim;
    if (u_lo >= u_hi) {  // fewer than 32 bytes, no whole unit
      p = lo + t;
      lim = hi;
    } else if (t < 16) {
      p = lo + t;
      lim = u_lo << 4;
    } else {
      p = (u_hi << 4) + (t - 16);
      lim = hi;
    }
    if (p < lim) {
      int v = vals.find(0, p);
      out[p] = static_cast<uint8_t>(vals.byte(v, p));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
sums_kernel(const int32_t* __restrict__ doffs, int64_t n_dict,
            const uint32_t* __restrict__ words, int iw, int64_t non_null,
            uint32_t* __restrict__ sums) {
  __shared__ uint32_t sm[32];
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kValues +
                     threadIdx.x * kPer;
  uint32_t s = 0;
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = v0 + j;
    if (i < non_null) s += value_len(doffs, index_at(words, iw, i, n_dict));
  }
  s = block_total(s, sm);
  if (threadIdx.x == 0) sums[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
copy_kernel(const int32_t* __restrict__ doffs, int64_t n_dict,
            const uint8_t* __restrict__ ddata, int64_t dsize,
            const uint32_t* __restrict__ words, int iw, int64_t non_null,
            int64_t icnt, const uint32_t* __restrict__ sums, int nb,
            uint8_t* __restrict__ out, int64_t cap) {
  __shared__ int32_t offs[kValues + 1];
  __shared__ int32_t starts[kValues];
  __shared__ uint32_t sm[32];
  __shared__ int32_t tail_offs[2];
  __shared__ int32_t tail_start;
  const int tid = threadIdx.x;

  // the sums before this block (its first output offset) and all of them
  uint32_t pre = 0, tot = 0;
  for (int b = tid; b < nb; b += kThreads) {
    const uint32_t x = __ldg(sums + b);
    tot += x;
    if (b < static_cast<int>(blockIdx.x)) pre += x;
  }
  pre = block_total(pre, sm);
  tot = block_total(tot, sm);

  // the block's values: dictionary starts and output offsets
  const int64_t v0 = static_cast<int64_t>(blockIdx.x) * kValues;
  const int nv = static_cast<int>(icnt - v0 < kValues ? icnt - v0 : kValues);
  uint32_t len[kPer];
  int32_t st[kPer];
  uint32_t s = 0;
  for (int j = 0; j < kPer; ++j) {
    const int lv = tid * kPer + j;
    const int64_t i = v0 + lv;
    len[j] = 0;
    st[j] = 0;
    if (i < non_null) {
      const int32_t k = index_at(words, iw, i, n_dict);
      st[j] = __ldg(doffs + k);
      len[j] = value_len(doffs, k);
    }
    s += len[j];
  }
  const uint32_t incl = tpq::block_inclusive_scan(s, sm);
  uint32_t run = pre + incl - s;
  if (tid == 0) offs[0] = static_cast<int32_t>(pre);
  for (int j = 0; j < kPer; ++j) {
    const int lv = tid * kPer + j;
    run += len[j];
    if (lv < nv) {
      offs[lv + 1] = static_cast<int32_t>(run);
      starts[lv] = st[j];
    }
  }
  if (tid == 0) {
    // slot icnt - 1 decides every byte past the values' end
    const int64_t last = icnt - 1;
    const int32_t k = index_at(words, iw, last, n_dict);
    const uint32_t own = last < non_null ? value_len(doffs, k) : 0u;
    tail_offs[0] = static_cast<int32_t>(tot - own);
    tail_offs[1] = static_cast<int32_t>(tot);
    tail_start = __ldg(doffs + k);
  }
  __syncthreads();

  const auto cap32 = static_cast<int32_t>(cap);
  const Values mine{offs, starts, nv, ddata, dsize};
  write_range(out, max(offs[0], 0), min(offs[nv], cap32), mine);

  // the tail [total, cap), an equal share a block
  const int32_t total = max(static_cast<int32_t>(tot), 0);
  if (total < cap32) {
    const int32_t share = (cap32 - total + nb - 1) / nb;
    const int64_t t_lo = total + static_cast<int64_t>(share) * blockIdx.x;
    if (t_lo < cap32) {
      const Values last{tail_offs, &tail_start, 1, ddata, dsize};
      write_range(out, static_cast<int32_t>(t_lo),
                  static_cast<int32_t>(t_lo + share < cap32 ? t_lo + share
                                                            : cap32),
                  last);
    }
  }
}

}  // namespace

// `block_sums` (ceil(icnt / 4096) int32) is caller-allocated scratch;
// iw == 0: every index is 0 (words unused, may be null).
extern "C" int tpq_dict_bytes(const void* dict_offsets, int64_t n_offsets,
                              const void* dict_data, int64_t dict_size,
                              const void* words, int iw, int64_t non_null,
                              int64_t icnt, void* block_sums, void* out,
                              int64_t cap, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* doffs = static_cast<const int32_t*>(dict_offsets);
  const auto* w = static_cast<const uint32_t*>(words);
  auto* sums = static_cast<uint32_t*>(block_sums);
  if (icnt > 0 && cap > 0) {
    const unsigned nb = tpq::grid_for(icnt, kValues);
    sums_kernel<<<nb, kThreads, 0, s>>>(doffs, n_offsets - 1, w, iw,
                                        non_null, sums);
    copy_kernel<<<nb, kThreads, 0, s>>>(
        doffs, n_offsets - 1, static_cast<const uint8_t*>(dict_data),
        dict_size, w, iw, non_null, icnt, sums, static_cast<int>(nb),
        static_cast<uint8_t*>(out), cap);
  }
  return static_cast<int>(cudaGetLastError());
}
