// K8: snappy copy resolution on the device (sm_90a).
//
// Replaces tpuparquet/kernels/snappy.py expand_tokens (XLA-jitted) and the
// byte-to-word pass after it, decode.py u8_to_u32_words(_at).  The host
// scans a block's tags into a token table (compress.py snappy_scan_tokens,
// padded by kernels/snappy.py plan_tokens): te[t] is token t's output
// end, ts[t] its source, -(literal offset + 1) for a literal or the output
// position a copy reads from.  Padding tokens carry te = out_cap and
// ts = -1, so no output byte below out_cap ever selects one.
//
//   launch 1 (map):   per output byte i, t = upper_bound(te, i) clamped to
//                     T - 1, within = i - (t ? te[t-1] : 0), and
//                     m[i] = ts[t] < 0 ? ts[t] - within : ts[t] + within
//                     (negative: resolved to a literal byte; otherwise an
//                     earlier output byte, a link of a copy chain)
//   launches 2..:     `steps` rounds of pointer doubling,
//                     m'[i] = m[i] >= 0 ? m[clip(m[i], 0, out_cap - 1)]
//                                       : m[i],
//                     ping-ponging two buffers (a round in place would
//                     race: a thread could read a link another thread
//                     already advanced, so chains would resolve in an
//                     order-dependent number of rounds)
//   last launch:      gather lits[clip(-(m + 1), 0, L - 1)], either as the
//                     u8 blob or as little-endian u32 words read from byte
//                     offset `off` (any offset: the values of a V1 page
//                     follow its level bytes)
// int32 arithmetic wraps as the reference's does (out_cap < 2^31).
//
// Bound on the H100: memory.  Each output byte is written once; the map
// and every round read and write one int32 per byte, so the kernel moves
// about (8 * steps + 9) bytes per output byte where the function needs 1.
// Pointer doubling trades that traffic for parallelism over a copy graph
// that is sequential on the host.

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__global__ void map_kernel(const int32_t* __restrict__ te,
                           const int32_t* __restrict__ ts, int n_tok,
                           int32_t out_cap, int32_t* __restrict__ m) {
  const int32_t i = static_cast<int32_t>(blockIdx.x * blockDim.x +
                                         threadIdx.x);
  if (i >= out_cap) return;
  int lo = 0, hi = n_tok;  // first token whose end is > i
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(te + mid) <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  const int t = lo < n_tok - 1 ? lo : n_tok - 1;
  const int32_t start = t > 0 ? __ldg(te + t - 1) : 0;
  const int32_t within = wrap_add(i, -start);
  const int32_t src = __ldg(ts + t);
  m[i] = src < 0 ? wrap_add(src, -within) : wrap_add(src, within);
}

__global__ void round_kernel(const int32_t* __restrict__ m, int32_t out_cap,
                             int32_t* __restrict__ m_next) {
  const int32_t i = static_cast<int32_t>(blockIdx.x * blockDim.x +
                                         threadIdx.x);
  if (i >= out_cap) return;
  const int32_t mm = m[i];
  if (mm >= 0) {
    const int32_t j = mm < out_cap ? mm : out_cap - 1;
    m_next[i] = m[j];
  } else {
    m_next[i] = mm;
  }
}

__device__ __forceinline__ uint32_t lit_byte(const uint8_t* __restrict__ lits,
                                             int64_t n_lits, int32_t m) {
  int64_t k = -(static_cast<int64_t>(m) + 1);
  k = k < 0 ? 0 : (k > n_lits - 1 ? n_lits - 1 : k);
  return __ldg(lits + k);
}

__global__ void blob_kernel(const int32_t* __restrict__ m,
                            const uint8_t* __restrict__ lits, int64_t n_lits,
                            int32_t out_cap, uint8_t* __restrict__ out) {
  const int32_t i = static_cast<int32_t>(blockIdx.x * blockDim.x +
                                         threadIdx.x);
  if (i < out_cap) out[i] = static_cast<uint8_t>(lit_byte(lits, n_lits, m[i]));
}

__global__ void words_kernel(const int32_t* __restrict__ m,
                             const uint8_t* __restrict__ lits, int64_t n_lits,
                             int64_t off, int64_t n_words,
                             uint32_t* __restrict__ out) {
  const int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (k >= n_words) return;
  const int32_t* mk = m + off + 4 * k;
  out[k] = lit_byte(lits, n_lits, mk[0]) |
           (lit_byte(lits, n_lits, mk[1]) << 8) |
           (lit_byte(lits, n_lits, mk[2]) << 16) |
           (lit_byte(lits, n_lits, mk[3]) << 24);
}

}  // namespace

// te/ts: n_tok int32 (n_tok >= 1); lits: n_lits bytes (n_lits >= 1);
// m0/m1: caller-allocated scratch of out_cap int32 each.  n_words < 0
// writes the (out_cap,) u8 blob to `out`; otherwise n_words u32 words
// from byte `off` (off + 4 * n_words <= out_cap).
extern "C" int tpq_snappy_expand(const void* te, const void* ts, int n_tok,
                                 const void* lits, int64_t n_lits,
                                 int32_t out_cap, int steps, void* m0,
                                 void* m1, int64_t off, int64_t n_words,
                                 void* out, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  auto* a = static_cast<int32_t*>(m0);
  auto* b = static_cast<int32_t*>(m1);
  const auto* l = static_cast<const uint8_t*>(lits);
  if (out_cap > 0) {
    const unsigned nb = tpq::grid_for(out_cap, kThreads);
    map_kernel<<<nb, kThreads, 0, s>>>(static_cast<const int32_t*>(te),
                                       static_cast<const int32_t*>(ts), n_tok,
                                       out_cap, a);
    for (int r = 0; r < steps; ++r) {
      round_kernel<<<nb, kThreads, 0, s>>>(a, out_cap, b);
      int32_t* tmp = a;
      a = b;
      b = tmp;
    }
    if (n_words < 0) {
      blob_kernel<<<nb, kThreads, 0, s>>>(a, l, n_lits, out_cap,
                                          static_cast<uint8_t*>(out));
    } else if (n_words > 0) {
      words_kernel<<<tpq::grid_for(n_words, kThreads), kThreads, 0, s>>>(
          a, l, n_lits, off, n_words, static_cast<uint32_t*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
