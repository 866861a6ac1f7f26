// K8: snappy copy resolution on the device (sm_90a).
//
// Replaces tpuparquet/kernels/snappy.py expand_tokens (XLA-jitted) and the
// byte-to-word pass after it, decode.py u8_to_u32_words(_at).  The host
// scans a block's tags into a token table (compress.py snappy_scan_tokens,
// padded by kernels/snappy.py plan_tokens): te[t] is token t's output
// end, ts[t] its source, -(literal offset + 1) for a literal or the output
// position a copy reads from.  Padding tokens carry te = out_cap and
// ts = -1.  Output byte i belongs to token t = min(#{te <= i}, T - 1) and
// links to m = ts[t] < 0 ? ts[t] - within : ts[t] + within (within = i -
// te[t - 1]): negative, a literal byte; otherwise an earlier output byte.
// The reference doubles every link `steps` times (m = m[m]) and gathers
// lits[clip(-(m + 1), 0, L - 1)].
//
// Precondition: te is non-decreasing and every link points strictly
// before its byte (m < i).  The host scanner enforces it (csrc/snappy.c
// rejects a copy with offset 0 or past the output), DELTA_BYTE_ARRAY
// tables copy from the previous value, and the bytes past out_len keep
// it (a padding token is a literal; a clamped last copy token reads
// earlier bytes).  The links then form a forest rooted at literals, full
// resolution has one fixed point, and any order of link jumping that
// stops when no link is left reaches it.  `steps` rounds reach it too
// for every plan_tokens table (2^steps >= out_cap), so this kernel, which
// stops when the data says so, equals the reference bit for bit.  A link
// that breaks the precondition is resolved to literal byte 0 (no hang).
//
//   tile kernel:  a block owns a tile of 16 KiB of output positions.  Its
//                 threads search te together for the tokens of the
//                 tile's first and last byte (256 samples a round), walk
//                 the tile's tokens and mark where each starts in a
//                 shared-memory map; a max-scan gives every byte its
//                 token, and each byte's link is written there.  Links
//                 inside the tile are resolved in shared memory by
//                 pointer jumping while __syncthreads_or(any link still
//                 points into the tile).  A byte whose chain leaves the
//                 tile keeps its first outside position q: it is
//                 "unresolved" (a bit in `unres`, its q in lk[i]) and q
//                 is marked "needed".
//                 Every byte is written straight from the tile (u32
//                 words where whole), literal roots gathered from lits.
//   rounds:       one cooperative launch, grid-synchronised rounds over
//                 the positions both needed and unresolved (few: the
//                 targets of the tiles' outgoing chains).  A position
//                 whose target is resolved copies its byte; the others
//                 jump (lk[i] = lk[q]).  Round 0 scans the bitmasks, each
//                 later one only the words the one before left unresolved
//                 (a list with a device-side count), and the rounds stop
//                 when none is left: at most ceil(log2(tiles)) + 1, and
//                 as many as the data's chains across tiles need.
//   fix-up:       each unresolved position copies its target's byte, now
//                 final (every target is needed, so resolved).
// An output of one tile (every position resolves in it) skips the
// memset, the rounds and the fix-up: 1 launch, else 4.  int32 arithmetic
// wraps as the reference's does (out_cap < 2^31).
//
// Bound on the H100: memory.  The function reads the token tables and
// the literals once and writes each output byte once.  This design adds,
// per output byte, 1/8 byte of bitmask and, for each unresolved byte, a
// 4-byte link written and read back and one byte read from its target.
// Most snappy bytes resolve inside their tile (copies reach at most 64
// KiB back, and chains of repeated blocks are short); front-coded strings
// (DELTA_BYTE_ARRAY) leave every shared-prefix byte unresolved, so their
// bytes cost about 10 instead of 1.  The reference's design moved about
// 8 * steps + 9.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kPer = 32;                  // positions a thread owns
constexpr int kTile = kThreads * kPer;    // 16384 positions a block
constexpr int kHalf = kThreads / 2;
constexpr int kWindowWords = 2048;        // needed marks kept in shared
                                          // memory: 64 KiB before the tile
constexpr int kMaxJumps = 16;             // log2(kTile) + 1
constexpr int kMaxRounds = 32;
constexpr int kScanThreads = 256;
constexpr size_t kTileSmem =
    (static_cast<size_t>(kTile) + kWindowWords) * sizeof(int32_t);

__device__ __forceinline__ int32_t wrap_add(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

// Map slot of tile position k: thread t's 32 positions t*32..t*32+31 land
// on 32 different banks.
__device__ __forceinline__ int slot(int k) { return k ^ ((k >> 5) & 31); }

// Where output position q lives: a words call writes the block from byte
// `off` on, so the bytes before it (read as copy sources only) go to a
// small scratch `head`.  A blob call has off = 0.
struct Bytes {
  uint8_t* head;
  uint8_t* win;
  int32_t off;
  __device__ __forceinline__ uint8_t* at(int32_t q) const {
    return q < off ? head + q : win + (q - off);
  }
};

// lits index of a resolved link (a literal root), clamped as the
// reference clamps it
__device__ __forceinline__ int32_t lit_index(int32_t v, int64_t n_lits) {
  const int64_t q = -(static_cast<int64_t>(v) + 1);
  return static_cast<int32_t>(q > n_lits - 1 ? n_lits - 1 : q);
}

template <typename T>
__device__ __forceinline__ T load_volatile(const T* p) {
  return *reinterpret_cast<const volatile T*>(p);
}

// Exclusive max-scan over the block (every thread calls it).
__device__ __forceinline__ int block_exclusive_max(int x, int* sm) {
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int incl = x;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl = max(incl, y);
  }
  if (lane == 31) sm[wid] = incl;
  __syncthreads();
  if (wid == 0) {
    int s = lane < static_cast<int>(blockDim.x >> 5) ? sm[lane] : -1;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = max(s, y);
    }
    sm[lane] = s;
  }
  __syncthreads();
  int excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = -1;
  if (wid > 0) excl = max(excl, sm[wid - 1]);
  return excl;
}

__global__ void __launch_bounds__(kThreads, 3)
tile_kernel(const int32_t* __restrict__ te, const int32_t* __restrict__ ts,
            int n_tok, const uint8_t* __restrict__ lits, int64_t n_lits,
            int32_t end, Bytes out, int32_t* __restrict__ lk,
            uint32_t* __restrict__ unres, uint32_t* __restrict__ needed) {
  extern __shared__ int32_t smem[];
  int32_t* map = smem;
  uint32_t* window = reinterpret_cast<uint32_t*>(smem + kTile);
  __shared__ int tok[2];
  __shared__ int bracket[2][2];
  __shared__ int below[2];
  __shared__ int scan_sm[32];
  const int tid = threadIdx.x;
  const int32_t base = static_cast<int32_t>(blockIdx.x) * kTile;
  const int n_valid = min(kTile, end - base);

  // the tokens of the tile's first and last byte: the first token whose
  // end is past each, searched by the whole block, half of it a byte,
  // kHalf samples a round (n tokens take log_kHalf(n) rounds)
  if (tid < 2) {
    bracket[tid][0] = 0;
    bracket[tid][1] = n_tok;
  }
  for (int w = tid; w < kWindowWords; w += kThreads) window[w] = 0;
  __syncthreads();
  // (log_256(2^31) < 4: the bound only guards against a table that breaks
  // the precondition)
  for (int round = 0;
       round < 8 &&
       (bracket[0][0] < bracket[0][1] || bracket[1][0] < bracket[1][1]);
       ++round) {
    const int h = tid / kHalf;
    const int lo = bracket[h][0], hi = bracket[h][1];
    const int32_t p = h == 0 ? base : base + n_valid - 1;
    const int stride = (hi - lo + kHalf - 1) / kHalf;
    const int idx = lo + (tid % kHalf) * stride;
    if (tid < 2) below[tid] = 0;
    __syncthreads();
    const unsigned m =
        __ballot_sync(0xffffffffu, idx < hi && __ldg(te + idx) <= p);
    if ((tid & 31) == 0 && m) atomicAdd(&below[h], __popc(m));
    __syncthreads();
    if (tid < 2) {
      // te rises: the samples at or below p come first
      const int blo = bracket[tid][0], bhi = bracket[tid][1];
      const int bs = (bhi - blo + kHalf - 1) / kHalf;
      const int c = below[tid];
      if (blo < bhi) {
        bracket[tid][0] = c == 0 ? blo : blo + (c - 1) * bs + 1;
        bracket[tid][1] = c == 0 ? blo : min(blo + c * bs, bhi);
      }
    }
    __syncthreads();
  }
  if (tid < 2) tok[tid] = min(bracket[tid][0], n_tok - 1);
  __syncthreads();
  const int t0 = tok[0], t1 = tok[1];
  for (int k = tid; k < kTile; k += kThreads) map[k] = t0;
  __syncthreads();
  // token t > t0 starts at te[t - 1], inside the tile
  for (int t = t0 + 1 + tid; t <= t1; t += kThreads) {
    const int32_t s = __ldg(te + t - 1);
    if (s > base && s < base + n_valid) atomicMax(&map[slot(s - base)], t);
  }
  __syncthreads();

  // max-scan: each byte's token is the last one starting at or before it
  const int k0 = tid * kPer;
  int run = t0;
  for (int j = 0; j < kPer; ++j) run = max(run, map[slot(k0 + j)]);
  int t = max(block_exclusive_max(run, scan_sm), t0);
  int cur = -1;
  int32_t start = 0, src = 0;
  for (int j = 0; j < kPer; ++j) {
    const int k = k0 + j;
    const int32_t i = base + k;
    t = max(t, map[slot(k)]);
    if (t != cur) {
      cur = t;
      start = t > 0 ? __ldg(te + t - 1) : 0;
      src = __ldg(ts + t);
    }
    const int32_t within = wrap_add(i, -start);
    int32_t link = src < 0 ? wrap_add(src, -within) : wrap_add(src, within);
    if (k >= n_valid || link >= i) link = -1;
    map[slot(k)] = link;
  }
  __syncthreads();

  // jump links that stay inside the tile while any is left
  for (int it = 0; it < kMaxJumps; ++it) {
    int more = 0;
    for (int j = 0; j < kPer; ++j) {
      const int k = k0 + j;
      const int32_t v = map[slot(k)];
      if (v >= base) {
        const int32_t w = map[slot(v - base)];
        map[slot(k)] = w;
        more |= w >= base;
      }
    }
    if (!__syncthreads_or(more)) break;
  }

  // unresolved bits of the thread's 32 positions (one bitmask word), and
  // their targets marked needed, runs of one target word combined
  uint32_t ubits = 0, mbits = 0;
  int32_t mword = -1;
  const int32_t wbase = (base >> 5) - kWindowWords;
  auto flush = [&]() {
    if (mword < 0) return;
    const int32_t rel = mword - wbase;
    if (rel >= 0 && rel < kWindowWords) {
      // most of a tile's chains leave it through a few positions
      if ((window[rel] & mbits) != mbits) atomicOr(&window[rel], mbits);
    } else {
      atomicOr(&needed[mword], mbits);
    }
  };
  for (int j = 0; j < kPer; ++j) {
    const int32_t v = map[slot(k0 + j)];
    if (v >= 0) {
      ubits |= 1u << j;
      if ((v >> 5) != mword) {
        flush();
        mword = v >> 5;
        mbits = 0;
      }
      mbits |= 1u << (v & 31);
    }
  }
  flush();
  if (k0 < n_valid) unres[(base >> 5) + tid] = ubits;
  __syncthreads();
  for (int w = tid; w < kWindowWords; w += kThreads) {
    const uint32_t b = window[w];
    if (b) atomicOr(&needed[wbase + w], b);
  }
  // write every byte of the tile, coalesced; unresolved ones keep their
  // target in lk (their byte comes later)
  auto byte_at = [&](int32_t p) -> uint32_t {
    const int32_t v = map[slot(p - base)];
    if (v >= 0) {
      lk[p] = v;
      return 0u;
    }
    return __ldg(lits + lit_index(v, n_lits));
  };
  const int32_t tile_end = base + n_valid;
  for (int32_t p = base + tid; p < min(tile_end, out.off); p += kThreads) {
    out.head[p] = static_cast<uint8_t>(byte_at(p));
  }
  const int32_t a = max(base, out.off);
  if (a < tile_end) {
    const int32_t w_lo = (a - out.off + 3) >> 2;
    const int32_t w_hi = (tile_end - out.off) >> 2;
    int32_t e0 = out.off + 4 * w_lo, e1 = out.off + 4 * w_hi;
    if (w_lo >= w_hi) e0 = e1 = tile_end;
    auto* words = reinterpret_cast<uint32_t*>(out.win);
    for (int32_t w = w_lo + tid; w < w_hi; w += kThreads) {
      const int32_t p = out.off + 4 * w;
      words[w] = byte_at(p) | (byte_at(p + 1) << 8) |
                 (byte_at(p + 2) << 16) | (byte_at(p + 3) << 24);
    }
    // the bytes outside the tile's whole words: at most 3 at each edge,
    // or at most 7 in all when the tile holds no whole word
    if (tid < 12) {
      const int32_t p = tid < 8 ? a + tid : e1 + (tid - 8);
      const int32_t lim = tid < 8 ? e0 : tile_end;
      if (p < lim) out.win[p - out.off] = static_cast<uint8_t>(byte_at(p));
    }
  }
}

// Position i, both needed and unresolved: if its target is resolved it
// copies the byte, else it jumps.  Returns whether it is still
// unresolved.
__device__ __forceinline__ bool resolve_one(int32_t i, Bytes out,
                                            int32_t* lk, uint32_t* unres) {
  const int32_t q = load_volatile(lk + i);
  const uint32_t qb = load_volatile(unres + (q >> 5));
  if (((qb >> (q & 31)) & 1u) == 0) {
    // q's byte is final: it was written before its bit was cleared
    __threadfence();
    const uint8_t b = load_volatile(out.at(q));
    *reinterpret_cast<volatile uint8_t*>(out.at(i)) = b;
    __threadfence();
    atomicAnd(unres + (i >> 5), ~(1u << (i & 31)));
    return false;
  }
  *reinterpret_cast<volatile int32_t*>(lk + i) = load_volatile(lk + q);
  return true;
}

// The rounds, in one cooperative launch: round 0 scans every bitmask
// word for positions both needed and unresolved (a warp takes 32 words
// and works through the non-zero ones), a later round only the words
// where the one before left any (a list, a word a warp, a lane a
// position), and the rounds stop when none is left.
__global__ void resolve_kernel(int32_t end, Bytes out, int32_t* lk,
                               uint32_t* unres, const uint32_t* needed,
                               int* counts, int32_t* lists, int rounds) {
  cg::grid_group grid = cg::this_grid();
  const int lane = threadIdx.x & 31;
  const int n_bm = (end + 31) >> 5;
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int n_warps = (gridDim.x * blockDim.x) >> 5;
  for (int wb = warp * 32; wb < n_bm; wb += n_warps * 32) {
    const int w = wb + lane;
    const uint32_t bits =
        w < n_bm ? (__ldg(needed + w) & load_volatile(unres + w)) : 0u;
    uint32_t nz = __ballot_sync(0xffffffffu, bits != 0);
    while (nz) {
      const int j = __ffs(nz) - 1;
      nz &= nz - 1;
      const uint32_t word = __shfl_sync(0xffffffffu, bits, j);
      const bool survive =
          ((word >> lane) & 1u) &&
          resolve_one(((wb + j) << 5) + lane, out, lk, unres);
      if (__ballot_sync(0xffffffffu, survive) && lane == 0) {
        lists[atomicAdd(counts, 1)] = wb + j;
      }
    }
  }
  grid.sync();
  for (int r = 1; r < rounds; ++r) {
    const int n_in = load_volatile(counts + r - 1);
    if (n_in == 0) break;  // the same count in every thread
    const int32_t* in = lists + ((r - 1) & 1) * n_bm;
    int32_t* next = lists + (r & 1) * n_bm;
    for (int e = warp; e < n_in; e += n_warps) {
      const int w = load_volatile(in + e);
      const uint32_t word = __ldg(needed + w) & load_volatile(unres + w);
      const bool survive = ((word >> lane) & 1u) &&
                           resolve_one((w << 5) + lane, out, lk, unres);
      if (__ballot_sync(0xffffffffu, survive) && lane == 0) {
        next[atomicAdd(counts + r, 1)] = w;
      }
    }
    grid.sync();
  }
}

// Every position still unresolved copies its (needed, so resolved)
// target's byte.  A warp takes 32 bitmask words and works through the
// non-zero ones four at a time, a lane a position of each, the loads of
// the four in flight together.
__global__ void fixup_kernel(int32_t end, Bytes out,
                             const int32_t* __restrict__ lk,
                             const uint32_t* __restrict__ unres) {
  constexpr int kGroup = 4;
  const int lane = threadIdx.x & 31;
  const int n_bm = (end + 31) >> 5;
  const int wb = ((blockIdx.x * blockDim.x + threadIdx.x) >> 5) * 32;
  if (wb >= n_bm) return;
  const uint32_t mine = wb + lane < n_bm ? __ldg(unres + wb + lane) : 0u;
  uint32_t nz = __ballot_sync(0xffffffffu, mine != 0);
  while (nz) {
    int32_t pos[kGroup], q[kGroup];
    bool set[kGroup];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      const int j = nz ? __ffs(nz) - 1 : 0;
      const uint32_t word = __shfl_sync(0xffffffffu, mine, j);
      set[c] = nz && ((word >> lane) & 1u);
      nz &= nz ? nz - 1 : 0u;
      pos[c] = ((wb + j) << 5) + lane;
      q[c] = set[c] ? __ldg(lk + pos[c]) : 0;
    }
    uint8_t b[kGroup];
#pragma unroll
    for (int c = 0; c < kGroup; ++c) b[c] = set[c] ? *out.at(q[c]) : 0;
#pragma unroll
    for (int c = 0; c < kGroup; ++c) {
      if (set[c]) *out.at(pos[c]) = b[c];
    }
  }
}

int rounds_for(int64_t tiles) {
  int r = 1;
  while ((int64_t{1} << (r - 1)) < tiles && r < kMaxRounds) ++r;
  return r;
}

// Blocks of resolve_kernel that fit on the card at once (a cooperative
// launch needs them all resident), per device.
int resolve_grid() {
  static int cached[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] == 0) {
    int sms = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, resolve_kernel, kScanThreads, 0) != cudaSuccess) {
      return 0;
    }
    cached[dev] = sms * per_sm;
  }
  return cached[dev];
}

}  // namespace

// te/ts: n_tok int32 (n_tok >= 1); lits: n_lits bytes (n_lits >= 1).
// n_words < 0 writes the (out_cap,) u8 blob to `out`; otherwise n_words
// u32 words from byte `off` (off + 4 * n_words <= out_cap).  Scratch,
// caller-allocated: lk (end int32, end = out_cap for a blob, off + 4 *
// n_words for words), bits (4 * ceil(end / 32) + 32 int32) and head (off
// bytes, words only).
extern "C" int tpq_snappy_expand(const void* te, const void* ts, int n_tok,
                                 const void* lits, int64_t n_lits,
                                 int32_t out_cap, int64_t off,
                                 int64_t n_words, void* out, void* lk,
                                 void* bits, void* head, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const bool blob = n_words < 0;
  const int64_t end64 = blob ? out_cap : off + 4 * n_words;
  if (end64 <= 0 || (!blob && n_words == 0)) {
    return static_cast<int>(cudaGetLastError());
  }
  const auto end = static_cast<int32_t>(end64);
  static bool configured = false;
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kTileSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = true;
  }
  Bytes o{static_cast<uint8_t*>(head), static_cast<uint8_t*>(out),
          blob ? 0 : static_cast<int32_t>(off)};
  auto* l = static_cast<int32_t*>(lk);
  const int64_t n_bm = (end64 + 31) / 32;
  auto* unres = static_cast<uint32_t*>(bits);
  auto* needed = unres + n_bm;
  auto* counts = reinterpret_cast<int*>(needed + n_bm);
  const int64_t tiles = (end64 + kTile - 1) / kTile;
  if (tiles > 1) {
    const cudaError_t e = cudaMemsetAsync(
        needed, 0, static_cast<size_t>(n_bm + kMaxRounds) * 4, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  tile_kernel<<<static_cast<unsigned>(tiles), kThreads, kTileSmem, s>>>(
      static_cast<const int32_t*>(te), static_cast<const int32_t*>(ts), n_tok,
      static_cast<const uint8_t*>(lits), n_lits, end, o, l, unres, needed);
  if (tiles > 1) {
    const int resident = resolve_grid();
    if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
    // a warp covers 32 bitmask words (1024 positions) a step
    const int64_t want = (n_bm + kScanThreads - 1) / kScanThreads;
    unsigned grid = static_cast<unsigned>(want < resident ? want : resident);
    int rounds = rounds_for(tiles);
    int32_t* lists = reinterpret_cast<int32_t*>(counts + kMaxRounds);
    void* args[] = {const_cast<int32_t*>(&end), &o, &l, &unres, &needed,
                    &counts, &lists, &rounds};
    const cudaError_t e = cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(resolve_kernel), dim3(grid),
        dim3(kScanThreads), args, 0, s);
    if (e != cudaSuccess) return static_cast<int>(e);
    // a warp takes 32 words
    fixup_kernel<<<static_cast<unsigned>((n_bm + kScanThreads - 1) /
                                         kScanThreads),
                   kScanThreads, 0, s>>>(end, o, l, unres);
  }
  return static_cast<int>(cudaGetLastError());
}
