// KE5: min and max of 1- or 2-lane values in signed, unsigned or float
// order (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py DeviceValues.min_max, whose
// device work is jnp.min/jnp.max (signed or unsigned) or
// jnp.nanmin/jnp.nanmax (floats) over the lane words bitcast to the
// value type.  Every value becomes an unsigned 64-bit key whose order is
// the wanted one: signed values flip their sign bit; floats set the sign
// bit of a positive and flip every bit of a negative, so -0.0 sorts below
// +0.0, as XLA orders them; NaN (either sign) is skipped.  No value: the
// minimum key stays above the maximum.
//
// Bound on the H100: memory (each word read once; two words written).
// One launch a call, with nothing to set first and nothing to copy after:
// - The lane count and the order are template parameters (6 kernels).
// - Each thread loads 16-byte vectors (4 words: 4 values of 1 lane or 2
//   of 2), kUnroll of them in flight before it takes their keys.  The
//   values before the view's first 16-byte boundary (a view 1-3 words
//   into its buffer) and after its last whole vector are loaded one by
//   one; 2-lane values that start off an 8-byte boundary are all loaded
//   one by one.
// - The grid is at most the blocks the card holds at once (asked of the
//   occupancy calculator once a card), fewer when the values need fewer.
// - A block reduces its keys (shuffles, then shared memory) and folds
//   them into `scratch` with two 64-bit atomicMax (of the complemented
//   minimum and of the maximum, so the fold starts from 0), then takes a
//   ticket, the word after them.  The wrapper zeroes the three words once
//   at first use.  The block that takes the last ticket exchanges the
//   fold for 0s, writes the two keys to `out` (the wrapper's pinned,
//   mapped host buffer, read after the stream's synchronization) and
//   sets the ticket back to 0, so the stream's next call starts from
//   0s.  The wrapper keeps one scratch a device and stream, so calls on
//   two streams never share a fold or a ticket.  The last block's chain
//   (the fold's fence, the ticket, the exchange, the write to the host)
//   is most of what the call takes beyond reading the values.

#include <array>
#include <atomic>

#include "common.cuh"

namespace {

using u64 = unsigned long long;

enum Order { kSigned = 0, kUnsigned = 1, kFloat = 2 };

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads a thread keeps in flight

// The key of one value (words w0, w1; w1 unused at 1 lane) into the
// running (mn, mx); NaN is skipped.
template <int LANES, int ORDER>
__device__ __forceinline__ void take(uint32_t w0, uint32_t w1, u64& mn,
                                     u64& mx) {
  u64 key;
  if constexpr (LANES == 1) {
    const uint32_t b = w0;
    if constexpr (ORDER == kFloat) {
      if ((b & 0x7FFFFFFFu) > 0x7F800000u) return;  // NaN
      key = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    } else {
      key = ORDER == kSigned ? (b ^ 0x80000000u) : b;
    }
  } else {
    const u64 b = static_cast<u64>(w0) | static_cast<u64>(w1) << 32;
    constexpr u64 kTop = 1ull << 63;
    if constexpr (ORDER == kFloat) {
      if ((b & ~kTop) > 0x7FF0000000000000ull) return;  // NaN
      key = (b & kTop) ? ~b : (b | kTop);
    } else {
      key = ORDER == kSigned ? (b ^ kTop) : b;
    }
  }
  mn = key < mn ? key : mn;
  mx = key > mx ? key : mx;
}

// The block's (min, max) in thread 0; every thread must call it.
__device__ __forceinline__ void block_min_max(u64& mn, u64& mx) {
  __shared__ u64 smin[kWarps], smax[kWarps];
  for (int o = 16; o > 0; o >>= 1) {
    const u64 a = __shfl_xor_sync(0xffffffffu, mn, o);
    const u64 b = __shfl_xor_sync(0xffffffffu, mx, o);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) {
    smin[wid] = mn;
    smax[wid] = mx;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 1; k < kWarps; ++k) {
      mn = smin[k] < mn ? smin[k] : mn;
      mx = smax[k] > mx ? smax[k] : mx;
    }
  }
}

template <int LANES, int ORDER>
__global__ void __launch_bounds__(kThreads) min_max_kernel(
    const uint32_t* __restrict__ flat, int64_t n, int64_t head,
    int64_t n_vec, u64* __restrict__ acc, unsigned* __restrict__ ticket,
    u64* __restrict__ out) {
  constexpr int kPer = 4 / LANES;  // values a 16-byte vector
  u64 mn = ~0ull, mx = 0ull;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads +
                    threadIdx.x;
  // the whole vectors, from the view's first 16-byte boundary
  const uint4* vec = reinterpret_cast<const uint4*>(flat + head * LANES);
  for (int64_t i = t; i < n_vec; i += kUnroll * stride) {
    uint4 x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * stride < n_vec) x[u] = __ldg(vec + i + u * stride);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (i + u * stride < n_vec) {
        if constexpr (LANES == 1) {
          take<1, ORDER>(x[u].x, 0u, mn, mx);
          take<1, ORDER>(x[u].y, 0u, mn, mx);
          take<1, ORDER>(x[u].z, 0u, mn, mx);
          take<1, ORDER>(x[u].w, 0u, mn, mx);
        } else {
          take<2, ORDER>(x[u].x, x[u].y, mn, mx);
          take<2, ORDER>(x[u].z, x[u].w, mn, mx);
        }
      }
    }
  }
  // the values one by one: the head, then the tail after the last vector
  const int64_t body_end = head + n_vec * kPer;
  const int64_t n_one = head + (n - body_end);
  for (int64_t e = t; e < n_one; e += stride) {
    const int64_t i = e < head ? e : body_end + (e - head);
    take<LANES, ORDER>(__ldg(flat + i * LANES),
                       LANES == 2 ? __ldg(flat + i * LANES + 1) : 0u, mn,
                       mx);
  }
  block_min_max(mn, mx);
  if (threadIdx.x != 0) return;
  // fold the block's keys into the call's: the maximum of the complements
  // (0, the fold's start, is the complement of no minimum) and of the keys
  atomicMax(acc, ~mn);
  atomicMax(acc + 1, mx);
  __threadfence();  // the fold is seen before the ticket
  if (atomicAdd(ticket, 1u) != gridDim.x - 1) return;
  // the last block: take the keys and leave 0s for the stream's next call
  const u64 lo = ~atomicExch(acc, 0ull);
  const u64 hi = atomicExch(acc + 1, 0ull);
  *ticket = 0u;
  *reinterpret_cast<ulonglong2*>(out) = make_ulonglong2(lo, hi);
  __threadfence_system();
}

using Kernel = void (*)(const uint32_t*, int64_t, int64_t, int64_t, u64*,
                        unsigned*, u64*);

// kernels by 3 * (lanes - 1) + order
const std::array<Kernel, 6> kKernels = {
    &min_max_kernel<1, kSigned>, &min_max_kernel<1, kUnsigned>,
    &min_max_kernel<1, kFloat>,  &min_max_kernel<2, kSigned>,
    &min_max_kernel<2, kUnsigned>, &min_max_kernel<2, kFloat>};

// The blocks of kernel k the current card holds at once, the grid's cap
// (asked once a card and kernel).
int resident_blocks(int k) {
  constexpr int kCards = 64;
  static std::atomic<int> cache[kCards][6];
  int card = 0;
  if (cudaGetDevice(&card) != cudaSuccess || card < 0 || card >= kCards) {
    return 1;
  }
  int blocks = cache[card][k].load(std::memory_order_relaxed);
  if (blocks == 0) {
    int per_sm = 0, sms = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernels[k],
                                                  kThreads, 0);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, card);
    blocks = per_sm * sms > 0 ? per_sm * sms : 1;
    cache[card][k].store(blocks, std::memory_order_relaxed);
  }
  return blocks;
}

}  // namespace

// flat holds n * lanes words (lanes 1 or 2, n >= 1); scratch 3 64-bit
// words (the fold of the complemented minimum and of the maximum, then the
// ticket: all 0 before the first call, and 0 again after each); out two
// 64-bit words, the minimum and maximum
// keys (minimum > maximum when no value counted) as one 16-byte store,
// device memory or a mapped host buffer's device pointer.
extern "C" int tpq_min_max(const void* flat, int64_t n, int lanes,
                           int order, void* scratch, void* out,
                           void* stream) {
  if (n < 1 || (lanes != 1 && lanes != 2) || order < 0 || order > 2 ||
      (reinterpret_cast<uintptr_t>(flat) & 3) != 0 ||
      (reinterpret_cast<uintptr_t>(out) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // values before the first 16-byte boundary; 2-lane values off an
  // 8-byte boundary never fill an aligned vector
  const uintptr_t addr = reinterpret_cast<uintptr_t>(flat);
  int64_t head = lanes == 2 && (addr & 7) != 0
                     ? n
                     : static_cast<int64_t>(((16 - (addr & 15)) & 15) / 4 /
                                            lanes);
  head = head < n ? head : n;
  const int64_t n_vec = (n - head) / (4 / lanes);
  const int64_t n_one = n - n_vec * (4 / lanes);
  const int64_t want =
      n_vec > 0 ? (n_vec + int64_t(kThreads) * kUnroll - 1) /
                      (int64_t(kThreads) * kUnroll)
                : (n_one + kThreads - 1) / kThreads;
  const int k = 3 * (lanes - 1) + order;
  const int64_t cap = resident_blocks(k);
  kKernels[k]<<<static_cast<unsigned>(want < cap ? want : cap), kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(flat), n, head, n_vec,
      static_cast<u64*>(scratch),
      reinterpret_cast<unsigned*>(static_cast<u64*>(scratch) + 2),
      static_cast<u64*>(out));
  return static_cast<int>(cudaGetLastError());
}

// Waits for the stream's work (the wrapper reads the mapped keys after).
extern "C" int tpq_min_max_wait(void* stream) {
  return static_cast<int>(
      cudaStreamSynchronize(static_cast<cudaStream_t>(stream)));
}

// The device pointer of a pinned host buffer; fails (a non-zero
// cudaError) when the buffer is not mapped into the device's space.
extern "C" int tpq_min_max_mapped(void* host, uint64_t* device) {
  void* p = nullptr;
  const cudaError_t rc = cudaHostGetDevicePointer(&p, host, 0);
  *device = reinterpret_cast<uint64_t>(p);
  return static_cast<int>(rc != cudaSuccess ? rc
                          : p == nullptr    ? cudaErrorInvalidValue
                                            : cudaSuccess);
}
