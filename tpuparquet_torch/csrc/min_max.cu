// KE5: min and max of 1- or 2-lane values in signed, unsigned or float
// order (sm_90a).
//
// Replaces tpuparquet/kernels/encode.py DeviceValues.min_max, whose
// device work is jnp.min/jnp.max (signed or unsigned) or
// jnp.nanmin/jnp.nanmax (floats) over the lane words bitcast to the
// value type.  Every value becomes an unsigned 64-bit key whose order is
// the wanted one: signed values flip their sign bit; floats set the sign
// bit of a positive and flip every bit of a negative, so -0.0 sorts below
// +0.0, as XLA orders them; NaN (either sign) is skipped.  The keys'
// minimum and maximum are reduced per thread, per warp with shuffles,
// per block through shared memory, and across blocks with 64-bit
// atomicMin/atomicMax on the two output words, which a one-thread launch
// sets to (~0, 0) first.  No value: the minimum key stays above the
// maximum.
//
// Bound on the H100: memory (each word read once; two words written).

#include "common.cuh"

namespace {

enum Order { kSigned = 0, kUnsigned = 1, kFloat = 2 };

__global__ void init_kernel(unsigned long long* out) {
  out[0] = ~0ull;
  out[1] = 0ull;
}

__device__ __forceinline__ bool key_of(const uint32_t* flat, int64_t i,
                                       int lanes, int order,
                                       unsigned long long* key) {
  if (lanes == 1) {
    const uint32_t b = __ldg(flat + i);
    if (order == kFloat) {
      if ((b & 0x7FFFFFFFu) > 0x7F800000u) return false;  // NaN
      *key = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    } else {
      *key = order == kSigned ? (b ^ 0x80000000u) : b;
    }
    return true;
  }
  const unsigned long long b =
      static_cast<unsigned long long>(__ldg(flat + 2 * i)) |
      static_cast<unsigned long long>(__ldg(flat + 2 * i + 1)) << 32;
  constexpr unsigned long long kTop = 1ull << 63;
  if (order == kFloat) {
    if ((b & ~kTop) > 0x7FF0000000000000ull) return false;  // NaN
    *key = (b & kTop) ? ~b : (b | kTop);
  } else {
    *key = order == kSigned ? (b ^ kTop) : b;
  }
  return true;
}

__global__ void min_max_kernel(const uint32_t* __restrict__ flat,
                               int64_t n, int lanes, int order,
                               unsigned long long* __restrict__ out) {
  __shared__ unsigned long long smin[32], smax[32];
  unsigned long long mn = ~0ull, mx = 0ull;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    unsigned long long k;
    if (key_of(flat, i, lanes, order, &k)) {
      mn = k < mn ? k : mn;
      mx = k > mx ? k : mx;
    }
  }
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long a = __shfl_xor_sync(0xffffffffu, mn, o);
    const unsigned long long b = __shfl_xor_sync(0xffffffffu, mx, o);
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
  if (wid == 0) {
    const int n_warps = blockDim.x >> 5;
    mn = lane < n_warps ? smin[lane] : ~0ull;
    mx = lane < n_warps ? smax[lane] : 0ull;
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long a = __shfl_xor_sync(0xffffffffu, mn, o);
      const unsigned long long b = __shfl_xor_sync(0xffffffffu, mx, o);
      mn = a < mn ? a : mn;
      mx = b > mx ? b : mx;
    }
    if (lane == 0) {
      atomicMin(out, mn);
      atomicMax(out + 1, mx);
    }
  }
}

}  // namespace

// flat holds n * lanes words (lanes 1 or 2); out two 64-bit words: the
// minimum and maximum keys (minimum > maximum when no value counted).
extern "C" int tpq_min_max(const void* flat, int64_t n, int lanes,
                           int order, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* keys = static_cast<unsigned long long*>(out);
  init_kernel<<<1, 1, 0, s>>>(keys);
  if (n > 0) {
    constexpr int kThreads = 256;
    const unsigned blocks = tpq::grid_for(n, kThreads);
    const unsigned grid = blocks < 1056u ? blocks : 1056u;  // 8 per SM
    min_max_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(flat), n, lanes, order, keys);
  }
  return static_cast<int>(cudaGetLastError());
}
