// K11: place a scattered width class of a DELTA_BINARY_PACKED page (sm_90a).
//
// Replaces tpuparquet/kernels/decode.py _scatter_grid and the scatter
// that consumes it in expand_delta_i32/_i64 (`deltas.at[pos].set(vals,
// mode="drop")`): the width class's k miniblocks of mb unpacked lanes
// (K1's output, or K6's lo/hi above width 32 and for int64) land at
// starts[m] + j for j < takes[m]; a target outside [0, out_len) is
// dropped.  The explicit bounds check is the reference's "drop" mode
// written out: an out-of-range index in PyTorch is a device assert, not a
// drop.
//
// Bound on the H100: memory.  Each lane is read once (4 bytes, 8 for
// int64) and written once to its target; the integer work per lane is a
// division and two compares.  The reference builds a (k, mb) position
// grid in device memory and then scatters; here one thread per lane
// computes its own target from the per-miniblock starts and takes (8
// bytes a miniblock), so the grid never exists.  Neighbouring threads
// read neighbouring lanes and, inside a miniblock, write neighbouring
// targets, so both sides coalesce.  Fusing the unpack into this pass is
// later work.

#include "common.cuh"

namespace {

__global__ void delta_scatter_kernel(const uint32_t* __restrict__ lo,
                                     const uint32_t* __restrict__ hi,
                                     const int32_t* __restrict__ starts,
                                     const int32_t* __restrict__ takes,
                                     int64_t k, int64_t mb,
                                     uint32_t* __restrict__ dlo,
                                     uint32_t* __restrict__ dhi,
                                     int64_t out_len) {
  const int64_t n = k * mb;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t m = i / mb;
    const int64_t j = i - m * mb;
    if (j >= static_cast<int64_t>(__ldg(takes + m))) continue;
    const int64_t p = static_cast<int64_t>(__ldg(starts + m)) + j;
    if (p < 0 || p >= out_len) continue;
    dlo[p] = __ldg(lo + i);
    if (hi != nullptr) dhi[p] = __ldg(hi + i);
  }
}

}  // namespace

// lo (and hi, or null) hold k * mb lanes; starts and takes k int32
// entries; dlo (and dhi) at least out_len words, written in place.
extern "C" int tpq_delta_scatter(const void* lo, const void* hi,
                                 const void* starts, const void* takes,
                                 int64_t k, int64_t mb, void* dlo, void* dhi,
                                 int64_t out_len, void* stream) {
  if (k > 0 && mb > 0) {
    constexpr int kThreads = 256;
    delta_scatter_kernel<<<tpq::grid_for(k * mb, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(lo), static_cast<const uint32_t*>(hi),
        static_cast<const int32_t*>(starts),
        static_cast<const int32_t*>(takes), k, mb,
        static_cast<uint32_t*>(dlo), static_cast<uint32_t*>(dhi), out_len);
  }
  return static_cast<int>(cudaGetLastError());
}
