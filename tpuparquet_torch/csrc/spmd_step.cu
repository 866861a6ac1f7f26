// KS2: the SPMD dictionary decode step, one mesh slot's share (sm_90a).
//
// Replaces tpuparquet/shard/mesh.py decode_step_spmd (a shard_map of
// kernels/hybrid.py expand_hybrid_core, vmapped over the units of an "rg"
// block, then a dictionary gather and all-gathers over "sp" and "rg").  A
// slot (r, s) of the (rg, sp) mesh decodes the units of rg block r at the
// value positions [pos0, pos0 + n_pos) of its sp slice: for each unit u
// and position i,
//   run    = searchsorted(run_ends[u], i, side="right"), clamped to R - 1
//   within = i - (run > 0 ? run_ends[u][run - 1] : 0)
//   index  = run_is_rle[u][run] ? run_value[u][run]
//            : lane clip(run_bp_start[u][run] + within, 0, n_bp - 1) of
//              unit u's bit-packed words at width max(width, 1)
//   out[unit0 + u][i][:] = dictionary[min(index, D - 1)][:]
// and writes them straight into its place in the (U, count, lanes) output,
// so the all-gathers reduce to copies between the mesh's distinct devices
// (none where the slots share one card).
//
// Bound on the H100: memory.  Per value it writes 4 * lanes bytes and reads
// at most width / 8 bytes of packed lanes; the run tables (13 bytes a run)
// and the dictionary are small and stay in L1/L2.  One thread per (unit,
// position): a binary search over the unit's run ends, then the RLE value
// or the lane unpacked in registers (no unpacked intermediate, unlike the
// JAX step, which unpacks every lane of the unit before it gathers).
// Every JAX implicit clamp is explicit here.

#include "common.cuh"

namespace {

__global__ void spmd_step_kernel(
    const uint32_t* __restrict__ bw, int64_t row_words,
    const int32_t* __restrict__ run_ends, const uint8_t* __restrict__ is_rle,
    const uint32_t* __restrict__ run_value,
    const int32_t* __restrict__ bp_start, int R,
    const uint32_t* __restrict__ dict, int64_t D, int lanes, int64_t n_units,
    int64_t pos0, int64_t n_pos, int wu, int64_t n_bp,
    uint32_t* __restrict__ out, int64_t count, int64_t unit0) {
  const int64_t total = n_units * n_pos;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t u = t / n_pos;
    const int64_t i = pos0 + (t - u * n_pos);
    const int32_t* ends = run_ends + u * R;
    int lo = 0, hi = R;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (static_cast<int64_t>(__ldg(ends + mid)) <= i) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    const int run = lo < R - 1 ? lo : R - 1;
    uint32_t idx;
    if (__ldg(is_rle + u * R + run) != 0) {
      idx = __ldg(run_value + u * R + run);
    } else {
      const int64_t start =
          run > 0 ? static_cast<int64_t>(__ldg(ends + run - 1)) : 0;
      int64_t pos = static_cast<int64_t>(__ldg(bp_start + u * R + run)) +
                    (i - start);
      pos = pos < 0 ? 0 : (pos > n_bp - 1 ? n_bp - 1 : pos);
      idx = tpq::unpack_lane(bw + u * row_words, pos, wu);
    }
    const int64_t k = static_cast<int64_t>(idx) < D - 1
                          ? static_cast<int64_t>(idx)
                          : D - 1;
    const uint32_t* src = dict + k * lanes;
    uint32_t* dst = out + ((unit0 + u) * count + i) * lanes;
    for (int l = 0; l < lanes; ++l) dst[l] = __ldg(src + l);
  }
}

}  // namespace

// `out` is the whole (U, count, lanes) output; this launch writes units
// [unit0, unit0 + n_units) at positions [pos0, pos0 + n_pos).  The unit
// arrays hold the n_units rows of this slot's rg block.  `wu` is
// max(width, 1).
extern "C" int tpq_spmd_step(const void* bw, int64_t row_words,
                             const void* run_ends, const void* is_rle,
                             const void* run_value, const void* bp_start,
                             int R, const void* dict, int64_t D, int lanes,
                             int64_t n_units, int64_t pos0, int64_t n_pos,
                             int wu, int64_t n_bp, void* out, int64_t count,
                             int64_t unit0, void* stream) {
  const int64_t total = n_units * n_pos;
  if (total > 0) {
    constexpr int kThreads = 256;
    spmd_step_kernel<<<tpq::grid_for(total, kThreads), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(bw), row_words,
        static_cast<const int32_t*>(run_ends),
        static_cast<const uint8_t*>(is_rle),
        static_cast<const uint32_t*>(run_value),
        static_cast<const int32_t*>(bp_start), R,
        static_cast<const uint32_t*>(dict), D, lanes, n_units, pos0, n_pos,
        wu, n_bp, static_cast<uint32_t*>(out), count, unit0);
  }
  return static_cast<int>(cudaGetLastError());
}
