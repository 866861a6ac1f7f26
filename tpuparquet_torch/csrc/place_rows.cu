// KS4: the placed gather's permute to unit order (sm_90a).
//
// Replaces the `place` program of tpuparquet/shard/scan.py _place_streams
// (XLA-jitted under the consumer's out-sharding):
//   out[i] = i < n_true ? x[rows[i]] : 0     for i < u_out
// over rows of `row_bytes` bytes: `x` is the shard-major assembly of the
// gathered units, `rows[u]` the assembly row of unit u (the gather's
// perm), and rows past the true unit count are zero padding.  The reshape
// to the output's row shape is a view.
//
// Bound on the H100: memory (each kept row read once, every output byte
// written once).  One thread per output word where a row is whole u32
// words and both buffers are word-aligned, else per byte; the row index is
// shared by the threads of a row.  The wrapper checks every row index
// against the assembly before the launch.

#include "common.cuh"

namespace {

template <typename T>
__global__ void place_rows_kernel(const T* __restrict__ x, int64_t row_elems,
                                  const int64_t* __restrict__ rows,
                                  int64_t n_true, int64_t u_out,
                                  T* __restrict__ out) {
  const int64_t total = u_out * row_elems;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < total; t += stride) {
    const int64_t i = t / row_elems;
    const int64_t e = t - i * row_elems;
    out[t] = i < n_true ? __ldg(x + __ldg(rows + i) * row_elems + e) : T(0);
  }
}

}  // namespace

extern "C" int tpq_place_rows(const void* x, int64_t row_bytes,
                              const void* rows, int64_t n_true, int64_t u_out,
                              void* out, void* stream) {
  const int64_t total = u_out * row_bytes;
  if (total > 0) {
    constexpr int kThreads = 256;
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* r = static_cast<const int64_t*>(rows);
    const bool words =
        row_bytes % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
        reinterpret_cast<uintptr_t>(out) % 4 == 0;
    if (words) {
      place_rows_kernel<uint32_t>
          <<<tpq::grid_for(total / 4, kThreads), kThreads, 0, s>>>(
              static_cast<const uint32_t*>(x), row_bytes / 4, r, n_true,
              u_out, static_cast<uint32_t*>(out));
    } else {
      place_rows_kernel<uint8_t>
          <<<tpq::grid_for(total, kThreads), kThreads, 0, s>>>(
              static_cast<const uint8_t*>(x), row_bytes, r, n_true, u_out,
              static_cast<uint8_t*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}
