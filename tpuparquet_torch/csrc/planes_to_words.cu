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
// Bound on the H100: memory for raw lanes (4 bytes read, 4 written); a
// run lane reads a table that stays in L1/L2 and costs a binary search of
// log2(n_runs) steps per value, far below the card's operation rate.  One
// thread per output word (value i, lane l), writing out[i * lanes + l], so
// the stores coalesce.

#include "common.cuh"

namespace {

constexpr int kMaxLanes = 4;
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

// searchsorted(ends[0:n_runs], i, side="right"), clamped to n_runs - 1.
__device__ __forceinline__ int run_of(const int32_t* __restrict__ ends,
                                      int n_runs, int64_t i) {
  int lo = 0, hi = n_runs;  // first index whose end is > i
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (static_cast<int64_t>(__ldg(ends + mid)) <= i) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < n_runs - 1 ? lo : n_runs - 1;
}

__global__ void planes_kernel(const uint32_t* __restrict__ raw32,
                              const int32_t* __restrict__ e32,
                              const uint32_t* __restrict__ v32,
                              const uint8_t* __restrict__ raw8,
                              const int32_t* __restrict__ e8,
                              const uint8_t* __restrict__ v8, Spec spec,
                              int64_t count, int lanes,
                              uint32_t* __restrict__ out) {
  const int64_t total = count * lanes;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       o < total; o += stride) {
    const int64_t i = o / lanes;
    const Lane& ln = spec.lane[o - i * lanes];
    uint32_t w;
    if (ln.kind == kRaw32) {
      w = __ldg(raw32 + static_cast<int64_t>(ln.a) * count + i);
    } else if (ln.kind == kRle32) {
      w = __ldg(v32 + ln.a + run_of(e32 + ln.a, ln.b, i));
    } else {
      w = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        uint32_t b;
        if (ln.sub_kind[t] == kRaw8) {
          b = __ldg(raw8 + static_cast<int64_t>(ln.sub_a[t]) * count + i);
        } else {
          b = __ldg(v8 + ln.sub_a[t] +
                    run_of(e8 + ln.sub_a[t], ln.sub_b[t], i));
        }
        w |= b << (8 * t);
      }
    }
    out[o] = w;
  }
}

}  // namespace

// `spec` is a host array of lanes * 15 int32: per lane kind, a, b, then
// sub_kind[4], sub_a[4], sub_b[4] (the kinds of the enum above).  It is
// copied into the launch's parameters, so it need only live for the call.
extern "C" int tpq_planes_to_words(const void* raw32, const void* e32,
                                   const void* v32, const void* raw8,
                                   const void* e8, const void* v8,
                                   const int32_t* spec, int64_t count,
                                   int lanes, void* out, void* stream) {
  if (lanes < 1 || lanes > kMaxLanes) {
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
    constexpr int kThreads = 256;
    planes_kernel<<<tpq::grid_for(count * lanes, kThreads), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint32_t*>(raw32), static_cast<const int32_t*>(e32),
        static_cast<const uint32_t*>(v32), static_cast<const uint8_t*>(raw8),
        static_cast<const int32_t*>(e8), static_cast<const uint8_t*>(v8), s,
        count, lanes, static_cast<uint32_t*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}
