// KS3: a BYTE_ARRAY unit densified into its row of the gathered block
// (sm_90a).
//
// Replaces the densify of tpuparquet/shard/scan.py gather_byte_column
// (XLA-jitted jnp ops per unit, then jnp.pad):
//   dl[i]     = mask[i] ? offsets[positions[i] + 1] - offsets[positions[i]]
//                       : 0
//   out_offs  = [0, cumsum(dl)], edge-padded to L entries (the byte total)
//   out_data  = the unit's value bytes, zero-padded to B
// A null value slot is a zero-length value: its bytes are already absent
// from the packed data, so the data row is the packed bytes as they are
// and only the offsets re-derive.  A null mask pointer means every slot is
// valid, a null positions pointer the identity.  Offsets and sums are
// int32, as the reference's are (its device runs without 64-bit
// integers); the wrapper refuses a unit of 2^31 bytes or more.
//
// Bound on the H100: memory (per slot a mask byte, a position and two
// offsets read, four bytes written; each data byte read once and written
// once).  The running sum spans blocks, so it is the two-pass block scan
// of K4: (1) each block sums its slots' lengths, (2) one block scans the
// block sums into block offsets, (3) each block scans its lengths again and
// writes its offsets; the blocks of pass 3 also copy the data bytes and
// write the padding, so the unit's two rows are finished in one pass over
// them.  Every position is clamped into [0, n_packed - 1], as JAX clamps
// its gather.

#include "common.cuh"

namespace {

constexpr int kThreads = 1024;

__device__ __forceinline__ int slot_len(const int32_t* __restrict__ offsets,
                                        int64_t n_packed,
                                        const uint8_t* __restrict__ mask,
                                        const int32_t* __restrict__ positions,
                                        int64_t n, int64_t i) {
  if (i >= n || n_packed == 0) return 0;
  if (mask != nullptr && __ldg(mask + i) == 0) return 0;
  int64_t p =
      positions == nullptr ? i : static_cast<int64_t>(__ldg(positions + i));
  p = p < 0 ? 0 : (p > n_packed - 1 ? n_packed - 1 : p);
  return __ldg(offsets + p + 1) - __ldg(offsets + p);
}

__global__ void sum_kernel(const int32_t* __restrict__ offsets,
                           int64_t n_packed, const uint8_t* __restrict__ mask,
                           const int32_t* __restrict__ positions, int64_t n,
                           int32_t* __restrict__ block_sums) {
  __shared__ int smem[32];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int x = slot_len(offsets, n_packed, mask, positions, n, i);
  const int incl = tpq::block_inclusive_scan(x, smem);
  if (threadIdx.x == kThreads - 1) block_sums[blockIdx.x] = incl;
}

// One block: exclusive scan of block_sums in place, 1024 entries a round;
// block_sums[nb] receives the total.
__global__ void scan_sums_kernel(int32_t* __restrict__ block_sums,
                                 int64_t nb) {
  __shared__ int smem[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int64_t base = 0; base < nb; base += kThreads) {
    const int64_t j = base + threadIdx.x;
    const int x = j < nb ? block_sums[j] : 0;
    const int incl = tpq::block_inclusive_scan(x, smem);
    const int c = carry;
    if (j < nb) block_sums[j] = c + incl - x;
    __syncthreads();
    if (threadIdx.x == kThreads - 1) carry = c + incl;
    __syncthreads();
  }
  if (threadIdx.x == 0) block_sums[nb] = carry;
}

// Blocks [0, nb) write the offsets of their slots (out_offs[i + 1]); all
// blocks then stride over the rest: out_offs[0], the edge padding, and the
// data row.
__global__ void write_kernel(const int32_t* __restrict__ offsets,
                             int64_t n_packed,
                             const uint8_t* __restrict__ mask,
                             const int32_t* __restrict__ positions, int64_t n,
                             const int32_t* __restrict__ block_offsets,
                             int64_t nb, int32_t* __restrict__ out_offs,
                             int64_t L, const uint8_t* __restrict__ data,
                             int64_t n_bytes, uint8_t* __restrict__ out_data,
                             int64_t B) {
  __shared__ int smem[32];
  if (blockIdx.x < nb) {
    const int64_t i =
        static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
    const int x = slot_len(offsets, n_packed, mask, positions, n, i);
    const int incl = tpq::block_inclusive_scan(x, smem);
    if (i < n) out_offs[i + 1] = __ldg(block_offsets + blockIdx.x) + incl;
  }
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  const int32_t total = __ldg(block_offsets + nb);
  if (t == 0) out_offs[0] = 0;
  for (int64_t j = n + 1 + t; j < L; j += stride) out_offs[j] = total;
  for (int64_t j = t; j < B; j += stride) {
    out_data[j] = j < n_bytes ? __ldg(data + j) : static_cast<uint8_t>(0);
  }
}

}  // namespace

// `block_sums` is caller-allocated scratch of ceil(n / 1024) + 1 int32.
// L >= n + 1 and B >= n_bytes.
extern "C" int tpq_byte_densify(const void* offsets, int64_t n_packed,
                                const void* mask, const void* positions,
                                int64_t n, void* block_sums, void* out_offs,
                                int64_t L, const void* data, int64_t n_bytes,
                                void* out_data, int64_t B, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t nb = (n + kThreads - 1) / kThreads;
  auto* sums = static_cast<int32_t*>(block_sums);
  const auto* offs = static_cast<const int32_t*>(offsets);
  const auto* m = static_cast<const uint8_t*>(mask);
  const auto* pos = static_cast<const int32_t*>(positions);
  if (nb > 0) {
    sum_kernel<<<static_cast<unsigned>(nb), kThreads, 0, s>>>(
        offs, n_packed, m, pos, n, sums);
  }
  scan_sums_kernel<<<1, kThreads, 0, s>>>(sums, nb);
  // the offset blocks, or enough strided blocks for the padding and the
  // data row (at most 4096: each then strides over its share)
  const int64_t rest = L > B ? L : B;
  int64_t fill = (rest + kThreads - 1) / kThreads;
  fill = fill < 4096 ? (fill > 0 ? fill : 1) : 4096;
  write_kernel<<<static_cast<unsigned>(nb > fill ? nb : fill), kThreads,
                 0, s>>>(offs, n_packed, m, pos, n, sums, nb,
                         static_cast<int32_t*>(out_offs), L,
                         static_cast<const uint8_t*>(data), n_bytes,
                         static_cast<uint8_t*>(out_data), B);
  return static_cast<int>(cudaGetLastError());
}
