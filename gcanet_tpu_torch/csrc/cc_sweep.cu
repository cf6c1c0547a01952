// Masked min-label sweep of the connected-components loop, for Hopper (sm_90a).
//
//   out[i] = min_j { labels[j] : nbr[i, j] != 0 },  or 2^30 if row i is empty
//
// Replaces: gcanet_tpu/ops/cc_pallas.py::masked_min_sweep (Pallas body
// _sweep_kernel), the one TPU kernel of the JAX package.  The loop around it
// (min with the old labels, two pointer jumps, the convergence test) stays in
// PyTorch: gcanet_tpu_torch/ops/cc.py.
//
// Bound: the sweep reads the N x N mask once (one byte per entry) and a few
// labels; it is bound by bytes.  At N = 7000 that is 49 MB, about 15 us at
// the 3.35 TB/s of an 80 GB H100 SXM.  49 MB is just under the 50 MB L2, so
// repeated sweeps over one mask may be served partly from L2.
//
// Design: one warp per row.  Lanes stream the row with 16-byte loads
// (neighbouring lanes on neighbouring addresses), skip an all-zero vector
// with one OR, and read labels[j] only where the mask byte is non-zero: the
// gated radius graph is sparse, so label reads are few and hit L1/L2.  The
// row's minimum is reduced with warp shuffles and lane 0 writes it.  A row
// of N bytes need not start on a 16-byte boundary (N = 7000: 7000 mod 16 = 8),
// so each row handles its unaligned head and its tail byte by byte; any row
// stride works and a torch bool tensor is read in place as 0/1 bytes.
// No shared memory, no atomics, nothing allocated: the wrapper allocates
// `out`, and the launch goes on the caller's stream.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBigLabel = 1 << 30;
constexpr int kWarpsPerBlock = 8;

// Minimum of labels[j0 + b] over the non-zero bytes b of a 4-byte mask word.
__device__ __forceinline__ int min_over_word(uint32_t word, int j0,
                                             const int* __restrict__ labels,
                                             int m) {
  while (word) {
    const int byte = (__ffs(word) - 1) >> 3;
    m = min(m, __ldg(labels + j0 + byte));
    word &= ~(0xFFu << (byte * 8));
  }
  return m;
}

__global__ void __launch_bounds__(32 * kWarpsPerBlock)
masked_min_sweep_kernel(const uint8_t* __restrict__ nbr, long long row_stride,
                        const int* __restrict__ labels, int* __restrict__ out,
                        int n) {
  const int row_id = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row_id >= n) return;  // uniform across the warp
  const uint8_t* row = nbr + static_cast<long long>(row_id) * row_stride;

  int m = kBigLabel;
  // unaligned head: at most 15 bytes, one per lane
  int head = static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) & 15);
  if (head > n) head = n;
  if (lane < head && row[lane]) m = __ldg(labels + lane);

  // aligned body: 16 bytes per lane per step
  const int nvec = (n - head) >> 4;
  const uint4* vec = reinterpret_cast<const uint4*>(row + head);
  for (int v = lane; v < nvec; v += 32) {
    const uint4 w = __ldg(vec + v);
    if ((w.x | w.y | w.z | w.w) == 0u) continue;
    const int j0 = head + (v << 4);
    m = min_over_word(w.x, j0, labels, m);
    m = min_over_word(w.y, j0 + 4, labels, m);
    m = min_over_word(w.z, j0 + 8, labels, m);
    m = min_over_word(w.w, j0 + 12, labels, m);
  }

  // tail: fewer than 16 bytes, one per lane
  const int j = head + (nvec << 4) + lane;
  if (j < n && row[j]) m = min(m, __ldg(labels + j));

#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    m = min(m, __shfl_xor_sync(0xffffffffu, m, off));
  if (lane == 0) out[row_id] = m;
}

}  // namespace

// C interface, loaded with ctypes.  nbr: [n, n] bytes (0/1) with the given
// row stride in bytes; labels, out: [n] int32.  Returns cudaGetLastError().
extern "C" int cc_masked_min_sweep(const void* nbr, long long row_stride,
                                   const void* labels, void* out, int n,
                                   void* stream) {
  if (n <= 0) return static_cast<int>(cudaSuccess);
  const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  masked_min_sweep_kernel<<<blocks, 32 * kWarpsPerBlock, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(nbr), row_stride,
      static_cast<const int*>(labels), static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
