// Multi-tile subtree-leaf histogram for Hopper (sm_90a):
//
//   out[t, p, q, s] = #{ r : kept[r],  qpk[r] - p_offsets[t] == p,
//                            leaf[r] - sub_starts[t, p, q] == s }
//
// for p < Pb and s < span, in exact int32 arithmetic.
//
// Replaces pipelinedp_tpu/ops/kernels/hist.py::hist_bin_multi, the Pallas
// kernel that bins one batch's rows into every packed [T, Pb, Qc, span]
// tile of the quantile walk's bottom levels. The TPU kernel keeps the
// whole output in VMEM and counts with two one-hot contractions per
// (tile, quantile) on the MXU, so it runs only inside a 4 MB envelope. On
// Hopper int32 atomics add exactly in any order, so the counts equal the
// per-tile scatter (jax_engine._subtree_counts) bit for bit, and the
// output may be as large as device memory: there is no envelope.
//
// Design: one thread per row in a grid-stride loop, so neighbouring
// threads read neighbouring words of qpk, leaf and kept. A row that is not
// kept reads nothing more. A kept row takes its tile-relative partition
// index in int32 (qpk - p_offsets[t], as the TPU kernel's docstring asks),
// skips tiles whose partition block does not hold it, gathers its Qc walk
// starts (random reads into [T, Pb, Qc], which L2 holds at the shapes the
// engine gives), and adds one to each bin whose leaf offset lies in
// [0, span) with a global int32 atomicAdd. The output index is int64:
// T * Pb * Qc * span passes 2^31 at about two million partitions. The
// kernel allocates nothing and does not zero `out`: it adds into it, so a
// streamed sweep accumulates every batch into one buffer (the wrapper
// zeroes a fresh output). It runs on the caller's stream and does not
// synchronise.
//
// Bound on the H100: the kernel must read the rows (N * 9 bytes), the
// starts and offsets, and write the output once (T * Pb * Qc * span * 4
// bytes); at BASELINE config 4 (N = 10M, P = 131072, Qc = 3, span = 256)
// that is about 0.49 GB, 0.15 ms at 3.35 TB/s, most of it the zeroing of
// the 403 MB output, which the wrapper does with a memset before the
// launch. Only rows inside a chosen subtree issue an atomic (about Q/256
// of the kept rows for values spread over the range), so the atomics are
// few. Expected trouble: the zipf hot partition sends all its in-subtree
// rows to Qc * span addresses, a few thousand atomics each at most; this
// first version keeps the plain atomics.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void hist_bin_kernel(const int32_t* __restrict__ qpk,
                                const int32_t* __restrict__ leaf,
                                const uint8_t* __restrict__ kept,
                                const int32_t* __restrict__ starts,
                                const int32_t* __restrict__ p_offsets,
                                int32_t* __restrict__ out, int64_t n_rows,
                                int32_t n_tiles, int32_t n_block,
                                int32_t n_quant, int32_t span) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < n_rows; r += stride) {
    if (kept[r] == 0) continue;
    const int32_t p = qpk[r];
    const int32_t l = leaf[r];
    for (int32_t t = 0; t < n_tiles; ++t) {
      // int32 differences, wrapping as the plain version's int32 tensors
      // wrap; unsigned compares put negative offsets out of range.
      const int32_t rel_p = static_cast<int32_t>(
          static_cast<uint32_t>(p) - static_cast<uint32_t>(p_offsets[t]));
      if (static_cast<uint32_t>(rel_p) >= static_cast<uint32_t>(n_block)) {
        continue;
      }
      const int64_t cell = (static_cast<int64_t>(t) * n_block + rel_p) *
                           n_quant;
      for (int32_t q = 0; q < n_quant; ++q) {
        const uint32_t s = static_cast<uint32_t>(l) -
                           static_cast<uint32_t>(starts[cell + q]);
        if (s >= static_cast<uint32_t>(span)) continue;
        atomicAdd(out + (cell + q) * span + s, 1);
      }
    }
  }
}

}  // namespace

// qpk, leaf: int32 [n_rows]; kept: uint8 [n_rows] (torch.bool);
// starts: int32 [n_tiles, n_block, n_quant]; p_offsets: int32 [n_tiles];
// out: int32 [n_tiles, n_block, n_quant, span], added into. Returns the
// CUDA error code of the launch (0 on success).
extern "C" int hist_bin_launch(const void* qpk, const void* leaf,
                               const void* kept, const void* starts,
                               const void* p_offsets, void* out,
                               long long n_rows, int n_tiles, int n_block,
                               int n_quant, int span, void* stream) {
  if (n_rows == 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int64_t needed = (n_rows + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(n_sm) * 8;  // 8 blocks per SM
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  hist_bin_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(qpk), static_cast<const int32_t*>(leaf),
      static_cast<const uint8_t*>(kept), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(p_offsets), static_cast<int32_t*>(out),
      static_cast<int64_t>(n_rows), n_tiles, n_block, n_quant, span);
  return static_cast<int>(cudaGetLastError());
}
