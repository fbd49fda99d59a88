// Lane segment sum for Hopper (sm_90a): out[p, c] = sum over rows r with
// pk[r] == p of cols[r, c], in exact int32 arithmetic.
//
// Replaces pipelinedp_tpu/ops/kernels/segsum.py::segment_sum_lanes, the
// Pallas kernel that fills the [N, C] segment-sum slot of
// jax_engine._reduce_per_pk. The TPU kernel contracts a one-hot [P, R]
// block with the lanes on the MXU; on Hopper, int32 addition is exact and
// associative, so atomics in any order give the same totals as
// index_add_ (or jax.ops.segment_sum) bit for bit.
//
// Design: one thread per element of the row-major [N, C] stack, in a
// grid-stride loop, so neighbouring threads read neighbouring words of
// cols. Each nonzero element adds itself to out[pk[row] * C + c] with a
// global int32 atomicAdd; zero elements (masked rows, empty lanes) issue
// no atomic, which changes no total. Rows whose pk lies outside [0, P)
// are dropped, as jax.ops.segment_sum drops them; the engine never
// produces one. The kernel allocates nothing (the wrapper zeroes out),
// runs on the caller's stream and does not synchronise.
//
// Bound on the H100: the kernel must read N * (C + 1) * 4 bytes (the
// lanes and the keys) and write P * C * 4. At the 25M-row MovieLens
// flagship shape (N = 25.0M, C = 6, P = 65536) that is about 0.7 GB, or
// about 0.21 ms at 3.35 TB/s, when every row holds a nonzero lane. The
// kernel reads pk only at rows with a nonzero lane, so on a sparser stack
// the bound is the cols bytes plus the pk sectors of those rows; the
// flagship's own stack (about 3% of rows nonzero) needs about 0.61 GB, or
// about 0.18 ms. Expected trouble: zipf(1.3) keys put about
// a quarter of all rows into one partition, so the atomics of that
// partition serialise on C addresses in L2. This first version keeps the
// plain atomics and its time is recorded in PERF.md; warp-aggregated or
// block-privatised accumulation is later work.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

__global__ void segsum_lanes_kernel(const int32_t* __restrict__ cols,
                                    const int32_t* __restrict__ pk,
                                    int32_t* __restrict__ out,
                                    int64_t total, int32_t n_cols,
                                    int32_t n_parts) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int32_t v = cols[i];
    if (v == 0) continue;
    const int64_t row = i / n_cols;
    const int32_t c = static_cast<int32_t>(i - row * n_cols);
    const int32_t p = pk[row];
    if (p < 0 || p >= n_parts) continue;
    atomicAdd(out + static_cast<int64_t>(p) * n_cols + c, v);
  }
}

}  // namespace

// cols: int32 [n_rows, n_cols] contiguous; pk: int32 [n_rows];
// out: int32 [n_parts, n_cols], zeroed by the caller. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int segsum_lanes_launch(const void* cols, const void* pk,
                                   void* out, long long n_rows, int n_cols,
                                   int n_parts, void* stream) {
  const int64_t total = static_cast<int64_t>(n_rows) * n_cols;
  if (total == 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = 256;
  const int64_t needed = (total + threads - 1) / threads;
  const int64_t cap = static_cast<int64_t>(n_sm) * 8;  // 8 blocks per SM
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  segsum_lanes_kernel<<<blocks, threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(cols), static_cast<const int32_t*>(pk),
      static_cast<int32_t*>(out), total, n_cols, n_parts);
  return static_cast<int>(cudaGetLastError());
}
