// Wide segment sum for Hopper (sm_90a): out[p, j] = sum over rows r with
// pk[r] == p of cols[r, j], in exact int32 arithmetic, for the
// lane-major [N, n_lanes * D] fixed-point coordinate lanes of VECTOR_SUM.
//
// Replaces pipelinedp_tpu/ops/kernels/segsum.py::segment_sum_wide, the
// Pallas kernel that jax_engine._reduce_per_pk calls for VECTOR_SUM under
// the fx accumulator. The TPU kernel tiles D so that a [P, Dt] slab stays
// in VMEM and contracts a one-hot [P, R] block with the lanes on the MXU.
// On Hopper int32 addition is exact and associative, so atomics in any
// order give the totals of index_add_ (or jax.ops.segment_sum) bit for
// bit; the TPU's VMEM tile hint (segsum_wide_d_block) has no counterpart.
//
// Design. Unlike K1's stack, these lanes are dense: every kept row is
// nonzero in almost every plane (the 2^23 offset), and zipf(1.3) keys put
// about a quarter of the rows into one partition. One global atomic per
// element would serialise N * W / 4 atomics on that partition's W
// addresses. So each block privatises a [P, T] accumulator in shared
// memory for a tile of T consecutive columns and a chunk of rows:
//   - grid (ceil(W / T), chunks); 256 threads as (256 / T) rows x T
//     columns, so neighbouring threads read neighbouring words of a row
//     (T * 4 bytes of each row, whole 32-byte sectors from T = 8 up);
//   - each thread loads four rows' values and keys before it adds them,
//     so four loads are in flight per thread; each nonzero element adds
//     itself to acc[pk[r]][c] with a shared-memory atomic;
//   - the block then flushes every nonzero accumulator with one global
//     atomic: at most chunks * P * W of them in all, against N * W loads.
// T is the widest power of two up to 32 (and up to W rounded up to a
// power of two) whose accumulator fits kSmemBudget; the chunk count fills
// one wave of resident blocks. When even T = 1 does not fit (P > 24576)
// the kernel takes K1's design instead: one thread per element, one
// global atomic per nonzero element.
//
// Rows whose pk lies outside [0, P) are dropped, as jax.ops.segment_sum
// drops them. The kernels allocate nothing (the wrapper zeroes out), run
// on the caller's stream and do not synchronise.
//
// Bound on the H100: the kernel must read N * W * 4 bytes of lanes and
// N * 4 of keys and write P * W * 4: at the JAX bench's widths (2048
// public partitions) about 1.55 GB at D = 64 (N = 2M, W = 192), 0.46 ms
// at 3.35 TB/s, and about 1.03-1.04 GB, 0.31 ms, at D = 256 and 1024.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSmemBudget = 96 * 1024;  // three blocks fit an SM's 227 KB
constexpr int kRowsInFlight = 4;

template <int T>
__global__ void __launch_bounds__(kThreads)
    segsum_wide_smem_kernel(const int32_t* __restrict__ cols,
                            const int32_t* __restrict__ pk,
                            int32_t* __restrict__ out, int64_t n_rows,
                            int32_t width, int32_t n_parts,
                            int64_t rows_per_chunk) {
  extern __shared__ int32_t acc[];  // [n_parts, T]
  constexpr int kRowStep = kThreads / T;
  const int lane_c = threadIdx.x % T;
  const int64_t c = static_cast<int64_t>(blockIdx.x) * T + lane_c;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * rows_per_chunk;
  const int64_t r_end =
      r_begin + rows_per_chunk < n_rows ? r_begin + rows_per_chunk : n_rows;
  const int acc_size = n_parts * T;
  for (int i = threadIdx.x; i < acc_size; i += kThreads) acc[i] = 0;
  __syncthreads();

  if (c < width) {
    for (int64_t r0 = r_begin + threadIdx.x / T; r0 < r_end;
         r0 += static_cast<int64_t>(kRowStep) * kRowsInFlight) {
      int32_t v[kRowsInFlight];
      int32_t p[kRowsInFlight];
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        const int64_t r = r0 + static_cast<int64_t>(k) * kRowStep;
        v[k] = r < r_end ? cols[r * width + c] : 0;
        p[k] = r < r_end ? pk[r] : -1;
      }
#pragma unroll
      for (int k = 0; k < kRowsInFlight; ++k) {
        if (v[k] != 0 && p[k] >= 0 && p[k] < n_parts) {
          atomicAdd(acc + p[k] * T + lane_c, v[k]);
        }
      }
    }
  }
  __syncthreads();

  for (int i = threadIdx.x; i < acc_size; i += kThreads) {
    const int32_t s = acc[i];
    const int64_t col = static_cast<int64_t>(blockIdx.x) * T + i % T;
    if (s != 0 && col < width) {
      atomicAdd(out + static_cast<int64_t>(i / T) * width + col, s);
    }
  }
}

__global__ void segsum_wide_global_kernel(const int32_t* __restrict__ cols,
                                          const int32_t* __restrict__ pk,
                                          int32_t* __restrict__ out,
                                          int64_t total, int32_t width,
                                          int32_t n_parts) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < total; i += stride) {
    const int32_t v = cols[i];
    if (v == 0) continue;
    const int64_t row = i / width;
    const int32_t p = pk[row];
    if (p < 0 || p >= n_parts) continue;
    atomicAdd(out + static_cast<int64_t>(p) * width + (i - row * width), v);
  }
}

int tile_for(int width, int n_parts) {
  int cap = 1;
  while (cap < width && cap < 32) cap *= 2;
  for (int t = cap; t >= 1; t /= 2) {
    if (static_cast<int64_t>(n_parts) * t * 4 <= kSmemBudget) return t;
  }
  return 0;
}

template <int T>
cudaError_t launch_smem(const int32_t* cols, const int32_t* pk, int32_t* out,
                        int64_t n_rows, int width, int n_parts, int n_sm,
                        cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_parts) * T * sizeof(int32_t);
  cudaError_t err = cudaFuncSetAttribute(
      segsum_wide_smem_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, segsum_wide_smem_kernel<T>, kThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) per_sm = 1;
  const int64_t tiles = (width + T - 1) / T;
  const int64_t wave = static_cast<int64_t>(n_sm) * per_sm;
  int64_t chunks = (wave + tiles - 1) / tiles;
  const int64_t row_step = kThreads / T;
  const int64_t max_chunks = (n_rows + row_step - 1) / row_step;
  if (chunks > max_chunks) chunks = max_chunks;
  if (chunks > 65535) chunks = 65535;
  if (chunks < 1) chunks = 1;
  const int64_t rows_per_chunk = (n_rows + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks));
  segsum_wide_smem_kernel<T><<<grid, kThreads, smem, stream>>>(
      cols, pk, out, n_rows, width, n_parts, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

// The column tile of the shared-memory design for [*, width] lanes over
// n_parts partitions, or 0 when the launch takes the global-atomic design.
extern "C" int segsum_wide_tile(int width, int n_parts) {
  return tile_for(width, n_parts);
}

// cols: int32 [n_rows, width] contiguous; pk: int32 [n_rows];
// out: int32 [n_parts, width], zeroed by the caller. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int segsum_wide_launch(const void* cols_v, const void* pk_v,
                                  void* out_v, long long n_rows, int width,
                                  int n_parts, void* stream_v) {
  if (n_rows == 0 || width == 0) return 0;
  const auto* cols = static_cast<const int32_t*>(cols_v);
  const auto* pk = static_cast<const int32_t*>(pk_v);
  auto* out = static_cast<int32_t*>(out_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (tile_for(width, n_parts)) {
    case 32:
      return static_cast<int>(launch_smem<32>(cols, pk, out, n_rows, width,
                                              n_parts, n_sm, stream));
    case 16:
      return static_cast<int>(launch_smem<16>(cols, pk, out, n_rows, width,
                                              n_parts, n_sm, stream));
    case 8:
      return static_cast<int>(launch_smem<8>(cols, pk, out, n_rows, width,
                                             n_parts, n_sm, stream));
    case 4:
      return static_cast<int>(launch_smem<4>(cols, pk, out, n_rows, width,
                                             n_parts, n_sm, stream));
    case 2:
      return static_cast<int>(launch_smem<2>(cols, pk, out, n_rows, width,
                                             n_parts, n_sm, stream));
    case 1:
      return static_cast<int>(launch_smem<1>(cols, pk, out, n_rows, width,
                                             n_parts, n_sm, stream));
    default:
      break;
  }
  const int64_t total = static_cast<int64_t>(n_rows) * width;
  const int64_t needed = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(n_sm) * 8;
  const int blocks = static_cast<int>(needed < cap ? needed : cap);
  segsum_wide_global_kernel<<<blocks, kThreads, 0, stream>>>(
      cols, pk, out, total, width, n_parts);
  return static_cast<int>(cudaGetLastError());
}
