// Wide segment sum for Hopper (sm_90a): out[p, j] = sum over rows r with
// pk[r] == p of cols[r, j], in exact int32 arithmetic, for the
// lane-major [N, n_lanes * D] fixed-point coordinate lanes of VECTOR_SUM.
//
// Replaces pipelinedp_tpu/ops/kernels/segsum.py::segment_sum_wide, the
// Pallas kernel that jax_engine._reduce_per_pk calls for VECTOR_SUM under
// the fx accumulator. The TPU kernel tiles D so that a [P, Dt] slab stays
// in VMEM and contracts a one-hot [P, R] block with the lanes on the MXU.
// On Hopper int32 addition is exact and associative, so partial sums and
// atomics in any order give the totals of index_add_ (or
// jax.ops.segment_sum) bit for bit; every partial sum adds a subset of one
// partition's rows of one lane, below the partition's total, which the
// lane plan (_fx_plan) keeps under 2^31.
//
// Bound on the H100: the kernel must read N * W * 4 bytes of lanes and
// N * 4 of keys and write P * W * 4: at the JAX bench's widths (2048
// public partitions) about 1.55 GB at D = 64 (N = 2M, W = 192), 0.46 ms
// at 3.35 TB/s, and about 1.03-1.04 GB, 0.31 ms, at D = 256 and 1024.
//
// The lanes are dense (the 2^23 offset makes nearly every element
// nonzero) and zipf(1.3) keys put about a quarter of the rows into one
// partition, so each block privatises a [P, T] accumulator in shared
// memory for a tile of T consecutive columns and a chunk of rows. The
// first design (T <= 32 in 96 KB so that three blocks shared an SM, 4-byte
// loads, four rows in flight, a shared atomic per element) kept too few
// bytes in flight and re-read every key W / 8 times at P = 2048. Now:
//   - of the tiles up to 64 columns (and up to W rounded up to 4) whose
//     accumulator fits kSmemBudget (200 KB), T is the widest multiple of
//     16, so that a block reads whole 64-byte pieces of each row, else the
//     widest multiple of 4; one block per SM. At P = 2048, T = 16 (keys
//     read W / 16 times) beat T = 24 (96-byte pieces) by 15-20%;
//   - threads are (threads / (T / 4)) row groups x (T / 4) column
//     vectors; each thread reads 4 columns of kRows = 2 rows with 16-byte
//     loads (4-byte loads when W % 4 != 0 or the pointer is not 16-byte
//     aligned) before it adds any of them: 32 KB in flight per SM;
//   - a thread first combines the rows it holds that share a key, then
//     adds each nonzero sum to acc[pk, c] with a shared-memory atomic;
//   - the block flushes every nonzero accumulator word with one global
//     atomic. The row chunks per column tile are chosen so that the grid
//     fills whole waves of resident blocks.
// The design rule by (W, P): this shared-memory design while T >= 4 fits,
// that is P <= 12800; above that the wrapper launches K1's kernel
// (csrc/segsum_lanes.cu: 16-byte loads, hot keys combined in shared
// memory, other keys' global atomics spread over many addresses), which
// takes any width. This rule is stated here only: segsum_wide_tile(W, P)
// answers it for the wrapper (0 for K1's kernels).
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/segsum_ab.py, through the
// wrappers of this checkout and of the one with the first design, in
// turns): 0.61-0.63 ms on the D = 64 stack (first design 1.41-1.43),
// 0.42-0.43 ms at D = 256 (0.89-0.91) and 0.43-0.46 ms at D = 1024
// (0.84-0.86), 1.3-1.5x the bound; K1's kernels at P = 65536 on a dense
// zipf(1.3) D = 64 stack 1.08-1.12 ms (first design's global atomics
// 4.09-4.17).
//
// Rows whose pk lies outside [0, P) are dropped, as jax.ops.segment_sum
// drops them. The kernel allocates nothing (the launch zeroes out, which
// the wrapper allocates), runs on the caller's stream and does not
// synchronise.

#include <cstdint>

#include <cuda_runtime.h>


namespace {

constexpr int kMaxThreads = 1024;
constexpr int kSmemBudget = 200 * 1024;
constexpr int kMaxTile = 64;
constexpr int kRows = 2;  // rows in flight per thread (beat 1, 3, 4 and 8)

template <bool kVec>
__device__ __forceinline__ int4 load4(const int32_t* __restrict__ row,
                                      int c, int width) {
  if (kVec) return __ldcs(reinterpret_cast<const int4*>(row + c));
  int4 v;
  v.x = c < width ? __ldcs(row + c) : 0;
  v.y = c + 1 < width ? __ldcs(row + c + 1) : 0;
  v.z = c + 2 < width ? __ldcs(row + c + 2) : 0;
  v.w = c + 3 < width ? __ldcs(row + c + 3) : 0;
  return v;
}

__device__ __forceinline__ void add4(int32_t* a, const int4& v) {
  if (v.x) atomicAdd(a, v.x);
  if (v.y) atomicAdd(a + 1, v.y);
  if (v.z) atomicAdd(a + 2, v.z);
  if (v.w) atomicAdd(a + 3, v.w);
}

template <bool kVec>
__global__ void __launch_bounds__(kMaxThreads, 1)
    segsum_wide_smem_kernel(const int32_t* __restrict__ cols,
                            const int32_t* __restrict__ pk,
                            int32_t* __restrict__ out, int64_t n_rows,
                            int32_t width, int32_t n_parts, int32_t tile,
                            int64_t rows_per_chunk) {
  extern __shared__ int4 acc4[];  // [n_parts, tile / 4]
  int32_t* acc = reinterpret_cast<int32_t*>(acc4);
  const int t4 = tile / 4;
  const int groups = blockDim.x / t4;
  const int g = threadIdx.x / t4;
  const int c4 = threadIdx.x - g * t4;
  const int c = blockIdx.x * tile + 4 * c4;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * rows_per_chunk;
  const int64_t r_end =
      r_begin + rows_per_chunk < n_rows ? r_begin + rows_per_chunk : n_rows;
  const int acc_vec = n_parts * t4;
  for (int i = threadIdx.x; i < acc_vec; i += blockDim.x) {
    acc4[i] = make_int4(0, 0, 0, 0);
  }
  __syncthreads();

  if (c < width) {
    const int64_t step = static_cast<int64_t>(groups) * kRows;
    for (int64_t r0 = r_begin + g; r0 < r_end; r0 += step) {
      int4 v[kRows];
      int32_t p[kRows];
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        const int64_t r = r0 + static_cast<int64_t>(k) * groups;
        const bool in = r < r_end;
        p[k] = in ? __ldg(pk + r) : -1;
        v[k] = in ? load4<kVec>(cols + r * width, c, width)
                  : make_int4(0, 0, 0, 0);
      }
      // Rows of one key are summed in registers first.
#pragma unroll
      for (int k = 1; k < kRows; ++k) {
#pragma unroll
        for (int j = 0; j < k; ++j) {
          if (p[k] >= 0 && p[j] == p[k]) {
            v[j].x += v[k].x;
            v[j].y += v[k].y;
            v[j].z += v[k].z;
            v[j].w += v[k].w;
            p[k] = -1;
          }
        }
      }
#pragma unroll
      for (int k = 0; k < kRows; ++k) {
        if (p[k] >= 0 && p[k] < n_parts) add4(acc + p[k] * tile + 4 * c4, v[k]);
      }
    }
  }
  __syncthreads();

  const int acc_size = n_parts * tile;
  for (int i = threadIdx.x; i < acc_size; i += blockDim.x) {
    const int32_t s = acc[i];
    const int part = i / tile;
    const int col = blockIdx.x * tile + (i - part * tile);
    if (s != 0 && col < width) {
      atomicAdd(out + static_cast<int64_t>(part) * width + col, s);
    }
  }
}

int tile_for(int width, int n_parts) {
  const int w4 = (width + 3) / 4 * 4;
  const int cap = w4 < kMaxTile ? w4 : kMaxTile;
  // Whole 64-byte row pieces first, then any multiple of 4 columns.
  for (int step = 16; step >= 4; step /= 4) {
    int t = cap / step * step;
    while (t >= step &&
           static_cast<int64_t>(n_parts) * t * 4 > kSmemBudget) {
      t -= step;
    }
    if (t >= step) return t;
  }
  return 0;
}

// Row chunks per column tile: the count (up to three waves' worth) whose
// grid fills its last wave of resident blocks best, the fewest on a tie.
int64_t chunks_for(int64_t tiles, int64_t slots, int64_t max_chunks) {
  int64_t best = 1;
  double best_fill = 0.0;
  const int64_t top = (3 * slots + tiles - 1) / tiles;
  for (int64_t c = 1; c <= top && c <= max_chunks; ++c) {
    const int64_t blocks = tiles * c;
    const int64_t waves = (blocks + slots - 1) / slots;
    const double fill = static_cast<double>(blocks) / (waves * slots);
    if (fill > best_fill + 1e-9) {
      best_fill = fill;
      best = c;
    }
  }
  return best;
}

// Blocks of segsum_wide_smem_kernel<kVec> of the given threads that fit
// an SM with smem bytes of dynamic shared memory, after raising the
// kernel's limit to smem. Kept for the next launch on the same device with
// the same shape: the queries take host time while the card waits after
// the output's zeroing.
template <bool kVec>
cudaError_t blocks_per_sm(int device, size_t smem, int threads,
                          int* per_sm) {
  static int cached_device = -1;
  static size_t cached_smem = 0;
  static int cached_threads = 0;
  static int cached = 0;
  if (device != cached_device || smem != cached_smem ||
      threads != cached_threads) {
    cudaError_t err = cudaFuncSetAttribute(
        segsum_wide_smem_kernel<kVec>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, segsum_wide_smem_kernel<kVec>, threads, smem);
    if (err != cudaSuccess) return err;
    cached = n < 1 ? 1 : n;
    cached_device = device;
    cached_smem = smem;
    cached_threads = threads;
  }
  *per_sm = cached;
  return cudaSuccess;
}

template <bool kVec>
cudaError_t launch_smem(const int32_t* cols, const int32_t* pk, int32_t* out,
                        int64_t n_rows, int width, int n_parts, int tile,
                        int device, int n_sm, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(n_parts) * tile * sizeof(int32_t);
  const int t4 = tile / 4;
  const int threads = kMaxThreads / t4 * t4;
  int per_sm = 0;
  const cudaError_t err = blocks_per_sm<kVec>(device, smem, threads, &per_sm);
  if (err != cudaSuccess) return err;
  const int64_t tiles = (width + tile - 1) / tile;
  const int64_t groups = threads / t4;
  int64_t max_chunks = (n_rows + groups - 1) / groups;
  if (max_chunks > 65535) max_chunks = 65535;
  const int64_t chunks =
      chunks_for(tiles, static_cast<int64_t>(n_sm) * per_sm, max_chunks);
  const int64_t rows_per_chunk = (n_rows + chunks - 1) / chunks;
  const dim3 grid(static_cast<unsigned>(tiles), static_cast<unsigned>(chunks));
  segsum_wide_smem_kernel<kVec><<<grid, threads, smem, stream>>>(
      cols, pk, out, n_rows, width, n_parts, tile, rows_per_chunk);
  return cudaGetLastError();
}

}  // namespace

// The column tile of the shared-memory design for [*, width] lanes over
// n_parts partitions, or 0 when the wrapper takes K1's design.
extern "C" int segsum_wide_tile(int width, int n_parts) {
  return tile_for(width, n_parts);
}

// cols: int32 [n_rows, width] contiguous; pk: int32 [n_rows];
// out: int32 [n_parts, width], written in full (zeroed first). Only for
// segsum_wide_tile(width, n_parts) > 0: returns cudaErrorInvalidValue
// otherwise. Returns the CUDA error code of the launch (0 on success).
extern "C" int segsum_wide_launch(const void* cols_v, const void* pk_v,
                                  void* out_v, long long n_rows, int width,
                                  int n_parts, void* stream_v) {
  const int tile = tile_for(width, n_parts);
  if (tile == 0) return static_cast<int>(cudaErrorInvalidValue);
  const auto* cols = static_cast<const int32_t*>(cols_v);
  const auto* pk = static_cast<const int32_t*>(pk_v);
  auto* out = static_cast<int32_t*>(out_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  cudaError_t err = cudaMemsetAsync(
      out, 0, static_cast<size_t>(n_parts) * width * sizeof(int32_t), stream);
  if (err != cudaSuccess || n_rows == 0) return static_cast<int>(err);
  int device = 0;
  err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = width % 4 == 0 &&
                   (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
  return static_cast<int>(
      vec ? launch_smem<true>(cols, pk, out, n_rows, width, n_parts, tile,
                              device, n_sm, stream)
          : launch_smem<false>(cols, pk, out, n_rows, width, n_parts, tile,
                               device, n_sm, stream));
}
