// Ordered float32 segment totals for Hopper (sm_90a):
//
//   out[i] = (((0 + x[s]) + x[s + 1]) + ...) + x[e - 1]
//
// for every row i of the segment [s, e): a run of rows that starts at a
// row whose flag new_seg is set (row 0 always starts one) and ends before
// the next such row. Every add is a float32 __fadd_rn, strictly left to
// right from +0.0, so the total has the bits of a sequential fold.
//
// K4 is a port-only kernel. It replaces the XLA scatter
// jax.ops.segment_sum(masked, seg_ord, num_segments=n) of
// pipelinedp_tpu/jax_engine.py::_partials (the per-partition-sum-bounds
// SUM), which XLA's CPU backend runs as a loop over the updates in row
// order. The total is clipped to [min_sum, max_sum] and then quantized,
// so its last bit decides released bits: atomics (index_add_), cumsum
// differences and tree reductions all round differently. Order is the
// whole contract, so a segment's adds form one dependent chain that no
// number of threads can shorten.
//
// Design, two launches on the caller's stream, no host synchronisation:
//
// 1. segtotal_short: a block stages a tile of kTile rows and the kShort
//    rows after it (values and flags, coalesced) in shared memory, with
//    the flags as one ballot word per 32 rows. The thread of each row
//    that starts a segment finds the segment's end from the words (the
//    next set bit), so its fold reads shared memory at known addresses
//    and only the float32 add chain orders it. A segment of more than
//    kShort rows goes to a list (one global atomic on a counter) for
//    launch 2. Most segments of a bounded table are short: the
//    flagship's per-partition stack has its longest (user, partition)
//    run at 70 rows among 25M, so almost every row is summed here.
// 2. segtotal_long: one warp per listed segment (warps stride over the
//    list, whose length they read from device memory). A ring of
//    kStages chunks of kChunk values and flags in shared memory is fed
//    by cp.async, kStages - 1 chunks ahead of the fold, so about 8 KB
//    are in flight for each segment; every lane holds the running total
//    and adds the staged values in order up to the first flagged row (a
//    warp minimum finds it). Then the warp writes the total to the
//    segment's rows with coalesced stores.
//
// Bound on the H100: the kernel reads x (4 bytes) and the flag (1 byte)
// of every row and writes the total (4 bytes): 9 bytes per row, 0.067 ms
// for the flagship's 25M rows at 3.35 TB/s; one add per row is far below
// any compute limit. A long segment is latency-bound instead: its L adds
// form one chain of L dependent float32 adds (about 4 cycles each), so a
// segment of 2^20 rows takes at least about 2.1 ms at 1.98 GHz however
// the loads are arranged; the ring keeps the loads ahead of that chain.
//
// cp.async needs x 16-byte and new_seg 8-byte aligned; the wrapper hands
// the kernel such buffers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 256;    // rows a segtotal_short block stages
constexpr int kShort = 64;    // the longest segment launch 1 folds
constexpr int kWindow = kTile + kShort;
constexpr int kChunk = 256;   // values of one ring stage of launch 2
constexpr int kStages = 8;    // ring stages of launch 2
constexpr unsigned kFull = 0xffffffffu;

__global__ void segtotal_short(const float* __restrict__ x,
                               const uint8_t* __restrict__ new_seg,
                               float* __restrict__ out, int64_t n,
                               int64_t* __restrict__ long_starts,
                               int32_t* __restrict__ n_long) {
  __shared__ float xs[kWindow];
  __shared__ unsigned starts[kWindow / 32];
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile; t0 < n;
       t0 += static_cast<int64_t>(gridDim.x) * kTile) {
    // kWindow and blockDim.x (kTile) are multiples of 32, so every warp
    // runs each pass whole and its ballot sees 32 rows.
    for (int i = threadIdx.x; i < kWindow; i += blockDim.x) {
      const int64_t r = t0 + i;
      const bool in = r < n;
      xs[i] = in ? x[r] : 0.0f;
      // A row past the table ends the segment before it, like a start.
      const bool start = !in || r == 0 || new_seg[r] != 0;
      const unsigned word = __ballot_sync(kFull, start);
      if ((i & 31) == 0) starts[i >> 5] = word;
    }
    __syncthreads();
    const int i = threadIdx.x;
    const int64_t r = t0 + i;
    if (r < n && ((starts[i >> 5] >> (i & 31)) & 1u)) {
      // The next start after row i within the window.
      int e = -1;
      const int j = i + 1;
      for (int w = j >> 5; w < kWindow / 32; ++w) {
        unsigned bits = starts[w];
        if (w == (j >> 5)) bits &= kFull << (j & 31);
        if (bits != 0) {
          e = w * 32 + __ffs(bits) - 1;
          break;
        }
      }
      if (e < 0 || e - i > kShort) {
        long_starts[atomicAdd(n_long, 1)] = r;
      } else {
        float s = 0.0f;
#pragma unroll 8
        for (int k = i; k < e; ++k) s = __fadd_rn(s, xs[k]);
        for (int k = i; k < e; ++k) out[t0 + k] = s;
      }
    }
    __syncthreads();
  }
}

__device__ __forceinline__ void cp_async(void* smem, const void* gmem,
                                         int bytes, int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(gmem), "r"(src_bytes));
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Lane `lane`'s share of chunk `base` (a multiple of kChunk): values
// [base + 8 lane, + 8) and their flags, zero-filled past the table.
__device__ __forceinline__ void copy_chunk_async(
    const float* __restrict__ x, const uint8_t* __restrict__ flags,
    int64_t n, int64_t base, float* xs, uint8_t* fs, int lane) {
  const int64_t first = base + 8 * lane;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int64_t at = first + 4 * h;
    const int64_t left = n - at;
    const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * static_cast<int>(left)
                                                 : 0);
    cp_async(xs + 8 * lane + 4 * h, bytes > 0 ? x + at : x, 16, bytes);
  }
  const int64_t left = n - first;
  const int fbytes = left >= 8 ? 8 : (left > 0 ? static_cast<int>(left) : 0);
  cp_async(fs + 8 * lane, fbytes > 0 ? flags + first : flags, 8, fbytes);
}

__global__ void segtotal_long(const float* __restrict__ x,
                              const uint8_t* __restrict__ new_seg,
                              float* __restrict__ out, int64_t n,
                              const int64_t* __restrict__ long_starts,
                              const int32_t* __restrict__ n_long) {
  // One warp per block.
  __shared__ __align__(16) float xs[kStages][kChunk];
  __shared__ __align__(16) uint8_t fs[kStages][kChunk];
  const int lane = threadIdx.x;
  const int64_t count = *n_long;
  for (int64_t w = blockIdx.x; w < count; w += gridDim.x) {
    const int64_t start = long_starts[w];
    const int64_t base0 = start - start % kChunk;
#pragma unroll
    for (int p = 0; p < kStages - 1; ++p) {
      copy_chunk_async(x, new_seg, n, base0 + p * kChunk, xs[p], fs[p],
                       lane);
      cp_async_commit();
    }
    float s = 0.0f;
    int64_t end = -1;
    for (int64_t c = 0; end < 0; ++c) {
      cp_async_wait<kStages - 2>();
      __syncwarp();
      const int stage = static_cast<int>(c % kStages);
      const int64_t base = base0 + c * kChunk;
      // The segment's rows in this chunk begin at lo; a flag from `from`
      // on ends it (the start's own flag does not).
      const int lo = c == 0 ? static_cast<int>(start - base0) : 0;
      const int from = c == 0 ? lo + 1 : 0;
      const int valid = n - base < kChunk ? static_cast<int>(n - base)
                                          : kChunk;
      int stop = valid;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int k = 8 * lane + q;
        if (k >= from && k < stop && fs[stage][k] != 0) stop = k;
      }
      stop = static_cast<int>(__reduce_min_sync(kFull,
                                                static_cast<unsigned>(stop)));
      const float* v = xs[stage];
#pragma unroll 8
      for (int k = lo; k < stop; ++k) s = __fadd_rn(s, v[k]);
      if (stop < kChunk) end = base + stop;
      __syncwarp();
      copy_chunk_async(x, new_seg, n, base0 + (c + kStages - 1) * kChunk,
                       xs[(c + kStages - 1) % kStages],
                       fs[(c + kStages - 1) % kStages], lane);
      cp_async_commit();
    }
    // Drain the copies still in flight before the ring is reused.
    cp_async_wait<0>();
    __syncwarp();
    for (int64_t k = start + lane; k < end; k += 32) out[k] = s;
  }
}

}  // namespace

// x: float32 [n], 16-byte aligned; new_seg: uint8 [n] (torch.bool),
// 8-byte aligned; out: float32 [n]; long_starts: int64 scratch of
// n / kShort + 1 entries; n_long: int32 [1], zeroed by the caller.
// Returns the CUDA error code of the launches (0 on success).
extern "C" int segtotal_launch(const void* x, const void* new_seg, void* out,
                               void* long_starts, void* n_long, long long n,
                               void* stream) {
  if (n == 0) return 0;
  static int n_sm = 0;
  if (n_sm == 0) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kTile - 1) / kTile;
  const int64_t cap = static_cast<int64_t>(n_sm) * 8;
  const int blocks = static_cast<int>(tiles < cap ? tiles : cap);
  segtotal_short<<<blocks, kTile, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(new_seg),
      static_cast<float*>(out), static_cast<int64_t>(n),
      static_cast<int64_t*>(long_starts), static_cast<int32_t*>(n_long));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // One warp a block, sixteen blocks an SM: the long segments' warps.
  segtotal_long<<<n_sm * 16, 32, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(new_seg),
      static_cast<float*>(out), static_cast<int64_t>(n),
      static_cast<const int64_t*>(long_starts),
      static_cast<const int32_t*>(n_long));
  return static_cast<int>(cudaGetLastError());
}
