// Ordered float32 keyed segment sums over many columns, for Hopper
// (sm_90a):
//
//   out[p, w] = (((0 + x[r0, w]) + x[r1, w]) + ...) + x[rk, w]
//
// where r0 < r1 < ... < rk are the rows whose key is p, in row order.
// Every add is a float32 __fadd_rn from +0.0, one row after another, so
// each total has the bits of a sequential fold; a key with no rows
// totals +0.0.
//
// K5 is a port-only kernel. It replaces the XLA scatter
// jax.ops.segment_sum(cols, pk_safe, num_segments=P) of the utility-
// analysis sweep (pipelinedp_tpu/analysis/jax_sweep.py: per_pk, [n, Cc, 5]
// per metric, and mom_pk, [n, Cc, 3] under private partition selection),
// which XLA's CPU backend runs as a loop over the updates in row order.
// Those sums feed clipping, square roots and the keep-probability window,
// so their last bit decides released bits: atomics (index_add_) and tree
// reductions round differently.
//
// The keys are the same for every config chunk of a sweep, so the caller
// hands the kernel a row order computed once: `order`, the rows sorted by
// key (a stable sort, so each key's rows stay in row order), and
// `offsets`, where key p's rows are order[offsets[p] .. offsets[p + 1]).
//
// Design (a simple first one): a block of kThreads threads takes
// kThreads adjacent columns of one key (blockIdx.y, striding by
// gridDim.y), a thread one column. The 32 lanes of a warp read 32
// adjacent floats of the same row, so every row read is one coalesced
// 128-byte line; the row index is the same for the whole warp (a
// broadcast load). A thread's adds form one dependent chain, so the
// loads of the next kDepth rows are issued before the adds of the
// current kDepth rows: the chain never waits on memory as long as a
// group's loads finish within kDepth adds' time.
//
// Bound on the H100: the kernel reads every value once (4 n W bytes), the
// order (4 n) and writes the totals (4 P W): about 1.3 GB, 0.39 ms at
// 3.35 TB/s for config 5's [500k, 650] count stack. A key's L rows are L
// dependent float32 adds (4.05 cycles each, measured on the H100 for
// K4), so the longest key takes at least 4 L cycles however the columns
// are split: 127k rows, 0.26 ms at 1.98 GHz, for config 5's hottest key.
// The kernel's bound is the larger of the two.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;  // columns of a block: four warps of 32
constexpr int kDepth = 16;     // rows whose loads run ahead of the adds
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ void load_group(const float* __restrict__ x,
                                           const int32_t* __restrict__ order,
                                           int64_t r, int64_t W, int col,
                                           float (&v)[kDepth]) {
  int32_t row[kDepth];
#pragma unroll
  for (int k = 0; k < kDepth; ++k) row[k] = __ldg(order + r + k);
#pragma unroll
  for (int k = 0; k < kDepth; ++k)
    v[k] = __ldg(x + static_cast<int64_t>(row[k]) * W + col);
}

__global__ void __launch_bounds__(kThreads)
    segkeyed_fold(const float* __restrict__ x,
                  const int32_t* __restrict__ order,
                  const int64_t* __restrict__ offsets,
                  float* __restrict__ out, int64_t W, int P) {
  const int col = blockIdx.x * kThreads + threadIdx.x;
  if (col >= W) return;
  for (int p = blockIdx.y; p < P; p += gridDim.y) {
    int64_t r = offsets[p];
    const int64_t end = offsets[p + 1];
    const int64_t groups = (end - r) / kDepth;
    float acc = 0.0f;
    float cur[kDepth];
    float nxt[kDepth];
    if (groups > 0) load_group(x, order, r, W, col, cur);
    for (int64_t g = 0; g < groups; ++g) {
      const int64_t r_next = r + kDepth;
      if (g + 1 < groups) load_group(x, order, r_next, W, col, nxt);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) acc = __fadd_rn(acc, cur[k]);
#pragma unroll
      for (int k = 0; k < kDepth; ++k) cur[k] = nxt[k];
      r = r_next;
    }
    for (; r < end; ++r)
      acc = __fadd_rn(acc, __ldg(x + static_cast<int64_t>(order[r]) * W + col));
    out[static_cast<int64_t>(p) * W + col] = acc;
  }
}

}  // namespace

// x: float32 [n, W] row-major; order: int32 [n]; offsets: int64 [P + 1];
// out: float32 [P, W]. Runs on `stream`; returns a cudaError_t.
extern "C" int segkeyed_launch(const void* x, const void* order,
                               const void* offsets, void* out, long long n,
                               long long W, int P, void* stream) {
  if (P <= 0 || W <= 0) return 0;
  (void)n;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>((W + kThreads - 1) / kThreads),
                  static_cast<unsigned>(P < kMaxGridY ? P : kMaxGridY));
  segkeyed_fold<<<grid, kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const int32_t*>(order),
      static_cast<const int64_t*>(offsets), static_cast<float*>(out),
      static_cast<int64_t>(W), P);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segkeyed_block_cols() { return kThreads; }
extern "C" int segkeyed_depth_rows() { return kDepth; }
