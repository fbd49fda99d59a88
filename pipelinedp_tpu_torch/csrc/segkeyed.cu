// Ordered float32 keyed segment sums over many columns, for Hopper
// (sm_90a):
//
//   out[p, w] = (((0 + x[r0, w]) + x[r1, w]) + ...) + x[rk, w]
//
// where r0 < r1 < ... < rk are key p's rows: the contiguous range
// offsets[p] .. offsets[p + 1] of x. Every add is a float32 __fadd_rn from
// +0.0, one row after another, so each total has the bits of a sequential
// fold; a key with no rows totals +0.0.
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
// The caller hands the kernel its rows in key order (each key's rows in
// row order; segkeyed.key_layout), computed once a sweep, and `walk`, the
// keys by row count, longest first.
//
// What bounds it on the H100. The bytes: every value read once and every
// total written once, 0.84 GB for config 5's [316669, 660] count stack,
// 0.25 ms at 3.35 TB/s. The chain: a key's L rows are L dependent float32
// adds (4.05 cycles each, measured for K4), so each of the key's columns
// takes at least 4 L cycles however the work is split: 19,969 rows, 0.04
// ms at 1.98 GHz, for that stack's longest key. A column's chain stalls
// whenever its next row is not yet on chip, so a long key's columns must
// get their bytes at the rate of their chain.
//
// Design. Units are taken longest first by a persistent grid of
// kWarpsPerSm one-warp blocks an SM from a counter, so the longest keys'
// tiles start first and the short ones fill in around them. Each lane
// folds one column out of a ring in shared memory ([stage][row][lane]);
// a key's rows are one contiguous range, so every address is known ahead
// of time and there is no index to load first.
//
// - The tiled ring, where W % 4 == 0, W >= 32, the base is 16-byte aligned
//   and there are at least kBoxRows rows (config 5's stacks): a unit is a
//   (key, 32-column tile), and lane 0 keeps kBoxStages - 1 TMA boxes of
//   [kBoxRows, 32] of the tile in flight, one instruction and one mbarrier
//   each (the tensor map is encoded per launch through the runtime's
//   driver entry point, so nothing links against libcuda). Every lane
//   waits on a box's mbarrier and reads its column of the box into
//   registers while it adds the previous box's rows, in one branch-free
//   block, so the shared-memory loads issue between the dependent adds;
//   only the step that reads a key's last box selects +0.0 for the next
//   key's rows there. Lane 0 refills the box whose rows every lane added
//   a step ago, so the warp barrier after each wait orders those reads
//   before the refill.
// - The 4-byte ring elsewhere (W = 5, 3, 645; views one float in): lane f
//   of the flattened [P, W] totals is column f % W of key walk[f / W], so
//   a unit is 32 columns of one key or reaches into the next, and at
//   W < 32 it holds several keys' columns (no lane idles on the walked
//   sweep's widths). Each lane streams its own column with 4-byte
//   cp.async copies kStages - 1 stages of kRows rows ahead of its adds,
//   and reads only what it copied itself, so no barrier is needed.
//
// What holds it back. The per-row work of one warp, not the bytes: a
// shared-memory load and a dependent add a row for each lane, and in the
// 4-byte ring a copy instruction a row. On a key much longer than the
// others (chip_smoke.py's one-key stack) the kernel runs at that rate
// (PERF.md).

#include <cstdint>

#include <cuda.h>
#include <cuda_runtime.h>

namespace {

constexpr int kLanes = 32;      // columns of a unit: one warp
constexpr int kRows = 16;       // rows of a stage of the 4-byte ring
constexpr int kStages = 16;     // stages of the 4-byte ring: 32 KB
constexpr int kBoxRows = 64;    // rows of a TMA box
constexpr int kBoxStages = 8;   // boxes of the tiled ring: 64 KB
constexpr int kWarpsPerSm = 2;  // resident warps of the persistent grid

// ---- the 4-byte ring ----

__device__ __forceinline__ void copy4(uint32_t dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wait_groups() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Copies rows g * kRows .. of the lane's column (`src`, stride W, `rows`
// rows) into ring stage `stage` at `slots`, as far as the column has rows.
__device__ __forceinline__ void fill(const float* src, int64_t rows,
                                     int64_t W, int64_t g, int stage,
                                     uint32_t slots) {
  const int64_t r0 = g * kRows;
  const float* p = src + r0 * W;
  const uint32_t d = slots + stage * (kRows * kLanes * 4);
  if (r0 + kRows <= rows) {
#pragma unroll
    for (int k = 0; k < kRows; ++k) copy4(d + k * (kLanes * 4), p + k * W);
  } else {
    for (int k = 0; r0 + k < rows; ++k)
      copy4(d + k * (kLanes * 4), p + k * W);
  }
}

// Adds the `left` rows (at most kRows) of one ring stage to `acc`.
__device__ __forceinline__ float add_stage(float acc, const float* slot,
                                           int64_t left) {
  if (left >= kRows) {
    float v[kRows];
#pragma unroll
    for (int k = 0; k < kRows; ++k) v[k] = slot[k * kLanes];
#pragma unroll
    for (int k = 0; k < kRows; ++k) acc = __fadd_rn(acc, v[k]);
  } else {
    for (int k = 0; k < left; ++k) acc = __fadd_rn(acc, slot[k * kLanes]);
  }
  return acc;
}

// The lane's column total: a left fold of `rows` values from `src` with
// stride W, streamed through the lane's ring slots (`mine` for its reads,
// its shared-space address `slots` for its copies). A lane reads only
// what it copied itself, so cp.async.wait_group orders its copies before
// its reads.
__device__ __forceinline__ float fold(const float* src, int64_t rows,
                                      int64_t W, const float* mine,
                                      uint32_t slots) {
  const int64_t groups = (rows + kRows - 1) / kRows;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    fill(src, rows, W, s, s, slots);
    commit();
  }
  float acc = 0.0f;
  int stage = 0;
  for (int64_t g = 0; g < groups; ++g) {
    // Refill the stage read last round with group g + kStages - 1; then
    // wait until at most kStages - 1 groups are pending: group g has
    // landed.
    fill(src, rows, W, g + kStages - 1,
         stage == 0 ? kStages - 1 : stage - 1, slots);
    commit();
    wait_groups<kStages - 1>();
    acc = add_stage(acc, mine + stage * (kRows * kLanes), rows - g * kRows);
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  wait_groups<0>();
  return acc;
}

__global__ void __launch_bounds__(kLanes)
    fold_ring(const float* __restrict__ x,
              const int64_t* __restrict__ offsets,
              const int32_t* __restrict__ walk, float* __restrict__ out,
              int* __restrict__ queue, int64_t W, int P, int n_units) {
  extern __shared__ float ring[];
  const int lane = threadIdx.x;
  const uint32_t slots =
      static_cast<uint32_t>(__cvta_generic_to_shared(ring + lane));
  const int64_t lanes_total = static_cast<int64_t>(P) * W;
  for (;;) {
    int u = 0;
    if (lane == 0) u = atomicAdd(queue, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    if (u >= n_units) break;
    const int64_t f = static_cast<int64_t>(u) * kLanes + lane;
    if (f < lanes_total) {
      const int64_t rank = f / W;
      const int64_t col = f - rank * W;
      const int key = walk[rank];
      const int64_t first = offsets[key];
      out[static_cast<int64_t>(key) * W + col] =
          fold(x + first * W + col, offsets[key + 1] - first, W, ring + lane,
               slots);
    }
    __syncwarp();
  }
}

// ---- the tiled TMA ring ----

__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_done(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// One [kBoxRows, 32] box of x at (row, col) into shared `dst`, completing
// on the mbarrier `bar`, when `issue` is set. Rows or columns past x's
// end land as +0.0.
__device__ __forceinline__ void load_box(uint32_t dst, const CUtensorMap* map,
                                         int64_t col, int64_t row,
                                         uint32_t bar, bool issue) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %5, 0;\n"
      " @p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%4], %6;\n"
      " @p cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier"
      "::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(static_cast<int>(col)),
      "r"(static_cast<int>(row)), "r"(bar), "r"(issue ? 1 : 0),
      "n"(kBoxRows * kLanes * 4)
      : "memory");
}

// The lane's column of one box into registers. In a key's last box
// (kLast) the rows from `left` on, the next key's first rows, read as
// +0.0. Neither version branches.
template <bool kLast>
__device__ __forceinline__ void read_box(float (&v)[kBoxRows],
                                         const float* box, int64_t left) {
  const int n = left < kBoxRows ? static_cast<int>(left) : kBoxRows;
#pragma unroll
  for (int k = 0; k < kBoxRows; ++k) {
    const float x = box[k * kLanes];
    v[k] = !kLast || k < n ? x : 0.0f;
  }
}

// The tiled ring's state for one unit: the tile's first row and rows,
// its column, and the shared addresses of the warp's boxes and mbarriers.
struct Tile {
  const CUtensorMap* map;
  int64_t first, rows, n_boxes, col;
  const float* mine;
  uint32_t boxes, bars;
  int lane;
};

// One step of the tiled fold: adds box g's rows (in `cur`) while box
// g + 1 is read into `next` (kLast: box g + 1 is the key's last box and
// may end early). First lane 0 refills the stage of box g - 1, whose rows
// every lane added a step ago (the warp barrier after the wait orders
// that), with box g + kBoxStages - 1; a box past the key's end is not
// loaded.
template <bool kLast>
__device__ __forceinline__ float tile_step(float acc,
                                           const float (&cur)[kBoxRows],
                                           float (&next)[kBoxRows],
                                           const Tile& t, int64_t g,
                                           uint32_t& phases) {
  constexpr int kBox = kBoxRows * kLanes;  // floats of one box
  const int s = static_cast<int>((g + 1) % kBoxStages);
  while (!mbar_done(t.bars + 8 * s, (phases >> s) & 1u)) {
  }
  phases ^= 1u << s;
  __syncwarp();
  const int64_t b = g + kBoxStages - 1;
  const int r = static_cast<int>(b % kBoxStages);
  load_box(t.boxes + r * kBox * 4, t.map, t.col, t.first + b * kBoxRows,
           t.bars + 8 * r, t.lane == 0 && b < t.n_boxes);
  read_box<kLast>(next, t.mine + s * kBox, t.rows - (g + 1) * kBoxRows);
#pragma unroll
  for (int k = 0; k < kBoxRows; ++k) acc = __fadd_rn(acc, cur[k]);
  return acc;
}

// Units of the tiled ring: (key, 32-column tile), keys in walk order.
__global__ void __launch_bounds__(kLanes)
    fold_tiled(const __grid_constant__ CUtensorMap map,
               const int64_t* __restrict__ offsets,
               const int32_t* __restrict__ walk, float* __restrict__ out,
               int* __restrict__ queue, int64_t W, int tiles, int n_units) {
  extern __shared__ __align__(128) float ring[];
  constexpr int kBox = kBoxRows * kLanes;
  Tile t;
  t.map = &map;
  t.lane = threadIdx.x;
  t.mine = ring + t.lane;
  t.boxes = static_cast<uint32_t>(__cvta_generic_to_shared(ring));
  t.bars = static_cast<uint32_t>(
      __cvta_generic_to_shared(ring + kBoxStages * kBox));
  if (t.lane == 0) {
    for (int s = 0; s < kBoxStages; ++s) mbar_init(t.bars + 8 * s);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncwarp();
  uint32_t phases = 0;  // the parity each box's mbarrier completes next
  for (;;) {
    int u = 0;
    if (t.lane == 0) u = atomicAdd(queue, 1);
    u = __shfl_sync(0xffffffffu, u, 0);
    if (u >= n_units) break;
    const int rank = u / tiles;
    t.col = static_cast<int64_t>(u - rank * tiles) * kLanes;
    const int key = walk[rank];
    t.first = offsets[key];
    t.rows = offsets[key + 1] - t.first;
    t.n_boxes = (t.rows + kBoxRows - 1) / kBoxRows;
#pragma unroll
    for (int s = 0; s < kBoxStages - 1; ++s)
      load_box(t.boxes + s * kBox * 4, &map, t.col, t.first + s * kBoxRows,
               t.bars + 8 * s, t.lane == 0 && s < t.n_boxes);
    float acc = 0.0f;
    if (t.n_boxes > 0) {
      while (!mbar_done(t.bars, phases & 1u)) {
      }
      phases ^= 1u;
      float a[kBoxRows], b[kBoxRows];
      read_box<true>(a, t.mine, t.rows);
      // Box g is in `a`, then in `b`: the steps ping-pong, and only the
      // step that reads the key's last box selects.
      const int64_t last = t.n_boxes - 1;
      for (int64_t g = 0;; g += 2) {
        if (g == last) {
#pragma unroll
          for (int k = 0; k < kBoxRows; ++k) acc = __fadd_rn(acc, a[k]);
          break;
        }
        acc = g + 1 < last ? tile_step<false>(acc, a, b, t, g, phases)
                           : tile_step<true>(acc, a, b, t, g, phases);
        if (g + 1 == last) {
#pragma unroll
          for (int k = 0; k < kBoxRows; ++k) acc = __fadd_rn(acc, b[k]);
          break;
        }
        acc = g + 2 < last ? tile_step<false>(acc, b, a, t, g + 1, phases)
                           : tile_step<true>(acc, b, a, t, g + 1, phases);
      }
    }
    if (t.col + t.lane < W)
      out[static_cast<int64_t>(key) * W + t.col + t.lane] = acc;
    __syncwarp();
  }
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no link
// against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

bool tiled(long long n, long long W, const void* x) {
  return W % 4 == 0 && W >= kLanes && n >= kBoxRows &&
         reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Sets the kernel's shared memory and zeroes the unit counter; `blocks`
// is the persistent grid: kWarpsPerSm one-warp blocks on every SM, or one
// a unit when there are fewer units.
template <typename Kernel>
cudaError_t prepare(Kernel kernel, int smem, int64_t units, int* queue,
                    cudaStream_t s, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  int device = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&device);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e == cudaSuccess) e = cudaMemsetAsync(queue, 0, sizeof(int), s);
  const int64_t most = static_cast<int64_t>(sms) * kWarpsPerSm;
  *blocks = static_cast<int>(units < most ? units : most);
  return e;
}

}  // namespace

// x: float32 [n, W] row-major, its rows in key order; offsets: int64
// [P + 1]; walk: int32 [P]; out: float32 [P, W]; queue: one int32 of
// scratch. Runs on `stream`; returns a cudaError_t.
extern "C" int segkeyed_launch(const void* x, const void* offsets,
                               const void* walk, void* out, void* queue,
                               long long n, long long W, int P,
                               void* stream) {
  if (P <= 0 || W <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* off = static_cast<const int64_t*>(offsets);
  const auto* wk = static_cast<const int32_t*>(walk);
  auto* o = static_cast<float*>(out);
  auto* q = static_cast<int*>(queue);
  int blocks = 0;
  cudaError_t e;
  if (tiled(n, W, x)) {
    const int64_t tiles = (W + kLanes - 1) / kLanes;
    const int64_t units = static_cast<int64_t>(P) * tiles;
    if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const EncodeTiled encode = encoder();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    CUtensorMap map;
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(W),
                                static_cast<cuuint64_t>(n)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(W) * 4};
    const cuuint32_t box[2] = {kLanes, kBoxRows};
    const cuuint32_t unit_strides[2] = {1, 1};
    if (encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
               const_cast<void*>(x), dims, strides, box, unit_strides,
               CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
               CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
               CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return static_cast<int>(cudaErrorInvalidValue);
    const int smem = kBoxStages * (kBoxRows * kLanes * 4 + 8);
    if ((e = prepare(fold_tiled, smem, units, q, s, &blocks)) != cudaSuccess)
      return static_cast<int>(e);
    fold_tiled<<<blocks, kLanes, smem, s>>>(map, off, wk, o, q,
                                            static_cast<int64_t>(W),
                                            static_cast<int>(tiles),
                                            static_cast<int>(units));
  } else {
    const int64_t units = (static_cast<int64_t>(P) * W + kLanes - 1) / kLanes;
    if (units > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int smem = kStages * kRows * kLanes * 4;
    if ((e = prepare(fold_ring, smem, units, q, s, &blocks)) != cudaSuccess)
      return static_cast<int>(e);
    fold_ring<<<blocks, kLanes, smem, s>>>(static_cast<const float*>(x), off,
                                           wk, o, q, static_cast<int64_t>(W),
                                           P, static_cast<int>(units));
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int segkeyed_ring_rows() { return kRows; }
extern "C" int segkeyed_ring_stages() { return kStages; }
extern "C" int segkeyed_box_rows() { return kBoxRows; }
extern "C" int segkeyed_box_stages() { return kBoxStages; }
