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
// whole contract: a running value may only be continued row by row, two
// partial sums are never added, so any split of a segment hands over
// the running value and continues the chain from it.
//
// Design, two launches on the caller's stream, no host synchronisation:
//
// 1. segtotal_tile: one block of kThreads threads a tile of kTile =
//    kThreads * kRows rows; each thread loads kRows consecutive rows into
//    registers (16-byte value loads, 8-byte flag loads) and stages the
//    values in shared memory, and the last warp loads the kSpill rows
//    after the tile. Blocks are not persistent: the next blocks' loads
//    are in flight on the SM while a block folds. Two scans over the
//    threads (shuffles, then one value per warp) give each thread the
//    last start before its rows and the first after them. A thread folds
//    the segments that start in its rows: one pass over its registers
//    gives the running value at each row, so a segment that ends in the
//    thread has its total at its last row, and the thread's last segment
//    continues the chain through the staged rows after it (16-byte shared
//    reads, one group of 16 ahead of the adds), and through the spill
//    rows when it runs past the tile and ends among them. No running
//    value is handed between threads, so no thread waits on another's
//    fold. Each total is put on its segment's first row in shared memory;
//    after a barrier every thread reads its rows' totals there and writes
//    them with 16-byte stores. A segment that runs more than kSpill rows
//    past the tile goes to a list (one atomic) for launch 2, and the rows
//    of a segment that starts before the tile are left to whoever folds
//    it. Each tile writes the row of its first start, so launch 2 finds
//    where a listed segment ends.
// 2. segtotal_long: a block of two warps per listed segment (entries
//    blockIdx.x, + gridDim.x, ...). The producer warp finds a segment's
//    end from the tiles' first starts and streams exactly its values
//    through a cp.async ring of kStages chunks of kChunk values, across
//    segments; the consumer warp folds each chunk from shared memory,
//    every lane the same chain, with 16-byte reads one group of 16 ahead
//    of the adds, and writes each total to its segment's rows with
//    16-byte stores. Named barriers hand the stages over, so the
//    consumer's instruction stream is the fold and two barrier
//    instructions a chunk: the copies and their waits are the producer's.
//
// Bound on the H100: the kernel reads x (4 bytes) and the flag (1 byte)
// of every row and writes the total (4 bytes): 9 bytes per row, 0.067 ms
// for 25M rows at 3.35 TB/s; one add per row is far below any compute
// limit. A segment's L adds form one chain of dependent float32 adds
// (4.05 cycles each, measured on the H100), so the longest segment takes
// at least 4 L cycles however the work is split: 2.1 ms for 2^20 rows at
// 1.98 GHz. The kernel's bound is the larger of the two.
//
// x must be 16-byte and new_seg 8-byte aligned; the wrapper hands the
// kernel such buffers.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 8;       // rows a thread of segtotal_tile holds
constexpr int kThreads = 256;  // threads of a segtotal_tile block
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads * kRows;
constexpr int kSpill = 64;     // rows after its tile a segtotal_tile block reads
static_assert(kSpill / 4 + kSpill / 8 <= 32, "one warp reads the spill rows");
constexpr int kChunk = 1024;   // values of one ring stage of launch 2
constexpr int kStages = 4;     // ring stages of launch 2
constexpr int kLongBlocks = 12;  // segtotal_long blocks an SM holds
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float add4(float s, float4 q) {
  s = __fadd_rn(s, q.x);
  s = __fadd_rn(s, q.y);
  s = __fadd_rn(s, q.z);
  return __fadd_rn(s, q.w);
}

// Folds staged rows [a, b) into s, in order: groups of 16 values read
// with 16-byte loads one group ahead of the adds.
__device__ __forceinline__ float fold_staged(float s, const float4* stage,
                                             int a, int b) {
  const float* v = reinterpret_cast<const float*>(stage);
  int k = a;
  for (; k < b && (k & 3); ++k) s = __fadd_rn(s, v[k]);
  if (k >= b) return s;
  int u = k >> 2;
  const int ue = b >> 2;
  if (u + 4 <= ue) {
    float4 c0 = stage[u], c1 = stage[u + 1], c2 = stage[u + 2],
           c3 = stage[u + 3];
    for (u += 4; u + 4 <= ue; u += 4) {
      const float4 n0 = stage[u], n1 = stage[u + 1], n2 = stage[u + 2],
                   n3 = stage[u + 3];
      s = add4(add4(add4(add4(s, c0), c1), c2), c3);
      c0 = n0;
      c1 = n1;
      c2 = n2;
      c3 = n3;
    }
    s = add4(add4(add4(add4(s, c0), c1), c2), c3);
  }
  for (; u < ue; ++u) s = add4(s, stage[u]);
  for (k = 4 * ue; k < b; ++k) s = __fadd_rn(s, v[k]);
  return s;
}

// Bit k is set where byte k of eight flag bytes is nonzero.
__device__ __forceinline__ unsigned flag_bits(uint2 f) {
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    bits |= (((f.x >> (8 * k)) & 0xffu) != 0 ? 1u : 0u) << k;
    bits |= (((f.y >> (8 * k)) & 0xffu) != 0 ? 1u : 0u) << (k + 4);
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
    segtotal_tile(const float* __restrict__ x,
                  const uint8_t* __restrict__ new_seg,
                  float* __restrict__ out, int64_t n,
                  int64_t* __restrict__ first_start,
                  int64_t* __restrict__ long_starts,
                  int32_t* __restrict__ count) {
  // The tile's values; after the fold, each segment's total sits on its
  // first row.
  __shared__ float4 xs[kTile / 4];
  __shared__ int warp_last[kWarps], warp_first[kWarps];
  // The first kSpill rows after the tile and the first of them that
  // starts a segment (kSpill if none does): a segment that runs past the
  // tile's end and ends among them is finished here; then `spilled`.
  __shared__ float4 spill_x[kSpill / 4];
  __shared__ int spill_end, spilled;
  float* xf = reinterpret_cast<float*>(xs);
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int row0 = threadIdx.x * kRows;  // the thread's first row in the tile
  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t r0 = t0 + row0;

  // Load: bit k of `starts` is set where row r0 + k starts a segment; a
  // row past the table counts as a start (it ends the segment before it,
  // and is never written).
  float v[kRows];
  unsigned starts = 0;
  if (r0 + kRows <= n) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q) {
      const float4 a = *reinterpret_cast<const float4*>(x + r0 + 4 * q);
      v[4 * q] = a.x;
      v[4 * q + 1] = a.y;
      v[4 * q + 2] = a.z;
      v[4 * q + 3] = a.w;
    }
#pragma unroll
    for (int q = 0; q < kRows / 8; ++q)
      starts |= flag_bits(*reinterpret_cast<const uint2*>(new_seg + r0 +
                                                           8 * q))
                << (8 * q);
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k) {
      const int64_t r = r0 + k;
      const bool in = r < n;
      v[k] = in ? x[r] : 0.0f;
      starts |= (!in || new_seg[r] != 0 ? 1u : 0u) << k;
    }
  }
  if (r0 == 0) starts |= 1u;
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q)
    xs[row0 / 4 + q] =
        make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  if (w == kWarps - 1) {
    // The spill rows: values (zero past the table) in lanes 0-15, starts
    // in lanes 16-23, eight rows each; a row past the table counts as a
    // start.
    const int64_t at = t0 + kTile;
    int end = kSpill;
    if (lane < kSpill / 4) {
      const int64_t row = at + 4 * lane;
      float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (row + 4 <= n) {
        q = *reinterpret_cast<const float4*>(x + row);
      } else if (row < n) {
        q.x = x[row];
        if (row + 1 < n) q.y = x[row + 1];
        if (row + 2 < n) q.z = x[row + 2];
      }
      spill_x[lane] = q;
    } else if (lane < kSpill / 4 + kSpill / 8) {
      const int first = 8 * (lane - kSpill / 4);
      const int64_t row = at + first;
      unsigned bits = 0;
      if (row + 8 <= n) {
        bits = flag_bits(*reinterpret_cast<const uint2*>(new_seg + row));
      } else {
        for (int k = 0; k < 8; ++k)
          bits |= (row + k >= n || new_seg[row + k] != 0 ? 1u : 0u) << k;
      }
      if (bits) end = first + __ffs(bits) - 1;
    }
    end = static_cast<int>(__reduce_min_sync(kFull, static_cast<unsigned>(end)));
    if (lane == 0) {
      spill_end = end;
      spilled = 0;
    }
  }

  // The last start before the thread's rows and the first after them, in
  // tile rows (-1 and kTile when there is none): an exclusive max scan
  // and an exclusive min scan over the threads.
  const int my_last = starts ? row0 + 31 - __clz(starts) : -1;
  const int my_first = starts ? row0 + __ffs(starts) - 1 : kTile;
  int up = my_last, down = my_first;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int u = __shfl_up_sync(kFull, up, d);
    const int o = __shfl_down_sync(kFull, down, d);
    if (lane >= d) up = max(up, u);
    if (lane + d < 32) down = min(down, o);
  }
  if (lane == 31) warp_last[w] = up;
  if (lane == 0) warp_first[w] = down;
  __syncthreads();
  int prev = __shfl_up_sync(kFull, up, 1);
  int next = __shfl_down_sync(kFull, down, 1);
  if (lane == 0) prev = -1;
  if (lane == 31) next = kTile;
  for (int i = 0; i < w; ++i) prev = max(prev, warp_last[i]);
  for (int i = w + 1; i < kWarps; ++i) next = min(next, warp_first[i]);
  if (threadIdx.x == 0) {
    int m = kTile;
    for (int i = 0; i < kWarps; ++i) m = min(m, warp_first[i]);
    first_start[blockIdx.x] = m < kTile && t0 + m < n ? t0 + m : n;
  }
  // The tile's last segment ends at the tile's end when the next row
  // starts one or lies past the table; otherwise it runs on.
  const bool closed = t0 + kTile >= n || spill_end == 0;

  // Fold each segment that starts in the thread's rows, in row order from
  // +0.0: one pass over the registers gives the running value at each
  // row, so a segment that ends inside the thread has its total at its
  // last row; the thread's last segment runs on through the staged rows
  // of the threads after it. Each total goes on the segment's first row
  // (a start, which no other fold reads). A segment that runs past the
  // tile and ends within kSpill rows is finished from the spill rows, and
  // their totals written here; a longer one goes to the list of launch 2.
  float c = 0.0f;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    c = __fadd_rn(((starts >> k) & 1u) ? 0.0f : c, v[k]);
    v[k] = c;
  }
  int open = -1;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if ((starts >> k) & 1u) open = k;
    if (k + 1 < kRows && ((starts >> (k + 1)) & 1u) && open >= 0)
      xf[row0 + open] = v[k];
  }
  if (open >= 0 && r0 + open < n) {
    // Where the segment ends past the tile, if it runs on.
    const int e = next == kTile && !closed ? spill_end : 0;
    if (e == kSpill) {
      long_starts[atomicAdd(count, 1)] = r0 + open;
    } else {
      float total = fold_staged(v[kRows - 1], xs, row0 + kRows, next);
      if (e > 0) {
        const float* sx = reinterpret_cast<const float*>(spill_x);
        for (int k = 0; k < e; ++k) total = __fadd_rn(total, sx[k]);
        for (int k = 0; k < e; ++k) out[t0 + kTile + k] = total;
        spilled = 1;
      }
      xf[row0 + open] = total;
    }
  }
  __syncthreads();

  // Each row's total: that of the last start at or before it. A row is
  // written here when its segment starts in this tile and ends in it or
  // in the spill rows.
  unsigned ok = 0;
  int s = prev;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    if ((starts >> k) & 1u) s = row0 + k;
    const bool ends_here =
        (starts >> (k + 1)) != 0 || next < kTile || closed || spilled;
    ok |= (s >= 0 && ends_here && r0 + k < n ? 1u : 0u) << k;
    v[k] = s >= 0 ? xf[s] : 0.0f;
  }
  if (ok == (1u << kRows) - 1) {
#pragma unroll
    for (int q = 0; q < kRows / 4; ++q)
      *reinterpret_cast<float4*>(out + r0 + 4 * q) =
          make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kRows; ++k)
      if ((ok >> k) & 1u) out[r0 + k] = v[k];
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// The rows of chunk [base, base + kChunk) before `end` into `stage`.
__device__ __forceinline__ void copy_chunk(const float* __restrict__ x,
                                           int64_t base, int64_t end,
                                           float4* stage, int lane) {
#pragma unroll
  for (int i = 0; i < kChunk / 128; ++i) {
    const int p = lane + 32 * i;
    const int64_t row = base + 4 * p;
    const int64_t left = end - row;
    if (left > 0)
      cp_async16(stage + p, x + row,
                 left >= 4 ? 16 : 4 * static_cast<int>(left));
  }
}

// Named barriers between the two warps of a segtotal_long block: stage
// st is full (its rows have landed) or empty (its fold is done).
__device__ __forceinline__ int full_bar(int st) { return 1 + st; }
__device__ __forceinline__ int empty_bar(int st) { return 1 + kStages + st; }

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, 64;\n" ::"r"(id) : "memory");
}

// What a ring stage holds: rows [a, b) of it belong to the segment
// [s, e); kFirst and kLast mark the segment's first and last chunk,
// kDone the end of the block's work.
constexpr int kFirst = 1, kLast = 2, kDone = 4;

// A listed segment [s, e) and its chunks of launch 2; `done` past the
// list's end.
struct Segment {
  int64_t s, e, chunks;
  bool done;
};

// The listed segment that starts at row s (s < 0: none), with its end:
// the first start of a later tile than its own, or n (the segment crosses
// its tile's end). Called by a whole warp.
__device__ __forceinline__ Segment find_end(
    int64_t s, int64_t n, const int64_t* __restrict__ first_start,
    int64_t n_tiles, int lane) {
  Segment g{s, n, 1, s < 0};
  if (g.done) return g;
  for (int64_t t = s / kTile + 1; t < n_tiles; t += 128) {
    int64_t f[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t at = t + lane + 32 * j;
      f[j] = at < n_tiles ? first_start[at] : n;
    }
    bool found = false;
#pragma unroll
    for (int j = 0; j < 4 && !found; ++j) {
      const unsigned hit = __ballot_sync(kFull, f[j] < n);
      if (hit) {
        g.e = __shfl_sync(kFull, f[j], __ffs(hit) - 1);
        found = true;
      }
    }
    if (found) break;
  }
  g.chunks = (g.e - (s & ~int64_t{3}) + kChunk - 1) / kChunk;
  return g;
}

__global__ void __launch_bounds__(64)
    segtotal_long(const float* __restrict__ x, float* __restrict__ out,
                  int64_t n, const int64_t* __restrict__ first_start,
                  int64_t n_tiles, const int64_t* __restrict__ long_starts,
                  const int32_t* __restrict__ list_count) {
  __shared__ float4 ring[kStages][kChunk / 4];
  __shared__ int64_t stage_s[kStages], stage_e[kStages];
  __shared__ int stage_a[kStages], stage_b[kStages], stage_flags[kStages];
  const int lane = threadIdx.x & 31;
  const int count = *list_count;
  if (threadIdx.x >= 32) {
    // The producer warp: takes the list's entries blockIdx.x, + gridDim.x,
    // ..., finds each one's end and streams its chunks into the ring,
    // across segments, kStages ahead of the fold. A stage is full once
    // the producer has seen its copies land: within a segment it checks
    // one stage later, so as not to wait on the newest copy; a segment's
    // last stage it checks after finding the next segment's end, so that
    // the search overlaps the copy.
    int it = 0;
    int item = blockIdx.x;
    Segment cur = find_end(item < count ? long_starts[item] : -1, n,
                           first_start, n_tiles, lane);
    item += gridDim.x;
    // The next entry's start, loaded one segment ahead.
    int64_t next_s = item < count ? long_starts[item] : -1;
    for (;;) {
      const int64_t base0 = cur.s & ~int64_t{3};
      for (int64_t c = 0; c < cur.chunks; ++c, ++it) {
        const int st = it % kStages;
        if (it >= kStages) bar_sync(empty_bar(st));
        const int64_t base = base0 + c * kChunk;
        if (!cur.done) copy_chunk(x, base, cur.e, ring[st], lane);
        cp_async_commit();
        if (lane == 0) {
          stage_s[st] = cur.s;
          stage_e[st] = cur.e;
          stage_a[st] = c == 0 ? static_cast<int>(cur.s - base0) : 0;
          stage_b[st] = cur.e - base < kChunk
                            ? static_cast<int>(cur.e - base)
                            : kChunk;
          stage_flags[st] = cur.done ? kDone
                                     : (c == 0 ? kFirst : 0) |
                                           (c == cur.chunks - 1 ? kLast : 0);
        }
        if (c > 0) {
          cp_async_wait<1>();
          bar_arrive(full_bar((it - 1) % kStages));
        }
      }
      // Find the next segment's end, and load the start of the one after,
      // while this segment's last copy lands.
      item += gridDim.x;
      const int64_t after_s = item < count ? long_starts[item] : -1;
      const Segment next =
          cur.done ? cur : find_end(next_s, n, first_start, n_tiles, lane);
      cp_async_wait<0>();
      bar_arrive(full_bar((it - 1) % kStages));
      if (cur.done) {
        // Match the consumer's last releases, so that no barrier is left
        // half passed when the block exits.
        for (int j = it - kStages; j < it - 1; ++j)
          if (j >= 0) bar_sync(empty_bar(j % kStages));
        return;
      }
      cur = next;
      next_s = after_s;
    }
  }
  // The consumer warp: folds each stage in order, every lane the same
  // chain, and writes each segment's total to its rows with 16-byte
  // stores once its last chunk is folded.
  float total = 0.0f;
  for (int it = 0;; ++it) {
    const int st = it % kStages;
    bar_sync(full_bar(st));
    const int flags = stage_flags[st];
    if (flags & kDone) return;
    if (flags & kFirst) total = 0.0f;
    total = fold_staged(total, ring[st], stage_a[st], stage_b[st]);
    const int64_t s = stage_s[st], e = stage_e[st];
    bar_arrive(empty_bar(st));
    if (flags & kLast) {
      int64_t head = (s + 3) & ~int64_t{3};
      if (head > e) head = e;
      const int64_t body_end = head + ((e - head) & ~int64_t{3});
      if (s + lane < head) out[s + lane] = total;
      const float4 t4 = make_float4(total, total, total, total);
      for (int64_t r = head + 4 * lane; r < body_end; r += 128)
        *reinterpret_cast<float4*>(out + r) = t4;
      if (body_end + lane < e) out[body_end + lane] = total;
    }
  }
}

}  // namespace

// x: float32 [n], 16-byte aligned; new_seg: uint8 [n] (torch.bool),
// 8-byte aligned; out: float32 [n]; scratch: int64 [2 tiles + 1], tiles
// of segtotal_tile_rows() rows: each tile's first start, the list of
// segments for launch 2, and its length (int32, zeroed here). Returns the
// CUDA error code of the launches (0 on success).
extern "C" int segtotal_launch(const void* x, const void* new_seg, void* out,
                               void* scratch, long long n, void* stream) {
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
  int64_t* first_start = static_cast<int64_t*>(scratch);
  int64_t* long_starts = first_start + tiles;
  int32_t* count = reinterpret_cast<int32_t*>(long_starts + tiles);
  cudaError_t err = cudaMemsetAsync(count, 0, sizeof(int32_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  segtotal_tile<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      static_cast<const float*>(x), static_cast<const uint8_t*>(new_seg),
      static_cast<float*>(out), static_cast<int64_t>(n), first_start,
      long_starts, count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // Two warps a block, kStages * kChunk * 4 bytes of ring each.
  segtotal_long<<<n_sm * kLongBlocks, 64, 0, s>>>(
      static_cast<const float*>(x), static_cast<float*>(out),
      static_cast<int64_t>(n), first_start, tiles, long_starts, count);
  return static_cast<int>(cudaGetLastError());
}

// Rows of one segtotal_tile block: the wrapper sizes the scratch by it.
extern "C" int segtotal_tile_rows() { return kTile; }
