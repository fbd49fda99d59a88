// The stream's batch assignment for Hopper (sm_90a): K7.
//
// A streamed table is cut into batches (and, on a mesh, each batch into
// one cell per rank) by hashes of the privacy ids, so that every unit's
// rows land in one cell. Row i's cell is
//
//   h       = fmix32(uint32(pid[i]) ^ seed)
//   batch   = (uint64(h) * n_batches) >> 32
//   cell[i] = batch * n_dev + fmix32(uint32(pid[i])) % n_dev   (n_dev > 1)
//   cell[i] = batch                                            (n_dev = 1)
//
// (fmix32 the murmur3 finalizer; the second hash is parallel/sharded.py's
// unsalted shard_of_rows). K7 gives
//
//   order[k]  = the row indices grouped by cell: cells ascending, rows in
//               input order within a cell (the stable grouping, unique);
//   counts[c] = the rows of cell c,
//
// bit for bit the host path's numpy (ingest/assign.py's cell_of_rows,
// then group_rows_by_cell's stable argsort), which is also K7's plain
// version (ops/kernels/assign.py). Every
// released value depends on the order: the bounding's tie-break bits are
// keyed by row position. The JAX package does this step on the host in
// numpy: K7 is a port-only kernel, and no Pallas body has to match it.
//
// For a few cells a stable grouping is not a sort but a counting
// partition: count each cell's rows per piece of the table, scan the
// counts, and scatter every row to its slot. Three launches on the
// caller's stream, no host synchronisation:
//
// 1. assign_segments<count>: each warp owns one segment of seg_rows
//    consecutive rows and walks it 32 rows a round, a lane a row (the
//    ids read coalesced, kUnroll rounds loaded ahead), hashing in
//    registers. __match_any_sync groups the lanes of one cell, and the
//    group's first lane adds the group's size to the warp's own counter
//    of that cell in shared memory (a warp's counters are its own, so
//    no atomics). The counters go out cell-major: table[c * n_seg + s].
// 2. assign_scan: one block scans the table in place into each
//    (cell, segment)'s first slot (the rows of every earlier cell, and
//    of this cell in every earlier segment), then writes counts.
// 3. assign_segments<scatter>: each warp starts its counters at its
//    segment's slots and walks its rows again in the same order; a lane's
//    slot is its cell's counter plus the lanes of its cell below it in
//    the round (__popc of the match mask below the lane); the group's
//    first lane then advances the counter. It stores the row index as
//    int32. For two cells a round's 32 stores fall in two runs.
//
// Within a round, lanes are rows in order; rounds walk the segment in
// order; segments follow each other in a cell's slots in segment order:
// so the grouping is stable by construction.
//
// Sizes: a warp's counters take n_cells int32 of shared memory, and a
// block holds as many warps (up to 8) as fit 48 KB, so n_cells is at most
// kMaxCells = 4096 (3 warps a block there); a larger cell space keeps the
// host path. The wrapper sizes segments so that the table holds at most
// about 2^22 entries (2048 rows a segment at the stream's few cells).
//
// Bound on the H100 (3.35 TB/s; the hash is a few integer operations a
// row): the ids read once (4 bytes a row) and the order written once (4),
// 0.24 ms at 100,480,507 rows. This design reads the ids twice: 12 bytes a
// row, plus the table's n_cells * n_seg int32 written, scanned and read.
//
// pid: int32 [n] on the card; table: int32 [n_cells * n_seg]; order:
// int32 [n]; counts: int64 [n_cells]. n < 2^31.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxCells = 4096;
constexpr int kMaxWarps = 8;          // warps of an assign_segments block
constexpr int kSmemInts = 12288;      // 48 KB of warp counters a block
constexpr int kUnroll = 4;            // rounds of 32 rows loaded ahead
constexpr int kScanThreads = 1024;    // the one block of assign_scan
constexpr int kScanPer = 8;           // table entries a scan thread takes
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNone = 0xffffffffu;  // a lane past its segment's end

struct Hash {
  uint32_t n_batches, n_dev, seed;
};

__device__ __forceinline__ uint32_t fmix32(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  return x ^ (x >> 16);
}

__device__ __forceinline__ uint32_t cell_of(int32_t pid, const Hash& hs) {
  const uint32_t u = static_cast<uint32_t>(pid);
  const uint32_t h = fmix32(u ^ hs.seed);
  uint32_t cell = static_cast<uint32_t>(
      (static_cast<uint64_t>(h) * hs.n_batches) >> 32);
  if (hs.n_dev > 1) cell = cell * hs.n_dev + fmix32(u) % hs.n_dev;
  return cell;
}

// Launch 1 (kScatter false): each warp's per-cell row counts into the
// table. Launch 3 (kScatter true): from the scanned table, each row's
// index to its slot of order.
template <bool kScatter>
__global__ void __launch_bounds__(kMaxWarps * 32)
    assign_segments(const int32_t* __restrict__ pid, int64_t n, Hash hs,
                    int n_cells, int64_t seg_rows, int64_t n_seg,
                    int32_t* __restrict__ table,
                    int32_t* __restrict__ order) {
  extern __shared__ int32_t s_cnt[];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int64_t seg =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x >> 5) + w;
  if (seg >= n_seg) return;  // the whole warp: no block barrier follows
  int32_t* cnt = s_cnt + w * n_cells;
  for (int c = lane; c < n_cells; c += 32)
    cnt[c] = kScatter ? table[static_cast<int64_t>(c) * n_seg + seg] : 0;
  __syncwarp();
  const int64_t r0 = seg * seg_rows;
  const int64_t r1 = r0 + seg_rows < n ? r0 + seg_rows : n;
  const unsigned below = (1u << lane) - 1u;
  for (int64_t base = r0; base < r1; base += 32 * kUnroll) {
    uint32_t cell[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const int64_t r = base + j * 32 + lane;
      cell[j] = r < r1 ? cell_of(__ldg(pid + r), hs) : kNone;
    }
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      const bool valid = cell[j] != kNone;
      const unsigned peers = __match_any_sync(kFull, cell[j]);
      const bool first = lane == __ffs(peers) - 1;
      if constexpr (kScatter) {
        const int32_t slot = valid ? cnt[cell[j]] + __popc(peers & below)
                                   : 0;
        __syncwarp();  // every peer has read the counter
        if (valid && first) cnt[cell[j]] += __popc(peers);
        if (valid)
          order[slot] = static_cast<int32_t>(base + j * 32 + lane);
      } else {
        if (valid && first) cnt[cell[j]] += __popc(peers);
      }
      __syncwarp();  // the next round's first lanes see the counters
    }
  }
  if constexpr (!kScatter) {
    for (int c = lane; c < n_cells; c += 32)
      table[static_cast<int64_t>(c) * n_seg + seg] = cnt[c];
  }
}

// Launch 2, one block: the table, in place, into its exclusive prefix
// sums (kScanThreads * kScanPer entries a step, the running total carried
// from step to step), then each cell's rows from its first slot and the
// next cell's (n past the last).
__global__ void __launch_bounds__(kScanThreads)
    assign_scan(int32_t* __restrict__ table, int64_t m, int64_t n_seg,
                int n_cells, int64_t n, int64_t* __restrict__ counts) {
  __shared__ int32_t s_warp[kScanThreads / 32];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  int32_t carry = 0;  // the entries before this step, alike in every thread
  for (int64_t step = 0; step < m;
       step += int64_t{kScanThreads} * kScanPer) {
    const int64_t t0 = step + static_cast<int64_t>(threadIdx.x) * kScanPer;
    int32_t v[kScanPer];
    int32_t sum = 0;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j) {
      const int32_t x = t0 + j < m ? table[t0 + j] : 0;
      v[j] = sum;
      sum += x;
    }
    int32_t incl = sum;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int32_t y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    if (lane == 31) s_warp[w] = incl;
    __syncthreads();
    int32_t before = 0, total = 0;
#pragma unroll
    for (int i = 0; i < kScanThreads / 32; ++i) {
      const int32_t x = s_warp[i];
      if (i < w) before += x;
      total += x;
    }
    const int32_t first = carry + before + incl - sum;
#pragma unroll
    for (int j = 0; j < kScanPer; ++j)
      if (t0 + j < m) table[t0 + j] = first + v[j];
    carry += total;
    __syncthreads();  // s_warp is written again next step
  }
  // The barrier above also makes the block's table writes visible here.
  for (int c = threadIdx.x; c < n_cells; c += kScanThreads) {
    const int64_t start = table[static_cast<int64_t>(c) * n_seg];
    const int64_t end =
        c + 1 < n_cells ? table[static_cast<int64_t>(c + 1) * n_seg] : n;
    counts[c] = end - start;
  }
}

}  // namespace

// pid: int32 [n] on the card; table: int32 [n_batches * n_dev * ceil(n /
// seg_rows)]; order: int32 [n]; counts: int64 [n_batches * n_dev]. seed is
// the low 32 bits of the stream's seed. seg_rows: a positive multiple of
// 32. Returns the CUDA error code of the launches (0 on success); n = 0
// zeroes counts and launches nothing.
extern "C" int assign_launch(const void* pid, long long n,
                             unsigned n_batches, unsigned n_dev,
                             unsigned seed, long long seg_rows, void* table,
                             void* order, void* counts, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint64_t cells = static_cast<uint64_t>(n_batches) * n_dev;
  if (n < 0 || n >= (1ll << 31) || cells < 1 || cells > kMaxCells ||
      seg_rows <= 0 || seg_rows % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_cells = static_cast<int>(cells);
  auto* cnt = static_cast<int64_t*>(counts);
  if (n == 0)
    return static_cast<int>(
        cudaMemsetAsync(cnt, 0, sizeof(int64_t) * n_cells, s));
  const Hash hs{n_batches, n_dev, seed};
  const int64_t n_seg = (n + seg_rows - 1) / seg_rows;
  int warps = kSmemInts / n_cells;
  warps = warps < kMaxWarps ? warps : kMaxWarps;
  const unsigned blocks = static_cast<unsigned>((n_seg + warps - 1) / warps);
  const size_t smem = sizeof(int32_t) * warps * n_cells;
  const auto* ids = static_cast<const int32_t*>(pid);
  auto* tab = static_cast<int32_t*>(table);
  auto* ord = static_cast<int32_t*>(order);
  assign_segments<false><<<blocks, warps * 32, smem, s>>>(
      ids, n, hs, n_cells, seg_rows, n_seg, tab, nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  assign_scan<<<1, kScanThreads, 0, s>>>(tab, n_seg * n_cells, n_seg,
                                         n_cells, n, cnt);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  assign_segments<true><<<blocks, warps * 32, smem, s>>>(
      ids, n, hs, n_cells, seg_rows, n_seg, tab, ord);
  return static_cast<int>(cudaGetLastError());
}

// The largest cell space K7 takes: the wrapper checks its own limit by it.
extern "C" int assign_max_cells() { return kMaxCells; }
