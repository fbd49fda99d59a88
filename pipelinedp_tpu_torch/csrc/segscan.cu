// Run scans over sorted rows for Hopper (sm_90a): K6.
//
// Rows are sorted so that equal keys are contiguous. new_run[i] marks the
// first row of a run and, optionally, new_group[i] the first row of a
// group; every group start is a run start and row 0 starts both. One scan
// over the flags gives every row
//
//   run_start[i] = the last j <= i with new_run[j] (0 where there is none)
//   run_ord[i]   = the run starts in (g, i], g the last group start at or
//                  before i (the run starts in [0, i], less one, where
//                  there is none): the ordinal of the row's run within
//                  its group.
//
// These are, bit for bit, the plain version's
// torch.cummax(where(new_run, idx, 0)) and
// cumsum(new_run) - 1 - cummax(where(new_group, cumsum(new_run) - 1, 0))
// (ops/kernels/segscan.py), which port jax.lax.cummax in
// pipelinedp_tpu/ops/segment.py::run_starts (:50) and
// ::run_ordinal_in_group (:69). That is XLA, not a Pallas body: K6 is a
// port-only kernel. PyTorch's CUDA scan-with-indices runs a 1-D tensor in
// one block, about 73 ms a scan over 25M rows on the H100, where the
// bytes allow a tenth of a millisecond.
//
// Both are associative carries, threaded through threads, warps and tiles:
//
// - run: the last run start, 0 where none; (a then b) = max(a, b), since
//   every index is >= 0.
// - group: the run starts counted since the last group start (since row 0
//   where none), with bit 62 set once a group start was seen (kSeen);
//   (a then b) = b has kSeen ? b : a + b. A row's own element is kSeen
//   at a group start, else its run flag. The count stays below 2^62.
//
// Two epilogues of the same scan:
//
// - generic: run_start and, with new_group, run_ord as int64 [n], either
//   left out where its pointer is null (run_starts, rank_in_run,
//   run_ordinal_in_group; the sweep's stage A and histograms, total-cap
//   mode, _run_ends).
// - bounding (Linf/L0, torch_engine._bound_sorted): from new_seg (the
//   runs) and new_pid (the groups), keep = (i - run_start < linf_cap) &
//   (run_ord < l0) and marker = new_seg & (run_ord < l0), bool [n].
//
// Design, on the caller's stream, no host synchronisation:
//
// Tiles of kTile = kThreads * kRows rows. A thread holds kRows
// consecutive flags of each input, read with one 16-byte load, as bit
// masks; its own carry comes from the masks (the highest set bit, a
// popcount); a warp scans the threads' carries with shuffles, the block
// the warps' with one value per warp in shared memory; then each thread
// walks its rows from its exclusive prefix. Outputs leave with 16-byte
// stores that cover contiguous bytes over a warp: the bool outputs
// straight from registers (one store a thread), the int64 ones staged
// through shared memory first (a thread's 16 rows are 128 bytes, so
// stores straight from registers would put a warp's 32 stores 128 bytes
// apart; measured on the H100 at 25M rows, 0.90 ms that way).
//
// The prefix crosses tiles in three launches: segscan_tile<kTotals>
// writes each tile's carry to scratch; segscan_carry, one block, scans
// those in place into each tile's exclusive prefix; segscan_tile<kGeneric
// or kBound> rescans each tile from its prefix and writes the rows. No
// block ever waits on another: a single pass with decoupled look-back
// would read the flags once instead of twice, but its blocks spin on
// their predecessors, whose progress rests on the order the hardware
// starts blocks in. The second read of the flags is 1-2 bytes a row, and
// much of it hits the 50 MB L2; the carry launch scans 6,104 tile carries
// at 25M rows, 32,768 at 2^27 (the largest streamed chunk). A table of
// one tile takes the last launch alone, from the empty prefix.
//
// Bound on the H100 (3.35 TB/s; no arithmetic bound is near): the
// generic epilogue with both outputs reads 2 bytes and writes 16 a row,
// 0.134 ms for 25M rows; the bounding epilogue reads 2 and writes 2, 0.030
// ms. This design reads the flags twice: 20 and 6 bytes a row.
//
// The flags must be 16-byte aligned; the wrapper hands the kernel such
// buffers, and allocates the outputs and the scratch.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 16;       // rows a thread holds: one 16-byte load
constexpr int kThreads = 256;   // threads of a segscan_tile block
constexpr int kTile = kThreads * kRows;
constexpr int kPad = kRows + 2;  // int64 a thread's rows take when staged
constexpr int kCarryThreads = 1024;  // the one block of segscan_carry
constexpr int kCarryPer = 8;    // tile carries a carry thread scans a step
constexpr int64_t kSeen = int64_t{1} << 62;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kTotals = 0, kGeneric = 1, kBound = 2 };

// (p then x), into x: the run carry and, with groups, the group carry.
template <bool kGroup>
__device__ __forceinline__ void after(int64_t p_run, int64_t p_grp,
                                      int64_t& run, int64_t& grp) {
  run = p_run > run ? p_run : run;
  if (kGroup) grp = (grp & kSeen) ? grp : p_grp + grp;
}

// On entry each thread's carry; on exit its exclusive prefix within the
// block, and the block's total in (tot_run, tot_grp). Shared scratch of
// one value per warp; the caller syncs before reusing it.
template <int kBlock, bool kGroup>
__device__ __forceinline__ void block_scan(int64_t& run, int64_t& grp,
                                           int64_t& tot_run,
                                           int64_t& tot_grp,
                                           int64_t* s_run, int64_t* s_grp) {
  constexpr int kBlockWarps = kBlock / 32;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int64_t p_run = __shfl_up_sync(kFull, run, d);
    const int64_t p_grp = kGroup ? __shfl_up_sync(kFull, grp, d) : 0;
    if (lane >= d) after<kGroup>(p_run, p_grp, run, grp);
  }
  if (lane == 31) {
    s_run[w] = run;
    if (kGroup) s_grp[w] = grp;
  }
  __syncthreads();
  int64_t e_run = __shfl_up_sync(kFull, run, 1);
  int64_t e_grp = kGroup ? __shfl_up_sync(kFull, grp, 1) : 0;
  if (lane == 0) e_run = e_grp = 0;
  // The warps before this one, and all of them.
  int64_t p_run = 0, p_grp = 0, a_run = 0, a_grp = 0;
#pragma unroll
  for (int i = 0; i < kBlockWarps; ++i) {
    if (i == w) {
      p_run = a_run;
      p_grp = a_grp;
    }
    int64_t x_run = s_run[i];
    int64_t x_grp = kGroup ? s_grp[i] : 0;
    after<kGroup>(a_run, a_grp, x_run, x_grp);
    a_run = x_run;
    a_grp = x_grp;
  }
  tot_run = a_run;
  tot_grp = a_grp;
  after<kGroup>(p_run, p_grp, e_run, e_grp);
  run = e_run;
  grp = e_grp;
}

// Bit k set where flag byte k of 16 is nonzero.
__device__ __forceinline__ unsigned flag_bits(uint4 v) {
  const unsigned words[4] = {v.x, v.y, v.z, v.w};
  unsigned bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      bits |= (((words[q] >> (8 * k)) & 0xffu) != 0 ? 1u : 0u)
              << (4 * q + k);
  return bits;
}

// The flags of rows [r0, r0 + kRows) as a bit mask; rows past n are 0.
__device__ __forceinline__ unsigned load_bits(const uint8_t* __restrict__ f,
                                              int64_t r0, int64_t n) {
  if (r0 + kRows <= n)
    return flag_bits(*reinterpret_cast<const uint4*>(f + r0));
  unsigned bits = 0;
  for (int k = 0; k < kRows; ++k)
    if (r0 + k < n && f[r0 + k] != 0) bits |= 1u << k;
  return bits;
}

// Rows [0, rows) of a tile staged in shared memory (a thread's kRows
// rows kPad apart) to out, two int64 a thread a step: a warp's 16-byte
// stores cover 512 contiguous bytes.
__device__ __forceinline__ void store_tile(const int64_t* stage,
                                           int64_t* __restrict__ out,
                                           int rows) {
  for (int e = 2 * threadIdx.x; e < rows; e += 2 * kThreads) {
    const longlong2 v = *reinterpret_cast<const longlong2*>(
        stage + (e / kRows) * kPad + e % kRows);
    if (e + 2 <= rows)
      *reinterpret_cast<longlong2*>(out + e) = v;
    else
      out[e] = v.x;
  }
}

template <int kMode, bool kGroup>
__global__ void __launch_bounds__(kThreads)
    segscan_tile(const uint8_t* __restrict__ new_run,
                 const uint8_t* __restrict__ new_group, int64_t n,
                 int64_t* __restrict__ tile_run,
                 int64_t* __restrict__ tile_grp,
                 int64_t* __restrict__ out_start,
                 int64_t* __restrict__ out_ord, uint8_t* __restrict__ keep,
                 uint8_t* __restrict__ marker, int64_t linf_cap,
                 int64_t l0) {
  __shared__ int64_t s_run[kThreads / 32], s_grp[kThreads / 32];
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * kTile +
                     threadIdx.x * kRows;
  const unsigned runs = load_bits(new_run, r0, n);
  const unsigned groups = kGroup ? load_bits(new_group, r0, n) : 0u;

  // The thread's carry: its last run start; the run starts after its
  // last group start (all of them where it has none).
  int64_t run = runs ? r0 + 31 - __clz(runs) : 0;
  int64_t grp = 0;
  if (kGroup) {
    if (groups) {
      const int h = 31 - __clz(groups);
      grp = kSeen | __popc(runs >> (h + 1));
    } else {
      grp = __popc(runs);
    }
  }
  int64_t tot_run, tot_grp;
  block_scan<kThreads, kGroup>(run, grp, tot_run, tot_grp, s_run, s_grp);
  if constexpr (kMode == kTotals) {
    if (threadIdx.x == 0) {
      tile_run[blockIdx.x] = tot_run;
      if (kGroup) tile_grp[blockIdx.x] = tot_grp;
    }
    return;
  }
  // The tile's exclusive prefix (none for a table of one tile).
  if (tile_run != nullptr)
    after<kGroup>(tile_run[blockIdx.x], kGroup ? tile_grp[blockIdx.x] : 0,
                  run, grp);
  if constexpr (kMode == kGeneric) {
    // The starts go out through shared memory, a thread's rows padded to
    // kPad so that the 16-byte writes of eight neighbouring threads fall
    // in distinct banks, and leave with stores that cover 512 contiguous
    // bytes a warp; the ordinals wait in registers, then follow the same
    // way. Threads past the table walk empty rows that are never stored.
    __shared__ __align__(16) int64_t stage[kThreads * kPad];
    int64_t* mine = stage + threadIdx.x * kPad;
    int64_t ord[kRows];
#pragma unroll
    for (int k = 0; k < kRows; k += 2) {
      int64_t s[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const unsigned r = (runs >> (k + j)) & 1u;
        if (r) run = r0 + k + j;
        s[j] = run;
        if constexpr (kGroup) {
          grp = ((groups >> (k + j)) & 1u) ? kSeen : grp + r;
          ord[k + j] = (grp & kSeen) ? grp - kSeen : grp - 1;
        }
      }
      *reinterpret_cast<longlong2*>(mine + k) = make_longlong2(s[0], s[1]);
    }
    const int64_t t0 = static_cast<int64_t>(blockIdx.x) * kTile;
    const int rows = static_cast<int>(n - t0 < kTile ? n - t0 : kTile);
    __syncthreads();
    if (out_start != nullptr) store_tile(stage, out_start + t0, rows);
    if constexpr (kGroup) {
      if (out_ord != nullptr) {
        __syncthreads();  // the starts are out
#pragma unroll
        for (int k = 0; k < kRows; k += 2)
          *reinterpret_cast<longlong2*>(mine + k) =
              make_longlong2(ord[k], ord[k + 1]);
        __syncthreads();
        store_tile(stage, out_ord + t0, rows);
      }
    }
    return;
  }

  if (r0 >= n) return;
  const bool whole = r0 + kRows <= n;
  // kBound: keep and marker bytes, four rows a word.
  unsigned kw[kRows / 4], mw[kRows / 4];
#pragma unroll
  for (int q = 0; q < kRows / 4; ++q) kw[q] = mw[q] = 0;
#pragma unroll
  for (int k = 0; k < kRows; ++k) {
    const unsigned r = (runs >> k) & 1u;
    if (r) run = r0 + k;
    grp = ((groups >> k) & 1u) ? kSeen : grp + r;
    const int64_t ord = (grp & kSeen) ? grp - kSeen : grp - 1;
    const bool in_l0 = ord < l0;
    const bool kept = in_l0 && (r0 + k - run) < linf_cap;
    kw[k / 4] |= (kept ? 1u : 0u) << (8 * (k % 4));
    mw[k / 4] |= (in_l0 && r ? 1u : 0u) << (8 * (k % 4));
  }
  if (whole) {
    *reinterpret_cast<uint4*>(keep + r0) =
        make_uint4(kw[0], kw[1], kw[2], kw[3]);
    *reinterpret_cast<uint4*>(marker + r0) =
        make_uint4(mw[0], mw[1], mw[2], mw[3]);
  } else {
    for (int k = 0; r0 + k < n; ++k) {
      keep[r0 + k] = (kw[k / 4] >> (8 * (k % 4))) & 1u;
      marker[r0 + k] = (mw[k / 4] >> (8 * (k % 4))) & 1u;
    }
  }
}

// One block: the tiles' carries, in place, into each tile's exclusive
// prefix; kCarryThreads * kCarryPer tiles a step, the running prefix
// carried from step to step.
template <bool kGroup>
__global__ void __launch_bounds__(kCarryThreads)
    segscan_carry(int64_t* __restrict__ tile_run,
                  int64_t* __restrict__ tile_grp, int64_t tiles) {
  __shared__ int64_t s_run[kCarryThreads / 32], s_grp[kCarryThreads / 32];
  int64_t c_run = 0, c_grp = 0;  // the tiles before this step
  for (int64_t base = 0; base < tiles;
       base += int64_t{kCarryThreads} * kCarryPer) {
    const int64_t t0 = base + static_cast<int64_t>(threadIdx.x) * kCarryPer;
    int64_t v_run[kCarryPer], v_grp[kCarryPer];
    // Each tile's prefix within the thread's tiles, and their total.
    int64_t run = 0, grp = 0;
#pragma unroll
    for (int j = 0; j < kCarryPer; ++j) {
      const int64_t t = t0 + j;
      int64_t x_run = t < tiles ? tile_run[t] : 0;
      int64_t x_grp = kGroup && t < tiles ? tile_grp[t] : 0;
      v_run[j] = run;
      v_grp[j] = grp;
      after<kGroup>(run, grp, x_run, x_grp);
      run = x_run;
      grp = x_grp;
    }
    int64_t tot_run, tot_grp;
    block_scan<kCarryThreads, kGroup>(run, grp, tot_run, tot_grp, s_run,
                                      s_grp);
    after<kGroup>(c_run, c_grp, run, grp);
#pragma unroll
    for (int j = 0; j < kCarryPer; ++j) {
      const int64_t t = t0 + j;
      if (t < tiles) {
        int64_t p_run = v_run[j], p_grp = v_grp[j];
        after<kGroup>(run, grp, p_run, p_grp);
        tile_run[t] = p_run;
        if (kGroup) tile_grp[t] = p_grp;
      }
    }
    after<kGroup>(c_run, c_grp, tot_run, tot_grp);
    c_run = tot_run;
    c_grp = tot_grp;
    __syncthreads();  // s_run and s_grp are read again next step
  }
}

template <int kMode, bool kGroup>
cudaError_t scan(const uint8_t* new_run, const uint8_t* new_group,
                 int64_t n, int64_t* scratch, int64_t* out_start,
                 int64_t* out_ord, uint8_t* keep, uint8_t* marker,
                 int64_t linf_cap, int64_t l0, cudaStream_t s) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  int64_t* tile_run = nullptr;
  int64_t* tile_grp = nullptr;
  if (tiles > 1) {
    tile_run = scratch;
    tile_grp = scratch + tiles;
    segscan_tile<kTotals, kGroup><<<static_cast<unsigned>(tiles), kThreads,
                                    0, s>>>(
        new_run, new_group, n, tile_run, tile_grp, nullptr, nullptr,
        nullptr, nullptr, 0, 0);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    segscan_carry<kGroup><<<1, kCarryThreads, 0, s>>>(tile_run, tile_grp,
                                                      tiles);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  segscan_tile<kMode, kGroup><<<static_cast<unsigned>(tiles), kThreads, 0,
                                s>>>(new_run, new_group, n, tile_run,
                                     tile_grp, out_start, out_ord, keep,
                                     marker, linf_cap, l0);
  return cudaGetLastError();
}

}  // namespace

// new_run, new_group: uint8 [n] (torch.bool), 16-byte aligned; new_group
// may be null (no group output). Generic epilogue (keep null): out_start
// and out_ord int64 [n], either null to leave it out (out_ord needs
// new_group). Bounding epilogue (keep non-null; new_group required): keep
// and marker uint8 [n] from linf_cap and l0. scratch: int64 [2 tiles],
// tiles of segscan_tile_rows() rows (unused for one tile). Returns the
// CUDA error code of the launches (0 on success); n = 0 launches nothing.
extern "C" int segscan_launch(const void* new_run, const void* new_group,
                              long long n, void* out_start, void* out_ord,
                              void* keep, void* marker, long long linf_cap,
                              long long l0, void* scratch, void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* run = static_cast<const uint8_t*>(new_run);
  const auto* grp = static_cast<const uint8_t*>(new_group);
  auto* sc = static_cast<int64_t*>(scratch);
  auto* st = static_cast<int64_t*>(out_start);
  auto* od = static_cast<int64_t*>(out_ord);
  auto* kp = static_cast<uint8_t*>(keep);
  auto* mk = static_cast<uint8_t*>(marker);
  cudaError_t err;
  if (keep != nullptr) {
    if (new_group == nullptr || marker == nullptr)
      return static_cast<int>(cudaErrorInvalidValue);
    err = scan<kBound, true>(run, grp, n, sc, nullptr, nullptr, kp, mk,
                             linf_cap, l0, s);
  } else if (new_group != nullptr) {
    err = scan<kGeneric, true>(run, grp, n, sc, st, od, nullptr, nullptr, 0,
                               0, s);
  } else {
    err = scan<kGeneric, false>(run, nullptr, n, sc, st, nullptr, nullptr,
                                nullptr, 0, 0, s);
  }
  return static_cast<int>(err);
}

// Rows of one segscan_tile block: the wrapper sizes the scratch by it.
extern "C" int segscan_tile_rows() { return kTile; }
