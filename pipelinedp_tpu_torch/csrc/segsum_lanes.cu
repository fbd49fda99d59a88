// Lane segment sum for Hopper (sm_90a): out[p, c] = sum over rows r with
// pk[r] == p of cols[r, c], in exact int32 arithmetic.
//
// Replaces pipelinedp_tpu/ops/kernels/segsum.py::segment_sum_lanes, the
// Pallas kernel that fills the [N, C] segment-sum slot of
// jax_engine._reduce_per_pk (and, through the wrapper, the wide segment
// sum of VECTOR_SUM when [P, tile] does not fit shared memory). The TPU
// kernel contracts a one-hot [P, R] block with the lanes on the MXU; on
// Hopper int32 addition is exact and associative, so partial sums and
// atomics in any order give the totals of index_add_ (or
// jax.ops.segment_sum) bit for bit. Every partial sum below adds a subset
// of one partition's rows of one lane, and the lane plan (_fx_plan) keeps
// each partition's total below 2^31, so no partial sum overflows either.
//
// Bound on the H100: every element of cols must be read (N * C * 4
// bytes), pk only at rows with a nonzero lane, and out written once. At
// the 25M-row MovieLens flagship (C = 6, P = 65536, about 3% of rows
// nonzero) that is about 0.61 GB, 0.182 ms at 3.35 TB/s; on the dense
// zipf(1.3) stack of that shape 0.70 GB, 0.209 ms; on config 4's mid
// histogram (C = 1 over 2^25 segments, 10M rows, 10% kept) 0.18 GB,
// 0.055 ms (chip_smoke.py computes each from its inputs).
//
// What held the first design back (one thread per element, 4-byte loads,
// a 64-bit division per element, one global atomic per nonzero element):
// one load in flight per thread, and on zipf(1.3) keys a quarter of all
// atomics serialised on the hot partition's C addresses in L2 (16.8 ms on
// the dense stack). The design now:
//   - hot keys: block 0 of a first kernel, which also zeroes out, reads a
//     strided sample of 2048 keys, counts them in a shared-memory hash
//     table and keeps up to kHot keys seen at least kMinHits times (the
//     threshold doubles while more qualify). Which keys are hot changes
//     no total, only the time;
//   - the main kernel reads the flat [N * C] stack with 16-byte loads,
//     kVecPerThread of them in flight per thread. The ragged head (up to
//     the first 16-byte boundary of the pointer, which a view need not
//     have) and tail are read with 4-byte loads. (row, column) comes from
//     one 64-bit division per tile and 32-bit arithmetic inside it, with
//     C a template constant for C <= 16;
//   - each warp's words pass through shared memory so that the lanes of
//     one atomic instruction hit consecutive words of a row;
//   - zero elements issue nothing; the keys of the others are loaded all
//     together before any add, so a thread waits once per tile for them;
//   - an element of a hot key adds itself to a per-block shared-memory
//     accumulator [n_hot, C], which the block flushes with one global
//     atomic per nonzero word;
//   - every other element adds itself to out with one global atomic: cold
//     keys spread over many addresses, which L2 serves in parallel.
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/segsum_ab.py, through the
// wrappers of this checkout and of the one with the first design, in
// turns): 0.32-0.34 ms on the flagship stack (first design 0.49), 0.81-0.86
// ms on the dense zipf(1.3) stack in either row order (16.7-18.7), 0.99-1.01
// ms on the D = 64 VECTOR_SUM stack (2.77-2.84); 0.151-0.160 ms on config
// 4's mid histogram (0.158-0.164; C = 1, no hot key, a 134 MB output whose
// zeroing is a third of the time).
//
// Rows whose pk lies outside [0, P) are dropped, as jax.ops.segment_sum
// drops them. The kernels allocate nothing (the wrapper hands out and a
// kHot-word scratch for the hot keys), run on the caller's stream and do
// not synchronise.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecPerThread = 4;                    // 16-byte loads in flight
constexpr int kTileVec = kThreads * kVecPerThread;  // int4 per block tile
constexpr int kHot = 64;
constexpr int kHotTable = 2 * kHot;  // open addressing, load <= 1/2
constexpr int kSample = 2048;
constexpr int kSampleTable = 2 * kSample;
constexpr int kMinHits = 4;  // 0.2% of the sample
// 32 KB: at W = 2048 a 64 KB accumulator left two blocks per SM.
constexpr int kHotAccBudget = 32 * 1024;
constexpr int kPrepThreads = 1024;

__device__ __forceinline__ unsigned key_hash(int p) {
  return static_cast<unsigned>(p) * 0x9E3779B1u;
}

// Block 0 writes up to n_slots hot keys of pk, from a strided sample, to
// hot[0, kHot) (unused slots -1) while the other blocks zero out, so the
// sample costs no launch of its own.
__global__ void __launch_bounds__(kPrepThreads)
    prep_kernel(const int32_t* __restrict__ pk, int64_t n_rows,
                int32_t n_parts, int n_slots, int32_t* __restrict__ hot,
                int32_t* __restrict__ out, int64_t out_words) {
  if (blockIdx.x == 0 && n_slots == 0) {
    for (int i = threadIdx.x; i < kHot; i += blockDim.x) hot[i] = -1;
  } else if (blockIdx.x == 0) {
    __shared__ int32_t keys[kSampleTable];
    __shared__ int32_t hits[kSampleTable];
    __shared__ int n_qual;
    __shared__ int n_out;
    for (int i = threadIdx.x; i < kSampleTable; i += blockDim.x) {
      keys[i] = -1;
      hits[i] = 0;
    }
    __syncthreads();
    const int n_sample =
        n_rows < kSample ? static_cast<int>(n_rows) : kSample;
    for (int s = threadIdx.x; s < n_sample; s += blockDim.x) {
      const int32_t p = pk[static_cast<int64_t>(s) * n_rows / n_sample];
      if (p < 0 || p >= n_parts) continue;
      unsigned h = key_hash(p) & (kSampleTable - 1);
      while (true) {
        const int32_t old = atomicCAS(&keys[h], -1, p);
        if (old == -1 || old == p) {
          atomicAdd(&hits[h], 1);
          break;
        }
        h = (h + 1) & (kSampleTable - 1);
      }
    }
    // The least threshold (from kMinHits, doubling) under which at most
    // n_slots keys qualify: the keys seen most.
    int threshold = kMinHits;
    while (true) {
      if (threadIdx.x == 0) n_qual = 0;
      __syncthreads();
      int mine = 0;
      for (int i = threadIdx.x; i < kSampleTable; i += blockDim.x) {
        mine += hits[i] >= threshold;
      }
      if (mine) atomicAdd(&n_qual, mine);
      __syncthreads();
      const int q = n_qual;
      __syncthreads();
      if (q <= n_slots) break;
      threshold *= 2;
    }
    if (threadIdx.x == 0) n_out = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < kSampleTable; i += blockDim.x) {
      if (hits[i] >= threshold) hot[atomicAdd(&n_out, 1)] = keys[i];
    }
    __syncthreads();
    for (int i = n_out + threadIdx.x; i < kHot; i += blockDim.x) hot[i] = -1;
  }
  // The other blocks zero out (16-byte aligned: it comes from the caching
  // allocator), block 0 too when it is alone.
  const int zeroers = gridDim.x > 1 ? gridDim.x - 1 : 1;
  const int zb = gridDim.x > 1 ? static_cast<int>(blockIdx.x) - 1 : 0;
  if (zb < 0) return;
  const int64_t n_vec = out_words / 4;
  const int64_t stride = static_cast<int64_t>(zeroers) * blockDim.x;
  int4* out4 = reinterpret_cast<int4*>(out);
  for (int64_t i = static_cast<int64_t>(zb) * blockDim.x + threadIdx.x;
       i < n_vec; i += stride) {
    out4[i] = make_int4(0, 0, 0, 0);
  }
  const int64_t i = 4 * n_vec + zb * blockDim.x + threadIdx.x;
  if (i < out_words) out[i] = 0;
}

struct HotSet {
  int32_t* key;       // [kHotTable], -1 empty
  int32_t* slot;      // [kHotTable]
  int32_t* slot_key;  // [kHot]
  int32_t* acc;       // [n_slots, C]

  __device__ __forceinline__ int find(int32_t p) const {
    unsigned h = key_hash(p) & (kHotTable - 1);
    while (true) {
      const int32_t k = key[h];
      if (k == p) return slot[h];
      if (k == -1) return -1;
      h = (h + 1) & (kHotTable - 1);
    }
  }
};

// Loads the first n_slots hot keys into the block's table and zeroes the
// accumulator.
__device__ HotSet load_hot(const int32_t* __restrict__ hot, int n_slots,
                           int n_cols, int32_t* smem) {
  HotSet hs{smem, smem + kHotTable, smem + 2 * kHotTable,
            smem + 2 * kHotTable + kHot};
  for (int i = threadIdx.x; i < kHotTable; i += blockDim.x) hs.key[i] = -1;
  for (int i = threadIdx.x; i < n_slots * n_cols; i += blockDim.x) {
    hs.acc[i] = 0;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < n_slots; i += blockDim.x) {
    const int32_t p = hot[i];
    hs.slot_key[i] = p;
    if (p >= 0) {
      unsigned h = key_hash(p) & (kHotTable - 1);
      while (atomicCAS(&hs.key[h], -1, p) != -1) h = (h + 1) & (kHotTable - 1);
      hs.slot[h] = i;
    }
  }
  __syncthreads();
  return hs;
}

// This thread's kVecPerThread int4 of the tile at vector index base,
// coalesced across the block; zeros past n_vec.
__device__ __forceinline__ void load_tile(const int4* __restrict__ body,
                                          int64_t base, int64_t n_vec,
                                          int4 (&v)[kVecPerThread]) {
#pragma unroll
  for (int u = 0; u < kVecPerThread; ++u) {
    const int64_t i = base + threadIdx.x + u * kThreads;
    v[u] = i < n_vec ? __ldcs(body + i) : make_int4(0, 0, 0, 0);
  }
}

// (row, column) of a tile-local word offset: a division by a constant
// for C_T > 0, else by n_cols.
template <int C_T>
__device__ __forceinline__ void row_col(int local, int n_cols, int& r,
                                        int& c) {
  r = local / n_cols;
  c = local - r * n_cols;
}

// Steps (r, c) by 32 words: a division by a constant for C_T > 0; for the
// wide rows of C_T = 0 (n_cols > 16) at most two wraps.
template <int C_T>
__device__ __forceinline__ void next_row_col(int n_cols, int& r, int& c) {
  if constexpr (C_T > 0) {
    const int local = r * C_T + c + 32;
    r = local / C_T;
    c = local - r * C_T;
  } else {
    c += 32;
    while (c >= n_cols) {
      c -= n_cols;
      ++r;
    }
  }
}

// Adds one element that needs no warp-wide step (the ragged ends).
__device__ __forceinline__ void add_one(const HotSet& hs,
                                        const int32_t* __restrict__ pk,
                                        int32_t* __restrict__ out,
                                        int64_t e, int32_t v, int n_cols,
                                        int32_t n_parts) {
  if (v == 0) return;
  const int64_t row = e / n_cols;
  const int c = static_cast<int>(e - row * n_cols);
  const int32_t p = pk[row];
  if (p < 0 || p >= n_parts) return;
  const int s = hs.find(p);
  if (s >= 0) {
    atomicAdd(hs.acc + s * n_cols + c, v);
  } else {
    atomicAdd(out + static_cast<int64_t>(p) * n_cols + c, v);
  }
}

// cols + head is 16-byte aligned; n_vec int4 follow it, then tail words.
// C_T is n_cols when it is at most 16, else 0 (read at run time).
template <int C_T>
__global__ void __launch_bounds__(kThreads)
    segsum_lanes_kernel(const int32_t* __restrict__ cols,
                        const int32_t* __restrict__ pk,
                        int32_t* __restrict__ out,
                        const int32_t* __restrict__ hot, int n_slots,
                        int32_t n_cols_rt, int32_t n_parts, int head,
                        int64_t n_vec, int tail) {
  const int n_cols = C_T > 0 ? C_T : n_cols_rt;
  extern __shared__ int4 smem4[];  // [stage | hot table | accumulator]
  int4* stage_base = smem4;
  const HotSet hs = load_hot(hot, n_slots, n_cols,
                             reinterpret_cast<int32_t*>(smem4 + kTileVec));
  const int lane = threadIdx.x & 31;

  // The ragged ends, 4-byte loads.
  const int gid = blockIdx.x * kThreads + threadIdx.x;
  if (gid < head) {
    add_one(hs, pk, out, gid, cols[gid], n_cols, n_parts);
  }
  if (gid < tail) {
    const int64_t e = head + 4 * n_vec + gid;
    add_one(hs, pk, out, e, cols[e], n_cols, n_parts);
  }

  const int4* body = reinterpret_cast<const int4*>(cols + head);
  // Each warp's 16-byte loads pass through shared memory so that lane l
  // then holds words l, l + 32, ... of the warp's span: the adds of one
  // instruction go to consecutive words of a row, as few L2 sectors as
  // the data allows (in the order of the loads, the lanes' words were 16
  // bytes apart: four times the sectors, 3.4 ms against 0.65 ms at
  // W = 512).
  int4* stage = stage_base + (threadIdx.x / 32) * (kVecPerThread * 32);
  const int32_t* words = reinterpret_cast<const int32_t*>(stage);
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kTileVec;
       base < n_vec; base += static_cast<int64_t>(gridDim.x) * kTileVec) {
    int4 v[kVecPerThread];
    load_tile(body, base, n_vec, v);
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) stage[u * 32 + lane] = v[u];
    __syncwarp();
    // One 64-bit division per tile; 32-bit offsets inside it. Word j of
    // this lane in span u lies at local = first + u * 4 * kThreads + 32 j.
    const int64_t e0 = head + 4 * base;
    const int64_t row0 = e0 / n_cols;
    const int first = static_cast<int>(e0 - row0 * n_cols) +
                      4 * (threadIdx.x & ~31) + lane;
    // The key of every nonzero word, all loads issued before any add.
    int32_t key[kVecPerThread][4];
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      int r, c;
      row_col<C_T>(first + u * 4 * kThreads, n_cols, r, c);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        key[u][j] = words[u * 128 + 32 * j + lane] != 0
                        ? __ldg(pk + row0 + r) : -1;
        next_row_col<C_T>(n_cols, r, c);
      }
    }
#pragma unroll
    for (int u = 0; u < kVecPerThread; ++u) {
      int r, c;
      row_col<C_T>(first + u * 4 * kThreads, n_cols, r, c);
      int32_t prev_p = -1;
      int prev_s = -1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int32_t val = words[u * 128 + 32 * j + lane];
        const int32_t p = key[u][j];
        int s = -2;  // nothing to add
        if (val != 0 && p >= 0 && p < n_parts) {
          s = p == prev_p ? prev_s : hs.find(p);
          prev_p = p;
          prev_s = s;
        }
        if (s >= 0) atomicAdd(hs.acc + s * n_cols + c, val);
        if (s == -1) {
          atomicAdd(out + static_cast<int64_t>(p) * n_cols + c, val);
        }
        next_row_col<C_T>(n_cols, r, c);
      }
    }
    __syncwarp();
  }

  // Flush: one global atomic per nonzero accumulator word.
  __syncthreads();
  for (int i = threadIdx.x; i < n_slots * n_cols; i += kThreads) {
    const int s = i / n_cols;
    const int32_t p = hs.slot_key[s];
    const int32_t sum = hs.acc[i];
    if (p >= 0 && sum != 0) {
      atomicAdd(out + static_cast<int64_t>(p) * n_cols + (i - s * n_cols),
                sum);
    }
  }
}

int hot_slots(int n_cols) {
  const int fit = kHotAccBudget / (4 * n_cols);
  return fit < kHot ? fit : kHot;
}

// Blocks of segsum_lanes_kernel<C_T> that fit an SM with smem bytes of
// dynamic shared memory, after raising the kernel's limit to smem. Kept
// for the next launch on the same device with the same smem: the queries
// take host time while the card waits between the two launches.
template <int C_T>
cudaError_t blocks_per_sm(int device, size_t smem, int* per_sm) {
  static int cached_device = -1;
  static size_t cached_smem = 0;
  static int cached = 0;
  if (device != cached_device || smem != cached_smem) {
    cudaError_t err = cudaFuncSetAttribute(
        segsum_lanes_kernel<C_T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int n = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, segsum_lanes_kernel<C_T>, kThreads, smem);
    if (err != cudaSuccess) return err;
    cached = n < 1 ? 1 : n;
    cached_smem = smem;
    cached_device = device;
  }
  *per_sm = cached;
  return cudaSuccess;
}

// The prep launch (hot keys, zeroed out), then the main one.
template <int C_T>
cudaError_t launch(const int32_t* cols, const int32_t* pk, int32_t* out,
                   int32_t* hot, int64_t n_rows, int n_cols, int n_parts,
                   int device, int n_sm, cudaStream_t stream) {
  const int n_slots = hot_slots(n_cols);
  const size_t smem =
      kTileVec * sizeof(int4) +
      (2 * kHotTable + kHot + static_cast<size_t>(n_slots) * n_cols) *
          sizeof(int32_t);
  int per_sm = 0;
  cudaError_t err = blocks_per_sm<C_T>(device, smem, &per_sm);
  if (err != cudaSuccess) return err;

  const int64_t out_words = static_cast<int64_t>(n_parts) * n_cols;
  int64_t prep_blocks =
      1 + (out_words / 4 + kPrepThreads - 1) / kPrepThreads;
  if (prep_blocks > 2 * n_sm) prep_blocks = 2 * n_sm;
  prep_kernel<<<static_cast<unsigned>(prep_blocks), kPrepThreads, 0,
                stream>>>(pk, n_rows, n_parts, n_slots, hot, out,
                          out_words);
  err = cudaGetLastError();
  const int64_t total = n_rows * n_cols;
  if (err != cudaSuccess || total == 0) return err;

  // Words up to the first 16-byte boundary, whole int4 after it, the rest.
  const int misalign =
      static_cast<int>((reinterpret_cast<uintptr_t>(cols) & 15) / 4);
  int64_t head = misalign == 0 ? 0 : 4 - misalign;
  if (head > total) head = total;
  const int64_t n_vec = (total - head) / 4;
  const int tail = static_cast<int>(total - head - 4 * n_vec);
  int64_t blocks = (n_vec + kTileVec - 1) / kTileVec;
  const int64_t ends = (head > tail ? head : tail);
  const int64_t end_blocks = (ends + kThreads - 1) / kThreads;
  if (blocks < end_blocks) blocks = end_blocks;
  const int64_t cap = static_cast<int64_t>(n_sm) * per_sm;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;
  segsum_lanes_kernel<C_T><<<static_cast<unsigned>(blocks), kThreads, smem,
                             stream>>>(cols, pk, out, hot, n_slots, n_cols,
                                       n_parts, static_cast<int>(head),
                                       n_vec, tail);
  return cudaGetLastError();
}

}  // namespace

// Hot-key slots of the shared-memory accumulator for rows of n_cols
// words: kHot, fewer when [kHot, n_cols] passes kHotAccBudget, 0 from
// n_cols > 8192 (every element then takes a global atomic).
extern "C" int segsum_lanes_hot_slots(int n_cols) {
  return hot_slots(n_cols);
}

// cols: int32 [n_rows, n_cols <= 2^28] contiguous (offsets within a tile
// are 32-bit), any 4-byte alignment; pk: int32 [n_rows]; out: int32
// [n_parts, n_cols], 16-byte aligned, written in full (zeroed first); hot:
// int32 scratch of at least kHot words. Returns the
// CUDA error code of the launches (0 on success).
extern "C" int segsum_lanes_launch(const void* cols_v, const void* pk_v,
                                   void* out_v, long long n_rows, int n_cols,
                                   int n_parts, void* hot_v, void* stream_v) {
  const auto* cols = static_cast<const int32_t*>(cols_v);
  const auto* pk = static_cast<const int32_t*>(pk_v);
  auto* out = static_cast<int32_t*>(out_v);
  auto* hot = static_cast<int32_t*>(hot_v);
  auto stream = static_cast<cudaStream_t>(stream_v);
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int n_sm = 0;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (n_cols) {
#define SEGSUM_CASE(C)                                                     \
  case C:                                                                  \
    return static_cast<int>(launch<C>(cols, pk, out, hot, n_rows, n_cols,  \
                                      n_parts, device, n_sm, stream));
    SEGSUM_CASE(1) SEGSUM_CASE(2) SEGSUM_CASE(3) SEGSUM_CASE(4)
    SEGSUM_CASE(5) SEGSUM_CASE(6) SEGSUM_CASE(7) SEGSUM_CASE(8)
    SEGSUM_CASE(9) SEGSUM_CASE(10) SEGSUM_CASE(11) SEGSUM_CASE(12)
    SEGSUM_CASE(13) SEGSUM_CASE(14) SEGSUM_CASE(15) SEGSUM_CASE(16)
#undef SEGSUM_CASE
    default:
      return static_cast<int>(launch<0>(cols, pk, out, hot, n_rows, n_cols,
                                        n_parts, device, n_sm, stream));
  }
}
