// Multi-tile subtree-leaf histogram for Hopper (sm_90a):
//
//   out[t, p, q, s] = #{ r : kept[r],  qpk[r] - p_offsets[t] == p,
//                            leaf[r] - sub_starts[t, p, q] == s }
//
// for p < Pb and s < span, in exact int32 arithmetic.
//
// Replaces pipelinedp_tpu/ops/kernels/hist.py::hist_bin_multi, the Pallas
// kernel that bins one batch's rows into every packed [T, Pb, Qc, span]
// tile of the quantile walk's bottom levels. The TPU kernel keeps the
// whole output in VMEM and counts with two one-hot contractions per
// (tile, quantile) on the MXU, so it runs only inside a 4 MB envelope. On
// Hopper int32 atomics add exactly in any order, so the counts equal the
// per-tile scatter (jax_engine._subtree_counts) bit for bit, and the
// output may be as large as device memory: there is no envelope.
//
// Bound on the H100: bytes (ops/kernels/hist.py::work). The kernel must
// write the output once (T * Pb * Qc * span * 4 bytes), read every kept
// flag, qpk and leaf at kept rows, and the starts and offsets. At BASELINE
// config 4 (N = 10M, P = 131072, Qc = 3, span = 256) that is 435 MB, 0.130
// ms at 3.35 TB/s, 403 MB of it the output; on a fused serve batch of 8
// PERCENTILE requests ([1, 16384, 3, 256], 4M rows) 86 MB, 0.026 ms, with
// the rows' reads a third of it. Only rows inside a chosen subtree add
// (about Qc / 256 of the kept rows for values spread over the range).
//
// The first design (one thread per row in a grid-stride loop, 8 blocks of
// 256 threads per SM, a memset by the wrapper) was bound by latency: each
// warp had one 32-byte sector in flight, a 1-byte kept load followed by
// dependent 4-byte loads and a dependent gather, about 270 KB card-wide
// where the card needs about 2 MB in flight to reach its bandwidth. The
// design now:
//   1. zero pass: a fresh output is zeroed by this source's own kernel,
//      from the same C entry and on the same stream, with 16-byte
//      streaming stores (__stcs, evict-first: the output passes L2),
//      four a thread in a grid-stride loop whose grid covers the output
//      in one round, and scalar stores for the words before the first
//      and after the last 16-byte boundary. The wrapper allocates with
//      torch.empty. Given an output to add into (a streamed sweep's
//      buffer), the pass is skipped. Measured on the H100 it ties
//      torch.zeros (both about 3.2 TB/s; a loop over only the resident
//      blocks was 4% slower);
//   2. count pass: each thread takes a run of 16 consecutive rows a step:
//      one 16-byte load of their kept flags, then for each 4-row group
//      with a kept flag one 16-byte load each of qpk and leaf, all issued
//      before any is used, while the next step's kept flags are already
//      in flight. Rows before the kept flags' first 16-byte boundary and
//      after their last are two more steps with scalar loads; where qpk
//      or leaf sits at another 16-byte phase than kept (views need not
//      share one), their loads are scalar, at kept rows only. No tensor
//      is copied. The warp then packs its kept rows (a prefix sum of the
//      lanes' counts) into shared memory, and each lane takes one packed
//      row a round: its tile-relative partition, then its Qc walk starts
//      (contiguous, read once per row and tile through the read-only
//      path, kQuant of them issued together). So the work follows the
//      kept rows: with 10% kept (config 4) a lane that counted its own
//      16 rows sat idle most of the time, and held 115 registers against
//      64. Persistent blocks fill the card: as many per SM as the
//      occupancy API allows;
//   3. warp-aggregated atomics: the lanes of a warp whose rows of one
//      round hit the same bin (__match_any_sync on the flat bin index)
//      add together, their leader with one atomicAdd of __popc of the
//      mask. Hits are rare on values spread over the range, so this costs
//      a ballot a (round, quantile); it bounds the hot bin that values
//      clipped at max_value make (a partition's clipped rows all land on
//      its top leaf) to one atomic per 32 rows instead of 32. Integer
//      adds are exact in any order: the counts stay bit for bit those of
//      the plain version.
//
// Measured (NVIDIA H100 80GB HBM3, 700 W; tools/segsum_ab.py --only K3,
// device time per call, against the first design in the same call): on
// config 4's stack the call 0.151 ms (first design 0.203), the count pass
// 0.024 (0.074); on the fused serve stack, 57% of 4M rows kept, 0.046
// (0.063) and 0.026 (0.037), where the rounds of start gathers lead; on
// 90% of 4M rows in one clipped leaf 0.092 (1.6).
//
// The relative partition and leaf indices are int32 differences that wrap
// as the plain version's int32 tensors wrap; unsigned compares put
// negative offsets out of range. The output index is int64 (T * Pb * Qc *
// span passes 2^31 at about two million partitions); the starts index is
// 32-bit, so T * Pb * Qc must stay below 2^31 (an 8 GB starts tensor).
// The kernels allocate nothing, run on the caller's stream and do not
// synchronise.

#include <atomic>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kStep = 16;  // rows a thread takes a step: one uint4 of kept
constexpr int kQuant = 4;  // walk starts a row gathers at once
constexpr int kZeroVec = 4;  // 16-byte stores a thread issues a round
constexpr unsigned kFull = 0xffffffffu;

// Zeroes out[0, n_words): n_vec 16-byte words from out + head on, kZeroVec
// of them a thread a round, then the head words before them and the tail
// words after them.
__global__ void zero_kernel(int32_t* __restrict__ out, int head,
                            int64_t n_vec, int64_t n_words) {
  int4* body = reinterpret_cast<int4*>(out + head);
  const int4 zero = make_int4(0, 0, 0, 0);
  const int64_t round =
      static_cast<int64_t>(gridDim.x) * blockDim.x * kZeroVec;
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * blockDim.x * kZeroVec +
                    threadIdx.x;
       i0 < n_vec; i0 += round) {
#pragma unroll
    for (int u = 0; u < kZeroVec; ++u) {
      const int64_t i = i0 + static_cast<int64_t>(u) * blockDim.x;
      if (i < n_vec) __stcs(body + i, zero);
    }
  }
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (tid < head) out[tid] = 0;
  const int64_t tail = head + 4 * n_vec + tid;
  if (tid < 4 && tail < n_words) out[tail] = 0;
}

// Where a step's rows lie: vector steps v in [0, n_body) take rows
// head + 16 v ..., kept's first 16-byte boundary on; step n_body takes the
// head rows [0, head), step n_body + 1 the tail rows [tail0, n_rows).
struct Steps {
  int64_t n_body;
  int64_t tail0;
  int head;
  int n_tail;
  bool vec_qpk;   // qpk + head is 16-byte aligned
  bool vec_leaf;  // leaf + head is 16-byte aligned
};

__device__ __forceinline__ int64_t step_row(const Steps& g, int64_t v) {
  return v < g.n_body ? g.head + kStep * v : (v == g.n_body ? 0 : g.tail0);
}

// Bit 0 of each byte: 1 where the byte of x is nonzero (a kept flag).
__device__ __forceinline__ uint32_t flags(uint32_t x) {
  return __vcmpne4(x, 0u) & 0x01010101u;
}

// The 16 kept flags of step v, one byte each (1 kept, 0 not or no row).
__device__ __forceinline__ uint4 load_kept(const uint8_t* __restrict__ kept,
                                           const Steps& g, int64_t v) {
  if (v < g.n_body) {
    const uint4 k =
        __ldcs(reinterpret_cast<const uint4*>(kept + g.head) + v);
    return make_uint4(flags(k.x), flags(k.y), flags(k.z), flags(k.w));
  }
  const int n = v == g.n_body ? g.head : (v == g.n_body + 1 ? g.n_tail : 0);
  const int64_t r0 = step_row(g, v);
  uint32_t w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int j = 0; j < kStep; ++j) {
    if (j < n && kept[r0 + j] != 0) w[j / 4] |= 1u << (8 * (j % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// x[r0 + 4 g .. + 3] for the 4-row groups g with a kept flag: one 16-byte
// load each where x sits at kept's phase, else 4-byte loads at kept rows.
__device__ __forceinline__ void load_group(const int32_t* __restrict__ x,
                                           int64_t r, uint32_t word,
                                           bool vec, int32_t* dst) {
  if (vec) {
    const int4 a = __ldcs(reinterpret_cast<const int4*>(x + r));
    dst[0] = a.x;
    dst[1] = a.y;
    dst[2] = a.z;
    dst[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      dst[i] = (word >> (8 * i)) & 1u ? __ldcs(x + r + i) : 0;
    }
  }
}

// Adds one to out[bin] for each lane of the warp with hit; lanes with the
// same bin add together through their lowest lane. All 32 lanes call it.
__device__ __forceinline__ void warp_add(int32_t* __restrict__ out, bool hit,
                                         uint64_t bin) {
  const unsigned peers = __match_any_sync(kFull, hit ? bin : ~0ull);
  const unsigned lane = threadIdx.x & 31;
  if (hit && static_cast<unsigned>(__ffs(peers) - 1) == lane) {
    atomicAdd(out + bin, __popc(peers));
  }
}

// The step's kept rows, bit j for row j.
__device__ __forceinline__ uint32_t kept_bits(const uint32_t (&words)[4]) {
  uint32_t bits = 0;
#pragma unroll
  for (int j = 0; j < kStep; ++j) {
    bits |= ((words[j / 4] >> (8 * (j % 4))) & 1u) << j;
  }
  return bits;
}

__global__ void __launch_bounds__(kThreads)
    hist_bin_kernel(const int32_t* __restrict__ qpk,
                    const int32_t* __restrict__ leaf,
                    const uint8_t* __restrict__ kept,
                    const int32_t* __restrict__ starts,
                    const int32_t* __restrict__ p_offsets,
                    int32_t* __restrict__ out, Steps g, int32_t n_tiles,
                    int32_t n_block, int32_t n_quant, int32_t span) {
  // Each warp's kept rows of one step, (qpk, leaf), packed in row order.
  __shared__ int2 queues[kThreads / 32][32 * kStep];
  int2* queue = queues[threadIdx.x >> 5];
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  const int64_t warp =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_steps = g.n_body + 2;
  const int64_t stride = 32 * n_warps;
  // Warp-uniform trip counts: every lane reaches each warp collective.
  uint4 kv = load_kept(kept, g, 32 * warp + lane);
  for (int64_t base = 32 * warp; base < n_steps; base += stride) {
    const int64_t v = base + lane;
    const uint4 next = load_kept(kept, g, v + stride);  // in flight meanwhile
    const uint32_t words[4] = {kv.x, kv.y, kv.z, kv.w};
    const int64_t r0 = step_row(g, v);
    const bool body = v < g.n_body;
    int32_t p[kStep], l[kStep];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (words[k] != 0) {
        load_group(qpk, r0 + 4 * k, words[k], body && g.vec_qpk, p + 4 * k);
        load_group(leaf, r0 + 4 * k, words[k], body && g.vec_leaf, l + 4 * k);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) p[4 * k + i] = l[4 * k + i] = 0;
      }
    }
    // Pack the warp's kept rows, so that each lane then takes one kept row
    // a round whatever the kept share.
    const uint32_t bits = kept_bits(words);
    const int mine = __popc(bits);
    int at = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, at, d);
      if (lane >= d) at += y;
    }
    const int n_kept = __shfl_sync(kFull, at, 31);
    at -= mine;
#pragma unroll
    for (int j = 0; j < kStep; ++j) {
      if ((bits >> j) & 1u) queue[at++] = make_int2(p[j], l[j]);
    }
    __syncwarp();
    for (int i0 = 0; i0 < n_kept; i0 += 32) {
      const bool have = i0 + lane < n_kept;
      const int2 row = have ? queue[i0 + lane] : make_int2(0, 0);
      for (int32_t t = 0; t < n_tiles; ++t) {
        const uint32_t rel = static_cast<uint32_t>(row.x) -
                             static_cast<uint32_t>(__ldg(p_offsets + t));
        const bool in_block = have && rel < static_cast<uint32_t>(n_block);
        if (__ballot_sync(kFull, in_block) == 0) continue;
        const uint32_t cell = (static_cast<uint32_t>(t) * n_block + rel) *
                              static_cast<uint32_t>(n_quant);
        for (int32_t q0 = 0; q0 < n_quant; q0 += kQuant) {
          int32_t st[kQuant];  // the row's walk starts, gathered together
#pragma unroll
          for (int u = 0; u < kQuant; ++u) {
            st[u] = in_block && q0 + u < n_quant
                        ? __ldg(starts + cell + q0 + u)
                        : 0;
          }
#pragma unroll
          for (int u = 0; u < kQuant; ++u) {
            if (q0 + u >= n_quant) break;  // warp-uniform
            const uint32_t s = static_cast<uint32_t>(row.y) -
                               static_cast<uint32_t>(st[u]);
            const bool hit = in_block && s < static_cast<uint32_t>(span);
            if (__ballot_sync(kFull, hit) != 0) {
              warp_add(out, hit,
                       static_cast<uint64_t>(cell + q0 + u) * span + s);
            }
          }
        }
      }
    }
    __syncwarp();  // the queue is refilled next step
    kv = next;
  }
}

// The SMs of `device` and the count pass's blocks per SM there, kept for
// the next launch on the same device: the queries take host time while the
// card waits. The service launches from several threads: the device is
// published after the values it keys.
cudaError_t card_shape(int device, int* n_sm, int* per_sm) {
  static std::atomic<int> cached_device{-1};
  static std::atomic<int> cached_sm{0}, cached_per_sm{0};
  if (cached_device.load(std::memory_order_acquire) != device) {
    int sms = 0, n = 0;
    cudaError_t err =
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, hist_bin_kernel,
                                                        kThreads, 0);
    if (err != cudaSuccess) return err;
    *n_sm = sms;
    *per_sm = n < 1 ? 1 : n;
    cached_sm.store(*n_sm, std::memory_order_relaxed);
    cached_per_sm.store(*per_sm, std::memory_order_relaxed);
    cached_device.store(device, std::memory_order_release);
    return cudaSuccess;
  }
  *n_sm = cached_sm.load(std::memory_order_relaxed);
  *per_sm = cached_per_sm.load(std::memory_order_relaxed);
  return cudaSuccess;
}

}  // namespace

// qpk, leaf: int32 [n_rows]; kept: uint8 [n_rows] (torch.bool);
// starts: int32 [n_tiles, n_block, n_quant]; p_offsets: int32 [n_tiles];
// out: int32 [n_tiles, n_block, n_quant, span]. With zero != 0, out is
// zeroed first (the zero pass); else the counts are added into it. Any
// pointer may sit at any element. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int hist_bin_launch(const void* qpk, const void* leaf,
                               const void* kept, const void* starts,
                               const void* p_offsets, void* out,
                               long long n_rows, int n_tiles, int n_block,
                               int n_quant, int span, int zero,
                               void* stream) {
  if (static_cast<int64_t>(n_tiles) * n_block * n_quant >= (1ll << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* out32 = static_cast<int32_t*>(out);
  if (zero != 0) {
    const int64_t n_words = static_cast<int64_t>(n_tiles) * n_block *
                            n_quant * span;
    int head = static_cast<int>(
        ((16 - (reinterpret_cast<uintptr_t>(out) & 15)) & 15) / 4);
    if (head > n_words) head = static_cast<int>(n_words);
    const int64_t n_vec = (n_words - head) / 4;
    // Enough blocks to cover the output in one round (the grid-stride
    // loop was measured slower with one round per SM-resident block).
    int64_t blocks = (n_vec + kThreads * kZeroVec - 1) / (kThreads * kZeroVec);
    blocks = blocks < 1 ? 1 : (blocks > (1 << 30) ? (1 << 30) : blocks);
    zero_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        out32, head, n_vec, n_words);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (n_rows == 0) return 0;
  Steps g;
  int64_t head = (16 - (reinterpret_cast<uintptr_t>(kept) & 15)) & 15;
  if (head > n_rows) head = n_rows;
  g.head = static_cast<int>(head);
  g.n_body = (n_rows - head) / kStep;
  g.tail0 = head + kStep * g.n_body;
  g.n_tail = static_cast<int>(n_rows - g.tail0);
  g.vec_qpk = ((reinterpret_cast<uintptr_t>(qpk) + 4 * head) & 15) == 0;
  g.vec_leaf = ((reinterpret_cast<uintptr_t>(leaf) + 4 * head) & 15) == 0;
  int n_sm = 0, per_sm = 0;
  err = card_shape(device, &n_sm, &per_sm);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One step a thread a round: the n_body + 2 steps over kThreads a block.
  const int64_t needed = (g.n_body + 2 + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(n_sm) * per_sm;
  const int64_t blocks = needed < cap ? needed : cap;
  hist_bin_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const int32_t*>(qpk), static_cast<const int32_t*>(leaf),
      static_cast<const uint8_t*>(kept), static_cast<const int32_t*>(starts),
      static_cast<const int32_t*>(p_offsets), out32, g, n_tiles, n_block,
      n_quant, span);
  return static_cast<int>(cudaGetLastError());
}
