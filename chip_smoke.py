"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each; any failure raises and exits non-zero:

1. card: name and power limit (``nvidia-smi``); build the kernel
   libraries from ``pipelinedp_tpu_torch/csrc/*.cu``, one ``nvcc`` each,
   all started together, and print the build seconds;
2. kernel vs plain: ``segment_sum_lanes`` on the card against its plain
   PyTorch version, bit for bit, at the shapes of the tests and on the
   flagship aggregation's own lane stack (P = 65536, C = 6, N = 25M),
   where the kernel, the plain version and one ``index_add_`` call (the
   library yardstick, never called by the port) are timed with CUDA
   events; and once more on a dense stack of that shape (every element
   nonzero) over the zipf(1.3) keys, the worst case for the atomics, in
   the main path's row order (the keys as the bounding sorts them) and in
   the raw order; the hot-key slots each launch had are logged;
3. main path, GPU vs CPU: ``DPEngine.aggregate`` at 1M rows and 8k
   partitions through ``TorchBackend(device="cuda")`` and
   ``TorchBackend(device="cpu")`` with one seed: the same kept keys and
   bit-identical float64 releases, and the kernel launched on the card;
4. main path at full scale: the MovieLens-25M-shaped flagship (25M rows,
   162k users, 59k partitions, COUNT+SUM+MEAN, Laplace, L0=4, Linf=2,
   eps=1, delta=1e-6, private selection) with the launch counts zeroed
   just before and read just after;
5. K2 vs plain: ``segment_sum_wide`` on the card against its plain
   version, bit for bit, at the shapes of the tests (widths that are no
   multiple of the kernel's column tile, P = 1, P on both sides of the
   shared-memory limit, P = 65536, lane-maximum columns) and on the lane
   stacks of the three VECTOR_SUM widths below, where the kernel, the
   plain version, one ``index_add_`` (the library yardstick) and K1 on
   the same stack (with its bound and library call) are timed, and on a
   dense zipf(1.3) stack at D = 64 over 65536 partitions, past the
   shared-memory limit, where K2 takes
   K1's kernel; the design each launch took (``segsum.wide_tile``, the
   kernel library's ``segsum_wide_tile``) is logged; the ``kernels`` line
   reports the D = 64 stack;
6. VECTOR_SUM, GPU vs CPU: 200k rows at D = 64 under the ``fx``
   accumulator with private selection, Laplace and Gaussian: the same
   kept keys and bit-identical float64 vectors, and K2 launched on the
   card and not on the CPU;
7. VECTOR_SUM at full width: the JAX package's ``bench_dp_vector_sum``
   data and params (D = 64, 256, 1024 at 2M, 500k, 125k rows; 2048
   public partitions; Gaussian, L0 = 4, Linf = 2, L2 norm 4.0) under
   ``fx``, with the launch counts zeroed just before each aggregation and
   read just after;
8. K3 vs plain: ``subtree_counts_multi`` on the card against its plain
   version, bit for bit, at the shapes of the tests (T = 1, 3, 5;
   unaligned starts; rows outside every block; ``kept`` mostly false;
   span 16, 64 and 256; adding into a sweep's buffer) and on the config-4
   stack (the bounded rows and top-walk starts of the aggregation in
   phase 10: T = 1, P = 131072, Q = 3, span = 256, N = 10M), where K3,
   the plain version, one ``bincount`` per (t, q) (the library
   yardstick) and the [P, 256] mid histogram are timed, the latter's K1
   launch held to its plain version and timed with its bound;
9. PERCENTILE, GPU vs CPU: 1M rows of the config-4 generator over 10k
   partitions, Laplace with private selection and Gaussian with public
   partitions, each single-batch and streamed at a chunk of n // 6 rows
   (seven batches): the same
   kept keys, bit-identical float32 percentiles and float64 variances,
   and K3 launched on the card (batches x sweeps when streamed) and never
   on the CPU;
10. BASELINE config 4 at full size (``zipf_dataset(10M, 200k, 100k,
    seed=4)``, P50/90/99 + VARIANCE, Laplace, L0 = 4, Linf = 2, private
    selection): single-batch, then streamed in six batches, with the
    launch counts of K1 and K3 zeroed just before each aggregation and
    read just after;
11. the JAX bench's ``bench_streamed_percentile`` shape (2M rows, 3000
    public partitions, seed 13, a chunk of n // 6 rows: seven batches)
    at the default byte cap and at a cap that makes pass B tile: the same
    percentiles;
12. K4 vs plain (after phase 4, on its data): ``segment_totals`` on the
    card against its plain version, bit for bit, on the flagship's
    bounded rows under per-partition sum bounds, on a hot-segment stack
    (one (user, partition) pair of 2^20 rows), on the mid-length stack
    (25M rows in segments of 65-1024 rows), each timed beside the plain
    version and one float32 ``index_add_`` (the library yardstick; its
    bits differ) with its bound (the larger of the bytes and the longest
    segment's add chain), and on every layout of
    ``segtotal.seam_layout`` (segments over the seams of the kernel's
    tiled fold), aligned and as an offset view; K1 timed on the
    per-partition lane stack;
13. the per-partition-sum-bounds SUM, GPU vs CPU: 1M rows, COUNT+SUM
    with totals clipped to [0, 20], in the three bounding modes: the same
    kept keys and float64 releases, K4 launched on the card where
    segments have rows to add;
14. that SUM at the flagship's full size (25M rows, L0 = 4, Linf = 2),
    with the kernel counts zeroed just before and read just after;
15. streamed VECTOR_SUM as ``bench_dp_vector_sum`` streams it (a chunk of
    n // 4: four batches, K2 once each): GPU vs CPU bit for bit at 200k
    rows, then rows/s and coordinate bytes/s at the three full widths
    (after phase 7);
16. streamed ``select_partitions`` (after phase 10): GPU vs CPU on the
    kept set at 1M rows in five batches, timed on config 4's 10M rows in
    six;
17. config 4 streamed under each pass-B source (``device_cache``, a
    ``hybrid`` budget of about half the batches, ``reship``) and each
    executor mode (serial, overlapped): bit for bit phase 10's streamed
    release;
18. kill and resume: config 4 streamed killed at batch 3 by the port's
    ``FaultPlan`` and resumed from a checkpoint under ``build/``, serial
    and overlapped: bit for bit the uninterrupted run;
19. the JAX package's streaming record shape (``bench_streaming``: 150M
    rows, COUNT+SUM+MEAN, three batches of the default chunk), serial and
    overlapped: bit for bit the same release, with each wall and its
    stage / device / fold split;
20. K5 vs plain: ``segmented_sums`` on the card against its plain
    version, bit for bit, on config 5's count stack (``[n, Cc * 5]``, the
    first chunk of phase 22: the marker rows in key order) and
    selection-moment stack (``[n, Cc * 3]``), on a one-key stack of the
    same rows (the add chain's case) and on the count stack of every row
    in key order (``[500k, 660]``, the rows K5 v1 read), each timed beside
    the plain version and one float32 ``index_add_`` (the library
    yardstick; its bits differ) with its bound, and on every layout of
    ``segkeyed.seam_layout``, with and without dropped rows, aligned and
    one float in;
21. the utility-analysis sweep, GPU vs CPU: config 5's data over 64
    configs of its grid (a chunk of 64 on the card, of 32 on the CPU), a
    mixed-mechanism sweep with public partitions (two empty) and
    per-partition rows, and the fused dataset histograms and ``tune`` on
    config 5's data: every field bit for bit;
22. BASELINE config 5 at its spec (``bench_analysis_sweep``:
    ``zipf_dataset(500k, 20k, 1000, seed=1)``, the 100 x 100 (l0, linf)
    grid of 10,000 configs, COUNT, Laplace, truncated-geometric
    selection): wall, configs/s, configs x rows / s, the chunking, K5's
    and K4's device time from CUDA events, the peak memory, with the
    kernel counts zeroed just before and read just after;
23. the sweep killed at config chunk 3 and resumed from its ``.sweep``
    checkpoint under ``build/``: bit for bit the unbroken sweep;
24. ``bench_utility_megasweep``'s shape (1M rows, 2000 partitions) at
    K = 16, 64, 256: walked (width 1) and batched (width K) bit for bit,
    configs/s of each;
25. the generic host path, in four parts: (a) routing on the card:
    fusable params on ``TorchBackend()`` give the fused path's lazy
    result, while a COUNT + PERCENTILE(50) over a range of 1e-35 (too small
    for the fused walk's float32 leaf constant) and a custom combiner take
    the host graph and release the same bits on ``TorchBackend()``,
    ``TorchBackend("cpu")`` and ``LocalBackend()`` under one host seed,
    and ``select_partitions`` on ``LocalBackend`` keeps the same keys here
    and in a spawned process that sees no card; (b) the host oracle on the
    flagship's first 250,000 rows (COUNT + SUM + PRIVACY_ID_COUNT, eps
    1e12, public keys, L0 and Linf at the rows' maxima) against the fused
    path (K1): counts equal after rounding, sums within
    ``1e-5 |sum| + 1e-3``; (c) the JAX bench's host-oracle spot check, 3
    configs on 20,000 rows of config 5's data, host graph against the
    fused sweep (K4, K1, K5), ``error_expected`` within ``max(5%, 0.5)``,
    and ``return_per_partition`` past a shrunken ``_PP_BYTE_CAP`` on
    ``TorchBackend()``, which takes the host graph and equals the CPU run
    bit for bit; (d) ``LocalBackend``'s rates at the JAX bench's sizes
    (the flagship at 250,000 rows, config 4 at 50,000, the sweep's unit
    rate on 8 nominal configs x 20,000 rows; best of 2 on the host, of 3
    on the card) beside the fused path's on the same rows and phases 4,
    10 and 22's full-size cells, with the ratios and the host CPU's model;
26. sketch-first DP heavy hitters, the JAX bench's
    ``bench_dp_heavy_hitters`` (``bench.py:1700-1795``; keys ``"url/" +
    (zipf(1.2) % (n / 10))``, n / 20 users, COUNT + SUM, Laplace, L0 = 4,
    Linf = 2; sketch eps 2, delta 1e-7, depth 2), in four parts: (a) its
    smoke shape (200,000 rows, width 2^12, cap 256, seed 31) on
    ``TorchBackend()`` and ``TorchBackend("cpu")`` under each binner
    backend: the same candidates, kept keys and float64 bits, the binner
    on the card, K1 launched, and the binner's counts on the card equal to
    ``np.bincount``; (b) PARITY row 37 on the card: every populated bucket
    selected, the release bit for bit the dense ``aggregate``'s; (c) the
    full size (10M rows, 1M distinct strings, 500,000 users, width 2^16,
    cap 2048): cold, then best of two warm (seeds 31, 32), with rows/s,
    the phase split, the funnel, top-50 recall, peak memory, K1's
    launches and the binner's CUDA-event time per chunk under each
    backend; (d) ``make_private(...).count`` and ``.sum`` on
    ``TorchBackend()``, bit for bit ``TorchBackend("cpu")``, K1 launched;
27. PLD budget accounting and the hardened native noise, in three
    parts, with the native libraries built from
    ``pipelinedp_tpu_torch/native/*.cc`` (the phase fails if either does
    not build): (a) under ``PLDBudgetAccountant(1, 1e-6)`` the flagship's
    params (Laplace, truncated-geometric selection), the same with
    Gaussian noise, and the per-partition-sum SUM (K4), each on 250,000
    rows of the flagship's generator on the card and on the CPU: the same
    kept keys, float64 bits and ``minimum_noise_std``; then each at the
    flagship's full size (25M rows), with ``compute_budgets`` timed on its
    own, the aggregation's wall and rows/s, and each mechanism's granted
    noise std beside the naive accountant's; (b) under
    ``set_secure_host_noise(True)`` with ``seed_host_rng(s)`` and no
    ``rng_seed``: COUNT, PRIVACY_ID_COUNT, SUM, MEAN and VARIANCE under
    both noise kinds on the 250,000 rows, and VECTOR_SUM at D = 64 on
    200,000 rows under ``fx`` (K2), card = CPU bit for bit with the same
    native calls, the integer sampler reached for the scalar metrics and
    the float sampler everywhere; then the full flagship with numpy noise
    and hardened, in turns, each with its ``host_decode_s`` and wall;
    (c) the flagship's keys and users spread to ``k * 2^33 + 7``, so the
    encode takes ``native.factorize_i64`` for both: the same released
    bytes as the unspread run, with ``host_encode_s`` beside the
    unspread run's and beside ``np.unique`` on the same arrays;
28. the obs and plan planes on the card, in three parts: (a) the
    flagship at full size (phase 4's data and params) once with every
    plane off (``PIPELINEDP_TPU_AUDIT=0``) and once with trace (a Chrome
    trace path), audit, costs and the heartbeat (a heartbeat path) on and
    a ledger directory, all under a temporary directory: both release
    phase 4's bytes; each ``timings`` field equals its ``engine.*`` span's
    total; the run report's fingerprint names the card; the cost table
    has K1's entry with its CUDA-event ms, its analytic bytes and a
    verdict against the H100 row, and the five kernel builds; the audit
    holds the accountant, aggregation and selection records; the store
    one entry under the port's fingerprint; the Chrome trace parses; the
    heartbeat reads back with a phase; (b) config 4 streamed in six
    batches under a plan file written by ``plan.write_plan`` that turns
    the ingest executor off and the pass-B cache to 0: phase 10's
    streamed bytes, ``plan.applied`` from the plan for both knobs, the
    serial executor and the re-shipped pass B; (c) the flagship's wall
    with every plane off and every plane on, three runs each in turns,
    their medians and difference beside the card's name and power limit;
29. the resident service (``pipelinedp_tpu_torch.serve``) on the card,
    at the JAX bench's serve records (``bench.py:1301-1560``: keys
    ``zipf(1.3) % 2000``, pids in ``[0, rows / 8)``, COUNT + SUM + MEAN,
    Laplace, L0 = 4, Linf = 2, three tenants, eps 0.5 per request), in
    three parts: (a) ``serve_request_latency`` at 500,000 rows with
    fusion off: a cold request, 12 sequential and 16 concurrent warm
    ones, each released bit for bit as the same request through
    ``DPEngine`` on the card (PARITY row 34), with the cold wall, warm
    p50 and p99, and sequential and concurrent requests/s; (b)
    ``serve_fused_throughput`` at 20,000 rows: 8 concurrent requests, a
    warm-up burst and 3 timed rounds, solo then fused; the warm-up
    bursts bit for bit between the modes and against the port's CPU solo
    run, every response served, at least one fused batch, K1 launched
    exactly once per fused batch (and once per request served solo),
    fused and solo requests/s; (c) one fused burst of 8 requests x
    500,000 rows: one batch, one K1 launch over the 4M rows, that stack
    timed against its plain version, its bound and ``index_add_``;
30. the mesh (``pipelinedp_tpu_torch/parallel``), after the rest, in
    two parts: (a) 4 gloo ranks (``parallel.launch.RankPool``) sharing
    ``cuda:0``, and the same 4 ranks on the CPU, at 200,000 rows of each
    generator: the flagship's COUNT+SUM+MEAN with its caps, config 4's
    P50/90/99 + VARIANCE (the walk on owned blocks), VECTOR_SUM at D = 64
    under ``fx``, the per-partition SUM, config 4 streamed in four
    batches, config 5's sweep over 1,024 configs and sketch-first at its
    smoke shape: every rank's release the same and the card's the CPU's,
    bit for bit, each workload's kernels launched on every card rank and
    on no CPU rank, and the flagship and config 4 under ``hier`` with two
    simulated hosts equal to ``flat``; (b) the 25M-row flagship on a
    one-rank NCCL mesh and on the 4-rank gloo mesh on the card: with the
    data's own maxima as caps both equal the single-device card release
    bit for bit; with the flagship's caps the wall, each rank's K1 ms and
    launches, the comms bytes and each rank's peak memory, beside the
    card's name and power limit (four ranks on one card measure no
    multi-GPU speed);
31. a ``kernels`` JSON line per kernel (K1-K5), then the card line, then
    the result line ``{"ok": true, "device": {...}}`` last.

``python3 chip_smoke.py --profile`` adds a breakdown of the flagship
after phase 4, of config 4 after phase 10 and of config 5's sweep after
phase 22: CUDA-event times of each device stage, and the device busy
share and top operators from ``torch.profiler``; and one more overlapped
150M-row run under the profiler in phase 19. ``--out DIR`` writes the
phase records (``chip_smoke.json``) and the profiler tables
(``flagship_profile.txt``, ``config4_profile.txt``,
``config4_streamed_profile.txt``, ``stream150_profile.txt``,
``config5_profile.txt``) into DIR.

It exits non-zero, and prints no result, without a CUDA device.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import numpy as np  # noqa: E402
import torch  # noqa: E402

FLAGSHIP = dict(rows=25_000_000, users=162_000, partitions=59_000, seed=6)
# ``bench.py``'s ``bench_dp_vector_sum`` at its full size.
VECTOR_WIDTHS = (64, 256, 1024)
VECTOR_ROWS_AT_64 = 2_000_000
VECTOR_PARTITIONS = 2048
# BASELINE config 4: ``bench.py``'s ``zipf_dataset(10_000_000, 200_000,
# 100_000, seed=4)``.
CONFIG4 = dict(rows=10_000_000, users=200_000, partitions=100_000, seed=4)
CHUNK_ENV = "PIPELINEDP_TPU_STREAM_CHUNK"
CAP_ENV = "PIPELINEDP_TPU_SUBHIST_CAP"
KERNEL_SOURCES = ("segsum_lanes", "segsum_wide", "hist_bin", "segtotal",
                  "segkeyed")
# ``bench.py``'s ``bench_streaming`` at its default ``--stream-rows``.
STREAM_ROWS = 150_000_000
# K4's hot segment: one (user, partition) pair of 2^20 rows.
HOT_ROWS = 1 << 20
# BASELINE config 5: ``bench.py``'s ``bench_analysis_sweep`` at its spec,
# ``zipf_dataset(500_000, 20_000, 1_000, seed=1)`` over the 100 x 100
# (l0, linf) grid.
CONFIG5 = dict(rows=500_000, users=20_000, partitions=1_000, seed=1)
CONFIG5_CONFIGS = 10_000
# ``bench.py``'s ``bench_utility_megasweep`` at 1M rows.
MEGASWEEP = dict(rows=1_000_000, users=40_000, partitions=2_000, seed=23)
MEGASWEEP_WIDTHS = (16, 64, 256)
SWEEP_BATCH_ENV = "PIPELINEDP_TPU_SWEEP_CONFIG_BATCH"
RECORD = {"phases": {}}


def log(phase: str, **fields) -> None:
    RECORD["phases"][phase] = fields
    print(f"[{phase}] " + json.dumps(fields, default=float), flush=True)


def zipf_columns(n_rows, n_users, n_partitions, seed, value_hi=10.0):
    """The columns of the JAX package's ``bench.zipf_dataset``: zipf(1.3)
    partition keys modulo the partition count, uniform users and values,
    from one numpy generator in that order."""
    rng = np.random.default_rng(seed)
    raw = rng.zipf(1.3, size=n_rows) % n_partitions
    pids = rng.integers(0, n_users, n_rows)
    values = rng.uniform(0.0, value_hi, n_rows)
    return pids, raw.astype(np.int64), values


def cuda_ms(fn, reps: int = 21, warm: int = 3) -> float:
    """Median milliseconds of ``fn`` over ``reps`` warm runs (CUDA
    events around each run)."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_card():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    max_sm_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    from concurrent.futures import ThreadPoolExecutor
    from pipelinedp_tpu_torch.ops.kernels import _build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        list(pool.map(_build.load, KERNEL_SOURCES))
    log("card", nvidia_smi=smi, device=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda, build_s=time.perf_counter() - t0,
        kernels_built=list(KERNEL_SOURCES), max_sm_mhz=max_sm_mhz)
    return smi, max_sm_mhz


def phase_kernel(columns):
    from pipelinedp_tpu_torch.ops.kernels import segsum
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    checked = []
    shapes = [(8, 2, 1000), (64, 11, 5000), (1024, 14, 20_000),
              (8192, 4, 3000)]
    for P, C, n in shapes:
        pk = torch.randint(0, P, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
        cols = torch.randint(0, 4096, (n, C), generator=gen, device=dev,
                             dtype=torch.int32)
        got = segsum.segment_sum_lanes(cols, pk, P)
        want = segsum.segment_sum_lanes_plain(cols, pk, P)
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"mismatch at P={P} C={C} n={n}"
        checked.append([P, C, n])
    for bits in (12, 11, 4):
        n, P = 8192, 16
        cols = torch.full((n, 3), (1 << bits) - 1, dtype=torch.int32,
                          device=dev)
        pk = torch.zeros(n, dtype=torch.int32, device=dev)
        got = segsum.segment_sum_lanes(cols, pk, P)
        assert int(got[0, 0]) == n * ((1 << bits) - 1)
        assert torch.equal(got, segsum.segment_sum_lanes_plain(cols, pk, P))
        checked.append([P, 3, n, f"lane_max_{bits}bit"])

    # The flagship's own lane stack, as the main path builds it: bounding
    # keeps 8 rows per user at most (L0=4, Linf=2), so most rows of the
    # stack are zero and issue no atomic.
    stack, spk, P = flagship_stack(columns)
    n, C = stack.shape
    got = segsum.segment_sum_lanes(stack, spk, P)
    want = segsum.segment_sum_lanes_plain(stack, spk, P)
    torch.cuda.synchronize()
    max_abs_err = int((got.long() - want.long()).abs().max())
    assert max_abs_err == 0, f"flagship mismatch: {max_abs_err}"
    checked.append([P, C, n, "flagship stack"])
    timings = time_kernel(stack, spk, P)
    nonzero_rows = float((stack != 0).any(dim=1).float().mean())
    del stack, got, want

    # The same shape with every element nonzero: the worst case for the
    # atomics on zipf(1.3) keys, where a quarter of the rows share one
    # partition; in the main path's row order and in the raw order.
    raw_keys = torch.from_numpy(columns[1].astype(np.int32)).to(dev)
    dense = torch.randint(0, 64, (n, C), generator=gen, device=dev,
                          dtype=torch.int32)
    dense[:, :2] = 1
    dense_timings = {}
    for order, keys in (("main_path_order", spk), ("raw_order", raw_keys)):
        assert torch.equal(segsum.segment_sum_lanes(dense, keys, P),
                           segsum.segment_sum_lanes_plain(dense, keys, P))
        checked.append([P, C, n, f"dense zipf1.3, {order}"])
        dense_timings[order] = time_kernel(dense, keys, P)
    hot_share = float(np.bincount(columns[1]).max() / n)
    del dense, raw_keys, spk
    log("kernel", kernel="segment_sum_lanes", bit_equal_shapes=checked,
        hot_slots=hot_slots(C),
        flagship=dict(shape=[P, C, n], nonzero_row_share=nonzero_rows,
                      **timings),
        dense_zipf=dict(hottest_partition_row_share=hot_share,
                        **dense_timings))
    return dict(max_abs_err=max_abs_err, **timings)


def hot_slots(C):
    """Hot-key slots of K1's shared-memory accumulator for C lanes."""
    import ctypes
    from pipelinedp_tpu_torch.ops.kernels import _build
    fn = _build.load("segsum_lanes").segsum_lanes_hot_slots
    fn.argtypes = [ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(C)


def wide_design(W, P):
    """The design K2 takes at (W, P), from the kernel library's rule."""
    from pipelinedp_tpu_torch.ops.kernels import segsum
    tile = segsum.wide_tile(W, P)
    return (f"shared-memory tile {tile}" if tile else
            f"K1's kernel, {hot_slots(W)} hot slots")


def flagship_stack(columns):
    """The [N, C] lane stack and sorted keys that ``_reduce_per_pk`` hands
    the kernel in the flagship aggregation (same data, params and seed)."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    from pipelinedp_tpu_torch.ops import prng
    params = pdt.AggregateParams(**flagship_params(pdt))
    config = te.FusedConfig.from_params(params, public=False)
    enc = te.encode(pdt.ArrayDataset(*columns), None, None)
    pid, pk, values = te.put_on_device(enc, torch.device("cuda"))
    fx_bits = te._fx_plan(enc.n_rows)[0]
    k_bound = prng.split(prng.PRNGKey(FLAGSHIP["seed"]), 3)[0]
    b = te._bound_rows(config, pid, pk, values, k_bound)
    stack, _ = te._lane_stack(config, b.masked, b.keep_row, b.seg_marker,
                              fx_bits)
    return stack, b.spk.to(torch.int32).contiguous(), te._pad_pow2(
        len(enc.pk_vocab))


def card_bound(work):
    """The bound of a kernel's ``work`` on this card, from the cost
    table's peak row (``obs/costs.py``: the H100's data-sheet memory
    rate, float32 rate and top SM clock), so the kernels line and the
    cost table give one bound for one launch."""
    from pipelinedp_tpu_torch.obs import costs
    peaks = costs.device_peaks(torch.cuda.get_device_name(0))
    assert peaks is not None and not peaks["proxy"], peaks
    return costs.kernel_bound(work, peaks)


def time_kernel(cols, pk, P, kernel="segment_sum_lanes"):
    """Median ms of ``kernel``, its plain version and one ``index_add_``
    (the library yardstick), and the bound for these inputs."""
    from pipelinedp_tpu_torch.ops.kernels import segsum
    launch = getattr(segsum, kernel)
    plain = getattr(segsum, kernel + "_plain")
    C = cols.shape[1]
    pk_long = pk.long()

    def library():
        return torch.zeros(P, C, dtype=torch.int32,
                           device=cols.device).index_add_(0, pk_long, cols)

    assert torch.equal(library(), plain(cols, pk, P))
    # Least work for these inputs: ``segsum.work``, the counts the cost
    # table bounds each launch with.
    work = segsum.work(cols, pk, P)
    bound = card_bound(work)
    return dict(
        ms=cuda_ms(lambda: launch(cols, pk, P)),
        plain_ms=cuda_ms(lambda: plain(cols, pk, P)),
        library_ms=cuda_ms(library),
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        bound_bytes=work.bytes, nonzero_elements=work.ops)


def _aggregate(pdt, columns, params_kw, device, seed, public=None,
               **backend):
    pids, pks, values = columns
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(device=device,
                                                rng_seed=seed, **backend))
    result = engine.aggregate(
        pdt.ArrayDataset(privacy_ids=pids, partition_keys=pks,
                         values=values),
        pdt.AggregateParams(**params_kw), pdt.DataExtractors(),
        public_partitions=public)
    acc.compute_budgets()
    rows = list(result)
    return rows, result.timings


def flagship_params(pdt):
    """``bench.py``'s ``flagship_params``: MEAN+COUNT+SUM, Laplace, L0=4,
    Linf=2, values in [0, 10]; private selection (truncated geometric)."""
    return dict(metrics=[pdt.Metrics.MEAN, pdt.Metrics.COUNT,
                         pdt.Metrics.SUM],
                noise_kind=pdt.NoiseKind.LAPLACE,
                max_partitions_contributed=4,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)


def phase_gpu_vs_cpu():
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.ops.kernels import segsum
    columns = zipf_columns(1_000_000, 40_000, 8192, seed=7)
    params = flagship_params(pdt)
    segsum.reset_launches()
    gpu_rows, gpu_t = _aggregate(pdt, columns, params, "cuda", 7)
    gpu_launches = segsum.LAUNCHES["segment_sum_lanes"]
    cpu_rows, cpu_t = _aggregate(pdt, columns, params, "cpu", 7)
    assert segsum.LAUNCHES["segment_sum_lanes"] == gpu_launches, (
        "the CPU run launched a kernel")
    assert gpu_launches >= 1, "the CUDA run never launched the kernel"
    assert [k for k, _ in gpu_rows] == [k for k, _ in cpu_rows], (
        "kept partition keys differ between the card and the CPU")
    assert len(gpu_rows) > 0
    for (k, a), (_, b) in zip(gpu_rows, cpu_rows):
        assert a._fields == b._fields
        assert (np.asarray(a, np.float64).tobytes() ==
                np.asarray(b, np.float64).tobytes()), f"release differs at {k}"
    log("gpu_vs_cpu", rows=1_000_000, partitions=8192,
        kept=len(gpu_rows), identical=True, launches=gpu_launches,
        gpu_device_s=gpu_t["device_s"], cpu_device_s=cpu_t["device_s"])


def phase_flagship(columns):
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.ops.kernels import segsum
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    segsum.reset_launches()
    t0 = time.perf_counter()
    rows, timings = _aggregate(pdt, columns, flagship_params(pdt), "cuda",
                               FLAGSHIP["seed"])
    wall_s = time.perf_counter() - t0
    launches = segsum.LAUNCHES["segment_sum_lanes"]
    assert launches >= 1, "the flagship run never launched the kernel"
    assert len(rows) > 0, "the flagship kept no partition"
    released = np.asarray([tuple(m) for _, m in rows], np.float64)
    assert released.shape == (len(rows), 3)
    assert np.isfinite(released).all()
    assert rows[0][1]._fields == ("mean", "count", "sum")
    n_parts = int(np.unique(columns[1]).size)
    log("flagship", rows=FLAGSHIP["rows"], users=FLAGSHIP["users"],
        partitions=n_parts, kept=len(rows),
        wall_s=wall_s, rows_per_s=FLAGSHIP["rows"] / wall_s,
        host_encode_s=timings["host_encode_s"],
        device_s=timings["device_s"],
        host_decode_s=timings["host_decode_s"],
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        segment_sum_lanes_launches=launches)
    return launches, rows


def _stage_timer(stages):
    """``timed(name, fn)``: runs ``fn`` between two CUDA events after a
    synchronise and records its milliseconds under ``name``."""

    def timed(name, fn):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        stages[name] = start.elapsed_time(end)
        return out

    return timed


def _profiled(run, out_path):
    """Runs ``run()`` once under ``torch.profiler``: the summed device
    time of its kernels and copies over the wall gives the busy share;
    the full operator table goes to ``out_path`` (if any)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    # Device rows only (kernels, copies, sets): an operator's row repeats
    # the device time of the kernels it launched.
    device_rows = [e for e in averages
                   if e.device_type == DeviceType.CUDA
                   and not e.key.startswith("Activity Buffer")]
    busy_ms = sum(e.self_device_time_total for e in device_rows) / 1e3
    top = sorted(device_rows, key=lambda e: e.self_device_time_total,
                 reverse=True)[:10]
    if out_path:
        with open(out_path, "w") as f:
            f.write(averages.table(sort_by="self_device_time_total",
                                   row_limit=40))
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=1.0 - busy_ms / wall_ms,
                top_device_ms={e.key[:90]: e.self_device_time_total / 1e3
                               for e in top})


def phase_breakdown(columns, out_dir):
    """``--profile`` only: where the flagship's time goes. The device
    path runs stage by stage with CUDA events around each stage, then the
    whole aggregation runs once under ``torch.profiler``."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    from pipelinedp_tpu_torch.ops import prng

    dev = torch.device("cuda")
    params = pdt.AggregateParams(**flagship_params(pdt))
    config = te.FusedConfig.from_params(params, public=False)
    stages = {}
    timed = _stage_timer(stages)
    t0 = time.perf_counter()
    enc = te.encode(pdt.ArrayDataset(*columns), None, None)
    stages["host_encode"] = (time.perf_counter() - t0) * 1e3
    pid, pk, values = timed("h2d", lambda: te.put_on_device(enc, dev))
    n_parts = len(enc.pk_vocab)
    P = te._pad_pow2(n_parts)
    fx_bits = te._fx_plan(enc.n_rows)[0]
    # The flagship's naive split gives the selection eps 0.5 (two
    # mechanisms of weight 1) and all of delta.
    table, thr, scale, min_count = te.selection_inputs(config, 0.5, 1e-6,
                                                       None)
    k_bound, k_sel, _ = prng.split(prng.PRNGKey(FLAGSHIP["seed"]), 3)
    part, nseg, _ = timed("partials", lambda: te._partials(
        config, P, pid, pk, values, k_bound, fx_bits))
    keep, raw = timed("selection", lambda: te._selection_and_metrics(
        config, P, part, nseg, table, thr, scale, min_count, 1.0, k_sel))
    cols = [raw[k] for k in sorted(raw)]
    timed("compact_fetch", lambda: te._compact_fetch(
        keep, cols, n_parts, min(n_parts, te._COMPACT_FETCH_CAP)).cpu())
    prof = _profiled(lambda: _aggregate(pdt, columns, flagship_params(pdt),
                                        "cuda", FLAGSHIP["seed"]),
                     out_dir and os.path.join(out_dir,
                                              "flagship_profile.txt"))
    log("breakdown", stage_ms=stages, **prof)


def vector_columns(rng, d):
    """One width of ``bench.py``'s ``bench_dp_vector_sum``: rows scale as
    1/D from 2M at D = 64; zipf(1.3) keys over 2048 partitions; n / 8
    users; uniform [-1, 1) float32 coordinates; drawn from ``rng`` in the
    bench's order."""
    n = max(VECTOR_ROWS_AT_64 * VECTOR_WIDTHS[0] // d, 2_000)
    pids = rng.integers(0, max(n // 8, 500), n)
    pks = (rng.zipf(1.3, n) % VECTOR_PARTITIONS).astype(np.int32)
    values = rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32)
    return pids, pks, values


def vector_params(pdt, d, noise="GAUSSIAN"):
    """``bench_dp_vector_sum``'s params at width ``d``."""
    return dict(metrics=[pdt.Metrics.VECTOR_SUM],
                noise_kind=pdt.NoiseKind[noise],
                max_partitions_contributed=4,
                max_contributions_per_partition=2, vector_size=d,
                vector_max_norm=4.0, vector_norm_kind=pdt.NormKind.L2)


def vector_stack(columns, d, public):
    """The [N, n_lanes * D] lanes and sorted keys that ``_reduce_per_pk``
    hands K2 in the full-width aggregation at width ``d`` (its data,
    params and seed)."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    from pipelinedp_tpu_torch.ops import prng
    params = pdt.AggregateParams(**vector_params(pdt, d))
    config = te.FusedConfig.from_params(params, public=public is not None)
    assert config.vector_accumulator == "fx"
    enc = te.encode(pdt.ArrayDataset(*columns), None, public,
                    vector_size=d)
    pid, pk, values = te.put_on_device(enc, torch.device("cuda"))
    fx_bits = te._fx_plan(enc.n_rows)[0]
    k_bound = prng.split(prng.PRNGKey(0), 3)[0]
    b = te._bound_rows(config, pid, pk, values, k_bound)
    lanes = te._vector_lanes(config, b.masked, b.keep_row, fx_bits)
    return (lanes, b.spk.to(torch.int32).contiguous(),
            te._pad_pow2(len(enc.pk_vocab)), fx_bits)


def phase_wide_kernel(vector_data):
    """K2 against its plain version, bit for bit, then timed on each
    width's lane stack with K1 on the same stack beside it."""
    from pipelinedp_tpu_torch.ops.kernels import segsum
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    checked = []
    # (P, W, n): column tiles from 64 down to 4, both sides of the
    # shared-memory limit (P = 12800) and K1's kernel at P = 65536; no W
    # a multiple of its tile, some W no multiple of 4.
    shapes = [(1, 7, 500), (8, 192, 3000), (64, 99, 2000), (700, 70, 5000),
              (1024, 40, 5000), (2048, 512, 2500), (8192, 130, 1000),
              (12800, 6, 5000), (12801, 6, 5000), (24576, 3, 5000),
              (65536, 24, 20_000)]
    for P, W, n in shapes:
        pk = torch.randint(0, P, (n,), generator=gen, device=dev,
                           dtype=torch.int32)
        cols = torch.randint(0, 4096, (n, W), generator=gen, device=dev,
                             dtype=torch.int32)
        got = segsum.segment_sum_wide(cols, pk, P)
        torch.cuda.synchronize()
        assert torch.equal(got, segsum.segment_sum_wide_plain(cols, pk, P)), (
            f"K2 mismatch at P={P} W={W} n={n}")
        checked.append([P, W, n, wide_design(W, P)])
    n, P, W = 8192, 1, 96
    cols = torch.full((n, W), (1 << 12) - 1, dtype=torch.int32, device=dev)
    pk = torch.zeros(n, dtype=torch.int32, device=dev)
    got = segsum.segment_sum_wide(cols, pk, P)
    assert (got == n * ((1 << 12) - 1)).all()
    assert torch.equal(got, segsum.segment_sum_wide_plain(cols, pk, P))
    checked.append([P, W, n, "lane_max_12bit"])
    pk[::5] = -1
    pk[1::7] = P
    assert torch.equal(segsum.segment_sum_wide(cols, pk, P),
                       segsum.segment_sum_wide_plain(cols, pk, P))
    checked.append([P, W, n, "keys outside [0, P) dropped"])

    stacks = {}
    max_abs_err = 0
    for d in VECTOR_WIDTHS:
        lanes, spk, P, fx_bits = vector_stack(vector_data[d], d,
                                              list(range(VECTOR_PARTITIONS)))
        got = segsum.segment_sum_wide(lanes, spk, P)
        want = segsum.segment_sum_wide_plain(lanes, spk, P)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_abs_err = max(max_abs_err, err)
        assert err == 0, f"K2 mismatch on the D={d} stack: {err}"
        n, W = lanes.shape
        rec = dict(shape=[P, W, n], fx_bits=fx_bits, design=wide_design(W, P),
                   nonzero_row_share=float(
                       (lanes != 0).any(dim=1).float().mean()),
                   **time_kernel(lanes, spk, P, "segment_sum_wide"))
        rec["k1_same_stack"] = time_kernel(lanes, spk, P)
        stacks[f"D={d}"] = rec
        del lanes, spk, got, want
    # Past the shared-memory limit: a dense zipf(1.3) stack at D = 64 over
    # 65536 partitions, where K2 takes K1's kernel.
    n, W, P = VECTOR_ROWS_AT_64, 3 * VECTOR_WIDTHS[0], 65536
    rng = np.random.default_rng(37)
    keys = torch.from_numpy(((rng.zipf(1.3, n) - 1) % P).astype(
        np.int32)).to(dev)
    dense = torch.randint(1, 1 << 10, (n, W), generator=gen, device=dev,
                          dtype=torch.int32)
    got = segsum.segment_sum_wide(dense, keys, P)
    err = int((got.long() - segsum.segment_sum_wide_plain(
        dense, keys, P).long()).abs().max())
    max_abs_err = max(max_abs_err, err)
    assert err == 0, f"K2 mismatch on the dense P={P} stack: {err}"
    stacks[f"dense zipf1.3 P={P} D={VECTOR_WIDTHS[0]}"] = dict(
        shape=[P, W, n], design=wide_design(W, P),
        **time_kernel(dense, keys, P, "segment_sum_wide"))
    del dense, keys, got
    log("wide_kernel", kernel="segment_sum_wide", bit_equal_shapes=checked,
        stacks=stacks)
    first = stacks[f"D={VECTOR_WIDTHS[0]}"]
    return dict(max_abs_err=max_abs_err,
                **{k: first[k] for k in ("ms", "plain_ms", "library_ms",
                                         "bound_ms", "bound_by")})


def phase_vector_gpu_vs_cpu():
    """VECTOR_SUM under fx, private selection, GPU against CPU."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.ops.kernels import segsum
    n, d = 200_000, 64
    rng = np.random.default_rng(31)
    columns = (rng.integers(0, n // 8, n),
               (rng.zipf(1.3, n) % VECTOR_PARTITIONS).astype(np.int32),
               rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32))
    out = {}
    for noise in ("LAPLACE", "GAUSSIAN"):
        params = vector_params(pdt, d, noise)
        segsum.reset_launches()
        gpu_rows, gpu_t = _aggregate(pdt, columns, params, "cuda", 11)
        gpu_launches = dict(segsum.LAUNCHES)
        cpu_rows, _ = _aggregate(pdt, columns, params, "cpu", 11)
        assert segsum.LAUNCHES == gpu_launches, "the CPU run launched a kernel"
        assert gpu_launches["segment_sum_wide"] >= 1, (
            "the CUDA run never launched K2")
        assert gpu_launches["segment_sum_lanes"] >= 1, (
            "the CUDA run never launched K1")
        assert len(gpu_rows) > 0
        assert [k for k, _ in gpu_rows] == [k for k, _ in cpu_rows], (
            f"{noise}: kept keys differ between the card and the CPU")
        a = np.stack([np.asarray(m.vector_sum, np.float64)
                      for _, m in gpu_rows])
        b = np.stack([np.asarray(m.vector_sum, np.float64)
                      for _, m in cpu_rows])
        assert a.shape == (len(gpu_rows), d)
        assert a.tobytes() == b.tobytes(), f"{noise}: vectors differ"
        out[noise] = dict(kept=len(gpu_rows), launches=gpu_launches,
                          gpu_device_s=gpu_t["device_s"])
    log("vector_gpu_vs_cpu", rows=n, d=d, partitions=VECTOR_PARTITIONS,
        identical=True, **out)


def phase_vector_full(vector_data):
    """VECTOR_SUM at the JAX bench's full widths, one aggregation each,
    with the launch counts zeroed just before and read just after."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.ops.kernels import segsum
    public = list(range(VECTOR_PARTITIONS))
    widths = {}
    totals = {"segment_sum_lanes": 0, "segment_sum_wide": 0}
    for d in VECTOR_WIDTHS:
        columns = vector_data[d]
        n = len(columns[1])
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        segsum.reset_launches()
        t0 = time.perf_counter()
        rows, timings = _aggregate(pdt, columns, vector_params(pdt, d),
                                   "cuda", 0, public)
        wall_s = time.perf_counter() - t0
        launches = dict(segsum.LAUNCHES)
        assert launches["segment_sum_wide"] >= 1, f"D={d}: K2 never launched"
        assert launches["segment_sum_lanes"] >= 1, f"D={d}: K1 never launched"
        for k in totals:
            totals[k] += launches[k]
        assert [k for k, _ in rows] == public
        vec = np.stack([np.asarray(m.vector_sum, np.float64) for _, m in rows])
        assert vec.shape == (VECTOR_PARTITIONS, d)
        assert not np.isnan(vec).any()
        widths[f"D={d}"] = dict(
            rows=n, wall_s=wall_s, rows_per_s=n / wall_s,
            coord_bytes_per_s=n * d * 4 / wall_s,
            host_encode_s=timings["host_encode_s"],
            device_s=timings["device_s"],
            host_decode_s=timings["host_decode_s"],
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            # The JAX package's counter Gaussian is +inf on the top point
            # of its 2^24-point grid; the port draws the same.
            infinite_coordinates=int(np.isinf(vec).sum()),
            launches=launches)
    log("vector_full", partitions=VECTOR_PARTITIONS, accumulator="fx",
        noise="GAUSSIAN", **widths)
    return totals


def config4_params(pdt, noise="LAPLACE"):
    """BASELINE config 4 (``bench.py``'s quantile record): P50/90/99 +
    VARIANCE, L0 = 4, Linf = 2, values in [0, 10]."""
    return dict(metrics=[pdt.Metrics.PERCENTILE(50),
                         pdt.Metrics.PERCENTILE(90),
                         pdt.Metrics.PERCENTILE(99), pdt.Metrics.VARIANCE],
                noise_kind=pdt.NoiseKind[noise],
                max_partitions_contributed=4,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)


def hist_case(T, Pb, Qc, span, n, kept_share, gen):
    """K3 test inputs on the card: rows over partitions [-3, T * Pb + 40),
    past both ends of every tile's block; tiles at scattered offsets;
    starts not span-aligned."""
    dev = torch.device("cuda")
    offsets = torch.sort(torch.randperm(T * Pb + 30, generator=gen,
                                        device=dev)[:T]).values
    qpk = torch.randint(-3, T * Pb + 40, (n,), generator=gen, device=dev,
                        dtype=torch.int32)
    leaf = torch.randint(0, 4 * span, (n,), generator=gen, device=dev,
                         dtype=torch.int32)
    kept = torch.rand(n, generator=gen, device=dev) < kept_share
    starts = torch.randint(0, 3 * span, (T, Pb, Qc), generator=gen,
                           device=dev, dtype=torch.int32)
    return qpk, leaf, kept, starts, offsets.to(torch.int32)


def config4_stack(columns):
    """The inputs the single-batch walk hands K3 in the config-4
    aggregation (same data, params and seed): the percentile row view of
    the bounded rows, the [P, 256] mid histogram (K1) and the T = 1
    subtree starts of the top walk, at full size."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    from pipelinedp_tpu_torch.aggregate_params import MechanismType
    from pipelinedp_tpu_torch.ops import prng
    params = pdt.AggregateParams(**config4_params(pdt))
    config = te.FusedConfig.from_params(params, public=False)
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    specs = te.request_budgets(config, params, acc)
    acc.request_budget(MechanismType.GENERIC, metric="partition_selection")
    acc.compute_budgets()
    scale = float(te._noise_scales(config, specs)[-1])
    enc = te.encode(pdt.ArrayDataset(*columns), None, None)
    pid, pk, values = te.put_on_device(enc, torch.device("cuda"))
    P = te._pad_pow2(len(enc.pk_vocab))
    k_bound, _, k_noise = prng.split(prng.PRNGKey(CONFIG4["seed"]), 3)
    b = te._bound_rows(config, pid, pk, values, k_bound)
    qrows = te._qrows(config, b.spk, b.svalues, b.keep_row)
    mid = te._mid_histogram(P, qrows)
    k_tree = prng.fold_in(k_noise, 0x7ee)
    leaf_lo = te._walk_top(config, P, mid, k_tree, scale)[3]
    qpk, leaf, kept = (x.contiguous() for x in qrows)
    starts = leaf_lo[None].to(torch.int32).contiguous()
    return qpk, leaf, kept, starts, P


def time_hist(qpk, leaf, kept, starts, offsets, Pb, span):
    """Median ms of K3 (its wrapper: the output's memset and the launch),
    its plain version and the library yardstick, one ``torch.bincount``
    per (t, q) over the flat bin index of the rows in range (the XLA
    scatter's work; the indices are computed outside the timing), and
    the bound for these inputs."""
    from pipelinedp_tpu_torch.ops.kernels import hist
    T, _, Qc = starts.shape
    flat = []
    for t in range(T):
        rel_pk = qpk - offsets[t]
        in_blk = kept & (rel_pk >= 0) & (rel_pk < Pb)
        pk_b = torch.clamp(rel_pk, 0, Pb - 1).long()
        for q in range(Qc):
            rel = leaf - starts[t, :, q][pk_b]
            ok = in_blk & (rel >= 0) & (rel < span)
            flat.append((pk_b * span + rel.long())[ok])

    def library():
        return [torch.bincount(f, minlength=Pb * span) for f in flat]

    want = hist.subtree_counts_multi_plain(qpk, leaf, kept, starts, offsets,
                                           Pb, span)
    lib = torch.stack(library()).view(T, Qc, Pb, span).permute(0, 2, 1, 3)
    assert torch.equal(lib.to(torch.int32), want)
    # Least work for these inputs: ``hist.work``, the counts the cost
    # table bounds each launch with; its adds are the library's bins.
    work = hist.work(qpk, leaf, kept, starts, offsets, Pb, span)
    assert work.ops == sum(int(f.numel()) for f in flat)
    bound = card_bound(work)
    return dict(
        ms=cuda_ms(lambda: hist.subtree_counts_multi(
            qpk, leaf, kept, starts, offsets, Pb, span)),
        plain_ms=cuda_ms(lambda: hist.subtree_counts_multi_plain(
            qpk, leaf, kept, starts, offsets, Pb, span), reps=5),
        library_ms=cuda_ms(library),
        memset_ms=cuda_ms(lambda: torch.zeros(T, Pb, Qc, span,
                                              dtype=torch.int32,
                                              device=qpk.device)),
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        bound_bytes=work.bytes, kept_rows=int(kept.sum()),
        in_range_adds=work.ops, out_bytes=T * Pb * Qc * span * 4)


def phase_hist_kernel(columns):
    """K3 against its plain version, bit for bit, at the test shapes and
    on the config-4 stack, where it is timed beside its plain version,
    the ``bincount`` yardstick and the mid histogram on K1."""
    from pipelinedp_tpu_torch.ops.kernels import hist, segsum
    from pipelinedp_tpu_torch import torch_engine as te
    gen = torch.Generator(device="cuda")
    gen.manual_seed(3)
    checked = []
    for T, Pb, Qc, span, n, share in [
            (1, 8, 1, 16, 9000, 0.8), (3, 8, 2, 16, 9000, 0.8),
            (5, 16, 4, 16, 9000, 0.8), (1, 4, 3, 256, 9000, 0.05),
            (3, 64, 3, 256, 50_000, 0.05), (5, 1, 5, 256, 20_000, 0.5),
            (4, 1024, 3, 64, 200_000, 0.3)]:
        args = hist_case(T, Pb, Qc, span, n, share, gen)
        got = hist.subtree_counts_multi(*args, Pb, span)
        torch.cuda.synchronize()
        want = hist.subtree_counts_multi_plain(*args, Pb, span)
        assert torch.equal(got, want), (
            f"K3 mismatch at T={T} Pb={Pb} Qc={Qc} span={span}")
        # Accumulation into a sweep's buffer.
        acc = want.clone()
        hist.subtree_counts_multi(*args, Pb, span, out=acc)
        assert torch.equal(acc, 2 * want)
        assert int(want.sum()) > 0
        checked.append([T, Pb, Qc, span, n, share])

    qpk, leaf, kept, starts, P = config4_stack(columns)
    offsets = torch.zeros(1, dtype=torch.int32, device="cuda")
    Q, span = starts.shape[2], 256
    got = hist.subtree_counts_multi(qpk, leaf, kept, starts, offsets, P,
                                    span)
    want = hist.subtree_counts_multi_plain(qpk, leaf, kept, starts, offsets,
                                           P, span)
    torch.cuda.synchronize()
    max_abs_err = int((got.long() - want.long()).abs().max())
    assert max_abs_err == 0, f"K3 mismatch on the config-4 stack"
    checked.append([1, P, Q, span, int(qpk.shape[0]), "config-4 stack"])
    del got, want
    timings = time_hist(qpk, leaf, kept, starts, offsets, P, span)
    qrows = (qpk, leaf, kept)
    mid_ms = cuda_ms(lambda: te._mid_histogram(P, qrows))
    n_mid = 256
    mkey = (qpk * n_mid + torch.clamp_max(leaf // 256, n_mid - 1)).to(
        torch.int32).contiguous()
    mcol = kept.to(torch.int32)[:, None].contiguous()
    assert torch.equal(segsum.segment_sum_lanes(mcol, mkey, P * n_mid),
                       segsum.segment_sum_lanes_plain(mcol, mkey, P * n_mid))
    mid_k1 = time_kernel(mcol, mkey, P * n_mid)
    del qpk, leaf, kept, starts, mkey, mcol
    log("hist_kernel", kernel="subtree_counts_multi",
        bit_equal_shapes=checked,
        config4=dict(shape=[1, P, Q, span], **timings),
        mid_histogram=dict(segments=P * n_mid, ms=mid_ms, k1=mid_k1))
    return dict(max_abs_err=max_abs_err, mid_ms=mid_ms, **timings)


def _released_identical(a_rows, b_rows, what):
    assert len(a_rows) > 0, f"{what}: no partition released"
    assert [k for k, _ in a_rows] == [k for k, _ in b_rows], (
        f"{what}: kept keys differ")
    for (k, a), (_, b) in zip(a_rows, b_rows):
        assert a._fields == b._fields
        assert (np.asarray(a, np.float64).tobytes() ==
                np.asarray(b, np.float64).tobytes()), f"{what}: differs at {k}"


def phase_percentile_gpu_vs_cpu():
    """PERCENTILE through ``DPEngine.aggregate`` on the card and on the
    CPU, single-batch and streamed: the same kept keys and bit-identical
    float32 percentiles and float64 scalars; K3 launched on the card
    (once per block single-batch, batches x sweeps streamed) and never
    on the CPU."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.ops.kernels import hist
    n, parts = 1_000_000, 10_000
    columns = zipf_columns(n, n // 50, parts, seed=41)
    out = {}
    for noise, public in (("LAPLACE", None), ("GAUSSIAN",
                                              list(range(parts)))):
        for mode in ("single", "streamed"):
            if mode == "streamed":
                os.environ[CHUNK_ENV] = str(n // 6)
            hist.reset_launches()
            gpu_rows, gpu_t = _aggregate(pdt, columns,
                                         config4_params(pdt, noise), "cuda",
                                         17, public)
            k3 = hist.LAUNCHES["subtree_counts_multi"]
            cpu_rows, cpu_t = _aggregate(pdt, columns,
                                         config4_params(pdt, noise), "cpu",
                                         17, public)
            os.environ.pop(CHUNK_ENV, None)
            assert hist.LAUNCHES["subtree_counts_multi"] == k3, (
                "the CPU run launched K3")
            what = f"{noise} {mode}"
            _released_identical(gpu_rows, cpu_rows, what)
            assert gpu_rows[0][1]._fields[-3:] == (
                "percentile_50", "percentile_90", "percentile_99")
            if mode == "streamed":
                assert gpu_t["stream_batches"] == cpu_t["stream_batches"] > 1
                assert k3 == (gpu_t["stream_batches"] *
                              gpu_t["stream_pass_b_sweeps"]), what
            else:
                assert k3 >= 1, f"{what}: K3 never launched"
            out[f"{noise.lower()}_{mode}"] = dict(
                kept=len(gpu_rows), k3_launches=k3,
                gpu_device_s=gpu_t["device_s"],
                cpu_device_s=cpu_t["device_s"],
                batches=gpu_t.get("stream_batches"))
    log("percentile_gpu_vs_cpu", rows=n, partitions=parts, identical=True,
        **out)


def _timed_aggregate(pdt, columns, params, seed, public=None):
    """``_run_record`` of one PERCENTILE aggregation, held to have launched
    K1 and K3 and released finite values."""
    rows, rec = _run_record(pdt, columns, params, seed, public)
    assert rec["launches"]["segment_sum_lanes"] >= 1, "K1 never launched"
    assert rec["launches"]["subtree_counts_multi"] >= 1, "K3 never launched"
    assert len(rows) > 0, "no partition released"
    released = np.asarray([tuple(m) for _, m in rows], np.float64)
    assert released.shape == (len(rows), len(rows[0][1]))
    assert np.isfinite(released).all()
    return rows, rec


def phase_config4(columns):
    """BASELINE config 4 at full size: single-batch, then streamed in the
    JAX bench's six batches (K3 launched batches x sweeps times)."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    params = config4_params(pdt)
    single, rec_single = _timed_aggregate(pdt, columns, params,
                                          CONFIG4["seed"])
    assert single[0][1]._fields == ("variance", "percentile_50",
                                    "percentile_90", "percentile_99")
    P = te._pad_pow2(CONFIG4["partitions"])
    blk = te._walk_blocks(P, 3, 256)
    rec_single["walk_blocks"] = -(-P // blk)
    assert rec_single["launches"]["subtree_counts_multi"] == \
        rec_single["walk_blocks"]
    os.environ[CHUNK_ENV] = str(-(-CONFIG4["rows"] // 6))
    try:
        streamed, rec_streamed = _timed_aggregate(pdt, columns, params,
                                                  CONFIG4["seed"])
    finally:
        os.environ.pop(CHUNK_ENV, None)
    assert rec_streamed["launches"]["subtree_counts_multi"] == (
        rec_streamed["stream_batches"] * rec_streamed["stream_pass_b_sweeps"])
    assert rec_streamed["stream_batches"] == 6
    log("config4", data=CONFIG4, single=rec_single, streamed=rec_streamed)
    return rec_single, rec_streamed, streamed


def phase_config4_breakdown(columns, out_dir):
    """``--profile`` only: where config 4's single-batch time goes, stage
    by stage with CUDA events (the walk split into the mid histogram on
    K1, the top levels, the subtree histogram on K3 and the bottom
    levels), then the whole aggregation once under ``torch.profiler``."""
    import dataclasses
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    from pipelinedp_tpu_torch.aggregate_params import MechanismType
    from pipelinedp_tpu_torch.ops import prng

    dev = torch.device("cuda")
    params = pdt.AggregateParams(**config4_params(pdt))
    config = te.FusedConfig.from_params(params, public=False)
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    specs = te.request_budgets(config, params, acc)
    sel = acc.request_budget(MechanismType.GENERIC,
                             metric="partition_selection")
    acc.compute_budgets()
    scale = float(te._noise_scales(config, specs)[-1])
    stages = {}
    timed = _stage_timer(stages)
    t0 = time.perf_counter()
    enc = te.encode(pdt.ArrayDataset(*columns), None, None)
    stages["host_encode"] = (time.perf_counter() - t0) * 1e3
    pid, pk, values = timed("h2d", lambda: te.put_on_device(enc, dev))
    n_parts = len(enc.pk_vocab)
    P = te._pad_pow2(n_parts)
    fx_bits = te._fx_plan(enc.n_rows)[0]
    table, thr, s_scale, min_count = te.selection_inputs(config, sel.eps,
                                                         sel.delta, None)
    k_bound, k_sel, k_noise = prng.split(prng.PRNGKey(CONFIG4["seed"]), 3)
    k_tree = prng.fold_in(k_noise, 0x7ee)
    part, nseg, qrows = timed("partials", lambda: te._partials(
        config, P, pid, pk, values, k_bound, fx_bits))
    keep, raw = timed("selection", lambda: te._selection_and_metrics(
        dataclasses.replace(config, percentiles=()), P, part, nseg, table,
        thr, s_scale, min_count, 1.0, k_sel))
    mid = timed("mid_histogram_k1", lambda: te._mid_histogram(P, qrows))
    lo, hi, target, leaf_lo, done = timed(
        "walk_top", lambda: te._walk_top(config, P, mid, k_tree, scale))
    offset = torch.zeros(1, dtype=torch.int32, device=dev)
    sub = timed("subtree_histogram_k3", lambda: te._subtree_counts_multi(
        *qrows, leaf_lo[None], offset, P, 256)[0])
    vals = timed("walk_bottom", lambda: te._walk_bottom(
        config, P, sub, leaf_lo, lo, hi, target, leaf_lo, done, k_tree,
        scale, 0))
    del sub, mid
    quantiles = np.asarray([p / 100.0 for p in config.percentiles],
                           np.float32)
    vals = timed("monotone", lambda: te._monotone_in_q(vals, quantiles))
    cols = [raw[k] for k in sorted(raw)] + [vals[:, i] for i in range(3)]
    timed("compact_fetch", lambda: te._compact_fetch(
        keep, [c.contiguous().view(torch.int32) if c.dtype != torch.int32
               else c for c in cols], n_parts,
        min(n_parts, te._COMPACT_FETCH_CAP)).cpu())
    prof = _profiled(lambda: _aggregate(pdt, columns, config4_params(pdt),
                                        "cuda", CONFIG4["seed"]),
                     out_dir and os.path.join(out_dir,
                                              "config4_profile.txt"))
    # The streamed run: its host batch assignment alone, then the whole
    # aggregation under the profiler.
    from pipelinedp_tpu_torch import streaming
    t0 = time.perf_counter()
    streaming._batch_assignment(config, enc, 6, CONFIG4["seed"])
    assign_ms = (time.perf_counter() - t0) * 1e3
    os.environ[CHUNK_ENV] = str(-(-CONFIG4["rows"] // 6))
    try:
        streamed = _profiled(
            lambda: _aggregate(pdt, columns, config4_params(pdt), "cuda",
                               CONFIG4["seed"]),
            out_dir and os.path.join(out_dir, "config4_streamed_profile.txt"))
    finally:
        os.environ.pop(CHUNK_ENV, None)
    log("config4_breakdown", stage_ms=stages, **prof,
        streamed=dict(batch_assignment_ms=assign_ms, **streamed))


def phase_streamed_percentile():
    """``bench.py``'s ``bench_streamed_percentile`` shape (2M rows, 3000
    public partitions, seed 13, a chunk of n // 6 rows) at the default
    byte cap and at the cap that makes pass B tile: the same
    percentiles."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    n, parts = 2_000_000, 3_000
    rng = np.random.default_rng(13)
    columns = (rng.integers(0, 1 << 20, n).astype(np.int32),
               (rng.zipf(1.3, n) % parts).astype(np.int32),
               rng.uniform(0.0, 10.0, n).astype(np.float32))
    public = list(range(parts))
    P_pad = te._pad_pow2(parts)
    cap = max(4, (5 * P_pad) // 8) * 256 * 4
    os.environ[CHUNK_ENV] = str(max(n // 6, 1000))
    try:
        default, rec_default = _timed_aggregate(
            pdt, columns, config4_params(pdt), 0, public)
        os.environ[CAP_ENV] = str(cap)
        capped, rec_capped = _timed_aggregate(
            pdt, columns, config4_params(pdt), 0, public)
    finally:
        os.environ.pop(CHUNK_ENV, None)
        os.environ.pop(CAP_ENV, None)
    assert rec_default["stream_pass_b_tiles"] == 1
    assert rec_capped["stream_pass_b_tiles"] > 1, "the capped run did not tile"
    for rec in (rec_default, rec_capped):
        assert rec["launches"]["subtree_counts_multi"] == (
            rec["stream_batches"] * rec["stream_pass_b_sweeps"])
    fields = ("percentile_50", "percentile_90", "percentile_99")
    assert [k for k, _ in default] == [k for k, _ in capped] == public
    for (k, a), (_, b) in zip(default, capped):
        assert all(getattr(a, f) == getattr(b, f) for f in fields), (
            f"capped percentiles differ at {k}")
    log("streamed_percentile", rows=n, partitions=parts, capped_cap=cap,
        capped_identical=True, default=rec_default, capped=rec_capped)


# ---------------------------------------------------------------------------
# The per-partition-sum-bounds SUM (K4) and the rest of single-GPU streaming
# ---------------------------------------------------------------------------


def sum_bounds_params(pdt, **bounding):
    """The flagship's shape with per-partition sum bounds: COUNT+SUM,
    Laplace, L0 = 4, Linf = 2 (or ``bounding``), each (user, partition)
    total clipped to [0, 20]."""
    kw = dict(metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
              noise_kind=pdt.NoiseKind.LAPLACE, max_partitions_contributed=4,
              max_contributions_per_partition=2, min_sum_per_partition=0.0,
              max_sum_per_partition=20.0)
    if bounding:
        kw.pop("max_partitions_contributed")
        kw.pop("max_contributions_per_partition")
        kw.update(bounding)
    return kw


def bounded_rows(columns, params_kw, seed):
    """``_bound_rows`` of the aggregation of ``columns`` under
    ``params_kw`` and ``seed``, on the card: the rows K4 and K1 see."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    from pipelinedp_tpu_torch.ops import prng
    config = te.FusedConfig.from_params(pdt.AggregateParams(**params_kw),
                                        public=False)
    enc = te.encode(pdt.ArrayDataset(*columns), None, None)
    pid, pk, values = te.put_on_device(enc, torch.device("cuda"))
    k_bound = prng.split(prng.PRNGKey(seed), 3)[0]
    b = te._bound_rows(config, pid, pk, values, k_bound)
    return config, b, te._pad_pow2(len(enc.pk_vocab)), te._fx_plan(
        enc.n_rows)[0]


def time_segtotal(values, new_seg, plain_reps=5):
    """K4 against its plain version, bit for bit, and the median ms of K4,
    the plain version and one float32 ``index_add_`` over the segment
    ordinals (the library yardstick: per-segment totals, in no fixed order,
    so not K4's bits), with the bound for these inputs: the larger of the
    bytes over the memory rate and the longest segment's add chain."""
    from pipelinedp_tpu_torch.ops.kernels import segtotal
    got = segtotal.segment_totals(values, new_seg)
    t0 = time.perf_counter()
    want = segtotal.segment_totals_plain(values, new_seg)
    torch.cuda.synchronize()
    plain_once_s = time.perf_counter() - t0
    diff = got.view(torch.int32) != want.view(torch.int32)
    max_abs_err = float((got - want).abs().max())
    assert not bool(diff.any()), (
        f"K4 differs from its plain version at {int(diff.sum())} rows")
    starts = new_seg.clone()
    starts[0] = True
    seg_ord = torch.cumsum(starts.to(torch.int64), 0) - 1
    n_seg = int(starts.sum())
    lens = torch.diff(torch.nonzero(starts).squeeze(1),
                      append=torch.tensor([values.shape[0]],
                                          device=values.device))

    def library():
        return torch.zeros(n_seg, dtype=torch.float32,
                           device=values.device).index_add_(0, seg_ord,
                                                            values)

    n = values.shape[0]
    # Least work for these inputs: ``segtotal.work``, the counts the cost
    # table bounds each launch with; the longest segment is one chain of
    # dependent float32 adds.
    work = segtotal.work(values, new_seg)
    bound = card_bound(work)
    return dict(
        max_abs_err=max_abs_err,
        ms=cuda_ms(lambda: segtotal.segment_totals(values, new_seg)),
        plain_ms=(plain_once_s * 1e3 if plain_reps <= 1 else
                  cuda_ms(lambda: segtotal.segment_totals_plain(
                      values, new_seg), reps=plain_reps, warm=1)),
        library_ms=cuda_ms(library),
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        bytes_ms=bound["bytes_ms"], chain_ms=bound["chain_ms"],
        bound_bytes=work.bytes, rows=n, segments=n_seg,
        longest_segment=work.chain,
        rows_in_segments_over_64=int(lens[lens > 64].sum()))


def mid_stack(n=FLAGSHIP["rows"], seed=46):
    """The mid-length stack: ``n`` rows cut into segments of lengths drawn
    uniformly from 65-1024 rows (many rows per (user, partition), such as
    one user's transactions at one merchant), float32 values uniform in
    [0, 10), from one numpy generator."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(65, 1025, n // 65 + 1)
    starts = np.concatenate([[0], np.cumsum(lengths)])
    new_seg = np.zeros(n, bool)
    new_seg[starts[starts < n]] = True
    values = rng.uniform(0.0, 10.0, n).astype(np.float32)
    dev = torch.device("cuda")
    return torch.from_numpy(values).to(dev), torch.from_numpy(new_seg).to(dev)


def segtotal_seams():
    """K4 against its plain version, bit for bit, on every layout of
    ``segtotal.seam_layout`` with normal and order-sensitive values,
    aligned and as a view one row in."""
    from pipelinedp_tpu_torch.ops.kernels import segtotal
    checked = []
    for name in segtotal.SEAM_LAYOUTS:
        for order_sensitive in (False, True):
            values, new_seg = segtotal.seam_layout(name, order_sensitive)
            for offset in (0, 1):
                v = torch.from_numpy(values).cuda()[offset:]
                f = torch.from_numpy(new_seg).cuda()[offset:]
                got = segtotal.segment_totals(v, f)
                want = segtotal.segment_totals_plain(v, f)
                assert torch.equal(got.view(torch.int32),
                                   want.view(torch.int32)), (
                    f"K4 differs from its plain version on {name} "
                    f"(order-sensitive {order_sensitive}, offset {offset})")
                checked.append(f"{name}/{order_sensitive}/{offset}")
    return checked


def phase_segtotal_kernel(columns, max_sm_mhz):
    """K4 against its plain version on the flagship stack with
    per-partition bounds, on a hot-segment stack (one (user, partition)
    pair with 2^20 rows), on the mid-length stack and on the seam layouts,
    timed on the three stacks; K1 timed on the flagship's per-partition
    lane stack."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    params = sum_bounds_params(pdt)
    config, b, P, fx_bits = bounded_rows(columns, params, FLAGSHIP["seed"])
    masked = b.masked.contiguous()
    flagship = time_segtotal(masked, b.new_seg)
    stack, _ = te._lane_stack(config, b.masked, b.keep_row, b.seg_marker,
                              fx_bits, b.contrib)
    k1 = time_kernel(stack, b.spk.to(torch.int32).contiguous(), P)
    del b, masked, stack
    hot_values, hot_new_seg = hot_stack()
    hot_rec = time_segtotal(hot_values, hot_new_seg,
                            plain_reps=1)
    assert hot_rec["longest_segment"] == HOT_ROWS
    del hot_values, hot_new_seg
    mid_values, mid_new_seg = mid_stack()
    mid_rec = time_segtotal(mid_values, mid_new_seg,
                            plain_reps=1)
    del mid_values, mid_new_seg
    seams = segtotal_seams()
    log("segtotal_kernel", kernel="segment_totals", flagship=flagship,
        flagship_k1=k1, hot_segment=hot_rec, mid_length=mid_rec,
        seams_identical=seams, max_sm_mhz=max_sm_mhz)
    return flagship


def hot_stack():
    """The hot segment: 3M flagship-like rows and one more user with
    HOT_ROWS rows in partition 0, all kept (Linf 2^21), bounded as the
    per-partition SUM bounds them, so the segment's values are its raw
    values."""
    import pipelinedp_tpu_torch as pdt
    base = zipf_columns(3_000_000, 20_000, 5_000, seed=43)
    rng = np.random.default_rng(44)
    hot = (np.concatenate([base[0], np.full(HOT_ROWS, 20_000)]),
           np.concatenate([base[1], np.zeros(HOT_ROWS, np.int64)]),
           np.concatenate([base[2], rng.uniform(0.0, 10.0, HOT_ROWS)]))
    hot_params = sum_bounds_params(pdt, max_partitions_contributed=4,
                                   max_contributions_per_partition=1 << 21)
    _, hb, _, _ = bounded_rows(hot, hot_params, 45)
    return hb.masked.contiguous(), hb.new_seg


def phase_sum_bounds_gpu_vs_cpu():
    """The per-partition SUM through ``DPEngine.aggregate`` on the card
    and on the CPU at 1M rows in the three bounding modes: the same kept
    keys and float64 releases; K4 launched on the card where segments
    have several rows, never on the CPU."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.ops.kernels import segsum, segtotal
    columns = zipf_columns(1_000_000, 40_000, 8192, seed=7)
    out = {}
    for mode, bounding in (("l0_linf", {}),
                           ("max_contributions", dict(max_contributions=8)),
                           ("bounds_enforced", dict(
                               max_partitions_contributed=4,
                               max_contributions_per_partition=2,
                               contribution_bounds_already_enforced=True))):
        params = sum_bounds_params(pdt, **bounding)
        cols = ((None,) + columns[1:] if mode == "bounds_enforced"
                else columns)
        segsum.reset_launches()
        segtotal.reset_launches()
        gpu_rows, gpu_t = _aggregate(pdt, cols, params, "cuda", 7)
        k4 = segtotal.LAUNCHES["segment_totals"]
        k1 = segsum.LAUNCHES["segment_sum_lanes"]
        cpu_rows, cpu_t = _aggregate(pdt, cols, params, "cpu", 7)
        assert segtotal.LAUNCHES["segment_totals"] == k4, "CPU launched K4"
        assert k1 >= 1, f"{mode}: K1 never launched"
        # Without privacy ids every row is its own segment: a row clip.
        assert k4 == (0 if mode == "bounds_enforced" else 1), (mode, k4)
        _released_identical(gpu_rows, cpu_rows, f"sum bounds {mode}")
        assert gpu_rows[0][1]._fields == ("count", "sum")
        out[mode] = dict(kept=len(gpu_rows), k4_launches=k4,
                         k1_launches=k1, gpu_device_s=gpu_t["device_s"],
                         cpu_device_s=cpu_t["device_s"])
    log("sum_bounds_gpu_vs_cpu", rows=1_000_000, partitions=8192,
        identical=True, **out)


def _launch_counts():
    from pipelinedp_tpu_torch.ops.kernels import (hist, segkeyed, segsum,
                                                  segtotal)
    return dict(segsum.LAUNCHES, **hist.LAUNCHES, **segtotal.LAUNCHES,
                **segkeyed.LAUNCHES)


def _reset_launches():
    from pipelinedp_tpu_torch.ops.kernels import (hist, segkeyed, segsum,
                                                  segtotal)
    for mod in (segsum, hist, segtotal, segkeyed):
        mod.reset_launches()


def _run_record(pdt, columns, params, seed, public=None, **backend):
    """One aggregation on the card with every kernel count zeroed just
    before it and read just after; the wall, the engine's timings and the
    peak device memory."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    rows, timings = _aggregate(pdt, columns, params, "cuda", seed, public,
                               **backend)
    wall_s = time.perf_counter() - t0
    n = len(columns[1])
    rec = dict(rows=n, kept=len(rows), wall_s=wall_s, rows_per_s=n / wall_s,
               peak_mem_bytes=torch.cuda.max_memory_allocated(),
               launches=_launch_counts(), **timings)
    return rows, rec


def phase_sum_bounds_full(columns):
    """The per-partition SUM at the flagship's full size through
    ``DPEngine.aggregate``, with the kernel counts zeroed just before and
    read just after."""
    import pipelinedp_tpu_torch as pdt
    rows, rec = _run_record(pdt, columns, sum_bounds_params(pdt),
                            FLAGSHIP["seed"])
    assert rec["launches"]["segment_totals"] >= 1, "K4 never launched"
    assert rec["launches"]["segment_sum_lanes"] >= 1, "K1 never launched"
    released = np.asarray([tuple(m) for _, m in rows], np.float64)
    assert released.shape == (len(rows), 2) and len(rows) > 0
    assert np.isfinite(released).all()
    log("sum_bounds_full", data=FLAGSHIP, **rec)
    return rec


def phase_vector_streamed(vector_data):
    """VECTOR_SUM streamed as ``bench_dp_vector_sum`` streams it (a chunk
    of n // 4 rows: four batches, K2 once per batch): GPU against CPU bit
    for bit at 200k rows, then the three full widths."""
    import pipelinedp_tpu_torch as pdt
    public = list(range(VECTOR_PARTITIONS))
    n, d0 = 200_000, VECTOR_WIDTHS[0]
    rng = np.random.default_rng(33)
    small = (rng.integers(0, n // 8, n),
             (rng.zipf(1.3, n) % VECTOR_PARTITIONS).astype(np.int32),
             rng.uniform(-1.0, 1.0, (n, d0)).astype(np.float32))
    os.environ[CHUNK_ENV] = str(n // 4)
    try:
        gpu_rows, g = _run_record(pdt, small, vector_params(pdt, d0), 19,
                                  public)
        cpu_rows, _ = _aggregate(pdt, small, vector_params(pdt, d0), "cpu",
                                 19, public)
    finally:
        os.environ.pop(CHUNK_ENV, None)
    _released_identical(gpu_rows, cpu_rows, "streamed VECTOR_SUM")
    assert g["stream_batches"] == 4
    assert g["launches"]["segment_sum_wide"] == g["stream_batches"]
    widths = {}
    for d in VECTOR_WIDTHS:
        columns = vector_data[d]
        n_d = len(columns[1])
        os.environ[CHUNK_ENV] = str(max(n_d // 4, 500))
        try:
            rows, rec = _run_record(pdt, columns, vector_params(pdt, d), 0,
                                    public)
        finally:
            os.environ.pop(CHUNK_ENV, None)
        assert rec["stream_batches"] == 4
        assert rec["launches"]["segment_sum_wide"] == 4
        vec = np.stack([np.asarray(m.vector_sum, np.float64)
                        for _, m in rows])
        assert vec.shape == (VECTOR_PARTITIONS, d)
        assert not np.isnan(vec).any()
        rec["coord_bytes_per_s"] = n_d * d * 4 / rec["wall_s"]
        widths[f"D={d}"] = rec
    log("vector_streamed", accumulator="fx", gpu_vs_cpu=dict(
        rows=n, d=d0, identical=True, kept=len(gpu_rows)), **widths)


def stream150_columns():
    """``bench.py``'s ``bench_streaming`` data at its default 150M rows:
    pids in [0, 2^24), zipf(1.3) keys modulo 50,000, values in [0, 10),
    int32/float32 columns, from ``default_rng(9)`` in that order."""
    rng = np.random.default_rng(9)
    n = STREAM_ROWS
    return (rng.integers(0, 1 << 24, n).astype(np.int32),
            (rng.zipf(1.3, n) % 50_000).astype(np.int32),
            rng.uniform(0.0, 10.0, n).astype(np.float32))


def stream150_params(pdt):
    """``bench_streaming``'s params: COUNT+SUM+MEAN, Laplace, L0 = 4,
    Linf = 2, values in [0, 10]."""
    return dict(metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM,
                         pdt.Metrics.MEAN],
                noise_kind=pdt.NoiseKind.LAPLACE,
                max_partitions_contributed=4,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)


def phase_stream150(columns, profile, out_dir):
    """The JAX package's streaming record shape at the default chunk
    (three batches), serial and overlapped: bit for bit the same
    release; the walls and the stage / device / fold split of each. With
    ``--profile`` one more overlapped run under ``torch.profiler`` gives
    the device's idle share."""
    import pipelinedp_tpu_torch as pdt
    params = stream150_params(pdt)
    runs = {}
    rows = {}
    for mode in ("serial", "overlapped"):
        rows[mode], runs[mode] = _run_record(
            pdt, columns, params, 0, ingest_executor=mode == "overlapped")
        assert runs[mode]["stream_executor"] == mode
        assert runs[mode]["launches"]["segment_sum_lanes"] == runs[mode][
            "stream_batches"]
    _released_identical(rows["serial"], rows["overlapped"],
                        "150M stream serial vs overlapped")
    released = np.asarray([tuple(m) for _, m in rows["serial"]], np.float64)
    assert np.isfinite(released).all()
    rec = dict(rows=STREAM_ROWS, identical=True, **runs)
    if profile:
        rec["profile_overlapped"] = _profiled(
            lambda: _aggregate(pdt, columns, params, "cuda", 0,
                               ingest_executor=True),
            out_dir and os.path.join(out_dir, "stream150_profile.txt"))
    log("stream150", **rec)


def phase_select_streamed(c4_columns):
    """Streamed ``select_partitions``: GPU against CPU on the kept set at
    1M rows in five batches, then timed on config 4's 10M rows in six."""
    import pipelinedp_tpu_torch as pdt

    def select(columns, device, seed):
        acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
        kept = pdt.DPEngine(acc, pdt.TorchBackend(
            device=device, rng_seed=seed)).select_partitions(
            pdt.ArrayDataset(privacy_ids=columns[0],
                             partition_keys=columns[1]),
            pdt.SelectPartitionsParams(max_partitions_contributed=4),
            pdt.DataExtractors())
        acc.compute_budgets()
        return list(kept)

    small = zipf_columns(1_000_000, 40_000, 8192, seed=47)
    os.environ[CHUNK_ENV] = str(200_000)
    try:
        _reset_launches()
        gpu = select(small, "cuda", 5)
        k1 = _launch_counts()["segment_sum_lanes"]
        cpu = select(small, "cpu", 5)
        os.environ[CHUNK_ENV] = str(-(-CONFIG4["rows"] // 6))
        torch.cuda.synchronize()
        _reset_launches()
        t0 = time.perf_counter()
        full = select(c4_columns, "cuda", CONFIG4["seed"])
        wall_s = time.perf_counter() - t0
        full_launches = _launch_counts()["segment_sum_lanes"]
    finally:
        os.environ.pop(CHUNK_ENV, None)
    assert gpu == cpu and len(gpu) > 0, "streamed kept sets differ"
    assert k1 == 5, k1
    assert full_launches == 6 and len(full) > 0
    log("select_streamed", gpu_vs_cpu=dict(rows=1_000_000, batches=5,
                                           kept=len(gpu), identical=True),
        config4=dict(rows=CONFIG4["rows"], batches=6, kept=len(full),
                     wall_s=wall_s, rows_per_s=CONFIG4["rows"] / wall_s,
                     k1_launches=full_launches))


def phase_pass_b_sources(columns, reference):
    """Config 4 streamed under each pass-B source (the device cache, a
    budget for about half the batches, none) and each executor mode: the
    same bits as each other and as phase 10's streamed run."""
    import pipelinedp_tpu_torch as pdt
    params = config4_params(pdt)
    os.environ[CHUNK_ENV] = str(-(-CONFIG4["rows"] // 6))
    # One batch's device bytes: pid, pk and value, 12 bytes a row.
    half = 3 * 12 * (-(-CONFIG4["rows"] // 6))
    runs = {}
    try:
        for mode in ("serial", "overlapped"):
            for source, cache in (("device_cache", None), ("hybrid", half),
                                  ("reship", 0)):
                rows, rec = _run_record(
                    pdt, columns, params, CONFIG4["seed"],
                    ingest_executor=mode == "overlapped", stream_cache=cache)
                assert rec["stream_pass_b"] == source, (source, rec)
                _released_identical(rows, reference,
                                    f"config 4 streamed {mode} {source}")
                runs[f"{mode}/{source}"] = rec
    finally:
        os.environ.pop(CHUNK_ENV, None)
    log("pass_b_sources", data=CONFIG4, hybrid_cache_bytes=half,
        identical=True, **runs)


def phase_kill_resume(columns, reference):
    """Config 4 streamed, killed at batch 3 by the port's ``FaultPlan`` and
    resumed from a checkpoint under ``build/``, serially and overlapped:
    the same bits as phase 10's uninterrupted run."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.resilience import (ChunkFailure, FaultPlan,
                                                 injected_faults)
    params = config4_params(pdt)
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke_ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    os.environ[CHUNK_ENV] = str(-(-CONFIG4["rows"] // 6))
    out = {}
    try:
        for mode in ("serial", "overlapped"):
            path = os.path.join(ckpt_dir, f"config4_{mode}.ckpt")
            if os.path.exists(path):
                os.unlink(path)
            t0 = time.perf_counter()
            try:
                with injected_faults(FaultPlan(fail_chunks=(3,))):
                    _aggregate(pdt, columns, params, "cuda", CONFIG4["seed"],
                               ingest_executor=mode == "overlapped",
                               checkpoint=path)
            except ChunkFailure:
                killed_s = time.perf_counter() - t0
            else:
                raise AssertionError(f"{mode}: the kill at batch 3 did "
                                     "not fire")
            assert os.path.exists(path), f"{mode}: no checkpoint survived"
            rows, rec = _run_record(pdt, columns, params, CONFIG4["seed"],
                                    ingest_executor=mode == "overlapped",
                                    checkpoint=path)
            assert not os.path.exists(path), "success must clear the store"
            assert rec["stream_resumed_from"] >= 1
            _released_identical(rows, reference, f"resumed {mode}")
            out[mode] = dict(killed_run_s=killed_s, **rec)
    finally:
        os.environ.pop(CHUNK_ENV, None)
    log("kill_resume", data=CONFIG4, killed_at_batch=3, identical=True,
        **out)


def sweep_options(tan, pdt, n_cfg):
    """``bench.py``'s config-5 grid: ``n_cfg`` (l0, linf) pairs of a
    square grid, COUNT, Laplace, eps = 1, delta = 1e-6, truncated-geometric
    selection."""
    side = int(round(np.sqrt(n_cfg)))
    pairs = [(a, b) for a in range(1, side + 1)
             for b in range(1, n_cfg // side + 1)]
    multi = tan.MultiParameterConfiguration(
        max_partitions_contributed=[a for a, _ in pairs],
        max_contributions_per_partition=[b for _, b in pairs])
    params = pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT], noise_kind=pdt.NoiseKind.LAPLACE,
        max_partitions_contributed=4, max_contributions_per_partition=2)
    return len(pairs), tan.UtilityAnalysisOptions(
        epsilon=1.0, delta=1e-6, aggregate_params=params,
        multi_param_configuration=multi)


def run_sweep(columns, options, device, width=None, public=None,
              per_partition=False, checkpoint=None, backend=None):
    """One ``perform_utility_analysis`` through ``TorchBackend(device)``
    (or ``backend``) with the chunk width pinned to ``width`` (None: the
    static formula): (lazy result, [AggregateMetrics], per-partition rows
    or None, wall seconds with the device synchronised)."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    if width is None:
        os.environ.pop(SWEEP_BATCH_ENV, None)
    else:
        os.environ[SWEEP_BATCH_ENV] = str(width)
    try:
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        if backend is None:
            backend = pdt.TorchBackend(device=device, checkpoint=checkpoint)
        out = tan.perform_utility_analysis(
            pdt.ArrayDataset(*columns), backend, options,
            pdt.DataExtractors(), public_partitions=public,
            return_per_partition=per_partition)
        lazy, rows = out if per_partition else (out, None)
        result = list(lazy)[0]
        rows = dict(rows) if rows is not None else None
        if device == "cuda":
            torch.cuda.synchronize()
        return lazy, result, rows, time.perf_counter() - t0
    finally:
        os.environ.pop(SWEEP_BATCH_ENV, None)


def sweep_bits(result):
    """Every float field of every config's AggregateMetrics, as float64
    bits (error metrics of each analysed metric, then selection)."""
    import dataclasses
    out = []
    for m in result:
        for part in (m.count_metrics, m.sum_metrics,
                     m.privacy_id_count_metrics,
                     m.partition_selection_metrics):
            if part is None:
                continue
            for v in dataclasses.astuple(part):
                if isinstance(v, (float, list)):
                    out += list(np.asarray(v, np.float64).ravel())
    return np.asarray(out, np.float64).view(np.uint64)


def _assert_sweeps_identical(a, b, what):
    assert len(a) == len(b), f"{what}: {len(a)} vs {len(b)} configs"
    ab, bb = sweep_bits(a), sweep_bits(b)
    assert ab.shape == bb.shape and bool((ab == bb).all()), (
        f"{what}: {int((ab != bb).sum())} fields differ")
    assert np.isfinite(ab.view(np.float64)).all(), f"{what}: non-finite"


def _assert_pp_rows_identical(a, b, what):
    import dataclasses
    assert [str(k) for k in a] == [str(k) for k in b], what
    for k in a:
        for x, y in zip(a[k], b[k]):
            if isinstance(x, float):
                assert np.float64(x).view(np.uint64) == np.float64(
                    y).view(np.uint64), (what, k)
            else:
                fx = [v for v in dataclasses.astuple(x)
                      if isinstance(v, float)]
                fy = [v for v in dataclasses.astuple(y)
                      if isinstance(v, float)]
                assert (np.asarray(fx).view(np.uint64) ==
                        np.asarray(fy).view(np.uint64)).all(), (what, k)


class _EventClock:
    """CUDA events around every call of the given functions while active
    (``targets``: (owner, attribute, label) triples): the summed device
    milliseconds between each call's start and end, per label, read after
    the run."""

    def __init__(self, targets):
        self._targets = targets
        self.events = {label: [] for _, _, label in targets}
        self._saved = []

    def __enter__(self):
        for owner, attr, label in self._targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, fn))

            def timed(*args, _fn=fn, _label=label, **kwargs):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = _fn(*args, **kwargs)
                end.record()
                self.events[_label].append((start, end))
                return out
            setattr(owner, attr, timed)
        return self

    def __exit__(self, *exc):
        for owner, attr, fn in reversed(self._saved):
            setattr(owner, attr, fn)

    def ms(self):
        torch.cuda.synchronize()
        return {label: sum(s.elapsed_time(e) for s, e in ev)
                for label, ev in self.events.items()}

    def calls(self):
        return {label: len(ev) for label, ev in self.events.items()}


def _kernel_clock():
    from pipelinedp_tpu_torch.ops.kernels import segkeyed, segtotal
    return _EventClock([(segkeyed, "segmented_sums", "segmented_sums"),
                        (segtotal, "segment_totals", "segment_totals")])


def capture_k5_stacks(columns, n_cfg, every_row=False):
    """The K5 inputs of one config-5 chunk as the main path builds them:
    the [n, Cc * 3] selection moments and the [n, Cc * 5] count stack,
    with their key layout (captured from the wrapper's calls). The rows
    are the marker rows in key order, or with ``every_row`` every row in
    key order, as the sweep folds them when a value rules compaction out
    (``torch_sweep._k5_rows``)."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    from pipelinedp_tpu_torch.ops.kernels import segkeyed
    captured = []
    real = segkeyed.segmented_sums
    real_layout = segkeyed.key_layout

    def spy(values, layout):
        captured.append((values.clone(), layout))
        return real(values, layout)

    def every_row_layout(keys, P, keep=None):
        return real_layout(keys, P)
    segkeyed.segmented_sums = spy
    if every_row:
        segkeyed.key_layout = every_row_layout
    try:
        _, options = sweep_options(tan, pdt, n_cfg)
        run_sweep(columns, options, "cuda")
    finally:
        segkeyed.segmented_sums = real
        segkeyed.key_layout = real_layout
    (moments, layout), (count, _) = captured[:2]
    return count, moments, layout


def time_segkeyed(values, layout):
    """K5 against its plain version, bit for bit, and the median ms of K5,
    the plain version (one call) and one float32 ``index_add_`` over the
    keys (the library yardstick: per-key column totals in no fixed order,
    so not K5's bits), with the bound for these inputs: the larger of the
    bytes over the memory rate and the longest key's add chain."""
    from pipelinedp_tpu_torch.ops.kernels import segkeyed
    got = segkeyed.segmented_sums(values, layout)
    t0 = time.perf_counter()
    want = segkeyed.segmented_sums_plain(values, layout)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    diff = got.view(torch.int32) != want.view(torch.int32)
    assert not bool(diff.any()), (
        f"K5 differs from its plain version at {int(diff.sum())} elements")
    max_abs_err = float((got - want).abs().max())
    n, W = values.shape
    P = layout.P
    lens = torch.diff(layout.offsets)
    keys = torch.repeat_interleave(torch.arange(P, device=values.device),
                                   lens)

    def library():
        return torch.zeros(P, W, dtype=torch.float32,
                           device=values.device).index_add_(0, keys, values)

    # Least work for these inputs: ``segkeyed.work``, the counts the cost
    # table bounds each launch with; a key's rows are one chain of
    # dependent float32 adds.
    work = segkeyed.work(values, layout)
    bound = card_bound(work)
    return dict(
        max_abs_err=max_abs_err,
        ms=cuda_ms(lambda: segkeyed.segmented_sums(values, layout)),
        plain_ms=plain_s * 1e3, library_ms=cuda_ms(library),
        bound_ms=bound["bound_ms"], bound_by=bound["bound_by"],
        bytes_ms=bound["bytes_ms"], chain_ms=bound["chain_ms"],
        bound_bytes=work.bytes, shape=[n, W], keys=P,
        longest_key_rows=work.chain,
        ring="tma" if segkeyed.takes_tiles(n, W, values.data_ptr())
        else "cp.async 4-byte")


def segkeyed_seams():
    """K5 against its plain version on every ``segkeyed.seam_layout``
    layout, normal and order-sensitive values, every row and every third
    row dropped (``keep``), aligned and as a view one float in (an
    unaligned base)."""
    from pipelinedp_tpu_torch.ops.kernels import segkeyed
    checked = []
    for name in segkeyed.SEAM_LAYOUTS:
        for order_sensitive in (False, True):
            values, keys, P = segkeyed.seam_layout(name, order_sensitive)
            k = torch.from_numpy(keys).cuda()
            for dropped in (False, True):
                keep = (torch.arange(len(keys), device="cuda") % 3 != 0
                        if dropped else None)
                layout = segkeyed.key_layout(k, P, keep)
                rows = torch.from_numpy(values).cuda().index_select(
                    0, layout.order)
                for offset in (0, 1):
                    buf = torch.empty(rows.numel() + offset, device="cuda")
                    v = buf[offset:].view(rows.shape)
                    v.copy_(rows)
                    got = segkeyed.segmented_sums(v, layout)
                    want = segkeyed.segmented_sums_plain(v, layout)
                    assert torch.equal(got.view(torch.int32),
                                       want.view(torch.int32)), (
                        f"K5 differs from its plain version on {name} "
                        f"(order-sensitive {order_sensitive}, rows dropped "
                        f"{dropped}, offset {offset})")
                    checked.append(
                        f"{name}/{order_sensitive}/{dropped}/{offset}")
    return checked


def phase_segkeyed_kernel(c5_columns, max_sm_mhz):
    """K5 against its plain version, timed, on config 5's count stack and
    selection-moment stack (the first chunk of the main path: the marker
    rows in key order), on a one-key stack of the same rows (the add
    chain's case), on the count stack of every row in key order (the
    bytes K5 v1 read, without the compaction), and on the seam
    layouts."""
    from pipelinedp_tpu_torch.ops.kernels import segkeyed
    count, moments, layout = capture_k5_stacks(c5_columns, 132)
    rec_count = time_segkeyed(count, layout)
    rec_moments = time_segkeyed(moments, layout)
    one_key = segkeyed.key_layout(
        torch.zeros(count.shape[0], dtype=torch.int32, device="cuda"),
        layout.P)
    rec_one = time_segkeyed(moments, one_key)
    del count, moments
    every, _, every_layout = capture_k5_stacks(c5_columns, 132,
                                               every_row=True)
    rec_every = time_segkeyed(every, every_layout)
    del every, _
    seams = segkeyed_seams()
    log("segkeyed_kernel", kernel="segmented_sums", count_stack=rec_count,
        moment_stack=rec_moments, one_key_stack=rec_one,
        every_row_count_stack=rec_every, seams_identical=seams,
        max_sm_mhz=max_sm_mhz)
    return rec_count


def phase_sweep_gpu_vs_cpu(c5_columns):
    """The sweep on the card against the CPU, bit for bit: config 5's data
    over 64 configs of its grid (one chunk of 64 on the card, chunks of 32
    on the CPU); a mixed-mechanism sweep with public partitions (two
    empty) and per-partition rows; and the fused dataset histograms and
    ``tune`` on config 5's data."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    from pipelinedp_tpu_torch.ops.kernels import segkeyed
    _, options = sweep_options(tan, pdt, 64)
    segkeyed.reset_launches()
    _, gpu, _, gpu_s = run_sweep(c5_columns, options, "cuda", width=64)
    k5 = segkeyed.LAUNCHES["segmented_sums"]
    _, cpu, _, cpu_s = run_sweep(c5_columns, options, "cpu", width=32)
    assert segkeyed.LAUNCHES["segmented_sums"] == k5, "the CPU launched K5"
    assert k5 == 2, f"64 configs in one chunk launch K5 twice, not {k5}"
    _assert_sweeps_identical(gpu, cpu, "config 5, 64 configs")

    small = zipf_columns(50_000, 3_000, 300, seed=51)
    public = list(range(302))  # keys 300 and 301 hold no row
    S, N = pdt.PartitionSelectionStrategy, pdt.NoiseKind
    mixed = tan.UtilityAnalysisOptions(
        epsilon=1.5, delta=1e-6,
        aggregate_params=pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM,
                     pdt.Metrics.PRIVACY_ID_COUNT],
            max_partitions_contributed=3,
            max_contributions_per_partition=2, min_sum_per_partition=0.0,
            max_sum_per_partition=8.0),
        multi_param_configuration=tan.MultiParameterConfiguration(
            max_partitions_contributed=[1, 3, 5, 8],
            max_contributions_per_partition=[2, 2, 1, 3],
            noise_kind=[N.LAPLACE, N.GAUSSIAN, N.GAUSSIAN, N.LAPLACE]))
    _, g_mixed, g_rows, _ = run_sweep(small, mixed, "cuda", public=public,
                                      per_partition=True)
    _, c_mixed, c_rows, _ = run_sweep(small, mixed, "cpu", public=public,
                                      per_partition=True)
    _assert_sweeps_identical(g_mixed, c_mixed, "mixed public")
    _assert_pp_rows_identical(g_rows, c_rows, "mixed public rows")
    assert len(g_rows) == 302

    def extractors():
        return pdt.DataExtractors()

    ds = pdt.ArrayDataset(*c5_columns)
    g_hist = list(tan.compute_dataset_histograms(
        ds, extractors(), pdt.TorchBackend("cuda")))[0]
    c_hist = list(tan.compute_dataset_histograms(
        pdt.ArrayDataset(*c5_columns), extractors(),
        pdt.TorchBackend("cpu")))[0]
    for name in ("l0_contributions_histogram",
                 "linf_contributions_histogram",
                 "count_per_partition_histogram",
                 "count_privacy_id_per_partition"):
        a = [(b.lower, b.count, b.sum, b.max)
             for b in getattr(g_hist, name).bins]
        b_ = [(b.lower, b.count, b.sum, b.max)
              for b in getattr(c_hist, name).bins]
        assert a == b_, f"histogram {name} differs"
        assert a, f"histogram {name} is empty"
    tune_opts = tan.TuneOptions(
        epsilon=1.0, delta=1e-6,
        aggregate_params=pdt.AggregateParams(
            metrics=[pdt.Metrics.COUNT], noise_kind=pdt.NoiseKind.LAPLACE,
            max_partitions_contributed=1,
            max_contributions_per_partition=1),
        function_to_minimize=tan.MinimizingFunction.ABSOLUTE_ERROR,
        parameters_to_tune=tan.ParametersToTune(
            max_partitions_contributed=True,
            max_contributions_per_partition=True))
    tuned = {}
    for device, hist in (("cuda", g_hist), ("cpu", c_hist)):
        t0 = time.perf_counter()
        tuned[device] = (list(tan.tune(
            pdt.ArrayDataset(*c5_columns), pdt.TorchBackend(device), hist,
            tune_opts, extractors()))[0], time.perf_counter() - t0)
    g_tune, c_tune = tuned["cuda"][0], tuned["cpu"][0]
    assert g_tune.index_best == c_tune.index_best
    _assert_sweeps_identical(g_tune.utility_analysis_results,
                             c_tune.utility_analysis_results, "tune")
    best = g_tune.utility_analysis_results[g_tune.index_best]
    log("sweep_gpu_vs_cpu", identical=True, config5_configs=64,
        config5_gpu_s=gpu_s, config5_cpu_s=cpu_s, k5_launches=k5,
        mixed_public_partitions=len(g_rows),
        tune_candidates=g_tune.utility_analysis_parameters.size,
        tune_best=dict(
            l0=best.input_aggregate_params.max_partitions_contributed,
            linf=best.input_aggregate_params.max_contributions_per_partition),
        tune_gpu_s=tuned["cuda"][1], tune_cpu_s=tuned["cpu"][1])


def phase_config5(c5_columns):
    """BASELINE config 5 at its spec on the card (500k rows, the 100 x 100
    grid of 10,000 configs), with every kernel count zeroed just before
    and read just after; K5's and K4's device time from CUDA events."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    n_cfg, options = sweep_options(tan, pdt, CONFIG5_CONFIGS)
    assert n_cfg == CONFIG5_CONFIGS
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    with _kernel_clock() as clock:
        lazy, result, _, wall_s = run_sweep(c5_columns, options, "cuda")
    kernel_ms = clock.ms()
    launches = _launch_counts()
    assert len(result) == n_cfg
    bits = sweep_bits(result).view(np.float64)
    assert np.isfinite(bits).all(), "config 5 released a non-finite field"
    assert launches["segmented_sums"] == 2 * lazy.n_chunks, launches
    assert launches["segment_totals"] == 1, launches
    assert launches["segment_sum_lanes"] >= 1, launches
    errs = np.asarray([m.count_metrics.error_expected for m in result])
    log("config5", data=CONFIG5, configs=n_cfg, wall_s=wall_s,
        configs_per_s=n_cfg / wall_s,
        config_rows_per_s=n_cfg * CONFIG5["rows"] / wall_s,
        chunk=lazy.chunk, chunks=lazy.n_chunks, launches=launches,
        k5_ms=kernel_ms["segmented_sums"],
        k4_ms=kernel_ms["segment_totals"],
        k5_share=kernel_ms["segmented_sums"] / (wall_s * 1e3),
        k4_share=kernel_ms["segment_totals"] / (wall_s * 1e3),
        peak_mem_bytes=torch.cuda.max_memory_allocated(),
        error_expected_range=[float(errs.min()), float(errs.max())])
    return dict(launches=launches, result=result, wall_s=wall_s)


def phase_config5_breakdown(c5_columns, out_dir):
    """Where config 5's sweep spends its time (``--profile``): 1,056
    configs (eight chunks of 132) with CUDA events around each stage
    (stage A, the key layout, each chunk, and inside the chunks K5, the
    keep probability and the error quantiles), host clocks around the
    encode and the packing, then one chunk under ``torch.profiler``: the
    device busy share and the top operators."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    from pipelinedp_tpu_torch.analysis import torch_sweep as ts
    from pipelinedp_tpu_torch.ops.kernels import segkeyed
    _, options = sweep_options(tan, pdt, 1056)
    targets = [(ts.LazySweepResult, "_stage_a", "stage_a"),
               (segkeyed, "key_layout", "key_layout"),
               (ts, "_sweep_chunk_body", "chunks"),
               (segkeyed, "segmented_sums", "k5"),
               (ts, "_keep_probability", "keep_probability"),
               (ts, "_error_quantiles", "error_quantiles"),
               (ts, "_concat_fetch", "fetch")]
    host = {}

    def host_timed(owner, attr):
        fn = getattr(owner, attr)

        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            host[attr] = host.get(attr, 0.0) + time.perf_counter() - t0
            return out
        setattr(owner, attr, timed)
        return fn

    saved = [(ts.LazySweepResult, a, host_timed(ts.LazySweepResult, a))
             for a in ("_encode", "_pack")]
    try:
        with _EventClock(targets) as clock:
            lazy, _, _, wall_s = run_sweep(c5_columns, options, "cuda",
                                           width=132)
        stages_ms = clock.ms()
        calls = clock.calls()
    finally:
        for owner, attr, fn in saved:
            setattr(owner, attr, fn)
    _, one_chunk = sweep_options(tan, pdt, 132)
    run_sweep(c5_columns, one_chunk, "cuda", width=132)
    profile = _profiled(
        lambda: run_sweep(c5_columns, one_chunk, "cuda", width=132),
        os.path.join(out_dir, "config5_profile.txt") if out_dir else None)
    log("config5_breakdown", configs=1056, chunk=lazy.chunk,
        chunks=lazy.n_chunks, wall_s=wall_s, stage_ms=stages_ms,
        stage_calls=calls,
        host_s={k.lstrip("_"): v for k, v in host.items()},
        one_chunk_profile=profile)


def phase_megasweep():
    """``bench_utility_megasweep``'s shape (1M rows, 40k users, 2000
    partitions, seed 23) at K = 16, 64 and 256: walked (width 1) against
    batched (width K), bit for bit per config, with configs/s of each
    leg."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    columns = zipf_columns(MEGASWEEP["rows"], MEGASWEEP["users"],
                           MEGASWEEP["partitions"], MEGASWEEP["seed"])
    out = {}
    for k in MEGASWEEP_WIDTHS:
        n_cfg, options = sweep_options(tan, pdt, k)
        _, batched, _, batched_s = run_sweep(columns, options, "cuda",
                                             width=n_cfg)
        _, walked, _, walked_s = run_sweep(columns, options, "cuda",
                                           width=1)
        _assert_sweeps_identical(batched, walked, f"megasweep K={k}")
        out[f"K{k}"] = dict(configs=n_cfg, batched_s=batched_s,
                            walked_s=walked_s,
                            batched_configs_per_s=n_cfg / batched_s,
                            walked_configs_per_s=n_cfg / walked_s)
    log("megasweep", data=MEGASWEEP, identical=True, **out)


def phase_sweep_kill_resume(c5_columns):
    """Config 5's data over 1,024 configs in chunks of 132, killed at
    config chunk 3 by the port's ``FaultPlan`` and resumed from its
    ``.sweep`` checkpoint under ``build/``: the bits of the unbroken
    sweep."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    from pipelinedp_tpu_torch.resilience import (ChunkFailure, FaultPlan,
                                                 injected_faults)
    _, options = sweep_options(tan, pdt, 1024)
    ckpt_dir = os.path.join(HERE, "build", "chip_smoke_ckpt")
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, "config5_sweep.ckpt")
    if os.path.exists(path + ".sweep"):
        os.unlink(path + ".sweep")
    _, unbroken, _, unbroken_s = run_sweep(c5_columns, options, "cuda",
                                           width=132)
    try:
        with injected_faults(FaultPlan(fail_sweep_config_chunks=(3,))):
            run_sweep(c5_columns, options, "cuda", width=132,
                      checkpoint=path)
    except ChunkFailure:
        pass
    else:
        raise AssertionError("the kill at config chunk 3 did not fire")
    assert os.path.exists(path + ".sweep"), "no sweep checkpoint survived"
    lazy, resumed, _, resumed_s = run_sweep(c5_columns, options, "cuda",
                                            width=132, checkpoint=path)
    assert lazy._resumed_from_chunk == 3
    assert not os.path.exists(path + ".sweep"), "success must clear it"
    _assert_sweeps_identical(resumed, unbroken, "resumed sweep")
    log("sweep_kill_resume", configs=1024, chunk=132, killed_at_chunk=3,
        identical=True, unbroken_s=unbroken_s, resumed_s=resumed_s)


# ---------------------------------------------------------------------------
# Phase 25: the generic host path
# ---------------------------------------------------------------------------

# The JAX bench's LocalBackend sizes (``bench.py:2786``, ``:2856``,
# ``:436-465``): 250,000 rows of the flagship, 50,000 of config 4, and the
# sweep's host unit rate on 8 nominal configs x 20,000 rows of config 5.
HOST_FLAGSHIP_ROWS = 250_000
HOST_CONFIG4_ROWS = 50_000
HOST_SWEEP_ROWS = 20_000
# Best of 2 on the host (best of 3 would take config 4's host leg alone
# past two minutes); best of 3 on the card.
HOST_REPEATS = 2
CARD_REPEATS = 3


def _engine_release(pdt, backend, columns, params_kw, public=None, eps=1.0,
                    delta=1e-6, seed=None):
    """One ``DPEngine.aggregate`` on ``backend`` (an ``ArrayDataset`` of
    ``columns``), with the host RNG seeded first when ``seed`` is given:
    (rows, the lazy result, wall seconds with the card synchronised)."""
    from pipelinedp_tpu_torch.ops import noise
    if seed is not None:
        noise.seed_host_rng(seed)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    acc = pdt.NaiveBudgetAccountant(total_epsilon=eps, total_delta=delta)
    engine = pdt.DPEngine(acc, backend)
    result = engine.aggregate(pdt.ArrayDataset(*columns),
                              pdt.AggregateParams(**params_kw),
                              pdt.DataExtractors(), public_partitions=public)
    acc.compute_budgets()
    rows = list(result)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return rows, result, time.perf_counter() - t0


def _release_bits(rows):
    """(keys, float64 bits of every released value) of a release."""
    keys = [k for k, _ in rows]
    vals = np.asarray([np.asarray(tuple(m), np.float64) for _, m in rows],
                      np.float64)
    return keys, vals.view(np.uint64)


def _noisy_count_combiner(pdt):
    """A user's custom combiner: a noisy count on the host RNG."""
    from pipelinedp_tpu_torch.aggregate_params import MechanismType
    from pipelinedp_tpu_torch.ops import noise

    class NoisyCount(pdt.CustomCombiner):

        def request_budget(self, budget_accountant):
            self._spec = budget_accountant.request_budget(
                MechanismType.LAPLACE)

        def create_accumulator(self, values):
            return len(list(values))

        def merge_accumulators(self, a, b):
            return a + b

        def compute_metrics(self, acc):
            return acc + noise.np_laplace(2.0 / self._spec.eps)

        def explain_computation(self):
            return lambda: "noisy count"

    return NoisyCount()


def _host_select(seed):
    """``select_partitions`` on ``LocalBackend`` over phase 25's rows with
    the host RNG seeded: the kept keys. Runs in this process and in a
    spawned process that sees no card."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.ops import noise
    rng = np.random.default_rng(seed)
    rows = list(zip(rng.integers(0, 3000, 20_000).tolist(),
                    (rng.zipf(1.3, 20_000) % 500).tolist()))
    noise.seed_host_rng(seed)
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    result = pdt.DPEngine(acc, pdt.LocalBackend()).select_partitions(
        rows, pdt.SelectPartitionsParams(max_partitions_contributed=2),
        pdt.DataExtractors(privacy_id_extractor=lambda r: r[0],
                           partition_extractor=lambda r: r[1]))
    acc.compute_budgets()
    return list(result), torch.cuda.is_available()


def phase_host_routing():
    """25a. Routing on the card: fusable params on ``TorchBackend()`` give
    the fused path's lazy result; a percentile range under the fused
    walk's float32 limit and a custom combiner take the host graph, and
    release the same bits on ``TorchBackend()``, ``TorchBackend("cpu")``
    and ``LocalBackend()`` under one host seed; ``select_partitions`` on
    ``LocalBackend`` keeps the same keys here and in a process without
    the card."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import torch_engine as te
    columns = zipf_columns(1_000, 400, 10, seed=61)
    fused_rows, fused, _ = _engine_release(
        pdt, pdt.TorchBackend(rng_seed=0), columns, flagship_params(pdt))
    assert isinstance(fused, te.LazyFusedResult), type(fused)
    assert fused_rows, "the fused flagship kept nothing"
    tiny = dict(metrics=[pdt.Metrics.COUNT, pdt.Metrics.PERCENTILE(50)],
                max_partitions_contributed=2,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=1e-35)
    tiny_cols = (columns[0], columns[1], columns[2] * 1e-36)
    backends = {"cuda": lambda: pdt.TorchBackend(rng_seed=0),
                "cpu": lambda: pdt.TorchBackend("cpu", rng_seed=0),
                "local": pdt.LocalBackend}
    released = {}
    for case, kw in (("tiny_range", dict(params_kw=tiny)),
                     ("custom_combiner", dict(params_kw=None))):
        for name, make in backends.items():
            params = kw["params_kw"] or dict(
                max_partitions_contributed=2,
                max_contributions_per_partition=2,
                custom_combiners=[_noisy_count_combiner(pdt)])
            rows, result, wall = _engine_release(
                pdt, make(), tiny_cols if case == "tiny_range" else columns,
                params, seed=62)
            assert not isinstance(result, te.LazyFusedResult), (case, name)
            released[(case, name)] = (_release_bits(rows), wall)
        ref = released[(case, "cuda")][0]
        assert ref[0], f"{case}: nothing released"
        for name in ("cpu", "local"):
            got = released[(case, name)][0]
            assert got[0] == ref[0] and np.array_equal(got[1], ref[1]), (
                f"{case}: {name} differs from the card's backend")
    here, card_visible = _host_select(63)
    assert card_visible
    saved = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    try:
        with ProcessPoolExecutor(
                1, mp_context=multiprocessing.get_context("spawn")) as pool:
            there, there_visible = pool.submit(_host_select, 63).result()
    finally:
        if saved is None:
            os.environ.pop("CUDA_VISIBLE_DEVICES")
        else:
            os.environ["CUDA_VISIBLE_DEVICES"] = saved
    assert not there_visible, "the spawned process saw the card"
    assert here == there and here, "select_partitions depends on the card"
    log("host_routing", fused_flagship_kept=len(fused_rows),
        tiny_range_kept=len(released[("tiny_range", "cuda")][0][0]),
        custom_combiner_kept=len(released[("custom_combiner",
                                           "cuda")][0][0]),
        identical=True, select_partitions_kept=len(here),
        walls_s={f"{c}/{n}": w for (c, n), (_, w) in released.items()})


def phase_host_oracle(prefix):
    """25b. The host oracle against the fused path on the flagship's
    first 250,000 rows: COUNT + SUM + PRIVACY_ID_COUNT, Laplace, eps 1e12,
    delta 1e-2, the prefix's keys public and L0, Linf at the prefix's
    maxima (neither path samples). Counts and privacy-id counts equal
    after rounding; sums within the fused path's 24-bit fixed point,
    ``|d| <= 1e-5 |sum| + 1e-3``."""
    import pipelinedp_tpu_torch as pdt
    pids, pks, _ = prefix
    pairs, per_pair = np.unique(np.stack([pids, pks]), axis=1,
                                return_counts=True)
    l0 = int(np.unique(pairs[0], return_counts=True)[1].max())
    linf = int(per_pair.max())
    public = np.unique(pks).tolist()
    params = dict(metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM,
                           pdt.Metrics.PRIVACY_ID_COUNT],
                  noise_kind=pdt.NoiseKind.LAPLACE,
                  max_partitions_contributed=l0,
                  max_contributions_per_partition=linf, min_value=0.0,
                  max_value=10.0)
    host, _, host_s = _engine_release(pdt, pdt.LocalBackend(), prefix,
                                      params, public, eps=1e12, delta=1e-2,
                                      seed=64)
    _reset_launches()
    fused, _, fused_s = _engine_release(pdt, pdt.TorchBackend(rng_seed=0),
                                        prefix, params, public, eps=1e12,
                                        delta=1e-2)
    launches = _launch_counts()
    assert launches["segment_sum_lanes"] >= 1, "K1 never launched"
    host, fused = dict(host), dict(fused)
    assert sorted(host) == sorted(fused) == sorted(public)
    worst = 0.0
    for k, h in host.items():
        f = fused[k]
        assert round(h.count) == round(f.count), (k, h, f)
        assert round(h.privacy_id_count) == round(f.privacy_id_count), k
        d = abs(h.sum - f.sum)
        assert d <= 1e-5 * abs(h.sum) + 1e-3, (k, h.sum, f.sum)
        worst = max(worst, d / (1e-5 * abs(h.sum) + 1e-3))
    log("host_oracle", rows=len(pks), partitions=len(public), l0=l0,
        linf=linf, counts_equal=True, sum_tolerance="1e-5*|sum| + 1e-3",
        sum_worst_share_of_tolerance=worst, host_s=host_s, fused_s=fused_s,
        launches=launches)


def small_sweep_options(tan, pdt, n_cfg):
    """``bench.py``'s ``sweep_options`` below 1,000 configs: l0 caps
    ``unique(geomspace(1, 60, n_cfg))`` at Linf 2, COUNT, Laplace,
    eps = 1, delta = 1e-6."""
    caps = np.unique(np.geomspace(1, 60, n_cfg).astype(int))
    multi = tan.MultiParameterConfiguration(
        max_partitions_contributed=caps.tolist(),
        max_contributions_per_partition=[2] * len(caps))
    params = pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT], noise_kind=pdt.NoiseKind.LAPLACE,
        max_partitions_contributed=4, max_contributions_per_partition=2)
    return len(caps), tan.UtilityAnalysisOptions(
        epsilon=1.0, delta=1e-6, aggregate_params=params,
        multi_param_configuration=multi)


def phase_host_sweep_oracle(c5_slice):
    """25c. The JAX bench's host-oracle spot check (``bench.py:452-465``):
    3 configs on 20,000 rows of config 5's data, the host graph on
    ``LocalBackend`` against the fused sweep on the card, ``error_expected``
    within ``max(5%, 0.5)``; then ``return_per_partition`` past a shrunken
    ``_PP_BYTE_CAP`` on ``TorchBackend()``, which takes the host graph and
    equals the CPU run bit for bit."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    from pipelinedp_tpu_torch.analysis import torch_sweep
    from pipelinedp_tpu_torch.ops import noise
    n_cfg, options = small_sweep_options(tan, pdt, 3)
    noise.seed_host_rng(65)
    _, host, _, host_s = run_sweep(c5_slice, options, "cuda",
                                   backend=pdt.LocalBackend())
    _reset_launches()
    lazy, fused, _, fused_s = run_sweep(c5_slice, options, "cuda")
    launches = _launch_counts()
    assert isinstance(lazy, torch_sweep.LazySweepResult)
    for name in ("segment_totals", "segment_sum_lanes", "segmented_sums"):
        assert launches[name] >= 1, f"{name} never launched: {launches}"
    assert len(host) == len(fused) == n_cfg
    diffs = []
    for h, f in zip(host, fused):
        hv, fv = h.count_metrics.error_expected, f.count_metrics.error_expected
        assert abs(hv - fv) <= max(0.05 * abs(hv), 0.5), (hv, fv)
        diffs.append([hv, fv])
    small = tuple(c[:5_000] for c in c5_slice)
    saved = torch_sweep._PP_BYTE_CAP
    torch_sweep._PP_BYTE_CAP = 64
    try:
        _reset_launches()
        noise.seed_host_rng(66)
        _, g_res, g_rows, g_s = run_sweep(small, options, "cuda",
                                          per_partition=True)
        assert _launch_counts()["segmented_sums"] == 0, (
            "past the byte cap the sweep must take the host graph")
        noise.seed_host_rng(66)
        _, c_res, c_rows, _ = run_sweep(small, options, "cpu",
                                        per_partition=True)
    finally:
        torch_sweep._PP_BYTE_CAP = saved
    _assert_sweeps_identical(g_res, c_res, "byte-capped host fallback")
    _assert_pp_rows_identical(g_rows, c_rows, "byte-capped rows")
    assert g_rows
    log("host_sweep_oracle", rows=len(c5_slice[1]), configs=n_cfg,
        error_expected_host_fused=diffs, tolerance="max(5%, 0.5)",
        host_s=host_s, fused_s=fused_s, launches=launches,
        byte_cap_rows=len(small[1]), byte_cap_partitions=len(g_rows),
        byte_cap_identical=True, byte_cap_s=g_s)


def host_cpu() -> dict:
    """The host CPU as ``/proc/cpuinfo`` names its first processor (a
    virtual machine may report its model name as unknown; the family and
    model numbers still identify the part)."""
    fields = {"vendor_id": "vendor", "cpu family": "family",
              "model": "model", "model name": "model_name"}
    out = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            key = key.strip()
            if not key:
                break
            if key in fields:
                out[fields[key]] = value.strip()
    return out


def _best(fn, repeats):
    return min(fn() for _ in range(repeats))


def phase_host_rates(flag_prefix, c4_prefix, c5_slice):
    """25d. Host rates beside the card's, as the JAX bench measures them
    (best of ``HOST_REPEATS`` on the host, of ``CARD_REPEATS`` on the
    card after a warm run): ``LocalBackend`` rows/s of the flagship params
    at 250,000 rows and of config 4 at 50,000 (the host ``QuantileTree``),
    and the host sweep's configs x rows / s on 8 nominal configs x 20,000
    rows; each beside the fused path on the same rows and the full-size
    cell of phases 4, 10 and 22, with the ratios (the port's first
    ``vs LocalBackend`` figures)."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    phases = RECORD["phases"]
    out = {}
    for name, cols, params, full in (
            ("flagship", flag_prefix, flagship_params(pdt),
             phases["flagship"]["rows_per_s"]),
            ("config4", c4_prefix, config4_params(pdt),
             phases["config4"]["single"]["rows_per_s"])):
        n = len(cols[1])
        host_s = _best(lambda: _engine_release(
            pdt, pdt.LocalBackend(), cols, params)[2], HOST_REPEATS)
        card = pdt.TorchBackend(rng_seed=0)
        _engine_release(pdt, card, cols, params)
        card_s = _best(lambda: _engine_release(pdt, card, cols, params)[2],
                       CARD_REPEATS)
        out[name] = dict(rows=n, host_rows_per_s=n / host_s,
                         card_rows_per_s=n / card_s,
                         card_vs_host=host_s / card_s,
                         full_size_card_rows_per_s=full,
                         full_size_vs_host=full / (n / host_s),
                         host_s=host_s, card_s=card_s)
    n_cfg, options = small_sweep_options(tan, pdt, 8)
    n = len(c5_slice[1])
    host_s = _best(lambda: run_sweep(c5_slice, options, "cuda",
                                     backend=pdt.LocalBackend())[3],
                   HOST_REPEATS)
    run_sweep(c5_slice, options, "cuda")
    card_s = _best(lambda: run_sweep(c5_slice, options, "cuda")[3],
                   CARD_REPEATS)
    full = phases["config5"]["config_rows_per_s"]
    out["sweep"] = dict(rows=n, configs=n_cfg,
                        host_config_rows_per_s=n_cfg * n / host_s,
                        card_config_rows_per_s=n_cfg * n / card_s,
                        card_vs_host=host_s / card_s,
                        full_size_card_config_rows_per_s=full,
                        full_size_vs_host=full / (n_cfg * n / host_s),
                        host_s=host_s, card_s=card_s)
    log("host_rates", host_cpu=host_cpu(),
        host_cores=os.cpu_count(), host_repeats=HOST_REPEATS,
        card_repeats=CARD_REPEATS, **out)


# ---------------------------------------------------------------------------
# Phase 26: sketch-first DP heavy hitters
# ---------------------------------------------------------------------------

# The JAX bench's ``bench_dp_heavy_hitters`` (``bench.py:1700-1795``): its
# smoke shape, and its full size (``:2905-2908``), run once cold and then
# best of two warm with seeds 31 and 32.
HH_SMOKE_ROWS = 200_000
HH_ROWS = 10_000_000
HH_SEEDS = (31, 32)


def hh_columns(n_rows):
    """``bench_dp_heavy_hitters``' data: keys ``"url/" + (zipf(1.2) %
    distinct)`` with ``distinct = n / 10``, ``n / 20`` users, values
    uniform in [0, 10), from one numpy generator (seed 23) in that order.
    Returns (pids, keys, values, raw key ids, distinct)."""
    distinct = max(n_rows // 10, 1_000)
    n_users = max(n_rows // 20, 1_000)
    rng = np.random.default_rng(23)
    raw = (rng.zipf(1.2, n_rows) % distinct).astype(np.int64)
    keys = np.char.add("url/", raw.astype("U12"))
    pids = rng.integers(0, n_users, n_rows)
    values = rng.uniform(0.0, 10.0, n_rows)
    return pids, keys, values, raw, distinct


def hh_params(pdt):
    """COUNT + SUM, Laplace, L0 = 4, Linf = 2, values in [0, 10]."""
    return dict(metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM],
                noise_kind=pdt.NoiseKind.LAPLACE,
                max_partitions_contributed=4,
                max_contributions_per_partition=2, min_value=0.0,
                max_value=10.0)


def hh_sketch(pdt, smoke, **kw):
    """The bench's sketch: eps 2, delta 1e-7, depth 2; width 2^12 and cap
    256 at the smoke shape, 2^16 and 2048 at full size."""
    base = dict(eps=2.0, delta=1e-7, width=(1 << 12) if smoke else 1 << 16,
                depth=2, candidate_cap=256 if smoke else 2048)
    base.update(kw)
    return pdt.SketchParams(**base)


def _hh_run(pdt, columns, device, seed, sketch=None):
    """One ``DPEngine.aggregate`` (sketch-first unless ``sketch`` is None)
    on ``TorchBackend(device)``: (rows, the lazy result, the wall of its
    iteration with the card synchronised, as the bench times it)."""
    pids, keys, values = columns[:3]
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(device=device,
                                                rng_seed=seed))
    result = engine.aggregate(
        pdt.ArrayDataset(privacy_ids=pids, partition_keys=keys,
                         values=values),
        pdt.AggregateParams(**hh_params(pdt)), pdt.DataExtractors(),
        sketch_first=sketch)
    acc.compute_budgets()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = list(result)
    torch.cuda.synchronize()
    return rows, result, time.perf_counter() - t0


def _hh_pair_buckets(columns, sketch, l0):
    """The bounded pairs' [depth, n] bucket ids, as phase 1 computes them
    on the host."""
    from pipelinedp_tpu_torch.sketch import engine as sk_engine
    from pipelinedp_tpu_torch.sketch import hashing
    pids, keys = columns[:2]
    uniq, inv = sk_engine._factorize_keys(keys)
    hashes = hashing.stable_hash64(uniq, sketch.hash_seed)
    buckets = hashing.bucket_ids(hashes, sketch.resolved_width(),
                                 sketch.resolved_depth(), sketch.hash_seed)
    kept = sk_engine.bound_pairs(pids, inv, hashes, l0, sketch.hash_seed)
    return np.ascontiguousarray(buckets[:, kept])


def phase_hh_gpu_vs_cpu(columns):
    """26a. The smoke shape on ``TorchBackend()`` and ``TorchBackend("cpu")``
    under each binner backend: the same candidates, kept keys and float64
    bits, the binner on the card and K1 launched there; and the binner's
    [depth, width] counts on the card, both backends, equal to
    ``np.bincount`` of the bucket ids."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.sketch import device as sk_device
    out = {}
    releases = {}
    for backend in ("matmul", "xla"):
        sketch = hh_sketch(pdt, True, backend=backend)
        _reset_launches()
        gpu_rows, gres, gpu_s = _hh_run(pdt, columns, "cuda", 31, sketch)
        launches = _launch_counts()
        cpu_rows, cres, cpu_s = _hh_run(pdt, columns, "cpu", 31, sketch)
        assert gres.binner_device.startswith("cuda"), gres.binner_device
        assert cres.binner_device == "cpu", cres.binner_device
        assert launches["segment_sum_lanes"] >= 1, "K1 never launched"
        assert (gres.timings["sketch_candidates"] ==
                cres.timings["sketch_candidates"] > 0)
        assert gres._candidate_table == cres._candidate_table
        _released_identical(gpu_rows, cpu_rows,
                            f"heavy hitters ({backend}) GPU vs CPU")
        releases[backend] = gpu_rows
        out[backend] = dict(candidates=gres.timings["sketch_candidates"],
                            kept=len(gpu_rows), gpu_s=gpu_s, cpu_s=cpu_s,
                            launches=launches)
    _released_identical(releases["matmul"], releases["xla"],
                        "heavy hitters matmul vs xla")
    sketch = hh_sketch(pdt, True)
    width = sketch.resolved_width()
    pairs = _hh_pair_buckets(columns, sketch, 4)
    chunk = torch.from_numpy(sk_device.pad_chunk(pairs)).cuda()
    want = np.stack([np.bincount(pairs[d], minlength=width)
                     for d in range(pairs.shape[0])])
    for backend in ("matmul", "xla"):
        counts = sk_device.sketch_chunk(chunk, width, backend)
        assert counts.device.type == "cuda" and counts.dtype == torch.int32
        assert np.array_equal(counts.cpu().numpy(), want), (
            f"binner {backend} differs from np.bincount")
    log("hh_gpu_vs_cpu", rows=len(columns[1]), pairs=int(pairs.shape[1]),
        width=width, identical=True, **out)


def phase_hh_parity_dense(columns):
    """26b. PARITY row 37 on the card: every populated bucket selected (a
    generous sketch budget, threshold 0.5, the cap at the width, and a
    phase-1 bound above any user's distinct keys, so that every key
    reaches the sketch), so the candidates are every key and the
    sketch-first release equals the dense ``aggregate`` on the same rows
    and seed, bit for bit."""
    import pipelinedp_tpu_torch as pdt
    sketch = hh_sketch(pdt, True, eps=1e6, width=1 << 16,
                       candidate_cap=1 << 16, threshold=0.5,
                       max_buckets_contributed=1 << 10)
    dense, _, dense_s = _hh_run(pdt, columns, "cuda", 37)
    sk_rows, res, sk_s = _hh_run(pdt, columns, "cuda", 37, sketch)
    assert res.timings["sketch_candidates"] == len(np.unique(columns[3]))
    _released_identical(sk_rows, dense, "sketch-first vs dense")
    log("hh_parity_dense", kept=len(dense),
        candidates=res.timings["sketch_candidates"], identical=True,
        dense_s=dense_s, sketch_s=sk_s)


def phase_hh_full(columns):
    """26c. The bench's full-size cell: cold (seed 31), then best of two
    warm (seeds 31, 32), each with the kernel counts zeroed just before
    and read just after; rows/s, the phase split, the funnel, top-50
    recall against the true distinct-user ranking, peak device memory;
    and the binner's CUDA-event time on the cold run's first chunk under
    each backend."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch.sketch import device as sk_device
    pids, keys, values, raw, distinct = columns
    sketch = hh_sketch(pdt, False)
    captured = []
    real_chunk = sk_device.sketch_chunk

    def capture(buckets, width, backend):
        if not captured:
            captured.append(buckets.clone())
        return real_chunk(buckets, width, backend)

    runs = []
    for i, seed in enumerate((HH_SEEDS[0],) + HH_SEEDS):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_launches()
        sk_device.sketch_chunk = capture if i == 0 else real_chunk
        try:
            rows, res, wall = _hh_run(pdt, columns, "cuda", seed, sketch)
        finally:
            sk_device.sketch_chunk = real_chunk
        assert res.binner_device.startswith("cuda"), res.binner_device
        launches = _launch_counts()
        assert launches["segment_sum_lanes"] >= 1, "K1 never launched"
        released = np.asarray([tuple(m) for _, m in rows], np.float64)
        assert len(rows) > 0 and released.shape == (len(rows), 2)
        assert np.isfinite(released).all()
        assert set(k for k, _ in rows) <= set(res._candidate_table)
        runs.append(dict(seed=seed, wall_s=wall,
                         rows_per_s=len(keys) / wall,
                         peak_mem_bytes=torch.cuda.max_memory_allocated(),
                         launches=launches, released=len(rows),
                         out={k for k, _ in rows}, **res.timings))
    cold, warm = runs[0], min(runs[1:], key=lambda r: r["wall_s"])
    pair = np.unique(pids.astype(np.int64) * distinct + raw)
    users_per_key = np.bincount((pair % distinct).astype(np.int64),
                                minlength=distinct)
    top50 = np.argsort(-users_per_key, kind="stable")[:50]
    top50_keys = {f"url/{k}" for k in top50.tolist()}
    recall = sum(1 for k in top50_keys if k in warm["out"]) / 50
    chunk = captured[0]
    width = sketch.resolved_width()
    binner_ms = {b: cuda_ms(lambda b=b: sk_device.sketch_chunk(chunk, width,
                                                               b), reps=11)
                 for b in ("matmul", "xla")}
    for r in runs:
        r.pop("out")
    log("hh_full", rows=len(keys), distinct_keys=int(len(np.unique(raw))),
        users=int(pids.max()) + 1, width=width,
        depth=sketch.resolved_depth(),
        candidate_cap=sketch.resolved_candidate_cap(),
        backend=sketch.resolved_backend(), top50_recall=recall,
        cold=cold, warm=warm, warm_runs=runs[1:],
        binner_chunk_rows=int(chunk.shape[1]), binner_ms=binner_ms)
    return warm


def phase_hh_fluent():
    """26d. The fluent API on the card: ``make_private(rows, TorchBackend(),
    ...)`` ``.count`` and ``.sum`` on a few thousand rows give the same
    bits as on ``TorchBackend("cpu")``, and launch K1."""
    import operator
    import pipelinedp_tpu_torch as pdt
    pids, keys, values = hh_columns(4_000)[:3]
    rows = list(zip(pids.tolist(), keys.tolist(), values.tolist()))
    out = {}
    for device in ("cuda", "cpu"):
        acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0,
                                        total_delta=1e-6)
        pcol = pdt.make_private(rows, pdt.TorchBackend(device=device,
                                                       rng_seed=41),
                                acc, operator.itemgetter(0))
        common = dict(max_partitions_contributed=4,
                      max_contributions_per_partition=2,
                      partition_extractor=operator.itemgetter(1))
        counts = pcol.count(pdt.CountParams(**common))
        sums = pcol.sum(pdt.SumParams(
            min_value=0.0, max_value=10.0,
            value_extractor=operator.itemgetter(2), **common))
        acc.compute_budgets()
        _reset_launches()
        got = (sorted(counts), sorted(sums))
        out[device] = (got, _launch_counts())
    (gpu, launches), (cpu, _) = out["cuda"], out["cpu"]
    assert launches["segment_sum_lanes"] >= 2, launches
    for g, c, what in ((gpu[0], cpu[0], "count"), (gpu[1], cpu[1], "sum")):
        assert g and [k for k, _ in g] == [k for k, _ in c], what
        assert (np.asarray([v for _, v in g], np.float64).tobytes() ==
                np.asarray([v for _, v in c], np.float64).tobytes()), what
    log("hh_fluent", rows=len(rows), count_kept=len(gpu[0]),
        sum_kept=len(gpu[1]), identical=True, launches=launches)


PLD_SMOKE = dict(rows=250_000, users=10_000, partitions=4096, seed=37)
SPREAD = 2**33  # wide int64 keys: k * SPREAD + 7, too wide for a table
NATIVE_SAMPLERS = ("discrete_laplace", "discrete_gaussian",
                   "snapping_laplace", "secure_gaussian")


def _pld_run(pdt, columns, params_kw, device, seed, public=None):
    """One aggregation under ``PLDBudgetAccountant(1, 1e-6)``: the rows,
    the accountant, and the timings with ``compute_budgets`` on its own
    (host seconds) and the aggregation's wall without it."""
    acc = pdt.PLDBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(device=device,
                                                rng_seed=seed))
    if device == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = engine.aggregate(pdt.ArrayDataset(*columns),
                              pdt.AggregateParams(**params_kw),
                              pdt.DataExtractors(), public_partitions=public)
    t1 = time.perf_counter()
    acc.compute_budgets()
    t2 = time.perf_counter()
    rows = list(result)
    if device == "cuda":
        torch.cuda.synchronize()
    t3 = time.perf_counter()
    wall_s = (t1 - t0) + (t3 - t2)
    return rows, acc, dict(result.timings, compute_budgets_s=t2 - t1,
                           wall_s=wall_s, rows_per_s=len(columns[1]) / wall_s)


def _naive_noise_stds(pdt, columns, params_kw, acc_pld, public=None):
    """Each mechanism of the PLD run beside the noise std the naive
    accountant grants the same metrics (the lazy result is never run)."""
    acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0, total_delta=1e-6)
    pdt.DPEngine(acc, pdt.TorchBackend("cpu")).aggregate(
        pdt.ArrayDataset(*columns), pdt.AggregateParams(**params_kw),
        pdt.DataExtractors(), public_partitions=public)
    acc.compute_budgets()
    out = []
    for m_pld, m_naive in zip(acc_pld._mechanisms, acc._mechanisms):
        spec = m_pld.mechanism_spec
        assert spec.metric == m_naive.mechanism_spec.metric
        out.append(dict(metric=spec.metric, type=spec.mechanism_type.name,
                        internal_splits=m_pld.internal_splits,
                        pld_std=acc_pld._spec_noise_std(m_pld),
                        naive_std=acc._spec_noise_std(m_naive)))
    return out


class _NativeLog:
    """Counts the port's native calls by sampler while it is entered (the
    engine looks the samplers up on the module at each call)."""

    def __init__(self):
        from pipelinedp_tpu_torch import native
        self._native = native
        self.calls = []

    def __enter__(self):
        self._saved = {n: getattr(self._native, n) for n in NATIVE_SAMPLERS}
        for name, fn in self._saved.items():
            setattr(self._native, name, self._wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(self._native, name, fn)

    def _wrap(self, name, fn):
        def logged(values, scale, **kw):
            self.calls.append((name, int(np.size(values))))
            return fn(values, scale, **kw)
        return logged

    def count(self, *names):
        return sum(1 for n, _ in self.calls if n in names)


def _secure_run(pdt, columns, params_kw, device, host_seed, public=None):
    """One hardened aggregation: ``seed_host_rng(host_seed)`` under
    ``set_secure_host_noise(True)``, no ``rng_seed``; the rows, the wall,
    the engine's timings and the native calls by sampler."""
    from pipelinedp_tpu_torch.ops import noise
    noise.seed_host_rng(host_seed)
    with _NativeLog() as calls:
        rows, timings = _aggregate(pdt, columns, params_kw, device, None,
                                   public)
        if device == "cuda":
            torch.cuda.synchronize()
    return rows, timings, calls


def _secure_pair(pdt, columns, params_kw, host_seed, what, integer=True,
                 public=None):
    """The hardened release on the card and on the CPU from one host seed:
    the same kept keys and float64 bits, the same native calls in the
    same order, the integer sampler reached iff ``integer`` and the float
    sampler always (where the JAX package reaches them). Returns the
    card's launches and call counts."""
    _reset_launches()
    gpu_rows, gpu_t, gpu_calls = _secure_run(pdt, columns, params_kw,
                                             "cuda", host_seed, public)
    launches = _launch_counts()
    cpu_rows, _, cpu_calls = _secure_run(pdt, columns, params_kw, "cpu",
                                         host_seed, public)
    assert _launch_counts() == launches, f"{what}: the CPU run launched"
    assert launches["segment_sum_lanes"] >= 1, f"{what}: K1 never launched"
    _released_identical(gpu_rows, cpu_rows, what)
    assert gpu_calls.calls == cpu_calls.calls, (
        f"{what}: the native calls differ between the card and the CPU")
    n_int = gpu_calls.count("discrete_laplace", "discrete_gaussian")
    n_float = gpu_calls.count("snapping_laplace", "secure_gaussian")
    assert (n_int > 0) == integer, f"{what}: integer sampler calls {n_int}"
    assert n_float > 0, f"{what}: the float sampler was never called"
    return dict(kept=len(gpu_rows), launches=launches,
                native_integer_calls=n_int, native_float_calls=n_float,
                host_decode_s=gpu_t["host_decode_s"])


def phase_pld_secure(smi):
    """PLD budget accounting, the hardened native noise and the native
    integer factorizer on the fused path (phase 27 of the module
    docstring)."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import native
    from pipelinedp_tpu_torch.ops import noise
    t0 = time.perf_counter()
    assert native.available(), "the native noise library did not build"
    assert native.encode_available(), "the native factorizer did not build"
    build_s = time.perf_counter() - t0
    smoke = zipf_columns(PLD_SMOKE["rows"], PLD_SMOKE["users"],
                         PLD_SMOKE["partitions"], PLD_SMOKE["seed"])
    gaussian = dict(flagship_params(pdt), noise_kind=pdt.NoiseKind.GAUSSIAN)
    pld_cases = {"flagship_laplace": flagship_params(pdt),
                 "flagship_gaussian": gaussian,
                 "per_partition_sum": sum_bounds_params(pdt)}

    # (a) PLD on the fused path: card = CPU at the smoke size.
    pld_smoke = {}
    for name, params in pld_cases.items():
        _reset_launches()
        gpu_rows, gpu_acc, gpu_t = _pld_run(pdt, smoke, params, "cuda", 41)
        launches = _launch_counts()
        cpu_rows, cpu_acc, _ = _pld_run(pdt, smoke, params, "cpu", 41)
        _released_identical(gpu_rows, cpu_rows, f"pld {name}")
        assert (np.float64(gpu_acc.minimum_noise_std).tobytes() ==
                np.float64(cpu_acc.minimum_noise_std).tobytes())
        assert launches["segment_sum_lanes"] >= 1, f"pld {name}: no K1"
        if name == "per_partition_sum":
            assert launches["segment_totals"] >= 1, f"pld {name}: no K4"
        pld_smoke[name] = dict(kept=len(gpu_rows), launches=launches,
                               minimum_noise_std=gpu_acc.minimum_noise_std,
                               compute_budgets_s=gpu_t["compute_budgets_s"])
    log("pld_smoke", nvidia_smi=smi, data=PLD_SMOKE, identical=True,
        native_build_s=build_s, **pld_smoke)

    # (b) the hardened release: card = CPU at the smoke size.
    scalar5 = [pdt.Metrics.COUNT, pdt.Metrics.PRIVACY_ID_COUNT,
               pdt.Metrics.SUM, pdt.Metrics.MEAN, pdt.Metrics.VARIANCE]
    noise.set_secure_host_noise(True)
    try:
        secure_smoke = {}
        for kind in ("LAPLACE", "GAUSSIAN"):
            params = dict(flagship_params(pdt), metrics=scalar5,
                          noise_kind=pdt.NoiseKind[kind])
            secure_smoke[f"scalar5_{kind.lower()}"] = _secure_pair(
                pdt, smoke, params, 43, f"secure scalar5 {kind}")
        os.environ["PIPELINEDP_TPU_VECTOR_ACCUMULATOR"] = "fx"
        try:
            n, d = 200_000, 64
            rng = np.random.default_rng(47)
            vec = (rng.integers(0, n // 8, n),
                   (rng.zipf(1.3, n) % VECTOR_PARTITIONS).astype(np.int32),
                   rng.uniform(-1.0, 1.0, (n, d)).astype(np.float32))
            for kind in ("LAPLACE", "GAUSSIAN"):
                rec = _secure_pair(pdt, vec, vector_params(pdt, d, kind), 53,
                                   f"secure vector_sum {kind}",
                                   integer=False)
                assert rec["launches"]["segment_sum_wide"] >= 1, "no K2"
                secure_smoke[f"vector_sum_d64_{kind.lower()}"] = rec
        finally:
            os.environ.pop("PIPELINEDP_TPU_VECTOR_ACCUMULATOR")
    finally:
        noise.set_secure_host_noise(False)
    log("secure_smoke", nvidia_smi=smi, data=PLD_SMOKE, identical=True,
        **secure_smoke)
    del smoke, vec

    # At full size: the flagship's data once more.
    columns = zipf_columns(FLAGSHIP["rows"], FLAGSHIP["users"],
                           FLAGSHIP["partitions"], FLAGSHIP["seed"])
    pld_full = {}
    for name, params in pld_cases.items():
        _reset_launches()
        rows, acc, timings = _pld_run(pdt, columns, params, "cuda",
                                      FLAGSHIP["seed"])
        launches = _launch_counts()
        released = np.asarray([tuple(m) for _, m in rows], np.float64)
        assert len(rows) > 0 and np.isfinite(released).all(), name
        assert launches["segment_sum_lanes"] >= 1, f"pld {name}: no K1"
        if name == "per_partition_sum":
            assert launches["segment_totals"] >= 1, f"pld {name}: no K4"
        pld_full[name] = dict(
            kept=len(rows), launches=launches,
            minimum_noise_std=acc.minimum_noise_std,
            noise_stds=_naive_noise_stds(pdt, columns, params, acc),
            **timings)
    log("pld_full", nvidia_smi=smi, data=FLAGSHIP, **pld_full)

    # The flagship with numpy noise (phase 4's seed) and hardened, in
    # turns: plain, secure, secure, plain.
    runs = []
    for secure in (False, True, True, False):
        noise.set_secure_host_noise(secure)
        t0 = time.perf_counter()
        try:
            if secure:
                rows, t, calls = _secure_run(pdt, columns,
                                             flagship_params(pdt), "cuda", 59)
                assert calls.count("discrete_laplace") > 0
                assert calls.count("snapping_laplace") > 0
            else:
                rows, t = _aggregate(pdt, columns, flagship_params(pdt),
                                     "cuda", FLAGSHIP["seed"])
                plain_rows = rows
        finally:
            noise.set_secure_host_noise(False)
        wall_s = time.perf_counter() - t0
        runs.append(dict(secure=secure, kept=len(rows), wall_s=wall_s,
                         rows_per_s=FLAGSHIP["rows"] / wall_s, **t))
    assert len(plain_rows) > 0

    # (c) the native factorizer in encode: the flagship's keys and users
    # spread into wide int64, so both take ``factorize_i64``.
    spread = (columns[0] * SPREAD + 7, columns[1] * SPREAD + 7, columns[2])
    calls = []
    real = native.factorize_i64

    def counting(arr):
        calls.append(len(arr))
        return real(arr)

    native.factorize_i64 = counting
    try:
        spread_rows, spread_t = _aggregate(pdt, spread, flagship_params(pdt),
                                           "cuda", FLAGSHIP["seed"])
    finally:
        native.factorize_i64 = real
    assert calls == [FLAGSHIP["rows"]] * 2, f"factorize_i64 calls {calls}"
    assert [(k - 7) // SPREAD for k, _ in spread_rows] == [
        k for k, _ in plain_rows], "spread keys released another key set"
    assert (np.asarray([tuple(m) for _, m in spread_rows], np.float64)
            .tobytes() == np.asarray([tuple(m) for _, m in plain_rows],
                                     np.float64).tobytes()), (
        "spread keys released other bytes")
    t0 = time.perf_counter()
    np.unique(spread[1], return_inverse=True)
    np.unique(spread[0], return_inverse=True)
    np_unique_s = time.perf_counter() - t0
    log("secure_full", nvidia_smi=smi, data=FLAGSHIP, runs=runs,
        factorize=dict(identical=True, calls=len(calls),
                       host_encode_s=spread_t["host_encode_s"],
                       plain_host_encode_s=[r["host_encode_s"] for r in runs
                                            if not r["secure"]],
                       np_unique_s=np_unique_s, device_s=spread_t["device_s"],
                       host_decode_s=spread_t["host_decode_s"]))


PLANE_VARS = ("PIPELINEDP_TPU_TRACE", "PIPELINEDP_TPU_AUDIT",
              "PIPELINEDP_TPU_COSTS", "PIPELINEDP_TPU_HEARTBEAT",
              "PIPELINEDP_TPU_LEDGER_DIR", "PIPELINEDP_TPU_PLAN_DIR")


def _planes(on: bool, tmp: str) -> None:
    """Every obs plane on (trace to a Chrome-trace path, audit, costs,
    the heartbeat to a file, a ledger directory) or every plane off."""
    for var in PLANE_VARS:
        os.environ.pop(var, None)
    if on:
        os.environ["PIPELINEDP_TPU_TRACE"] = os.path.join(tmp, "trace.json")
        os.environ["PIPELINEDP_TPU_COSTS"] = "1"
        os.environ["PIPELINEDP_TPU_HEARTBEAT"] = os.path.join(tmp, "hb.json")
        os.environ["PIPELINEDP_TPU_LEDGER_DIR"] = os.path.join(tmp, "ledger")
    else:
        os.environ["PIPELINEDP_TPU_AUDIT"] = "0"


def _flagship_wall(pdt, columns, on, tmp):
    """One flagship aggregation on the card under the planes ``on`` or
    off, from fresh obs state: (rows, timings, wall seconds)."""
    from pipelinedp_tpu_torch import obs
    _planes(on, tmp)
    obs.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows, timings = _aggregate(pdt, columns, flagship_params(pdt), "cuda",
                               FLAGSHIP["seed"])
    wall_s = time.perf_counter() - t0
    return rows, timings, wall_s


def phase_obs_flagship(columns, reference, kernel, smi):
    """Phase 28 (a) and (c): the obs planes on the flagship at full size,
    and their cost on its wall."""
    import tempfile
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import obs
    from pipelinedp_tpu_torch.obs import store as obs_store
    tmp = tempfile.mkdtemp(prefix="pdp_obs_")
    try:
        rows_off, _, wall_off = _flagship_wall(pdt, columns, False, tmp)
        _released_identical(rows_off, reference, "flagship, planes off")
        assert obs.ledger().snapshot()["spans"] == []
        rows_on, timings, wall_on = _flagship_wall(pdt, columns, True, tmp)
        _released_identical(rows_on, reference, "flagship, planes on")
        snap = obs.ledger().snapshot()
        totals = {}
        for sp in snap["spans"]:
            totals[sp.name] = totals.get(sp.name, 0.0) + sp.dur
        for field, span in (("host_encode_s", "engine.encode"),
                            ("device_s", "engine.device"),
                            ("host_decode_s", "engine.release")):
            assert abs(timings[field] - totals[span]) < 1e-9, (field, span)
        report = obs.build_run_report(snapshot=snap)
        card = torch.cuda.get_device_name(0)
        assert report["env"]["device_kind"] == card
        assert report["env"]["platform"] == "gpu"
        dc = report["device_costs"]
        assert dc["peaks"]["kind"] == "h100_sxm", dc["peaks"]
        [k1] = [e for e in dc["programs"].values()
                if e["program"] == "segment_sum_lanes"]
        assert k1["timer"] == "cuda_event" and k1["ms"] > 0.0
        assert k1["calls"] == 1 and k1["bytes_accessed"] > 0
        assert k1["verdict"] == "bandwidth_bound", k1
        assert k1["phase"] == "engine", k1
        # One launch, one bound: the table counts the flagship's launch
        # with the work phase 2 bounds the same stack with.
        assert (k1["flops"], k1["bytes_accessed"]) == (
            kernel["nonzero_elements"], kernel["bound_bytes"]), (k1, kernel)
        assert abs(k1["bound_ms"] - kernel["bound_ms"]) <= (
            1e-9 * kernel["bound_ms"]), (k1, kernel)
        assert set(KERNEL_SOURCES) <= set(dc["builds"]), dc["builds"]
        priv = report["privacy"]
        assert priv["enabled"] and priv["accountants"]
        assert priv["aggregations"][0]["method"] == "aggregate"
        assert priv["partition_selection"]["partitions_post"] == len(rows_on)
        assert priv["expected_errors"]
        fp = obs_store.fingerprint_key(report["env"])
        entries = obs_store.LedgerStore(
            os.environ["PIPELINEDP_TPU_LEDGER_DIR"]).entries()
        mine = [e for e in entries if e["fingerprint"] == fp]
        assert len(mine) == 1 and mine[0]["name"] == "engine.aggregate"
        trace_path = obs.write_chrome_trace(snapshot=snap)
        with open(trace_path, encoding="utf-8") as f:
            trace = json.load(f)
        assert any(e.get("name") == "engine.device"
                   for e in trace["traceEvents"])
        obs.monitor.stop()
        with open(os.environ["PIPELINEDP_TPU_HEARTBEAT"],
                  encoding="utf-8") as f:
            heartbeat = json.load(f)
        assert heartbeat["phase"] not in (None, "idle"), heartbeat
        log("obs_flagship", rows=FLAGSHIP["rows"], identical=True,
            wall_off_s=wall_off, wall_on_s=wall_on,
            timings={k: timings[k] for k in ("host_encode_s", "device_s",
                                             "host_decode_s")},
            fingerprint=fp, device_kind=card,
            power_limit=report["env"].get("power_limit"),
            k1_cost_entry=k1, k1_phase2_ms=kernel["ms"],
            k1_phase2_bound_ms=kernel["bound_ms"],
            k1_bound_share=kernel["bound_ms"] / k1["ms"],
            phases=dc["phases"], builds=dc["builds"],
            accountants=len(priv["accountants"]),
            ledger_entries=len(mine), trace_events=len(trace["traceEvents"]),
            heartbeat_phase=heartbeat["phase"])
        # (c) The planes' cost on the flagship's wall: off and on in turns.
        walls = {False: [], True: []}
        for _ in range(3):
            for on in (False, True):
                rows, _, wall = _flagship_wall(pdt, columns, on, tmp)
                _released_identical(rows, reference, f"flagship, on={on}")
                walls[on].append(wall)
                obs.monitor.stop()
        off_s = statistics.median(walls[False])
        on_s = statistics.median(walls[True])
        log("obs_overhead", nvidia_smi=smi, runs=3, walls_off_s=walls[False],
            walls_on_s=walls[True], median_off_s=off_s, median_on_s=on_s,
            difference_s=on_s - off_s,
            difference_frac=(on_s - off_s) / off_s)
    finally:
        obs.monitor.stop()
        _planes(False, tmp)
        os.environ.pop("PIPELINEDP_TPU_AUDIT", None)
        obs.reset()


def phase_obs_plan_config4(columns, reference):
    """Phase 28 (b): config 4 streamed in six batches under a plan file
    that turns the ingest executor off and the pass-B cache to 0."""
    import tempfile
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import obs, plan
    tmp = tempfile.mkdtemp(prefix="pdp_plan_")
    os.environ[CHUNK_ENV] = str(-(-CONFIG4["rows"] // 6))
    os.environ[plan.planner.ENV_DIR] = tmp
    try:
        obs.reset()
        path = plan.write_plan(plan.build_plan(
            {"default": {"knobs": {"ingest_executor": False,
                                   "stream_cache_bytes": 0}}},
            plan.CostModel(), torch.cuda.get_device_name(0),
            created_by="chip_smoke"))
        rows, rec = _run_record(pdt, columns, config4_params(pdt),
                                CONFIG4["seed"])
        _released_identical(rows, reference, "config 4 under a plan file")
        applied = {e["knob"]: e for e in obs.ledger().snapshot()["events"]
                   if e["name"] == "plan.applied"}
        for knob, value in (("ingest_executor", 0),
                            ("stream_cache_bytes", 0)):
            assert applied[knob]["source"] == "plan", applied[knob]
            assert applied[knob]["value"] == value, applied[knob]
        assert rec["stream_batches"] == 6
        assert rec["stream_executor"] == "serial"
        assert rec["stream_pass_b"] == "reship"
        log("obs_plan_config4", data=CONFIG4, plan_file=path,
            identical=True,
            applied={k: applied[k] for k in ("ingest_executor",
                                             "stream_cache_bytes")},
            **rec)
    finally:
        os.environ.pop(CHUNK_ENV, None)
        os.environ.pop(plan.planner.ENV_DIR, None)
        obs.reset()


SERVE_ROWS = 500_000
SERVE_FUSED_ROWS = 20_000
SERVE_PARTS = 2_000
SERVE_SEQ, SERVE_CONC, SERVE_FUSED_CONC, SERVE_ROUNDS = 12, 16, 8, 3


def serve_columns(n_rows, seed=23):
    """The columns of the JAX bench's serve records: pids in
    ``[0, max(rows / 8, 1000))``, keys ``zipf(1.3) % 2000``, values in
    [0, 10), from one numpy generator in that order."""
    rng = np.random.default_rng(seed)
    pids = rng.integers(0, max(n_rows // 8, 1_000), n_rows)
    keys = (rng.zipf(1.3, n_rows) % SERVE_PARTS).astype(np.int64)
    values = rng.uniform(0.0, 10.0, n_rows)
    return pids, keys, values


def serve_params(pdt):
    return pdt.AggregateParams(
        metrics=[pdt.Metrics.COUNT, pdt.Metrics.SUM, pdt.Metrics.MEAN],
        noise_kind=pdt.NoiseKind.LAPLACE, max_partitions_contributed=4,
        max_contributions_per_partition=2, min_value=0.0, max_value=10.0)


SERVE_TENANTS = {f"bench-t{i}": (1e6, 1e-3) for i in range(3)}


def _serve_request(pdt, columns, i, seed):
    """Request ``i``: a fresh ``ArrayDataset`` over the shared columns
    (its own encode cache, as distinct traffic has), tenant ``i % 3``."""
    from pipelinedp_tpu_torch import serve
    return serve.ServeRequest(
        tenant=f"bench-t{i % 3}", params=serve_params(pdt),
        dataset=pdt.ArrayDataset(*columns), epsilon=0.5, delta=1e-8,
        rng_seed=seed)


def _direct(pdt, columns, seed, device):
    """The same request through ``DPEngine`` (PARITY row 34)."""
    acc = pdt.NaiveBudgetAccountant(total_epsilon=0.5, total_delta=1e-8)
    engine = pdt.DPEngine(acc, pdt.TorchBackend(device, rng_seed=seed))
    result = engine.aggregate(pdt.ArrayDataset(*columns), serve_params(pdt),
                              pdt.DataExtractors())
    acc.compute_budgets()
    return list(result)


def _timed_submit(svc, request):
    t0 = time.perf_counter()
    out = svc.submit(request)
    wall = time.perf_counter() - t0
    assert out.ok, f"serve refused: {out}"
    return wall, out


def _burst(svc, requests):
    """Submits ``requests`` from one thread each; returns (wall seconds,
    per-request walls, responses)."""
    import threading
    walls = [None] * len(requests)
    outs = [None] * len(requests)
    errors = []

    def one(i):
        try:
            walls[i], outs[i] = _timed_submit(svc, requests[i])
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i,))
               for i in range(len(requests))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if errors:
        raise errors[0]
    return wall, walls, outs


def _serve_counters():
    from pipelinedp_tpu_torch import obs
    return {k: v for k, v in obs.ledger().snapshot()["counters"].items()
            if k.startswith("serve.")}


def _counter_delta(before, after, name):
    return int(after.get(name, 0)) - int(before.get(name, 0))


def phase_serve_latency(pdt, tmp):
    """Phase 29 (a): ``serve_request_latency``, fusion off."""
    from pipelinedp_tpu_torch import serve
    from pipelinedp_tpu_torch.ops.kernels import segsum
    columns = serve_columns(SERVE_ROWS)
    names = sorted(SERVE_TENANTS)
    seeds = [0] + list(range(1, SERVE_SEQ + 1)) + list(
        range(100, 100 + SERVE_CONC))
    outs = {}
    _reset_launches()
    with serve.Service(os.path.join(tmp, "latency"), tenants=SERVE_TENANTS,
                       max_queue=2 * SERVE_CONC,
                       max_inflight_per_tenant=SERVE_CONC, workers=4,
                       fusion=False) as svc:
        cold_s, outs[0] = _timed_submit(
            svc, _serve_request(pdt, columns, 0, 0))
        warm = []
        t0 = time.perf_counter()
        for i in range(1, SERVE_SEQ + 1):
            wall, outs[i] = _timed_submit(
                svc, _serve_request(pdt, columns, i, i))
            warm.append(wall)
        seq_s = time.perf_counter() - t0
        conc_s, conc_walls, conc_outs = _burst(svc, [
            _serve_request(pdt, columns, i, 100 + i)
            for i in range(SERVE_CONC)])
        for i, out in enumerate(conc_outs):
            outs[100 + i] = out
    launches = segsum.LAUNCHES["segment_sum_lanes"]
    assert launches == 1 + SERVE_SEQ + SERVE_CONC, launches
    warm.sort()
    # PARITY row 34: each served release is the direct engine's, bytes.
    for seed in seeds:
        want = _direct(pdt, columns, seed, "cuda")
        got = outs[seed].results
        assert len(want) > 0, "the serve workload kept no partition"
        _released_identical(got, want, f"serve vs direct, seed {seed}")
    counters = _serve_counters()
    rec = dict(rows_per_request=SERVE_ROWS, partitions=SERVE_PARTS,
               tenants=len(names), sequential_requests=SERVE_SEQ,
               concurrent_requests=SERVE_CONC, cold_s=cold_s,
               warm_p50_s=warm[len(warm) // 2],
               warm_p99_s=warm[min(len(warm) - 1, int(len(warm) * 0.99))],
               sequential_req_per_s=SERVE_SEQ / seq_s,
               concurrent_req_per_s=SERVE_CONC / conc_s,
               concurrent_p50_s=sorted(conc_walls)[SERVE_CONC // 2],
               kept=len(outs[0].results), k1_launches=launches,
               identical_to_direct=len(seeds),
               warm_hits=counters.get("serve.warm_hits", 0),
               cold_builds=counters.get("serve.cold_builds", 0))
    log("serve_latency", **rec)
    return rec


def phase_serve_fused(pdt, tmp):
    """Phase 29 (b): ``serve_fused_throughput``, solo then fused."""
    from pipelinedp_tpu_torch import obs, serve
    from pipelinedp_tpu_torch.ops.kernels import segsum
    columns = serve_columns(SERVE_FUSED_ROWS)
    n = SERVE_FUSED_CONC
    results = {}
    for fusion in (False, True):
        obs.reset()
        before = _serve_counters()
        _reset_launches()
        with serve.Service(os.path.join(tmp, f"fused-{fusion}"),
                           tenants=SERVE_TENANTS, max_queue=2 * n,
                           max_inflight_per_tenant=n, workers=4,
                           fusion=fusion, fuse_window_ms=250,
                           fuse_max_batch=n) as svc:
            _, _, warm_outs = _burst(svc, [
                _serve_request(pdt, columns, i, 1_000 + i)
                for i in range(n)])
            best = None
            for r in range(SERVE_ROUNDS):
                wall, _, _ = _burst(svc, [
                    _serve_request(pdt, columns, i, 1_100 + 100 * r + i)
                    for i in range(n)])
                best = wall if best is None else min(best, wall)
        after = _serve_counters()
        launches = segsum.LAUNCHES["segment_sum_lanes"]
        served = _counter_delta(before, after, "serve.requests_served")
        batches = _counter_delta(before, after, "serve.fused_batches")
        fused_requests = _counter_delta(before, after,
                                        "serve.fused_requests")
        fallbacks = _counter_delta(before, after, "serve.fusion_fallbacks")
        assert served == n * (1 + SERVE_ROUNDS), served
        assert fallbacks == 0, fallbacks
        # One K1 launch per request served solo (fusion off, or a window
        # of one); what is left was launched by the fused batches.
        solo_served = served - fused_requests
        per_batch = None
        if batches:
            per_batch = (launches - solo_served) / batches
            assert per_batch == 1, (launches, batches, served,
                                    fused_requests)
        else:
            assert launches == solo_served, (launches, served)
        results[fusion] = dict(req_per_s=n / best, k1_launches=launches,
                               k1_per_fused_batch=per_batch,
                               fused_batches=batches,
                               fused_requests=fused_requests,
                               outs=[o.results for o in warm_outs])
    assert results[True]["fused_batches"] >= 1, "the bursts never fused"
    for i in range(n):
        seed = 1_000 + i
        solo, fused = results[False]["outs"][i], results[True]["outs"][i]
        assert len(solo) > 0
        _released_identical(fused, solo, f"fused vs solo, seed {seed}")
        _released_identical(fused, _direct(pdt, columns, seed, "cpu"),
                            f"fused on the card vs CPU, seed {seed}")
    fused = results[True]
    rec = dict(rows_per_request=SERVE_FUSED_ROWS, concurrent_requests=n,
               rounds=SERVE_ROUNDS,
               fused_req_per_s=fused["req_per_s"],
               solo_req_per_s=results[False]["req_per_s"],
               speedup_vs_solo=(fused["req_per_s"] /
                                results[False]["req_per_s"]),
               fused_batches=fused["fused_batches"],
               fused_requests=fused["fused_requests"],
               k1_launches_fused=fused["k1_launches"],
               k1_launches_solo=results[False]["k1_launches"],
               k1_per_fused_batch=fused["k1_per_fused_batch"],
               parity_ok=True, gpu_equals_cpu=True)
    log("serve_fused", **rec)
    return rec


def phase_serve_burst(pdt, tmp):
    """Phase 29 (c): one fused burst of 8 requests x 500,000 rows, and
    its one K1 launch's stack timed."""
    from pipelinedp_tpu_torch import obs, serve
    from pipelinedp_tpu_torch.ops.kernels import segsum
    columns = serve_columns(SERVE_ROWS)
    n = SERVE_FUSED_CONC
    calls = []
    real = segsum.segment_sum_lanes

    def capture(cols, pk, P):
        calls.append((cols, pk, P))
        return real(cols, pk, P)

    obs.reset()
    _reset_launches()
    segsum.segment_sum_lanes = capture
    try:
        with serve.Service(os.path.join(tmp, "burst"),
                           tenants=SERVE_TENANTS, max_queue=2 * n,
                           max_inflight_per_tenant=n, workers=4,
                           fusion=True, fuse_window_ms=2_000,
                           fuse_max_batch=n) as svc:
            wall, _, outs = _burst(svc, [
                _serve_request(pdt, columns, i, 2_000 + i)
                for i in range(n)])
    finally:
        segsum.segment_sum_lanes = real
    counters = _serve_counters()
    launches = segsum.LAUNCHES["segment_sum_lanes"]
    assert counters.get("serve.fused_batches") == 1, counters
    assert counters.get("serve.fused_requests") == n, counters
    assert launches == 1 and len(calls) == 1, (launches, len(calls))
    cols, pk, P = calls[0]
    assert cols.shape[0] == n * SERVE_ROWS, cols.shape
    got = real(cols, pk, P)
    want = segsum.segment_sum_lanes_plain(cols, pk, P)
    torch.cuda.synchronize()
    max_abs_err = int((got.long() - want.long()).abs().max())
    assert max_abs_err == 0, f"fused stack mismatch: {max_abs_err}"
    timings = time_kernel(cols, pk, P)
    rec = dict(requests=n, rows_per_request=SERVE_ROWS,
               stack=[int(P), int(cols.shape[1]), int(cols.shape[0])],
               wall_s=wall,
               req_per_s=n / wall, k1_launches=launches,
               kept=[len(o.results) for o in outs],
               max_abs_err=max_abs_err, **timings)
    log("serve_burst", **rec)
    return rec


def phase_serve(smi):
    """Phase 29: the resident service on the card."""
    import shutil
    import tempfile
    import pipelinedp_tpu_torch as pdt
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        latency = phase_serve_latency(pdt, tmp)
        fused = phase_serve_fused(pdt, tmp)
        burst = phase_serve_burst(pdt, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("serve", card=smi, latency_concurrent_req_per_s=latency[
        "concurrent_req_per_s"], fused_req_per_s=fused["fused_req_per_s"],
        solo_req_per_s=fused["solo_req_per_s"],
        burst_k1_ms=burst["ms"], burst_k1_bound_ms=burst["bound_ms"])
    return fused, burst


# ---------------------------------------------------------------------------
# Phase 30: the mesh (``parallel/``) on the card
# ---------------------------------------------------------------------------

MESH_RANKS = 4
# The smoke shapes of phase 30 (a): 200,000 rows of each generator, the
# partitions scaled with the rows (the flagship's 424 rows per partition,
# config 4's 100, config 5's 500) and the users too (config 4's 50 rows
# per user, config 5's 25), but for the flagship's: 154 rows per user
# would leave about ten users per partition, too few for selection to
# keep a partition, so it has 10 rows per user.
MESH_SMOKE_ROWS = 200_000
MESH_SHAPES = {
    "flagship": dict(rows=MESH_SMOKE_ROWS, users=20_000, partitions=472,
                     seed=6),
    "config4": dict(rows=MESH_SMOKE_ROWS, users=4_000, partitions=2_000,
                    seed=4),
    "config5": dict(rows=MESH_SMOKE_ROWS, users=8_000, partitions=400,
                    seed=1),
}
MESH_SWEEP_CONFIGS = 1_024
# Rows per rank per batch of the streamed case: four batches of 200,000.
MESH_STREAM_CHUNK = 16_000
MESH_HIER_ENV = {"PIPELINEDP_TPU_MESH_TOPOLOGY": "hier",
                 "PIPELINEDP_TPU_MESH_HOSTS": "2"}
# A rank's cache of generated columns: a pool's ranks live for the whole
# phase, and the 25M-row flagship takes seconds to draw.
_RANK_COLUMNS = {}


def _rank_columns(name):
    if name not in _RANK_COLUMNS:
        if name == "flagship_full":
            _RANK_COLUMNS[name] = zipf_columns(
                FLAGSHIP["rows"], FLAGSHIP["users"], FLAGSHIP["partitions"],
                FLAGSHIP["seed"])
        elif name == "vector":
            rng = np.random.default_rng(29)
            n = MESH_SMOKE_ROWS
            _RANK_COLUMNS[name] = (
                rng.integers(0, n // 8, n),
                (rng.zipf(1.3, n) % VECTOR_PARTITIONS).astype(np.int32),
                rng.uniform(-1.0, 1.0, (n, 64)).astype(np.float32))
        elif name == "heavy_hitters":
            _RANK_COLUMNS[name] = hh_columns(HH_SMOKE_ROWS)[:3]
        else:
            s = MESH_SHAPES[name]
            _RANK_COLUMNS[name] = zipf_columns(s["rows"], s["users"],
                                               s["partitions"], s["seed"])
    return _RANK_COLUMNS[name]


def _release_digest(rows):
    """sha256 of the kept keys and of every released value's float64 bits
    (vectors included), and the kept count."""
    import hashlib
    h = hashlib.sha256()
    for key, metrics in rows:
        h.update(repr(key).encode())
        for field in metrics._fields:
            h.update(field.encode())
            h.update(np.asarray(getattr(metrics, field),
                                np.float64).tobytes())
    return h.hexdigest(), len(rows)


def _nonbinding_caps(columns):
    """(L0, Linf) at the data's own maxima: the most partitions one user
    contributes to and the most rows of one (user, partition) pair."""
    pids, pks, _ = columns
    pairs, per_pair = np.unique(pids.astype(np.int64) * (1 << 32) + pks,
                                return_counts=True)
    per_user = np.unique(pairs >> 32, return_counts=True)[1]
    return int(per_user.max()), int(per_pair.max())


def mesh_rank_case(case, device, caps=None, time_k1=False):
    """On every rank of a phase-30 pool: one workload on this rank's mesh
    on ``device`` (``mesh=False``: on one device, no mesh), with every
    kernel count zeroed just before the run and read just after. Returns
    the release digest, the launches, the wall, the peak device memory,
    the comms counters and, with ``time_k1``, the CUDA-event ms of this
    rank's first K1 launch (the partials) re-run on its own stack."""
    import pipelinedp_tpu_torch as pdt
    from pipelinedp_tpu_torch import analysis as tan
    from pipelinedp_tpu_torch import obs
    from pipelinedp_tpu_torch.ops.kernels import segsum
    from pipelinedp_tpu_torch.parallel import make_mesh
    mesh = make_mesh(device=device) if case != "single" else None
    on_card = torch.device(device).type == "cuda"
    seed = 61
    calls = []
    real_k1 = segsum.segment_sum_lanes
    if time_k1:
        def capture(cols, pk, P):
            if not calls:
                calls.append((cols, pk, P))
            return real_k1(cols, pk, P)
        segsum.segment_sum_lanes = capture
    obs.reset()
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    t0 = time.perf_counter()
    try:
        if case in ("flagship_full", "single"):
            columns = _rank_columns("flagship_full")
            params = flagship_params(pdt)
            if caps is not None:
                params.update(max_partitions_contributed=caps[0],
                              max_contributions_per_partition=caps[1])
            rows, _ = _aggregate(pdt, columns, params, device, seed,
                                 mesh=mesh)
        elif case == "sweep":
            n_cfg, options = sweep_options(tan, pdt, MESH_SWEEP_CONFIGS)
            assert n_cfg == MESH_SWEEP_CONFIGS, n_cfg
            _, result, _, _ = run_sweep(
                _rank_columns("config5"), options, device,
                backend=pdt.TorchBackend(device=device, mesh=mesh))
            import hashlib
            rows = None
            digest = (hashlib.sha256(sweep_bits(result).tobytes())
                      .hexdigest(), len(result))
        elif case == "heavy_hitters":
            pids, keys, values = _rank_columns("heavy_hitters")
            acc = pdt.NaiveBudgetAccountant(total_epsilon=1.0,
                                            total_delta=1e-6)
            engine = pdt.DPEngine(acc, pdt.TorchBackend(
                device=device, rng_seed=seed, mesh=mesh))
            result = engine.aggregate(
                pdt.ArrayDataset(privacy_ids=pids, partition_keys=keys,
                                 values=values),
                pdt.AggregateParams(**hh_params(pdt)), pdt.DataExtractors(),
                sketch_first=hh_sketch(pdt, smoke=True))
            acc.compute_budgets()
            rows = list(result)
        else:
            data, params = {
                "flagship": ("flagship", flagship_params(pdt)),
                "config4": ("config4", config4_params(pdt)),
                "stream": ("config4", config4_params(pdt)),
                "vector": ("vector", vector_params(pdt, 64)),
                "sum_bounds": ("flagship", sum_bounds_params(pdt)),
            }[case]
            rows, timings = _aggregate(pdt, _rank_columns(data), params,
                                       device, seed, mesh=mesh)
            if case == "stream":
                assert timings["stream_batches"] >= 3, timings
        if on_card:
            torch.cuda.synchronize()
    finally:
        segsum.segment_sum_lanes = real_k1
    wall_s = time.perf_counter() - t0
    launches = _launch_counts()
    if rows is not None:
        digest = _release_digest(rows)
    rec = dict(digest=digest[0], kept=digest[1], launches=launches,
               wall_s=wall_s, index=mesh.index if mesh else 0,
               comms={k: v for k, v in
                      obs.ledger().snapshot()["counters"].items()
                      if k.startswith("comms.")})
    if on_card:
        rec["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    if time_k1 and calls:
        cols, pk, P = calls[0]
        rec["k1_stack"] = [int(P), int(cols.shape[1]), int(cols.shape[0])]
        rec["k1_ms"] = cuda_ms(lambda: real_k1(cols, pk, P), reps=11)
    return rec


def mesh_rank_caps():
    """On a rank: the flagship's non-binding caps."""
    return _nonbinding_caps(_rank_columns("flagship_full"))


# Phase 30 (a)'s workloads and the kernel each must launch on every rank
# of the card's mesh.
MESH_CASES = {
    "flagship": ("segment_sum_lanes",),
    "config4": ("segment_sum_lanes",),
    "vector": ("segment_sum_wide",),
    "sum_bounds": ("segment_totals", "segment_sum_lanes"),
    "stream": ("subtree_counts_multi", "segment_sum_lanes"),
    "sweep": ("segmented_sums", "segment_totals"),
    "heavy_hitters": ("segment_sum_lanes",),
}


def _same_on_every_rank(outs, what):
    digests = {o["digest"] for o in outs}
    assert len(digests) == 1, f"{what}: the ranks' releases differ"
    return outs[0]


def phase_mesh_smoke(pool):
    """Phase 30 (a): each workload on the 4-rank gloo mesh on the card and
    on the CPU: every rank's release the same, the card's the CPU's, the
    kernels launched on every card rank and on no CPU rank; the flagship
    and config 4 once more under ``hier`` with two simulated hosts, equal
    to ``flat``."""
    out = {}
    for case, kernels in MESH_CASES.items():
        env = {}
        if case == "vector":
            env["PIPELINEDP_TPU_VECTOR_ACCUMULATOR"] = "fx"
        if case == "stream":
            env[CHUNK_ENV] = str(MESH_STREAM_CHUNK)
        recs = {}
        for device in ("cuda", "cpu"):
            outs = pool.run(mesh_rank_case, case, device, env=env)
            recs[device] = _same_on_every_rank(outs, f"{case} on {device}")
            for o in outs:
                for k in kernels:
                    got = o["launches"][k]
                    assert (got > 0) == (device == "cuda"), (
                        case, device, o["index"], k, got)
            recs[device]["launches_per_rank"] = [o["launches"]
                                                 for o in outs]
            recs[device]["wall_s_per_rank"] = [o["wall_s"] for o in outs]
        assert recs["cuda"]["digest"] == recs["cpu"]["digest"], (
            f"{case}: the card's mesh release differs from the CPU's")
        if case in ("flagship", "config4"):
            hier = _same_on_every_rank(
                pool.run(mesh_rank_case, case, "cuda",
                         env=dict(env, **MESH_HIER_ENV)), f"{case} hier")
            assert hier["digest"] == recs["cuda"]["digest"], (
                f"{case}: hier differs from flat")
            recs["hier_equals_flat"] = True
        out[case] = recs
        first = recs["cuda"]
        log(f"mesh_smoke_{case}", ranks=MESH_RANKS, kept=first["kept"],
            gpu_equals_cpu=True,
            hier_equals_flat=recs.get("hier_equals_flat"),
            launches_per_rank=first["launches_per_rank"],
            wall_s_per_rank=first["wall_s_per_rank"],
            cpu_wall_s_per_rank=recs["cpu"]["wall_s_per_rank"])
    return out


def phase_mesh_full(gloo_pool, smi):
    """Phase 30 (b): the flagship at full width on a one-rank NCCL mesh
    and on the 4-rank gloo mesh sharing the card. With the data's own
    maxima as caps (bounding keeps every row) both releases are the
    single-device card release, bit for bit; with the flagship's caps,
    the wall, each rank's K1 ms and launches, the comms bytes and each
    rank's peak memory."""
    from pipelinedp_tpu_torch.parallel import launch
    caps = gloo_pool.run(mesh_rank_caps)[0]
    rec = dict(card=smi, caps_nonbinding=list(caps),
               note=("four ranks share one card: these times measure no "
                     "multi-GPU speed"))
    with launch.RankPool(1, backend="nccl", deadline_s=600) as nccl:
        single = nccl.run(mesh_rank_case, "single", "cuda", caps)[0]
        one = nccl.run(mesh_rank_case, "flagship_full", "cuda", caps)[0]
        assert one["digest"] == single["digest"], (
            "the one-rank NCCL mesh differs from the single device")
        cold = nccl.run(mesh_rank_case, "flagship_full", "cuda")[0]
        warm = nccl.run(mesh_rank_case, "flagship_full", "cuda",
                        time_k1=True)[0]
    four = _same_on_every_rank(
        gloo_pool.run(mesh_rank_case, "flagship_full", "cuda", caps),
        "flagship nonbinding, gloo")
    assert four["digest"] == single["digest"], (
        "the 4-rank gloo mesh differs from the single device")
    cold4 = gloo_pool.run(mesh_rank_case, "flagship_full", "cuda")
    warm4 = gloo_pool.run(mesh_rank_case, "flagship_full", "cuda",
                          time_k1=True)
    assert len({o["digest"] for o in warm4}) == 1
    rec.update(
        nonbinding_equal_single_device=True, kept_nonbinding=single["kept"],
        nccl_1=dict(wall_s=warm["wall_s"], cold_wall_s=cold["wall_s"],
                    k1_ms=warm.get("k1_ms"), k1_stack=warm.get("k1_stack"),
                    k1_launches=warm["launches"]["segment_sum_lanes"],
                    comms=one["comms"],
                    peak_mem_bytes=warm["peak_mem_bytes"],
                    kept=warm["kept"]),
        gloo_4=dict(wall_s=max(o["wall_s"] for o in warm4),
                    cold_wall_s=max(o["wall_s"] for o in cold4),
                    k1_ms_per_rank=[o.get("k1_ms") for o in warm4],
                    k1_stack_per_rank=[o.get("k1_stack") for o in warm4],
                    k1_launches_per_rank=[
                        o["launches"]["segment_sum_lanes"] for o in warm4],
                    comms=four["comms"],
                    peak_mem_bytes_per_rank=[o["peak_mem_bytes"]
                                             for o in warm4],
                    kept=warm4[0]["kept"]))
    log("mesh_full", **rec)
    return rec


def phase_mesh(smi):
    """Phase 30: the mesh on the card."""
    from pipelinedp_tpu_torch.parallel import launch
    t0 = time.perf_counter()
    with launch.RankPool(MESH_RANKS, deadline_s=900, threads=2) as pool:
        smoke = phase_mesh_smoke(pool)
        full = phase_mesh_full(pool, smi)
    RECORD["mesh_s"] = time.perf_counter() - t0
    return smoke, full


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="add the flagship's stage breakdown")
    parser.add_argument("--out", default=None,
                        help="directory for the phase records")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs an NVIDIA GPU", file=sys.stderr)
        return 1
    import pipelinedp_tpu_torch  # noqa: F401  (fails outside the repo)
    t_start = time.perf_counter()
    smi, max_sm_mhz = phase_card()
    t0 = time.perf_counter()
    columns = zipf_columns(FLAGSHIP["rows"], FLAGSHIP["users"],
                           FLAGSHIP["partitions"], FLAGSHIP["seed"])
    RECORD["flagship_data_gen_s"] = time.perf_counter() - t0
    kernel = phase_kernel(columns)
    phase_gpu_vs_cpu()
    launches, flagship_rows = phase_flagship(columns)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
    if args.profile:
        phase_breakdown(columns, args.out)
    t0 = time.perf_counter()
    phase_obs_flagship(columns, flagship_rows, kernel, smi)
    RECORD["obs_plan_s"] = time.perf_counter() - t0
    del flagship_rows
    k4 = phase_segtotal_kernel(columns, max_sm_mhz)
    phase_sum_bounds_gpu_vs_cpu()
    sum_bounds = phase_sum_bounds_full(columns)
    flag_prefix = tuple(c[:HOST_FLAGSHIP_ROWS].copy() for c in columns)
    del columns
    # VECTOR_SUM under the fixed-point accumulator, set as the JAX bench
    # sets it.
    os.environ["PIPELINEDP_TPU_VECTOR_ACCUMULATOR"] = "fx"
    t0 = time.perf_counter()
    rng = np.random.default_rng(29)
    vector_data = {d: vector_columns(rng, d) for d in VECTOR_WIDTHS}
    RECORD["vector_data_gen_s"] = time.perf_counter() - t0
    wide = phase_wide_kernel(vector_data)
    phase_vector_gpu_vs_cpu()
    vector_launches = phase_vector_full(vector_data)
    phase_vector_streamed(vector_data)
    del vector_data
    os.environ.pop("PIPELINEDP_TPU_VECTOR_ACCUMULATOR")
    t0 = time.perf_counter()
    columns = zipf_columns(CONFIG4["rows"], CONFIG4["users"],
                           CONFIG4["partitions"], CONFIG4["seed"])
    RECORD["config4_data_gen_s"] = time.perf_counter() - t0
    k3 = phase_hist_kernel(columns)
    phase_percentile_gpu_vs_cpu()
    c4_single, c4_streamed, c4_rows = phase_config4(columns)
    if args.profile:
        phase_config4_breakdown(columns, args.out)
    phase_select_streamed(columns)
    phase_pass_b_sources(columns, c4_rows)
    phase_kill_resume(columns, c4_rows)
    t0 = time.perf_counter()
    phase_obs_plan_config4(columns, c4_rows)
    RECORD["obs_plan_s"] += time.perf_counter() - t0
    c4_prefix = tuple(c[:HOST_CONFIG4_ROWS].copy() for c in columns)
    del columns, c4_rows
    phase_streamed_percentile()
    t0 = time.perf_counter()
    columns = stream150_columns()
    RECORD["stream150_data_gen_s"] = time.perf_counter() - t0
    phase_stream150(columns, args.profile, args.out)
    del columns
    t0 = time.perf_counter()
    c5_columns = zipf_columns(CONFIG5["rows"], CONFIG5["users"],
                              CONFIG5["partitions"], CONFIG5["seed"])
    RECORD["config5_data_gen_s"] = time.perf_counter() - t0
    k5 = phase_segkeyed_kernel(c5_columns, max_sm_mhz)
    phase_sweep_gpu_vs_cpu(c5_columns)
    config5 = phase_config5(c5_columns)
    if args.profile:
        phase_config5_breakdown(c5_columns, args.out)
    phase_sweep_kill_resume(c5_columns)
    c5_slice = tuple(c[:HOST_SWEEP_ROWS].copy() for c in c5_columns)
    del c5_columns
    phase_megasweep()
    t0 = time.perf_counter()
    phase_host_routing()
    phase_host_oracle(flag_prefix)
    phase_host_sweep_oracle(c5_slice)
    phase_host_rates(flag_prefix, c4_prefix, c5_slice)
    RECORD["host_path_s"] = time.perf_counter() - t0
    t_hh = time.perf_counter()
    columns = hh_columns(HH_SMOKE_ROWS)
    phase_hh_gpu_vs_cpu(columns)
    phase_hh_parity_dense(columns)
    t0 = time.perf_counter()
    columns = hh_columns(HH_ROWS)
    RECORD["hh_data_gen_s"] = time.perf_counter() - t0
    hh_full = phase_hh_full(columns)
    del columns
    phase_hh_fluent()
    RECORD["heavy_hitters_s"] = time.perf_counter() - t_hh
    t0 = time.perf_counter()
    phase_pld_secure(smi)
    RECORD["pld_secure_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_fused, _ = phase_serve(smi)
    RECORD["serve_s"] = time.perf_counter() - t0
    phase_mesh(smi)
    kernels = [{
        "name": "segment_sum_lanes", "route": "cuda",
        "source": "pipelinedp_tpu_torch/csrc/segsum_lanes.cu",
        "replaces": "pipelinedp_tpu/ops/kernels/segsum.py:76",
        "parity": "bit-equal", "launches": launches,
        "launches_heavy_hitters": hh_full["launches"]["segment_sum_lanes"],
        "launches_serve_fused": serve_fused["k1_launches_fused"],
        "max_abs_err": kernel["max_abs_err"], "ms": kernel["ms"],
        "plain_ms": kernel["plain_ms"], "bound_ms": kernel["bound_ms"],
        "bound_by": kernel["bound_by"], "library_ms": kernel["library_ms"]}, {
        "name": "segment_sum_wide", "route": "cuda",
        "source": "pipelinedp_tpu_torch/csrc/segsum_wide.cu",
        "replaces": "pipelinedp_tpu/ops/kernels/segsum.py:134",
        "parity": "bit-equal",
        "launches": vector_launches["segment_sum_wide"],
        "max_abs_err": wide["max_abs_err"], "ms": wide["ms"],
        "plain_ms": wide["plain_ms"], "bound_ms": wide["bound_ms"],
        "bound_by": wide["bound_by"], "library_ms": wide["library_ms"]}, {
        "name": "subtree_counts_multi", "route": "cuda",
        "source": "pipelinedp_tpu_torch/csrc/hist_bin.cu",
        "replaces": "pipelinedp_tpu/ops/kernels/hist.py:130",
        "parity": "bit-equal",
        "launches": c4_single["launches"]["subtree_counts_multi"],
        "launches_streamed": c4_streamed["launches"][
            "subtree_counts_multi"],
        "max_abs_err": k3["max_abs_err"], "ms": k3["ms"],
        "plain_ms": k3["plain_ms"], "bound_ms": k3["bound_ms"],
        "bound_by": k3["bound_by"], "library_ms": k3["library_ms"]}, {
        # Port-only: it replaces the XLA segment_sum of the per-partition
        # SUM, not a Pallas kernel; its library call is a float32
        # index_add_, whose bits differ.
        "name": "segment_totals", "route": "cuda",
        "source": "pipelinedp_tpu_torch/csrc/segtotal.cu",
        "replaces": "pipelinedp_tpu/jax_engine.py:879",
        "port_only": True, "parity": "bit-equal",
        "launches": sum_bounds["launches"]["segment_totals"],
        "max_abs_err": k4["max_abs_err"], "ms": k4["ms"],
        "plain_ms": k4["plain_ms"], "bound_ms": k4["bound_ms"],
        "bound_by": k4["bound_by"], "library_ms": k4["library_ms"]}, {
        # Port-only: it replaces the XLA segment_sum of the sweep's
        # per-metric stack (jax_sweep.py:517) and selection moments
        # (:656); its library call is a float32 index_add_, whose bits
        # differ. Timed on config 5's count stack.
        "name": "segmented_sums", "route": "cuda",
        "source": "pipelinedp_tpu_torch/csrc/segkeyed.cu",
        "replaces": "pipelinedp_tpu/analysis/jax_sweep.py:517",
        "port_only": True, "parity": "bit-equal",
        "launches": config5["launches"]["segmented_sums"],
        "max_abs_err": k5["max_abs_err"], "ms": k5["ms"],
        "plain_ms": k5["plain_ms"], "bound_ms": k5["bound_ms"],
        "bound_by": k5["bound_by"], "library_ms": k5["library_ms"]}]
    RECORD["kernels"] = kernels
    RECORD["total_s"] = time.perf_counter() - t_start
    if args.out:
        with open(os.path.join(args.out, "chip_smoke.json"), "w") as f:
            json.dump(RECORD, f, indent=1, default=float)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
