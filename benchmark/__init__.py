"""The benchmark of ``pipelinedp_tpu_torch`` on one NVIDIA H100.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once and prints its
result as the last line of standard output. Everything one configuration,
traffic mix, per-layer metric or cell needs sits in files of its own
under ``configs/``, ``traffic/``, ``metrics/`` and ``limits/``, found by
the names ``BENCHMARK.json`` gives; ``core/``, ``data/``, ``runners/``,
``reference/`` and ``roofline/`` are the general code that reads them.
"""
