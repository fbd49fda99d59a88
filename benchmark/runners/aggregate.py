"""Traffic of DP aggregations: one ``DPEngine.aggregate`` per call,
through ``TorchBackend``, from one client, back to back.

The traffic file gives the query (``metrics``, ``noise_kind``,
``epsilon``, ``delta``, ``max_partitions_contributed``,
``max_contributions_per_partition``, ``min_value``, ``max_value``,
``partition_selection``) and ``dataset``: ``"resident"`` hands every call
the same ``ArrayDataset``, whose encoding and device copies the port
caches (an analyst's queries over a loaded table); ``"fresh"`` hands each
call a new one over the same columns, so encode and the copy are paid
every time (a one-shot release). Each call gets a fresh accountant,
backend and engine, seeded from the run's seed and the call's index.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark.core import harness, spec
from benchmark.reference import aggregate as reference


# Call indices of the warm-up calls, apart from the window's.
WARMUP_BASE = 1 << 40
# Releases a run judges: the last call's and three drawn from the seed.
JUDGED_CALLS = 4


class Runner:

    def __init__(self, cell, seed: int, device: torch.device, table):
        self.seed = seed
        self.device = device
        self.query = cell.traffic
        self.outputs: Dict[int, List] = {}
        self._newest = None
        self._seen = 0
        self._rng = np.random.default_rng([seed % (1 << 63), 7])
        self.table = table
        self.resident = None

    def spans(self) -> List[Tuple[str, str, str]]:
        """The layers' calls the traced run names its idle gaps by."""
        engine = "pipelinedp_tpu_torch.torch_engine"
        return [(engine, "encode", "encode"),
                (engine + ":LazyFusedResult", "_run_device", "device"),
                (engine + ":LazyFusedResult", "_finish_release", "release")]

    def setup(self) -> None:
        import pipelinedp_tpu_torch as pdt
        self.pdt = pdt
        if self.query["dataset"] == "resident":
            self.resident = self._dataset()
        for i in range(int(self.query.get("warmup_calls", 1))):
            self._aggregate(WARMUP_BASE + i)

    def _dataset(self):
        pid, pk, value = self.table
        return self.pdt.ArrayDataset(privacy_ids=pid, partition_keys=pk,
                                     values=value)

    def _params(self):
        pdt, q = self.pdt, self.query
        return pdt.AggregateParams(
            metrics=[getattr(pdt.Metrics, m) for m in q["metrics"]],
            noise_kind=getattr(pdt.NoiseKind, q["noise_kind"]),
            max_partitions_contributed=q["max_partitions_contributed"],
            max_contributions_per_partition=q[
                "max_contributions_per_partition"],
            min_value=q["min_value"], max_value=q["max_value"],
            partition_selection_strategy=getattr(
                pdt.PartitionSelectionStrategy, q["partition_selection"]))

    def _aggregate(self, i: int):
        pdt = self.pdt
        acc = pdt.NaiveBudgetAccountant(total_epsilon=self.query["epsilon"],
                                        total_delta=self.query["delta"])
        backend = pdt.TorchBackend(device=self.device,
                                   rng_seed=harness.call_seed(self.seed, i))
        engine = pdt.DPEngine(acc, backend)
        ds = self.resident if self.resident is not None else self._dataset()
        result = engine.aggregate(ds, self._params(), pdt.DataExtractors())
        acc.compute_budgets()
        rows = list(result)
        return rows, dict(result.timings)

    def call(self, i: int) -> Tuple[float, Dict[str, float]]:
        rows, timings = self._aggregate(i)
        self._keep(i, rows)
        return len(self.table[0]), timings

    def _keep(self, i: int, rows) -> None:
        """Holds the newest call's rows and a uniform sample, drawn from
        the seed, of ``JUDGED_CALLS - 1`` earlier calls' (reservoir
        sampling): the window never holds more releases than are
        judged, so the outputs kept for the check add no work, such as
        the garbage collector's, to later calls."""
        k = JUDGED_CALLS - 1
        if self._newest is not None:
            seen = self._seen
            self._seen += 1
            if len(self.outputs) < k:
                self.outputs[self._newest[0]] = self._newest[1]
            else:
                j = int(self._rng.integers(0, seen + 1))
                if j < k:
                    del self.outputs[sorted(self.outputs)[j]]
                    self.outputs[self._newest[0]] = self._newest[1]
        self._newest = (i, rows)

    def free(self) -> None:
        self.resident = None

    def judge(self) -> Tuple[bool, Dict[str, float]]:
        """The released rows of the last call of the window and of a
        sample of the others drawn from the seed, against the
        reference's expectation for this table and query."""
        if self._newest is not None:
            self.outputs[self._newest[0]] = self._newest[1]
        expected = reference.expected(*self.table, self.query, self.device)
        worst: Dict[str, float] = {}
        for i in sorted(self.outputs):
            numbers = reference.judge(expected,
                                      reference.released(self.outputs[i]))
            for name, v in numbers.items():
                worst[name] = max(worst.get(name, -np.inf), v)
        return bool(self.outputs), worst


def control(cell, seed: int, device: torch.device) -> Dict[str, Dict]:
    """The reference put in the program's place on the cell's table, as
    many releases as a run judges: with the L0 bound left out (the
    control, ``"control"``), with partition selection left out
    (``"no_selection"``), and as the query states it (``"model"``, the
    reference's own reading of a sound release)."""
    table = spec.load_generator(cell).generate(cell.config, seed, device)
    expected = reference.expected(*table, cell.traffic, device)
    out = {}
    for name, bound, select in (("control", False, True),
                                ("no_selection", True, False),
                                ("model", True, True)):
        worst: Dict[str, float] = {}
        for i in range(JUDGED_CALLS):
            rng = np.random.default_rng([seed % (1 << 63), 11, i])
            got = reference.judge(expected, reference.simulate(
                *table, cell.traffic, rng, bound_l0=bound, select=select))
            for k, v in got.items():
                worst[k] = max(worst.get(k, -np.inf), v)
        out[name] = worst
    return out
