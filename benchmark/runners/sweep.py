"""Traffic of utility analyses: one ``analysis.perform_utility_analysis``
of COUNT over the traffic file's grid of contribution bounds per call
(``l0_range``, inclusive, by ``linf_values``), each on a fresh
``ArrayDataset`` over the table (a user's one analysis of a table),
iterated to its result, back to back from one client. The traffic file
also gives ``noise_kind``, ``epsilon``, ``delta`` and
``partition_selection``."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.core import spec
from benchmark.reference import sweep as reference


class Runner:

    def __init__(self, cell, seed: int, device: torch.device, table):
        self.seed = seed
        self.device = device
        self.query = cell.traffic
        self.outputs: Dict[int, List] = {}
        self.table = table

    def spans(self) -> List[Tuple[str, str, str]]:
        sweep = "pipelinedp_tpu_torch.analysis.torch_sweep"
        return [(sweep + ":LazySweepResult", "_encode", "encode"),
                (sweep + ":LazySweepResult", "_stage_a", "stage_a"),
                (sweep, "_sweep_chunk_body", "chunk"),
                (sweep + ":LazySweepResult", "_pack", "pack")]

    def setup(self) -> None:
        import pipelinedp_tpu_torch as pdt
        from pipelinedp_tpu_torch import analysis
        self.pdt, self.analysis = pdt, analysis
        configs = reference.grid(self.query)
        q = self.query
        self.options = analysis.UtilityAnalysisOptions(
            epsilon=q["epsilon"], delta=q["delta"],
            aggregate_params=pdt.AggregateParams(
                metrics=[pdt.Metrics.COUNT],
                noise_kind=getattr(pdt.NoiseKind, q["noise_kind"]),
                max_partitions_contributed=configs[0][0],
                max_contributions_per_partition=configs[0][1],
                partition_selection_strategy=getattr(
                    pdt.PartitionSelectionStrategy,
                    q["partition_selection"])),
            multi_param_configuration=analysis.MultiParameterConfiguration(
                max_partitions_contributed=[a for a, _ in configs],
                max_contributions_per_partition=[b for _, b in configs]))
        self.n_configs = len(configs)
        for i in range(int(q.get("warmup_calls", 1))):
            self._analyse()

    def _analyse(self):
        pdt = self.pdt
        pid, pk, value = self.table
        lazy = self.analysis.perform_utility_analysis(
            pdt.ArrayDataset(privacy_ids=pid, partition_keys=pk,
                             values=value),
            pdt.TorchBackend(device=self.device), self.options,
            pdt.DataExtractors())
        return list(lazy)[0]

    def call(self, i: int):
        self.outputs[i] = self._analyse()
        return self.n_configs, None

    def free(self) -> None:
        pass

    def judge(self):
        """Every call's result against the float64 reference (the sweep
        has no noise: each call must give the same numbers)."""
        ref = reference.reference(self.table[0], self.table[1], self.query,
                                  torch.float64, self.device)
        worst: Dict[str, float] = {}
        for out in self.outputs.values():
            for name, v in reference.judge(
                    ref, reference.program_fields(out)).items():
                worst[name] = max(worst.get(name, 0.0), v)
        return bool(self.outputs), worst


def control(cell, seed: int, device: torch.device) -> Dict[str, Dict]:
    """The reference put in the program's place on the cell's table, in
    bfloat16 (the control: the next precision below the float32 the
    configuration states) and in float32 (the precision it states)."""
    pid, pk, _ = spec.load_generator(cell).generate(cell.config, seed,
                                                   device)
    ref = reference.reference(pid, pk, cell.traffic, torch.float64, device)
    return {name: reference.judge(ref, reference.reference(
        pid, pk, cell.traffic, dtype, device))
        for name, dtype in (("control", torch.bfloat16),
                            ("float32", torch.float32))}
