"""Utility-analysis API dataclasses: a copy of
``pipelinedp_tpu/analysis/data_structures.py`` on the port's own
parameter types (capability parity with the reference's
``analysis/data_structures.py``)."""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Iterator, Optional, Sequence

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch.aggregate_params import (AggregateParams, NoiseKind,
                                             PartitionSelectionStrategy)


@dataclasses.dataclass
class PreAggregateExtractors:
    """Extractors for pre-aggregated data: each row is one
    (privacy_id, partition_key) pair carrying (count, sum, n_partitions)
    (reference :24-44)."""
    partition_extractor: Callable
    preaggregate_extractor: Callable


@dataclasses.dataclass
class MultiParameterConfiguration:
    """Vectors of parameter values — one utility analysis per index
    (reference :46-119). Every vector that is set must share one length;
    configuration i is the base ``AggregateParams`` with entry i of each
    set vector substituted in."""
    max_partitions_contributed: Optional[Sequence[int]] = None
    max_contributions_per_partition: Optional[Sequence[int]] = None
    min_sum_per_partition: Optional[Sequence[float]] = None
    max_sum_per_partition: Optional[Sequence[float]] = None
    noise_kind: Optional[Sequence[NoiseKind]] = None
    partition_selection_strategy: Optional[
        Sequence[PartitionSelectionStrategy]] = None

    @classmethod
    def _vector_fields(cls) -> Sequence[str]:
        """The swept AggregateParams fields — derived from the dataclass
        declaration so new vectors are automatically validated and
        substituted."""
        return tuple(f.name for f in dataclasses.fields(cls))

    def __post_init__(self):
        lengths = {
            name: len(vec) for name in self._vector_fields()
            if (vec := getattr(self, name))
        }
        if not lengths:
            raise ValueError("MultiParameterConfiguration needs at "
                             "least 1 parameter vector.")
        if len(set(lengths.values())) > 1:
            raise ValueError(
                f"every set parameter vector must have the same length; "
                f"got {lengths}")
        if (self.min_sum_per_partition is None) != (
                self.max_sum_per_partition is None):
            raise ValueError(
                "min_sum_per_partition and max_sum_per_partition must be "
                "both set or both None in MultiParameterConfiguration.")
        self._size = next(iter(lengths.values()))

    @property
    def size(self):
        return self._size

    def get_aggregate_params(self, params: AggregateParams,
                             index: int) -> AggregateParams:
        """The index-th concrete AggregateParams (reference :99-119)."""
        out = copy.copy(params)
        for name in self._vector_fields():
            vec = getattr(self, name)
            if vec:
                setattr(out, name, vec[index])
        return out


@dataclasses.dataclass
class UtilityAnalysisOptions:
    """Options for the utility analysis (reference :121-144)."""
    epsilon: float
    delta: float
    aggregate_params: AggregateParams
    multi_param_configuration: Optional[MultiParameterConfiguration] = None
    partitions_sampling_prob: float = 1
    pre_aggregated_data: bool = False

    def __post_init__(self):
        input_validators.validate_epsilon_delta(self.epsilon, self.delta,
                                                "UtilityAnalysisOptions")
        if not 0 < self.partitions_sampling_prob <= 1:
            raise ValueError(
                f"partitions_sampling_prob must be in (0, 1], not "
                f"{self.partitions_sampling_prob}")

    @property
    def n_configurations(self):
        if self.multi_param_configuration is None:
            return 1
        return self.multi_param_configuration.size


def get_aggregate_params(
        options: UtilityAnalysisOptions) -> Iterator[AggregateParams]:
    """Yields the concrete AggregateParams of every configuration
    (reference :146-156)."""
    multi_param = options.multi_param_configuration
    if multi_param is None:
        yield options.aggregate_params
    else:
        for i in range(multi_param.size):
            yield multi_param.get_aggregate_params(
                options.aggregate_params, i)


def analysis_mechanism_type(options: UtilityAnalysisOptions):
    """Mechanism type for the analysis budget request: promoted to the
    delta-using (Gaussian) type when ANY analyzed configuration's noise
    kind needs delta — a per-config ``noise_kind`` vector may put
    GAUSSIAN configs under a LAPLACE base, whose noise-std prediction
    then needs a delta share to calibrate against. Shared by the host
    engine and the device sweep so both planes request identical
    budgets."""
    kinds = {p.noise_kind for p in get_aggregate_params(options)}
    if NoiseKind.GAUSSIAN in kinds:
        return NoiseKind.GAUSSIAN.convert_to_mechanism_type()
    return options.aggregate_params.noise_kind.convert_to_mechanism_type()
