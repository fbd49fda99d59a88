"""Parameter dataclasses and enums — the framework's whole config surface.

Capability parity with the reference's ``pipeline_dp/aggregate_params.py``
(``Metrics`` at :54, ``NoiseKind`` :68, ``MechanismType`` :79, ``NormKind``
:85, ``PartitionSelectionStrategy`` :92, ``AggregateParams`` :98 with its
validation matrix :175-270, per-metric convenience params :300-545, and the
readable pretty-printer :563). Re-designed for the TPU build: validation is
pure host-side Python; the dataclasses are also the carriers of everything the
fused XLA program needs (bounds, noise kind, metrics) so a single
``AggregateParams`` fully specifies one compiled aggregation.
"""

from __future__ import annotations

import dataclasses
import enum
import logging
import typing
from typing import Any, Callable, List, Optional, Sequence


class Metric:
    """A single output metric, possibly parameterized (e.g. PERCENTILE(90)).

    Mirrors the reference's parameterized metric objects
    (``aggregate_params.py:23-52``): equality and hashing are by
    (name, parameter) so metric lists can be deduplicated and compared.
    """

    def __init__(self, name: str, parameter: Optional[float] = None):
        self._name = name
        self._parameter = parameter

    @property
    def name(self) -> str:
        return self._name

    @property
    def parameter(self):
        return self._parameter

    def __call__(self, parameter) -> "Metric":
        if self._parameter is not None:
            raise ValueError(f"{self} is already parameterized")
        return Metric(self._name, parameter)

    def __eq__(self, other):
        return (isinstance(other, Metric) and self._name == other._name and
                self._parameter == other._parameter)

    def __hash__(self):
        return hash((self._name, self._parameter))

    def __repr__(self):
        if self._parameter is None:
            return self._name
        return f"{self._name}({self._parameter})"

    @property
    def is_percentile(self) -> bool:
        return self._name == "PERCENTILE"


class Metrics:
    """Namespace of supported metrics (reference ``aggregate_params.py:54-66``)."""
    COUNT = Metric("COUNT")
    PRIVACY_ID_COUNT = Metric("PRIVACY_ID_COUNT")
    SUM = Metric("SUM")
    MEAN = Metric("MEAN")
    VARIANCE = Metric("VARIANCE")
    VECTOR_SUM = Metric("VECTOR_SUM")

    @staticmethod
    def PERCENTILE(percentile_to_compute: float) -> Metric:
        return Metric("PERCENTILE", percentile_to_compute)


class NoiseKind(enum.Enum):
    """User-facing choice of additive noise (reference :68-77)."""
    LAPLACE = "laplace"
    GAUSSIAN = "gaussian"

    def convert_to_mechanism_type(self) -> "MechanismType":
        if self == NoiseKind.LAPLACE:
            return MechanismType.LAPLACE
        return MechanismType.GAUSSIAN


class MechanismType(enum.Enum):
    """Internal mechanism taxonomy used by budget accounting (reference :79-84).

    GENERIC covers mechanisms that consume raw (eps, delta) directly, e.g.
    private partition selection.
    """
    LAPLACE = "Laplace"
    GAUSSIAN = "Gaussian"
    GENERIC = "Generic"

    def to_noise_kind(self) -> NoiseKind:
        if self == MechanismType.LAPLACE:
            return NoiseKind.LAPLACE
        if self == MechanismType.GAUSSIAN:
            return NoiseKind.GAUSSIAN
        raise ValueError(f"{self} has no corresponding noise kind")


class NormKind(enum.Enum):
    """Norm used for vector-sum clipping (reference :85-90)."""
    Linf = "linf"
    L0 = "l0"
    L1 = "l1"
    L2 = "l2"


class PartitionSelectionStrategy(enum.Enum):
    """Private partition selection flavors (reference :92-96)."""
    TRUNCATED_GEOMETRIC = "Truncated Geometric"
    LAPLACE_THRESHOLDING = "Laplace Thresholding"
    GAUSSIAN_THRESHOLDING = "Gaussian Thresholding"


@dataclasses.dataclass
class AggregateParams:
    """Parameters of a single DP aggregation (reference :98-298).

    Attributes:
      metrics: list of ``Metric`` to compute.
      noise_kind: additive noise flavor (ignored for pure selection).
      max_partitions_contributed: L0 bound — max partitions a single privacy
        unit may influence.
      max_contributions_per_partition: Linf bound — max rows a privacy unit
        may contribute to one partition.
      max_contributions: alternative total bound across all partitions
        (mutually exclusive with the pair above).
      min_value/max_value: per-row value clipping range (SUM/MEAN/VARIANCE).
      min_sum_per_partition/max_sum_per_partition: alternative clipping of a
        privacy unit's *sum* within a partition (SUM only).
      budget_weight: relative share of the pipeline (eps, delta).
      vector_size/vector_max_norm/vector_norm_kind: VECTOR_SUM knobs.
      contribution_bounds_already_enforced: input is pre-bounded; no privacy
        id is available or needed.
      partition_selection_strategy: strategy for private partition selection.
      pre_threshold: additional additive threshold on the number of privacy
        units required before a partition may be released.
      public_partitions_already_filtered: input only contains public keys.
      custom_combiners: advanced extension point — user combiners replace the
        built-in metric computation.
    """
    metrics: List[Metric] = dataclasses.field(default_factory=list)
    noise_kind: NoiseKind = NoiseKind.LAPLACE
    max_partitions_contributed: Optional[int] = None
    max_contributions_per_partition: Optional[int] = None
    max_contributions: Optional[int] = None
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    min_sum_per_partition: Optional[float] = None
    max_sum_per_partition: Optional[float] = None
    budget_weight: float = 1.0
    vector_size: Optional[int] = None
    vector_max_norm: Optional[float] = None
    vector_norm_kind: NormKind = NormKind.Linf
    contribution_bounds_already_enforced: bool = False
    partition_selection_strategy: PartitionSelectionStrategy = (
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC)
    pre_threshold: Optional[int] = None
    public_partitions_already_filtered: bool = False
    custom_combiners: Optional[Sequence] = None

    @property
    def metrics_str(self) -> str:
        if self.custom_combiners:
            names = [c.metrics_names() for c in self.custom_combiners]
            return f"custom combiners={names}"
        return f"[{', '.join(str(m) for m in self.metrics or [])}]"

    @property
    def bounds_per_contribution_are_set(self) -> bool:
        return self.min_value is not None and self.max_value is not None

    @property
    def bounds_per_partition_are_set(self) -> bool:
        return (self.min_sum_per_partition is not None and
                self.max_sum_per_partition is not None)

    def __post_init__(self):
        self._validate()

    # --- validation (mirrors the reference's matrix at :175-270) ---

    def _validate(self):
        # Contribution bounds, budget weight and pre-threshold are required
        # regardless of custom combiners (the reference validates bounds
        # before its custom-combiner handling, aggregate_params.py:246-270).
        self._validate_contribution_bounds()
        if self.budget_weight <= 0:
            raise ValueError("budget_weight must be positive")
        if self.pre_threshold is not None and self.pre_threshold <= 0:
            raise ValueError(
                f"pre_threshold must be positive, not {self.pre_threshold}")

        if self.custom_combiners:
            logging.warning("Warning: custom combiners are an experimental"
                            " feature. The API may change without notice.")
            if self.metrics:
                raise ValueError(
                    "custom_combiners are set, 'metrics' must not be set")
            return
        if not self.metrics:
            raise ValueError(
                "metrics must be set (or provide custom_combiners)")

        self._validate_metrics()
        self._validate_value_bounds()
        self._validate_vector_params()

    def _validate_metrics(self):
        if not self.metrics:
            return
        names = [m.name for m in self.metrics]
        if len(set(self.metrics)) != len(self.metrics):
            raise ValueError(f"duplicate metrics in {self.metrics_str}")
        if "VECTOR_SUM" in names and len(set(names)) > 1:
            if set(names) - {"VECTOR_SUM"}:
                raise ValueError(
                    "VECTOR_SUM cannot be computed together with scalar "
                    "metrics (COUNT, SUM, MEAN, ...)")
        if self.contribution_bounds_already_enforced and (
                Metrics.PRIVACY_ID_COUNT in self.metrics):
            raise ValueError(
                "PRIVACY_ID_COUNT cannot be computed when "
                "contribution_bounds_already_enforced is True (privacy ids "
                "are not available)")

    def _validate_contribution_bounds(self):
        per_pair = (self.max_partitions_contributed is not None or
                    self.max_contributions_per_partition is not None)
        if self.max_contributions is not None:
            if per_pair:
                raise ValueError(
                    "set either max_contributions or the pair "
                    "(max_partitions_contributed, "
                    "max_contributions_per_partition), not both")
            _check_positive_int(self.max_contributions, "max_contributions")
        else:
            # The pair must be set together, regardless of metrics
            # (reference aggregate_params.py:255-270).
            n_set = sum(x is not None
                        for x in (self.max_partitions_contributed,
                                  self.max_contributions_per_partition))
            if n_set == 0:
                raise ValueError(
                    "either max_contributions must be set or both "
                    "max_partitions_contributed and "
                    "max_contributions_per_partition must be set")
            if n_set == 1:
                raise ValueError(
                    "either none or both of max_partitions_contributed and "
                    "max_contributions_per_partition must be set")
            _check_positive_int(self.max_partitions_contributed,
                                "max_partitions_contributed")
            _check_positive_int(self.max_contributions_per_partition,
                                "max_contributions_per_partition")

    def _validate_value_bounds(self):
        # metrics may be None (e.g. params destined for custom combiners,
        # reference aggregate_params.py:201 guards every use the same way).
        metrics = self.metrics or []
        needs_values = any(
            m in (Metrics.SUM, Metrics.MEAN, Metrics.VARIANCE) or
            m.is_percentile for m in metrics)
        has_pair = self.bounds_per_contribution_are_set
        has_sum_pair = self.bounds_per_partition_are_set
        if (self.min_value is None) != (self.max_value is None):
            raise ValueError("min_value and max_value must be set together")
        if (self.min_sum_per_partition is None) != (
                self.max_sum_per_partition is None):
            raise ValueError("min_sum_per_partition and max_sum_per_partition"
                             " must be set together")
        if has_pair and has_sum_pair:
            raise ValueError(
                "set either (min_value, max_value) or "
                "(min_sum_per_partition, max_sum_per_partition), not both")
        if has_sum_pair and any(
                m in (Metrics.MEAN, Metrics.VARIANCE) for m in metrics):
            raise ValueError(
                "per-partition sum bounds support only SUM, not MEAN/VARIANCE")
        if needs_values and not (has_pair or has_sum_pair):
            raise ValueError(
                f"value bounds must be set for metrics {self.metrics_str}")
        for lo, hi, what in ((self.min_value, self.max_value, "value"),
                             (self.min_sum_per_partition,
                              self.max_sum_per_partition,
                              "sum_per_partition")):
            if lo is not None and not _is_number(lo):
                raise ValueError(f"min_{what} must be a number")
            if hi is not None and not _is_number(hi):
                raise ValueError(f"max_{what} must be a number")
            if lo is not None and hi is not None and lo > hi:
                raise ValueError(f"min_{what} must be <= max_{what}")
        # Percentiles subdivide the clip range into quantile-tree
        # leaves: a zero-width range has no subdivision (the host tree
        # ctor rejects it too, but deep in the pipeline — fail at
        # params construction with the cause named).
        if (any(m.is_percentile for m in (self.metrics or [])) and
                self.min_value is not None and
                self.min_value == self.max_value):
            raise ValueError(
                "PERCENTILE metrics need min_value < max_value "
                "(a zero-width clip range has no quantile structure)")

    def _validate_vector_params(self):
        if Metrics.VECTOR_SUM not in (self.metrics or []):
            return
        if self.vector_size is None or self.vector_size <= 0:
            raise ValueError("vector_size must be a positive int for "
                             "VECTOR_SUM")
        if self.vector_max_norm is None or self.vector_max_norm <= 0:
            raise ValueError("vector_max_norm must be positive for "
                             "VECTOR_SUM")

    def __str__(self):
        return parameters_to_readable_string(self)


def _check_positive_int(value, name: str):
    if not isinstance(value, int) or isinstance(value, bool) or value <= 0:
        raise ValueError(f"{name} must be a positive integer, not {value}")


def _is_number(x) -> bool:
    return isinstance(x, (int, float)) and not isinstance(x, bool)


@dataclasses.dataclass
class SelectPartitionsParams:
    """Parameters of ``DPEngine.select_partitions`` (reference :300-323)."""
    max_partitions_contributed: int = 1
    budget_weight: float = 1.0
    partition_selection_strategy: PartitionSelectionStrategy = (
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC)
    pre_threshold: Optional[int] = None

    def __post_init__(self):
        _check_positive_int(self.max_partitions_contributed,
                            "max_partitions_contributed")
        if self.budget_weight <= 0:
            raise ValueError("budget_weight must be positive")
        if self.pre_threshold is not None and self.pre_threshold <= 0:
            raise ValueError("pre_threshold must be positive")


# --- Convenience per-metric params for the fluent private APIs
#     (reference :325-545). Each knows how to lower itself to
#     AggregateParams with exactly one metric. ---


@dataclasses.dataclass
class _SingleMetricParams:
    noise_kind: NoiseKind = NoiseKind.LAPLACE
    max_partitions_contributed: int = 1
    budget_weight: float = 1.0
    partition_extractor: Optional[Callable] = None
    value_extractor: Optional[Callable] = None
    public_partitions: Any = None
    partition_selection_strategy: PartitionSelectionStrategy = (
        PartitionSelectionStrategy.TRUNCATED_GEOMETRIC)
    pre_threshold: Optional[int] = None
    contribution_bounds_already_enforced: bool = False

    METRIC: typing.ClassVar[Optional[Metric]] = None  # per subclass

    def _common_kwargs(self) -> dict:
        return dict(
            metrics=[self.METRIC],
            noise_kind=self.noise_kind,
            max_partitions_contributed=self.max_partitions_contributed,
            budget_weight=self.budget_weight,
            partition_selection_strategy=self.partition_selection_strategy,
            pre_threshold=self.pre_threshold,
            contribution_bounds_already_enforced=(
                self.contribution_bounds_already_enforced),
        )

    def to_aggregate_params(self) -> AggregateParams:
        return AggregateParams(**self._common_kwargs())


@dataclasses.dataclass
class CountParams(_SingleMetricParams):
    """reference :465-500"""
    max_contributions_per_partition: int = 1
    METRIC = Metrics.COUNT

    def to_aggregate_params(self) -> AggregateParams:
        kw = self._common_kwargs()
        kw["max_contributions_per_partition"] = (
            self.max_contributions_per_partition)
        return AggregateParams(**kw)


@dataclasses.dataclass
class PrivacyIdCountParams(_SingleMetricParams):
    """reference :502-545"""
    METRIC = Metrics.PRIVACY_ID_COUNT

    def to_aggregate_params(self) -> AggregateParams:
        kw = self._common_kwargs()
        kw["max_contributions_per_partition"] = 1
        return AggregateParams(**kw)


@dataclasses.dataclass
class SumParams(_SingleMetricParams):
    """reference :325-374"""
    max_contributions_per_partition: Optional[int] = None
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    min_sum_per_partition: Optional[float] = None
    max_sum_per_partition: Optional[float] = None
    METRIC = Metrics.SUM

    def to_aggregate_params(self) -> AggregateParams:
        kw = self._common_kwargs()
        kw.update(
            max_contributions_per_partition=(
                self.max_contributions_per_partition),
            min_value=self.min_value,
            max_value=self.max_value,
            min_sum_per_partition=self.min_sum_per_partition,
            max_sum_per_partition=self.max_sum_per_partition,
        )
        return AggregateParams(**kw)


@dataclasses.dataclass
class MeanParams(_SingleMetricParams):
    """reference :420-463"""
    max_contributions_per_partition: int = 1
    min_value: Optional[float] = None
    max_value: Optional[float] = None
    METRIC = Metrics.MEAN

    def to_aggregate_params(self) -> AggregateParams:
        kw = self._common_kwargs()
        kw.update(
            max_contributions_per_partition=(
                self.max_contributions_per_partition),
            min_value=self.min_value,
            max_value=self.max_value,
        )
        return AggregateParams(**kw)


@dataclasses.dataclass
class VarianceParams(MeanParams):
    """reference :376-418"""
    METRIC = Metrics.VARIANCE


def parameters_to_readable_string(params: AggregateParams,
                                  is_public_partition: Optional[bool] = None
                                  ) -> str:
    """Human-readable multi-line description (reference :563-594)."""
    lines = [f"Computed metrics: {params.metrics_str}"]
    if params.noise_kind is not None:
        lines.append(f"Noise: {params.noise_kind.value}")
    if params.max_contributions is not None:
        lines.append("Contribution bounding: max_contributions="
                     f"{params.max_contributions}")
    else:
        lines.append(
            "Contribution bounding: max_partitions_contributed="
            f"{params.max_partitions_contributed}, "
            "max_contributions_per_partition="
            f"{params.max_contributions_per_partition}")
    if params.bounds_per_contribution_are_set:
        lines.append(f"Value clipping: [{params.min_value}, "
                     f"{params.max_value}] per contribution")
    if params.bounds_per_partition_are_set:
        lines.append(f"Sum clipping: [{params.min_sum_per_partition}, "
                     f"{params.max_sum_per_partition}] per partition")
    if is_public_partition is not None:
        kind = "public" if is_public_partition else "private"
        lines.append(f"Partitions: {kind}")
    return "\n".join(" " + l for l in lines)
