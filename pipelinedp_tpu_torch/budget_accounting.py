"""Two-phase privacy-budget accounting.

Capability parity with the reference's ``pipeline_dp/budget_accounting.py``:
lazy ``MechanismSpec`` handles (:36-100) registered during graph construction,
filled in place by ``compute_budgets()`` (:368-396) so closures already
captured by the (possibly compiled) execution graph observe final values;
weighted nested scopes (:262-287); naive (eps, delta)-splitting composition
(:289-396); and a PLD accountant (:399-600) that binary-searches the minimal
noise standard deviation whose composed privacy-loss distribution still
satisfies the total (eps, delta).

Port copy of the JAX package's ``budget_accounting.py``, both
accountants: the PLD accountant runs the port's copy of the JAX package's
PLD engine (``pld.py``), so both packages grant bit-identical noise levels
and equivalent (eps, delta). ``MechanismSpec`` values are read when the
lazy result runs, after ``compute_budgets()``.
"""

from __future__ import annotations

import abc
import dataclasses
import logging
import math
from typing import List, Optional

from pipelinedp_tpu_torch import input_validators
from pipelinedp_tpu_torch.aggregate_params import MechanismType


@dataclasses.dataclass
class Budget:
    """A concrete (epsilon, delta) slice, known only after compute_budgets."""
    epsilon: float
    delta: float

    def __str__(self):
        return f"(eps={self.epsilon}, delta={self.delta})"


class MechanismSpec:
    """Lazy handle for one DP mechanism's budget share.

    Reference semantics (``budget_accounting.py:36-100``): created at graph
    construction, raises if eps/delta are read before ``compute_budgets()``;
    afterwards returns the allotted share. ``count`` mechanisms share one
    spec (the reference deduplicates identical requests via ``use_count``).
    """

    def __init__(self,
                 mechanism_type: MechanismType,
                 _eps: Optional[float] = None,
                 _delta: Optional[float] = None,
                 _count: int = 1,
                 metric: Optional[str] = None):
        self._mechanism_type = mechanism_type
        self._eps = _eps
        self._delta = _delta
        self._count = _count
        self._metric = metric
        self._noise_standard_deviation: Optional[float] = None

    @property
    def mechanism_type(self) -> MechanismType:
        return self._mechanism_type

    @property
    def metric(self) -> Optional[str]:
        """Which metric/release this mechanism serves — the audit label
        threaded through ``request_budget(metric=...)`` (None for callers
        that predate the audit record)."""
        return self._metric

    @property
    def eps(self) -> float:
        if self._eps is None:
            raise AssertionError(
                "Privacy budget is not calculated yet. Call "
                "BudgetAccountant.compute_budgets() first.")
        return self._eps

    @property
    def delta(self) -> float:
        if self._delta is None:
            raise AssertionError(
                "Privacy budget is not calculated yet. Call "
                "BudgetAccountant.compute_budgets() first.")
        return self._delta

    @property
    def count(self) -> int:
        return self._count

    @property
    def noise_standard_deviation(self) -> float:
        """Set only by the PLD accountant (reference :88-100)."""
        if self._noise_standard_deviation is None:
            raise AssertionError(
                "Noise standard deviation is not calculated yet. Call "
                "BudgetAccountant.compute_budgets() first.")
        return self._noise_standard_deviation

    def set_eps_delta(self, eps: float, delta: Optional[float]) -> None:
        self._eps = eps
        self._delta = delta

    def set_noise_standard_deviation(self, stddev: float) -> None:
        self._noise_standard_deviation = stddev

    def use_delta(self) -> bool:
        return self._mechanism_type != MechanismType.LAPLACE

    def __str__(self):
        return f"MechanismSpec({self._mechanism_type.value})"


@dataclasses.dataclass
class MechanismSpecInternal:
    """Accountant-private record pairing a spec with its weight/sensitivity
    (reference ``budget_accounting.py:102-111``).

    ``internal_splits`` declares that the consumer will split the granted
    (eps, delta) evenly into that many sub-mechanisms (mean/variance's
    count+normalized-sum pair, a vector's per-coordinate releases, a
    quantile tree's per-level noise). Naive composition is invariant to
    the declaration (an even split of a share is the same total share);
    PLD composition convolves the sub-mechanisms individually."""
    sensitivity: float
    weight: float
    mechanism_spec: MechanismSpec
    internal_splits: int = 1


class BudgetAccountantScope:
    """Context manager creating a weighted sub-budget scope.

    On exit, the weights of all mechanisms registered inside the scope are
    normalised so the scope as a whole consumes exactly ``weight`` of the
    parent budget (reference :262-287). Scopes nest.
    """

    def __init__(self, accountant: "BudgetAccountant", weight: float):
        self._accountant = accountant
        self.weight = weight
        self._mechanisms: List[MechanismSpecInternal] = []

    def __enter__(self):
        self._accountant._enter_scope(self)
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        self._accountant._exit_scope()
        self._normalise_mechanism_weights()
        return False

    def _normalise_mechanism_weights(self):
        if not self._mechanisms:
            return
        total = sum(m.weight for m in self._mechanisms)
        for m in self._mechanisms:
            m.weight = m.weight * self.weight / total


class BudgetAccountant(abc.ABC):
    """Base class for all accountants (reference :113-260)."""

    def __init__(self,
                 total_epsilon: float,
                 total_delta: float,
                 num_aggregations: Optional[int] = None,
                 aggregation_weights: Optional[List[float]] = None):
        input_validators.validate_epsilon_delta(total_epsilon, total_delta,
                                                type(self).__name__)
        self._total_epsilon = total_epsilon
        self._total_delta = total_delta
        self._scopes_stack: List[BudgetAccountantScope] = []
        self._mechanisms: List[MechanismSpecInternal] = []
        self._finalized = False
        # Optional pipeline-shape contract (reference :128-143): the caller
        # declares up-front how many aggregations (and with which weights)
        # the pipeline will perform; compute_budgets() verifies the claim.
        if num_aggregations is not None and aggregation_weights is not None:
            raise ValueError(
                "'num_aggregations' and 'aggregation_weights' can not be "
                "set simultaneously")
        if num_aggregations is not None and num_aggregations <= 0:
            raise ValueError("num_aggregations must be positive")
        self._expected_num_aggregations = num_aggregations
        self._expected_aggregation_weights = aggregation_weights
        self._actual_aggregation_weights: List[float] = []
        #: (tenant, request_id) books tag for resident-service runs —
        #: see :meth:`bind_books`.
        self._books: Optional[dict] = None

    # --- resident-service integration ---

    @property
    def total_epsilon(self) -> float:
        """The accountant's whole-pipeline epsilon. For a resident
        service this IS the request's debit against the tenant's
        durable budget ledger: the accountant by construction
        distributes exactly its totals, so leasing (eps, delta) from
        the ledger and constructing the per-request accountant with
        those totals makes the ledger's arithmetic exact."""
        return self._total_epsilon

    @property
    def total_delta(self) -> float:
        """The accountant's whole-pipeline delta (see
        :attr:`total_epsilon`)."""
        return self._total_delta

    def bind_books(self, tenant: str, request_id: str) -> None:
        """Tag this accountant with the tenant's books it debits: the
        audit record (and thus the run report / per-tenant ledger
        entry) then names which tenant and which request the granted
        (eps, delta) splits belong to. Idempotent; the serve layer
        calls it right after leasing the request's budget."""
        self._books = {"tenant": str(tenant),
                       "request_id": str(request_id)}

    # --- scope management ---

    def scope(self, weight: float) -> BudgetAccountantScope:
        self._actual_aggregation_weights.append(weight)
        return BudgetAccountantScope(self, weight)

    def _enter_scope(self, scope: BudgetAccountantScope):
        self._scopes_stack.append(scope)

    def _exit_scope(self):
        self._scopes_stack.pop()

    def _register_mechanism(self,
                            mechanism: MechanismSpecInternal
                            ) -> MechanismSpecInternal:
        if self._finalized:
            raise AssertionError(
                "request_budget() is called after compute_budgets(). "
                "Register all mechanisms before computing budgets.")
        self._mechanisms.append(mechanism)
        for scope in self._scopes_stack:
            scope._mechanisms.append(mechanism)
        return mechanism

    def _check_not_finalized(self):
        """A second compute_budgets() would silently re-split the budget
        (possibly after more requests slipped in) — the reference raises
        (``budget_accounting.py:368-372``)."""
        if self._finalized:
            raise Exception("compute_budgets can not be called twice.")

    def _check_not_in_scope(self):
        """compute_budgets inside an open scope would see un-normalised
        weights (normalisation happens on scope exit) — the reference raises
        here too (``budget_accounting.py:505-507``)."""
        if self._scopes_stack:
            raise Exception(
                "Cannot call compute_budgets from within a budget scope.")

    def _check_aggregation_restrictions(self):
        """Verifies the declared pipeline shape (reference :203-235)."""
        weights = self._actual_aggregation_weights
        if self._expected_num_aggregations is not None:
            if len(weights) != self._expected_num_aggregations:
                raise ValueError(
                    f"'num_aggregations'={self._expected_num_aggregations} "
                    f"but {len(weights)} aggregations were performed.")
            if any(w != 1 for w in weights):
                raise ValueError(
                    "When 'num_aggregations' is set, all aggregations must "
                    "have budget_weight=1.")
        if self._expected_aggregation_weights is not None:
            expected = self._expected_aggregation_weights
            if len(weights) != len(expected):
                raise ValueError(
                    f"'aggregation_weights' has {len(expected)} entries but "
                    f"{len(weights)} aggregations were performed.")
            for i, (w, e) in enumerate(zip(weights, expected)):
                if abs(w - e) > 1e-12:
                    raise ValueError(
                        f"Aggregation {i} has weight {w}, but "
                        f"'aggregation_weights' declared {e}.")

    def _compute_budget_for_aggregation(self,
                                        weight: float) -> Optional[Budget]:
        """The (eps, delta) share a whole aggregation with ``weight`` will
        consume — used for annotations (reference :177-201).

        A per-aggregation budget is only knowable at aggregation time when
        the pipeline shape was declared up front (``num_aggregations`` or
        ``aggregation_weights``); otherwise returns None, like the
        reference."""
        if self._expected_num_aggregations:
            return Budget(
                self._total_epsilon / self._expected_num_aggregations,
                self._total_delta / self._expected_num_aggregations)
        if self._expected_aggregation_weights:
            share = weight / sum(self._expected_aggregation_weights)
            return Budget(self._total_epsilon * share,
                          self._total_delta * share)
        return None

    # --- abstract API ---

    @abc.abstractmethod
    def request_budget(self,
                       mechanism_type: MechanismType,
                       sensitivity: float = 1,
                       weight: float = 1,
                       count: int = 1,
                       noise_standard_deviation: Optional[float] = None,
                       internal_splits: int = 1,
                       metric: Optional[str] = None) -> MechanismSpec:
        """Registers a mechanism; returns a lazy spec.

        ``internal_splits``: the consumer will divide the granted budget
        evenly into this many internal sub-mechanisms (see
        MechanismSpecInternal). ``metric`` labels the release this
        mechanism serves in the privacy audit record."""

    def compute_budgets(self) -> None:
        """Distributes the total budget over all registered mechanisms,
        mutating every MechanismSpec in place. Template method: runs the
        shared finalize checks once, so no subclass can forget them, then
        dispatches to the accountant's ``_compute_budgets``."""
        self._check_not_finalized()
        self._check_not_in_scope()
        self._check_aggregation_restrictions()
        self._finalized = True
        if not self._mechanisms:
            logging.warning("No budgets were requested.")
        else:
            self._compute_budgets()

    @property
    def finalized(self) -> bool:
        return self._finalized

    # --- privacy audit record ---

    def audit_record(self) -> dict:
        """Machine-readable twin of the explain report's budget lines:
        every registered mechanism's metric label, mechanism type,
        granted (eps, delta) split, and noise standard deviation — the
        per-request audit section that today dies with the accountant at
        exit. Meaningful after ``compute_budgets()`` (before it, the
        lazy eps/delta render as None)."""
        mechanisms = []
        for i, m in enumerate(self._mechanisms):
            spec = m.mechanism_spec
            mechanisms.append({
                "metric": spec.metric or f"mechanism_{i}",
                "mechanism_type": spec.mechanism_type.value,
                "eps": spec._eps,
                "delta": spec._delta,
                "noise_standard_deviation": self._spec_noise_std(m),
                "weight": m.weight,
                "sensitivity": m.sensitivity,
                "count": spec.count,
                "internal_splits": m.internal_splits,
            })
        record = {
            "accountant": type(self).__name__,
            "total_epsilon": self._total_epsilon,
            "total_delta": self._total_delta,
            "finalized": self._finalized,
            "mechanisms": mechanisms,
        }
        if self._books is not None:
            record["books"] = dict(self._books)
        return record

    def _spec_noise_std(self, m: MechanismSpecInternal) -> Optional[float]:
        """Noise stddev of ONE of the spec's ``internal_splits``
        sub-mechanisms at the registered sensitivity: the PLD-granted
        value when set, else the standard calibration of the even
        (eps, delta)/k split (None for GENERIC mechanisms and before
        finalization)."""
        spec = m.mechanism_spec
        if spec._noise_standard_deviation is not None:
            return spec._noise_standard_deviation
        if not spec._eps:
            return None
        k = max(m.internal_splits, 1)
        if spec.mechanism_type == MechanismType.LAPLACE:
            return math.sqrt(2.0) * m.sensitivity * k / spec._eps
        if spec.mechanism_type == MechanismType.GAUSSIAN and spec._delta:
            from pipelinedp_tpu_torch.ops import noise as noise_ops
            return noise_ops.gaussian_sigma(spec._eps / k, spec._delta / k,
                                            m.sensitivity)
        return None

    @abc.abstractmethod
    def _compute_budgets(self) -> None:
        """The accountant-specific budget split; mechanisms are
        non-empty and the accountant is already finalized."""


class NaiveBudgetAccountant(BudgetAccountant):
    """Naive (basic) composition: eps and delta are split proportionally to
    mechanism weights (reference :289-396). Delta is only allotted to
    mechanisms that use it (:384-385, :392-395)."""

    def request_budget(self,
                       mechanism_type: MechanismType,
                       sensitivity: float = 1,
                       weight: float = 1,
                       count: int = 1,
                       noise_standard_deviation: Optional[float] = None,
                       internal_splits: int = 1,
                       metric: Optional[str] = None) -> MechanismSpec:
        if noise_standard_deviation is not None:
            raise NotImplementedError(
                "noise_standard_deviation is not implemented for "
                "NaiveBudgetAccountant (count IS supported).")
        if mechanism_type == MechanismType.GAUSSIAN and (
                self._total_delta == 0):
            raise AssertionError(
                "The Gaussian mechanism requires delta > 0")
        if internal_splits < 1:
            raise ValueError("internal_splits must be >= 1")
        spec = MechanismSpec(mechanism_type, _count=count, metric=metric)
        self._register_mechanism(
            MechanismSpecInternal(sensitivity=sensitivity,
                                  weight=weight,
                                  mechanism_spec=spec,
                                  internal_splits=internal_splits))
        return spec

    def _compute_budgets(self) -> None:
        total_weight_eps = 0.0
        total_weight_delta = 0.0
        for m in self._mechanisms:
            total_weight_eps += m.weight * m.mechanism_spec.count
            if m.mechanism_spec.use_delta():
                total_weight_delta += m.weight * m.mechanism_spec.count
        for m in self._mechanisms:
            eps = delta = 0.0
            if total_weight_eps:
                eps = self._total_epsilon * m.weight / total_weight_eps
            if m.mechanism_spec.use_delta():
                if total_weight_delta:
                    delta = (self._total_delta * m.weight /
                             total_weight_delta)
            m.mechanism_spec.set_eps_delta(eps, delta)


class PLDBudgetAccountant(BudgetAccountant):
    """Privacy-loss-distribution composition accountant.

    Reference behavior (``budget_accounting.py:399-600``): registers
    mechanisms with sensitivities/weights, then binary-searches the minimal
    common noise multiplier such that the *composed* PLD of all mechanisms
    stays within (total_epsilon, total_delta); writes the resulting
    per-mechanism noise stddev into each spec. The reference delegates PLD
    arithmetic to the external ``dp_accounting`` library; this build carries
    a self-contained discretized-PLD engine (``pipelinedp_tpu_torch.pld``) —
    Laplace and Gaussian privacy-loss distributions are discretized on a
    fixed grid with pessimistic rounding and composed by FFT convolution.
    """

    def __init__(self,
                 total_epsilon: float,
                 total_delta: float,
                 pld_discretization: float = 1e-4,
                 num_aggregations: Optional[int] = None,
                 aggregation_weights: Optional[List[float]] = None):
        super().__init__(total_epsilon, total_delta, num_aggregations,
                         aggregation_weights)
        self._pld_discretization = pld_discretization
        self.minimum_noise_std: Optional[float] = None

    def request_budget(self,
                       mechanism_type: MechanismType,
                       sensitivity: float = 1,
                       weight: float = 1,
                       count: int = 1,
                       noise_standard_deviation: Optional[float] = None,
                       internal_splits: int = 1,
                       metric: Optional[str] = None) -> MechanismSpec:
        if count != 1 or noise_standard_deviation is not None:
            raise NotImplementedError(
                "count/noise_standard_deviation are not supported by "
                "PLDBudgetAccountant yet.")
        if mechanism_type == MechanismType.GAUSSIAN and (
                self._total_delta == 0):
            # A finite-sigma Gaussian always has delta > 0 — calibrating it
            # under a pure-DP budget would be non-private (reference
            # budget_accounting.py:460-463).
            raise AssertionError(
                "The Gaussian mechanism requires delta > 0")
        if internal_splits < 1:
            raise ValueError("internal_splits must be >= 1")
        spec = MechanismSpec(mechanism_type, metric=metric)
        self._register_mechanism(
            MechanismSpecInternal(sensitivity=sensitivity,
                                  weight=weight,
                                  mechanism_spec=spec,
                                  internal_splits=internal_splits))
        return spec

    def _compute_budgets(self) -> None:
        from pipelinedp_tpu_torch import pld as pld_lib
        # A spec with internal_splits=k is k independent sub-mechanisms,
        # each carrying weight/k — so a k-split metric at weight w consumes
        # the same share of the pipeline as a single-mechanism metric at
        # weight w, matching the naive accountant's semantics (the combiner
        # splits the granted budget evenly; equally_split_budget).
        sum_weights = sum(m.weight for m in self._mechanisms)
        if self._total_delta == 0:
            # Pure-DP pipeline: only Laplace-style composition is possible;
            # the reference uses the closed form sum(weights)/eps * sqrt(2)
            # (``budget_accounting.py:509-514``). sum_weights already counts
            # each k-split spec as k sub-mechanisms of weight/k.
            minimum_noise_std = (sum_weights / self._total_epsilon *
                                 math.sqrt(2.0))
        else:
            sub_mechanisms = []
            for m in self._mechanisms:
                k = m.internal_splits
                sub_mechanisms.extend(
                    [(m.mechanism_spec.mechanism_type, m.sensitivity,
                      m.weight / k)] * k)
            minimum_noise_std = pld_lib.find_minimum_noise_std(
                mechanisms=sub_mechanisms,
                total_epsilon=self._total_epsilon,
                total_delta=self._total_delta,
                discretization=self._pld_discretization)
        self.minimum_noise_std = minimum_noise_std
        for m in self._mechanisms:
            # Weight semantics mirror the reference (:506-524): a mechanism
            # with a larger weight receives proportionally *less* noise.
            # The granted stddev is per SUB-mechanism (each of the k
            # internal splits runs at this noise level).
            k = m.internal_splits
            sub_weight = m.weight / k
            stddev = m.sensitivity * minimum_noise_std / sub_weight
            spec = m.mechanism_spec
            spec.set_noise_standard_deviation(stddev)
            if spec.mechanism_type == MechanismType.GENERIC:
                # Generic mechanisms consume raw (eps, delta), derived from
                # the granted noise level by the shared conversion helper.
                eps0, delta0 = pld_lib.generic_mechanism_eps_delta(
                    stddev, self._total_epsilon, self._total_delta)
                spec.set_eps_delta(k * eps0, k * delta0)
            else:
                # Also publish the EQUIVALENT per-mechanism (eps, delta):
                # the combiner layer calibrates noise from them, and with
                # these values its calibration round-trips to exactly the
                # PLD-granted noise level — which is what makes this
                # accountant work end-to-end with DPEngine (the reference's
                # PLD accountant never could, reference :406). A k-split
                # spec publishes k times the per-sub-mechanism equivalent:
                # the combiner's even split recovers exactly the
                # sub-mechanism (eps, delta) whose calibration yields the
                # granted stddev, so the composition the PLD convolved is
                # the composition that actually runs.
                eps_m, delta_m = self._equivalent_eps_delta(
                    spec.mechanism_type, stddev, m.sensitivity, sub_weight,
                    sum_weights)
                spec.set_eps_delta(k * eps_m, k * delta_m)

    def _equivalent_eps_delta(self, mechanism_type: MechanismType,
                              stddev: float, sensitivity: float,
                              weight: float, sum_weights: float):
        """(eps, delta) whose standard calibration reproduces ``stddev``
        at the spec's registered sensitivity. A downstream combiner
        multiplying in its own (larger) sensitivity scales the granted
        noise proportionally, which is exactly the PLD model's semantics.

        Laplace: noise scale b = sensitivity/eps, so eps =
        sensitivity*sqrt(2)/stddev and delta = 0. Gaussian: fix this
        mechanism's delta share and invert the analytic-Gaussian
        calibration by bisection so gaussian_sigma(eps, delta,
        sensitivity) == stddev."""
        from pipelinedp_tpu_torch.ops import noise as noise_ops

        if mechanism_type == MechanismType.LAPLACE:
            return math.sqrt(2.0) * sensitivity / stddev, 0.0
        # Bisect eps directly on the exact delta(eps) curve at the granted
        # sigma (monotone decreasing in eps); delta is this mechanism's
        # share of the total.
        delta_share = self._total_delta * weight / sum_weights
        lo, hi = 1e-12, 1e12
        for _ in range(80):
            mid = math.sqrt(lo * hi)
            if noise_ops.gaussian_delta(mid, stddev,
                                        sensitivity) > delta_share:
                lo = mid  # too little eps -> too much residual delta
            else:
                hi = mid
        # Returning a bracket endpoint would silently publish an eps whose
        # calibration UNDER-noises relative to the PLD grant — fail loudly
        # instead (never reached for any sane budget).
        recomputed = noise_ops.gaussian_sigma(hi, delta_share, sensitivity)
        if not 0.999 * stddev <= recomputed <= 1.001 * stddev:
            raise ValueError(
                f"could not invert the Gaussian calibration for noise "
                f"std {stddev} (eps bracket [{lo}, {hi}] exhausted)")
        return hi, delta_share
