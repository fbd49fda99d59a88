"""Bounded retry with exponential backoff and deterministic jitter.

The jitter is drawn from a seeded ``numpy`` generator so a policy's
backoff schedule is a pure function of its fields: tests (and incident
reproductions) see the exact same delays every run. Jitter still does
its job in production — distinct seeds (e.g. per process id) decorrelate
thundering-herd retries.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Type

import numpy as np

from pipelinedp_tpu_torch.resilience.clock import Clock, SystemClock


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Exponential backoff: attempt k (0-based) failing sleeps
    ``min(base_delay_s * multiplier**k, max_delay_s)`` scaled by a
    deterministic jitter factor in ``[1 - jitter, 1 + jitter]``."""

    max_attempts: int = 3
    base_delay_s: float = 1.0
    multiplier: float = 2.0
    max_delay_s: float = 30.0
    jitter: float = 0.1
    seed: int = 0

    def delays(self) -> List[float]:
        """The full backoff schedule (``max_attempts - 1`` entries),
        deterministic for a given policy."""
        # lint: disable=rng-purity(seeded backoff jitter, not DP noise)
        rng = np.random.default_rng(self.seed)
        out = []
        for k in range(max(0, self.max_attempts - 1)):
            d = min(self.base_delay_s * self.multiplier**k,
                    self.max_delay_s)
            u = 2.0 * rng.random() - 1.0  # [-1, 1)
            out.append(d * (1.0 + self.jitter * u))
        return out


class RetriesExhausted(Exception):
    """All attempts failed. Carries the attempt count and last error."""

    def __init__(self, attempts: int, last_error: BaseException):
        super().__init__(
            f"all {attempts} attempts failed; last error: {last_error!r}")
        self.attempts = attempts
        self.last_error = last_error


def call_with_retry(fn: Callable,
                    policy: Optional[RetryPolicy] = None,
                    clock: Optional[Clock] = None,
                    retry_on: Tuple[Type[BaseException], ...] = (Exception,),
                    on_retry: Optional[Callable] = None,
                    label: Optional[str] = None):
    """Call ``fn()`` up to ``policy.max_attempts`` times, sleeping the
    policy's deterministic backoff schedule (via ``clock``) between
    attempts. ``on_retry(attempt, delay_s, error)`` is invoked before
    each sleep. Raises ``RetriesExhausted`` wrapping the last error.

    Every retry attempt (with its backoff delay) and every exhaustion
    is also recorded in the run ledger (``pipelinedp_tpu_torch.obs``) under
    ``label`` — retries used to be invisible unless a caller wired its
    own ``on_retry``."""
    from pipelinedp_tpu_torch import obs

    policy = policy or RetryPolicy()
    clock = clock or SystemClock()
    label = label or getattr(fn, "__qualname__", repr(fn))
    delays = policy.delays()
    last: Optional[BaseException] = None
    for attempt in range(policy.max_attempts):
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 — per-attempt handling
            last = e
            if attempt < policy.max_attempts - 1:
                delay = delays[attempt]
                obs.inc("retry.attempts")
                obs.event("retry.attempt", label=label, attempt=attempt,
                          delay_s=float(delay), error=repr(e))
                if on_retry is not None:
                    on_retry(attempt, delay, e)
                clock.sleep(delay)
    obs.inc("retry.exhausted")
    obs.event("retry.exhausted", label=label,
              attempts=policy.max_attempts, error=repr(last))
    raise RetriesExhausted(policy.max_attempts, last)
