"""Shared scalar validators for privacy parameters.

Capability parity with the reference's ``pipeline_dp/input_validators.py:17-34``
(epsilon strictly positive, delta in [0, 1)), written fresh for the TPU build.
"""

from __future__ import annotations


def validate_epsilon_delta(epsilon: float, delta: float, who: str) -> None:
    """Raises ValueError unless ``epsilon > 0`` and ``0 <= delta < 1``.

    Args:
      epsilon: the epsilon privacy parameter.
      delta: the delta privacy parameter.
      who: name of the calling object, used in error messages.
    """
    if epsilon is None:
        raise ValueError(f"{who}: epsilon must be set")
    if delta is None:
        raise ValueError(f"{who}: delta must be set")
    if epsilon <= 0:
        raise ValueError(
            f"{who}: epsilon must be positive, not {epsilon}.")
    if delta < 0 or delta >= 1:
        raise ValueError(
            f"{who}: delta must be in [0, 1), not {delta}.")
