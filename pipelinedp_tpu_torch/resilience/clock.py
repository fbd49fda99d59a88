"""The injectable clock — the ONLY module allowed to call ``time.sleep``.

Every wait in the library routes through a ``Clock`` so fault tests can
assert a real backoff *schedule* (the exact sleep durations) without
spending wall time: inject a ``FakeClock`` and read ``clock.sleeps``.
``make faultcheck`` greps the tree to keep direct ``time.sleep`` calls
out of every other code path.
"""

from __future__ import annotations

import time as _time
from typing import List


class Clock:
    """Minimal clock interface: ``sleep`` and ``monotonic``."""

    def sleep(self, seconds: float) -> None:
        raise NotImplementedError

    def monotonic(self) -> float:
        raise NotImplementedError


class SystemClock(Clock):
    """Real wall-clock time."""

    def sleep(self, seconds: float) -> None:
        if seconds > 0:
            _time.sleep(seconds)

    def monotonic(self) -> float:
        return _time.monotonic()


class FakeClock(Clock):
    """Virtual time for tests: ``sleep`` records the requested duration
    and advances the virtual clock instantly. ``sleeps`` is the full
    observed schedule, in order."""

    def __init__(self, start: float = 0.0):
        self._now = float(start)
        self.sleeps: List[float] = []

    def sleep(self, seconds: float) -> None:
        self.sleeps.append(float(seconds))
        self._now += float(seconds)

    def monotonic(self) -> float:
        return self._now
