"""Exponential backoff with full jitter and a cap.

A copy of the JAX package's ``utils/backoff.py``: the one policy of
every reconnect/retry path (the p2p switch's reconnect plane, and any
future dial/retry loop). Full
jitter (delay_n = uniform(0, min(cap, base * factor**n))) spreads
synchronized reconnect storms better than equal jitter: after a
network-wide event every node would otherwise redial on the same
schedule.

The class is loop-agnostic: ``next_delay()`` is a pure draw, usable
from sync and async code alike. Pass a seeded ``random.Random`` for
deterministic schedules.
"""

from __future__ import annotations

import random
from typing import Optional


class Backoff:
    """Successive ``next_delay()`` calls return jittered, exponentially
    growing delays: uniform(0, min(cap_s, base_s * factor**attempt))."""

    def __init__(
        self,
        base_s: float = 1.0,
        cap_s: float = 30.0,
        factor: float = 2.0,
        rng: Optional[random.Random] = None,
    ):
        if base_s <= 0 or cap_s < base_s or factor < 1.0:
            raise ValueError(
                f"bad backoff params base={base_s} cap={cap_s} factor={factor}"
            )
        self.base_s = base_s
        self.cap_s = cap_s
        self.factor = factor
        self._rng = rng or random.Random()
        self.attempt = 0

    def ceiling(self) -> float:
        """Current un-jittered ceiling (exposed for tests/metrics)."""
        return min(self.cap_s, self.base_s * self.factor ** self.attempt)

    def next_delay(self) -> float:
        d = self._rng.uniform(0.0, self.ceiling())
        self.attempt += 1
        return d

    def reset(self) -> None:
        """Back to the first attempt (call after a success)."""
        self.attempt = 0
