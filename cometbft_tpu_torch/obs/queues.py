"""Backpressure telemetry: instrumented bounded queues + a per-node
registry. A copy of the JAX package's ``obs/queues.py``.

Every bounded queue in the hot planes (mempool ingest, p2p per-peer
send channels, consensus inbox, event-bus subscribers, blocksync pool
window, parallel-verify dispatch) reports three things the RPC
``health`` route and /metrics need:

- **depth** — current backlog (a queue pinned at depth ~maxsize is
  the upstream cause of every "mysteriously slow" span downstream);
- **high watermark** — worst backlog since start (a queue that
  *touched* its bound under a burst sheds next time);
- **dropped** — unified shed counter: every plane that sheds under
  overload counts it here (``count_drop``), so "are we losing work"
  is one number per queue instead of per-plane conventions.

``InstrumentedQueue`` subclasses ``asyncio.Queue``; ``put()`` funnels
through ``put_nowait`` in CPython, so overriding the latter covers
both entries with two attribute writes and a compare.

``QueueRegistry`` holds callables, not queues: planes recreate their
queues across start/stop (the ingest queue) or fan out per peer (p2p
send channels), so an entry is a ``stats_fn() -> dict | None``
evaluated at read time.
"""

from __future__ import annotations

import asyncio
import threading
from typing import Callable, Dict, Optional


class InstrumentedQueue(asyncio.Queue):
    """asyncio.Queue + depth/high-watermark/shed telemetry."""

    def __init__(self, maxsize: int = 0, *, name: str = "") -> None:
        super().__init__(maxsize)
        self.name = name
        self.high_watermark = 0
        self.enqueued = 0
        self.dropped = 0

    def put_nowait(self, item) -> None:
        super().put_nowait(item)
        self.enqueued += 1
        n = self.qsize()
        if n > self.high_watermark:
            self.high_watermark = n

    def count_drop(self, n: int = 1) -> None:
        """Callers that shed under overload (QueueFull, overflow
        policies) count the loss here — the unified drop counter."""
        self.dropped += n

    def stats(self) -> dict:
        return {
            "depth": self.qsize(),
            "high_watermark": self.high_watermark,
            "enqueued": self.enqueued,
            "dropped": self.dropped,
            "maxsize": self.maxsize,
        }


class InstrumentedGate:
    """Thread-safe bounded-concurrency gate with the same stats
    contract as InstrumentedQueue (depth = current holders).

    The light-client serving plane admits request work through one of
    these (light/serving.py): ``try_enter`` never blocks — overload is
    a SHED (counted in ``dropped``), not a queue, so a thousand
    stalled sessions can't pile unbounded work behind a slow verify.
    Registered in a QueueRegistry exactly like a queue; ``maxsize``
    keeps the health route's depth>=maxsize overload convention.
    """

    def __init__(self, limit: int, *, name: str = "") -> None:
        if limit < 1:
            raise ValueError("gate limit must be >= 1")
        self.name = name
        self.limit = limit
        self._cond = threading.Condition()
        self._holders = 0
        self.high_watermark = 0
        self.entered = 0
        self.dropped = 0

    def _admit_locked(self) -> None:
        self._holders += 1
        self.entered += 1
        if self._holders > self.high_watermark:
            self.high_watermark = self._holders

    def try_enter(self) -> bool:
        with self._cond:
            if self._holders >= self.limit:
                self.dropped += 1
                return False
            self._admit_locked()
            return True

    def enter(self, timeout: float = 0.0) -> bool:
        """Admit, waiting up to ``timeout`` seconds for a slot (a
        BOUNDED wait absorbs admission bursts without letting work
        pile unbounded); past the timeout the request is shed and
        counted."""
        with self._cond:
            if self._holders < self.limit:
                self._admit_locked()
                return True
            if timeout > 0 and self._cond.wait_for(
                lambda: self._holders < self.limit, timeout=timeout
            ):
                self._admit_locked()
                return True
            self.dropped += 1
            return False

    def exit(self) -> None:
        with self._cond:
            if self._holders > 0:
                self._holders -= 1
            self._cond.notify()

    def count_drop(self, n: int = 1) -> None:
        with self._cond:
            self.dropped += n

    def wait_idle(self, timeout: float) -> bool:
        """Bounded wait for every holder to exit (drain paths: the
        caller stops admitting first, then waits in-flight work out)."""
        with self._cond:
            return self._cond.wait_for(
                lambda: self._holders == 0, timeout=timeout
            )

    def depth(self) -> int:
        return self._holders

    def stats(self) -> dict:
        return {
            "depth": self._holders,
            "high_watermark": self.high_watermark,
            "enqueued": self.entered,
            "dropped": self.dropped,
            "maxsize": self.limit,
        }


StatsFn = Callable[[], Optional[dict]]


class QueueRegistry:
    """Named, callback-backed queue stats for one node."""

    def __init__(self) -> None:
        self._entries: Dict[str, StatsFn] = {}

    def register(self, name: str, stats_fn: StatsFn) -> None:
        """``stats_fn`` returns a stats dict (depth required; the
        rest optional) or None when the plane is not running.

        Convention: ``maxsize`` means "this entry is ONE bounded
        queue and depth >= maxsize is an overload condition" — the
        health route flags it degraded. Entries that aggregate
        several queues (p2p.send, events.subs) or whose bound is a
        soft target (blocksync window, verify dispatch) must use a
        different field name (per_channel_maxsize, window_target,
        ...) so a summed depth is never compared to a per-queue
        bound."""
        self._entries[name] = stats_fn

    def register_queue(
        self, name: str, queue_fn: Callable[[], Optional[InstrumentedQueue]]
    ) -> None:
        """Register a queue that may be rebuilt across restarts."""

        def stats() -> Optional[dict]:
            q = queue_fn()
            return None if q is None else q.stats()

        self.register(name, stats)

    def names(self):
        return sorted(self._entries)

    def get(self, name: str) -> Optional[dict]:
        fn = self._entries.get(name)
        if fn is None:
            return None
        try:
            return fn()
        except Exception:
            # a mid-teardown plane must not break a health scrape
            return None

    def snapshot(self) -> Dict[str, dict]:
        out: Dict[str, dict] = {}
        for name in self.names():
            s = self.get(name)
            if s is not None:
                out[name] = s
        return out

    def high_watermarks(self) -> Dict[str, int]:
        return {
            name: int(s.get("high_watermark", 0))
            for name, s in self.snapshot().items()
        }

    def total_dropped(self) -> int:
        return sum(
            int(s.get("dropped", 0)) for s in self.snapshot().values()
        )
