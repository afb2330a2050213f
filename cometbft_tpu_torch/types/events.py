"""EventBus: typed pub/sub for consensus/tx events (reference types/event_bus.go).

Subscriptions are predicate-filtered asyncio queues; synchronous
fan-out mirrors the reference's evsw semantics for reactor-internal
listeners (gossip wakeups must not miss events).

A copy of the JAX package's ``types/events.py``; the bus's lock is
the runtime sanitizer's ``events.bus`` (``analysis/runtime.py``: the
raw lock when the sanitizer is off).
"""

from __future__ import annotations

import asyncio
import threading
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

from ..analysis.runtime import sanitized_lock
from ..obs.queues import InstrumentedQueue


# per-subscriber queue bound: a subscriber that stops draining sheds
# (events dropped + counted) instead of growing the queue without
# bound until the process dies — the outbound analog of the mempool
# ingest queue's overload policy
SUBSCRIPTION_QUEUE_SIZE = 2048

EVENT_NEW_BLOCK = "NewBlock"
EVENT_NEW_BLOCK_HEADER = "NewBlockHeader"
EVENT_NEW_BLOCK_EVENTS = "NewBlockEvents"
EVENT_TX = "Tx"
EVENT_NEW_ROUND_STEP = "NewRoundStep"
EVENT_NEW_ROUND = "NewRound"
EVENT_COMPLETE_PROPOSAL = "CompleteProposal"
EVENT_VOTE = "Vote"
EVENT_POLKA = "Polka"
EVENT_LOCK = "Lock"
EVENT_VALIDATOR_SET_UPDATES = "ValidatorSetUpdates"
EVENT_NEW_EVIDENCE = "NewEvidence"
EVENT_TIMEOUT_PROPOSE = "TimeoutPropose"
EVENT_TIMEOUT_WAIT = "TimeoutWait"


@dataclass
class Event:
    type_: str
    data: Any
    attrs: Dict[str, str] = field(default_factory=dict)


class Subscription:
    def __init__(
        self,
        bus: "EventBus",
        match: Callable[[Event], bool],
        queue_size: int = SUBSCRIPTION_QUEUE_SIZE,
    ):
        self._bus = bus
        self._match = match
        self.queue: InstrumentedQueue = InstrumentedQueue(queue_size, name="events.sub")

    def _offer(self, event: "Event") -> None:
        """Non-blocking delivery with shed-and-count overflow: when a
        subscriber stops draining, NEW events are dropped (counted on
        its queue + the bus) and the backlog it already holds stays
        intact — publishers and other subscribers never block behind
        it, and a resumed drainer sees a gap-free prefix followed by
        a counted gap."""
        try:
            self.queue.put_nowait(event)
        except asyncio.QueueFull:
            self.queue.count_drop()
            self._bus.dropped += 1

    def unsubscribe(self):
        self._bus._remove(self)


class EventBus:
    """Thread-safe publish; async + sync consumption."""

    def __init__(self):
        self._subs: List[Subscription] = []
        self._sync_listeners: List[Callable[[Event], None]] = []
        self._lock = sanitized_lock(threading.Lock(), "events.bus")
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self.dropped = 0  # events shed across all subscribers

    def set_loop(self, loop: asyncio.AbstractEventLoop):
        self._loop = loop

    def subscribe(
        self, match: Optional[Callable[[Event], bool]] = None
    ) -> Subscription:
        sub = Subscription(self, match or (lambda e: True))
        with self._lock:
            self._subs.append(sub)
        return sub

    def subscribe_type(self, type_: str) -> Subscription:
        return self.subscribe(lambda e, t=type_: e.type_ == t)

    def add_sync_listener(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            self._sync_listeners.append(fn)

    def remove_sync_listener(self, fn: Callable[[Event], None]) -> None:
        with self._lock:
            if fn in self._sync_listeners:
                self._sync_listeners.remove(fn)

    def _remove(self, sub: Subscription):
        with self._lock:
            if sub in self._subs:
                self._subs.remove(sub)

    def publish(self, event: Event) -> None:
        with self._lock:
            subs = list(self._subs)
            listeners = list(self._sync_listeners)
        for fn in listeners:
            fn(event)
        for sub in subs:
            if sub._match(event):
                if self._loop is not None and not self._loop.is_closed():
                    self._loop.call_soon_threadsafe(sub._offer, event)
                else:
                    sub._offer(event)

    def queue_stats(self) -> dict:
        """Aggregate subscriber-queue backpressure (obs registry):
        depth summed, watermark = worst subscriber, drops bus-wide."""
        with self._lock:
            subs = list(self._subs)
        depth = hwm = enqueued = 0
        for sub in subs:
            q = sub.queue
            depth += q.qsize()
            hwm = max(hwm, q.high_watermark)
            enqueued += q.enqueued
        # no "maxsize": this entry AGGREGATES over subscribers, and
        # the health route's full-queue check compares depth against
        # maxsize — a per-subscriber bound must not be compared with
        # a summed depth (obs/queues.py convention: aggregates and
        # soft targets use a differently-named field)
        return {
            "depth": depth,
            "high_watermark": hwm,
            "enqueued": enqueued,
            "dropped": self.dropped,
            "subscribers": len(subs),
            "subscriber_maxsize": SUBSCRIPTION_QUEUE_SIZE,
        }

    # convenience publishers (reference event_bus.go PublishEventX)
    def publish_type(self, type_: str, data: Any, **attrs) -> None:
        self.publish(Event(type_, data, {k: str(v) for k, v in attrs.items()}))
