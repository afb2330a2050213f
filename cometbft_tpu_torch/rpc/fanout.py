"""Outbound fan-out plane: one-pass event delivery + height-keyed
commit waiters.

Three structural fixes over the per-subscriber shape this replaces:

- **FanoutHub** — websocket subscribers are grouped by query shape
  (the query string). Each committed block/tx event is flattened to
  query attributes ONCE per event and JSON-encoded ONCE per matching
  group; every member socket then gets a frame spliced from the
  shared payload plus its pre-rendered subscription-id prefix — N
  subscribers over G shapes pay G serializations, not N. The old
  shape (one bus subscription + one pump task + one ``send_json``
  per subscriber) serialized the same block N times and evaluated N
  predicates per publish.
- **CommitWaiterMap** — ``broadcast_tx_commit`` used to open a bus
  subscription per in-flight RPC, each adding a predicate lambda
  evaluated on EVERY publish. Now ONE sync bus listener resolves
  waiters by a dict lookup on the tx hash, so publish cost is O(1)
  in the number of in-flight commit RPCs — and lossless: a bounded
  subscription queue could shed the one Tx event a waiter needs
  under a >queue-size publish burst (a 2048+-tx block), turning a
  successful commit into a false RPC timeout.
- Per-subscriber overflow keeps the shed-and-count semantics of
  ``types/events.py``: a subscriber that stops draining sheds NEW
  frames (counted on its own bounded queue, aggregated under the
  ``rpc.fanout`` registry entry → ``cometbft_queue_dropped_total``)
  while publishers and every other subscriber stay unaffected.

Spans: ``fanout.deliver`` (one event through attrs → group encodes →
member enqueues) on the node's tracer when it is enabled.

A copy of the JAX package's ``rpc/fanout.py``: frames are byte-for-byte
the JAX node's, so a JAX websocket subscriber reads a port node.
"""

from __future__ import annotations

import asyncio
import json
import traceback
from typing import Any, Dict, Optional, Set

from ..abci.types import attr_kvi
from ..obs.queues import InstrumentedQueue
from ..types import events as ev
from ..types.events import SUBSCRIPTION_QUEUE_SIZE
from ..utils.tasks import spawn
from . import encoding as enc

# bounded wait for a cancelled writer/drain task to unwind:
# a closing socket must not leak a mid-send task into loop teardown,
# and a wedged send must not hang the unsubscribe path either
DETACH_WAIT_S = 2.0


def _event_attrs(e: ev.Event) -> Dict[str, list]:
    """Flatten an Event into query-matchable attributes, mirroring the
    reference's composite keys (tm.event + abci event attributes).
    Computed ONCE per event by the hub, shared across every group."""
    attrs: Dict[str, list] = {"tm.event": [e.type_]}
    for k, v in e.attrs.items():
        attrs.setdefault(f"tm.{k}", []).append(str(v))
    if e.type_ == ev.EVENT_TX and isinstance(e.data, dict):
        attrs["tx.height"] = [str(e.data.get("height", ""))]
        if "hash" in e.attrs:
            attrs["tx.hash"] = [e.attrs["hash"].upper()]
        flat = e.data.get("events_flat")
        if flat is not None:
            # the finalize lane already flattened the attributes once
            # (state/native_finalize.py) — read the shared form
            for type_, kvis in flat:
                for k, v, _ in kvis:
                    attrs.setdefault(f"{type_}.{k}", []).append(v)
            return attrs
        result = e.data.get("result")
        for evt in getattr(result, "events", []) or []:
            for a in evt.attributes:
                k, v, _ = attr_kvi(a)
                attrs.setdefault(f"{evt.type_}.{k}", []).append(v)
    return attrs


def _event_json(e: ev.Event) -> Dict[str, Any]:
    if e.type_ == ev.EVENT_NEW_BLOCK and isinstance(e.data, dict):
        return {
            "type": "tendermint/event/NewBlock",
            "value": {"block": enc.block_json(e.data["block"])},
        }
    if e.type_ == ev.EVENT_TX and isinstance(e.data, dict):
        return {
            "type": "tendermint/event/Tx",
            "value": {
                "TxResult": {
                    "height": str(e.data["height"]),
                    "index": e.data["index"],
                    "tx": enc.b64(e.data["tx"]),
                    "result": enc.tx_result_json(e.data["result"]),
                }
            },
        }
    return {"type": f"tendermint/event/{e.type_}", "value": {}}


async def _reap_task(task: Optional[asyncio.Future]) -> None:
    """Cancel + await a task with a bound, swallowing ITS
    cancellation but propagating the caller's."""
    if task is None or task.done():
        return
    task.cancel()
    try:
        # gather(return_exceptions) absorbs the task's own
        # CancelledError; wait_for bounds a send wedged in a dead
        # socket; our own cancellation still propagates
        await asyncio.wait_for(
            asyncio.gather(task, return_exceptions=True), DETACH_WAIT_S
        )
    except asyncio.TimeoutError:
        pass


class FanoutSubscriber:
    """One websocket subscription: a bounded frame queue + a writer
    task. The queue keeps the types/events.py shed-and-count contract
    per subscriber; the writer is the only place this subscriber's
    socket speed matters."""

    __slots__ = ("ws", "sub_id", "query_str", "queue", "task", "_prefix")

    def __init__(
        self,
        ws,
        sub_id,
        query_str: str,
        queue_size: int = SUBSCRIPTION_QUEUE_SIZE,
    ):
        self.ws = ws
        self.sub_id = sub_id
        self.query_str = query_str
        self.queue: InstrumentedQueue = InstrumentedQueue(
            queue_size, name="rpc.fanout.sub"
        )
        self.task: Optional[asyncio.Future] = None
        # the only per-subscriber bytes in a frame: the JSON-RPC
        # envelope with this subscription's id, rendered once here so
        # delivery is a string splice, never a serialization
        self._prefix = (
            '{"jsonrpc": "2.0", "id": ' + json.dumps(sub_id) + ', "result": '
        )

    def offer(self, payload: str) -> bool:
        """Enqueue a frame spliced from the group-shared payload;
        shed-and-count when this subscriber has stopped draining."""
        try:
            self.queue.put_nowait(self._prefix + payload + "}")
            return True
        except asyncio.QueueFull:
            self.queue.count_drop()
            return False


class _Group:
    """Subscribers sharing one query shape: one parse, one match per
    event, one serialization per matching event."""

    __slots__ = ("query_str", "query", "members")

    def __init__(self, query_str: str, query):
        self.query_str = query_str
        self.query = query
        self.members: Set[FanoutSubscriber] = set()


class FanoutHub:
    """One bus subscription fanned out to every websocket subscriber
    in one serialization pass per (event, query shape)."""

    def __init__(self, bus, tracer=None):
        self._bus = bus
        self.tracer = tracer
        self._groups: Dict[str, _Group] = {}
        self._sub = None  # the ONE bus Subscription
        self._drain_task: Optional[asyncio.Future] = None
        self.encodes = 0  # JSON serializations (one per event×group)
        self.delivered = 0  # frames enqueued to subscriber queues
        self.dropped = 0  # frames shed by stalled subscribers

    # --- membership ---------------------------------------------------

    def attach(self, ws, query_str: str, query, sub_id) -> FanoutSubscriber:
        g = self._groups.get(query_str)
        if g is None:
            g = _Group(query_str, query)
            self._groups[query_str] = g
        sub = FanoutSubscriber(ws, sub_id, query_str)
        g.members.add(sub)
        sub.task = spawn(self._writer(sub), name="fanout-writer")
        if self._drain_task is None:
            self._sub = self._bus.subscribe()
            self._drain_task = spawn(self._drain(), name="fanout-drain")
        return sub

    async def detach(self, sub: FanoutSubscriber) -> None:
        """Remove + await the writer (bounded): after this returns no
        task of this subscription can still be mid-send."""
        g = self._groups.get(sub.query_str)
        if g is not None:
            g.members.discard(sub)
            if not g.members:
                self._groups.pop(sub.query_str, None)
        await _reap_task(sub.task)
        sub.task = None
        if not self._groups:
            await self._stop_drain()

    async def detach_all(self, subs) -> None:
        subs = list(subs)
        for sub in subs:
            g = self._groups.get(sub.query_str)
            if g is not None:
                g.members.discard(sub)
                if not g.members:
                    self._groups.pop(sub.query_str, None)
        # concurrent reaps (each wait_for-bounded internally): one
        # DETACH_WAIT_S bounds the whole batch, not per wedged writer
        await asyncio.gather(*(_reap_task(s.task) for s in subs))
        for sub in subs:
            sub.task = None
        if not self._groups:
            await self._stop_drain()

    async def close(self) -> None:
        tasks = [
            s.task
            for g in self._groups.values()
            for s in g.members
            if s.task is not None
        ]
        self._groups.clear()
        t, self._drain_task = self._drain_task, None
        sub, self._sub = self._sub, None
        if sub is not None:
            sub.unsubscribe()
        if t is not None:
            tasks.append(t)
        if tasks:
            # concurrent reaps: each _reap_task is wait_for-bounded at
            # DETACH_WAIT_S internally, so the gather bounds the WHOLE
            # close at DETACH_WAIT_S (not per wedged writer)
            await asyncio.gather(*(_reap_task(task) for task in tasks))

    async def _stop_drain(self) -> None:
        t, self._drain_task = self._drain_task, None
        sub, self._sub = self._sub, None
        if sub is not None:
            sub.unsubscribe()
        await _reap_task(t)

    # --- delivery -----------------------------------------------------

    async def _drain(self) -> None:
        while True:
            event = await self._sub.queue.get()
            try:
                self._deliver(event)
            except Exception:
                # one malformed event must not kill delivery for all
                traceback.print_exc()

    def _deliver(self, event: ev.Event) -> None:
        groups = [g for g in self._groups.values() if g.members]
        if not groups:
            return
        tracer = self.tracer
        span = (
            tracer.span("fanout.deliver", type=event.type_)
            if tracer is not None and tracer.enabled
            else None
        )
        attrs = _event_attrs(event)  # ONCE per event
        ejson = None  # lazy: only events someone matches pay encoding
        n_groups = n_subs = 0
        for g in groups:
            if not g.query.matches(attrs):
                continue
            if ejson is None:
                ejson = _event_json(event)
            payload = json.dumps(
                {"query": g.query_str, "data": ejson, "events": attrs}
            )
            self.encodes += 1
            n_groups += 1
            for sub in g.members:
                if sub.offer(payload):
                    self.delivered += 1
                    n_subs += 1
                else:
                    self.dropped += 1
        if span is not None:
            span.set(groups=n_groups, subs=n_subs)
            span.end()

    async def _writer(self, sub: FanoutSubscriber) -> None:
        try:
            while True:
                frame = await sub.queue.get()
                await sub.ws.send_str(frame)
        except (asyncio.CancelledError, ConnectionError):
            pass
        except Exception:
            traceback.print_exc()

    # --- obs ----------------------------------------------------------

    def queue_stats(self) -> Optional[dict]:
        """Aggregate subscriber backpressure for the obs registry
        (rpc.fanout): depth summed, watermark = worst subscriber,
        drops hub-wide AND MONOTONIC (``self.dropped`` counts every
        shed ever — summing per-member queues would make the counter
        regress when a shedding subscriber detaches, which breaks
        both Prometheus counter semantics and the chaos storm's
        before/after delta). Same convention as events.subs (no
        ``maxsize``: aggregates must not trip the health route's
        full-queue check against a summed depth)."""
        subs = [s for g in self._groups.values() for s in g.members]
        depth = hwm = enqueued = 0
        for s in subs:
            q = s.queue
            depth += q.qsize()
            hwm = max(hwm, q.high_watermark)
            enqueued += q.enqueued
        return {
            "depth": depth,
            "high_watermark": hwm,
            "enqueued": enqueued,
            "dropped": self.dropped,
            "subscribers": len(subs),
            "groups": len(self._groups),
            "encodes": self.encodes,
            "subscriber_maxsize": SUBSCRIPTION_QUEUE_SIZE,
        }


class CommitWaiterMap:
    """Height-keyed commit waiters behind ONE sync bus listener.

    ``register`` parks a future under the tx hash (hex); the listener
    resolves it by dict lookup when the Tx event for that hash is
    published at height commit. Publish cost no longer scales with
    in-flight ``broadcast_tx_commit`` RPCs (each used to add its own
    predicate subscription evaluated on every publish); the gRPC
    broadcast API rides the same map.

    A sync listener rather than a subscription deliberately: a
    bounded subscription queue sheds NEW events when full, and a shed
    Tx event here is not a dropped frame but a waiter that never
    resolves — a committed tx reported as an RPC timeout. The
    listener is O(1) per publish (type check + dict membership) and
    hands resolution to the loop via ``call_soon_threadsafe`` (the
    loop's ready queue, not a bounded asyncio.Queue)."""

    def __init__(self, bus):
        self._bus = bus
        self._waiters: Dict[str, Set[asyncio.Future]] = {}
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._listening = False
        self.resolved = 0

    def _ensure(self) -> None:
        if not self._listening:
            self._loop = asyncio.get_running_loop()
            self._bus.add_sync_listener(self._on_publish)
            self._listening = True

    def _on_publish(self, event) -> None:
        """Publish-path hook (any thread): one type check + one dict
        membership probe; resolution always runs on the loop, where
        ``_waiters`` is mutated. register-before-submit gives the
        happens-before that makes the cross-thread read safe."""
        if event.type_ != ev.EVENT_TX:
            return
        key = event.attrs.get("hash")
        if not key or key not in self._waiters:
            return
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(self._resolve, key, event)
            except RuntimeError:
                pass  # loop torn down mid-publish (shutdown race)

    def _resolve(self, key: str, event) -> None:
        futs = self._waiters.pop(key, None)
        if not futs:
            return
        for f in futs:
            # a waiter that timed out/cancelled between lookup
            # and resolution is skipped, never errored
            if not f.done():
                self.resolved += 1
                f.set_result(event)

    def register(self, tx_hash_hex: str) -> asyncio.Future:
        """Park a waiter BEFORE submitting the tx (same ordering the
        per-tx subscription had: a commit can never race past)."""
        self._ensure()
        fut = asyncio.get_running_loop().create_future()
        self._waiters.setdefault(tx_hash_hex, set()).add(fut)
        return fut

    def unregister(self, tx_hash_hex: str, fut: asyncio.Future) -> None:
        s = self._waiters.get(tx_hash_hex)
        if s is not None:
            s.discard(fut)
            if not s:
                self._waiters.pop(tx_hash_hex, None)

    def size(self) -> int:
        return sum(len(s) for s in self._waiters.values())

    async def close(self) -> None:
        if self._listening:
            self._bus.remove_sync_listener(self._on_publish)
            self._listening = False
        for s in self._waiters.values():
            for f in s:
                if not f.done():
                    f.cancel()
        self._waiters.clear()
