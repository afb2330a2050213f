"""Unified verify scheduler: ONE dispatch queue for every consumer of
signature verification.

The port's counterpart of the JAX package's ``crypto/scheduler.py``.
Commit validation (``types/validation.py``) and the vote coalescer
(``crypto/coalesce.py``) submit here:

- **Priority classes**: live round (0) > light session (1) >
  catch-up/evidence (2). Host work is dispatched one calibrated chunk
  at a time (~4 ms of serial work, ``parallel_verify.chunk_size``), so
  a live ticket that arrives during a storm is served at the next
  chunk boundary, not behind the storm's residue.
- **Starvation guard**: a ticket queued longer than
  ``promote_after_s`` is served ahead of higher classes once every
  ``promote_every`` picks, so catch-up keeps a bounded share of
  dispatch slots under any sustained live load.
- **Calibrated routing**: a ticket of the "cuda" backend (the
  default; ``crypto/batch``'s ``CudaBatchVerifier`` submits here too)
  routes its ed25519 lanes by ``batch.route_to_device``: the floor and
  the measured host-vs-device crossover. Device dispatches are
  asynchronous: a watcher thread blocks on the dispatch's CUDA event,
  feeds the calibration (unforced "cuda" dispatches on a CUDA device
  only)
  and resolves the ticket.
- **Device**: a ticket carries the device it was submitted for
  (``device=None`` is the GPU and raises without one).

Departure from the JAX package: there, a failed device route is hidden
behind host verification (the dispatch's ``except``, the watcher's
per-item fallback and the dispatcher's serial fallback). Here a
failure anywhere on a ticket's route — the device dispatch, its
readiness or its verdicts — resolves the ticket with a
``DeviceRouteError`` chained to that exception: ``result()`` raises it
and ``degraded`` counts it. Whatever the cause (a CUDA error, a
``ValueError`` of a kernel's shape checks, an ``OSError`` loading a
kernel library), a caller tells a failed route from a verdict on the
signatures by that one type. No ticket is
resolved with host verdicts in place of the device's. A failing host
chunk still falls back to per-item host verification, as in the JAX
package.

Waiting: ``resolved(ticket)`` awaits a ticket on an event loop without
holding a thread (an executor thread blocked on a ticket that never
resolves keeps its process from exiting), and ``close`` resolves every
ticket it leaves unrouted with a ``DeviceRouteError``, so no waiter is
left blocked by a closed scheduler.

- **Mesh**: a ticket of the "mesh" backend (``crypto/mesh_backend``)
  sends its ed25519 lanes to its device with no calibration gate once
  they reach the floor; ``ops/ed25519`` splits them over every card
  when more than one is visible. With no card at all the ticket's
  backend reads "mesh-degraded", ``degraded`` counts it and its lanes
  go to the host plane, as the JAX package does without a mesh: a
  routing choice, not a failure. (The JAX package also degrades with
  one device; here one card takes the lanes.) A failed mesh dispatch
  raises like any other device route (C3).
"""

from __future__ import annotations

import asyncio
import threading
import time
from collections import deque
from typing import List, Optional, Sequence, Tuple

from ..device import resolve
from ..trace import global_tracer
from ..utils.log import get_logger
from . import batch as crypto_batch

_log = get_logger("crypto.sched")

# Priority classes, lower value = served first.
PRIORITY_LIVE = 0
PRIORITY_LIGHT = 1
PRIORITY_CATCHUP = 2

CLASS_NAMES = ("live", "light", "catchup")

# Starvation guard defaults: a ticket queued longer than this is
# "aged"; one aged chunk is served per PROMOTE_EVERY picks while any
# aged ticket exists.
DEFAULT_PROMOTE_AFTER_S = 0.25
DEFAULT_PROMOTE_EVERY = 4

# backends whose lanes the scheduler routes itself; any other
# registered backend verifies a whole ticket through its own verifier
_ROUTED_BACKENDS = ("cuda", "cpu", "cpu-parallel", "mesh")


class DeviceRouteError(RuntimeError):
    """A ticket's verify route failed; ``__cause__`` holds the error.
    No verdict on any lane: the signatures were not checked."""


def _clamp_priority(priority) -> int:
    try:
        p = int(priority)
    except (TypeError, ValueError):
        return PRIORITY_CATCHUP
    return min(max(p, PRIORITY_LIVE), PRIORITY_CATCHUP)


class VerifyTicket:
    """One submitted batch: ``result()`` blocks for the merged
    verdicts and returns ``(all_ok, oks)`` like the BatchVerifier
    handles, or raises ``DeviceRouteError`` if its route failed."""

    __slots__ = (
        "items", "priority", "label", "device", "t_submit", "t_done", "oks",
        "backend", "_chunks", "_units_left", "_event", "_routed", "_error",
        "_callbacks",
    )

    def __init__(self, items, priority: int, label: str, device=None) -> None:
        self.items = items
        self.priority = priority
        self.label = label
        self.device = device
        self.t_submit = time.perf_counter()
        self.t_done: Optional[float] = None
        self.oks: List[bool] = [False] * len(items)
        self.backend: Optional[str] = None
        self._chunks: deque = deque()
        self._units_left = 0
        self._event = threading.Event()
        self._routed = False
        self._error: Optional[BaseException] = None
        self._callbacks: list = []

    def result(self, timeout: Optional[float] = None) -> Tuple[bool, List[bool]]:
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"verify ticket ({len(self.items)} lanes, "
                f"class={CLASS_NAMES[self.priority]}) not resolved "
                f"within {timeout}s"
            )
        if self._error is not None:
            raise self._error
        oks = self.oks
        return all(oks) and bool(oks), oks

    def done(self) -> bool:
        return self._event.is_set()

    def add_done_callback(self, fn) -> None:
        """Call ``fn(ticket)`` once, when the ticket resolves (now, if
        it has), on the thread that resolves it."""
        self._callbacks.append(fn)
        if self._event.is_set():
            self._run_callbacks()

    def _run_callbacks(self) -> None:
        # list.pop is atomic: each callback runs once, whichever of the
        # resolving and the registering thread pops it
        while True:
            try:
                fn = self._callbacks.pop()
            except IndexError:
                return
            fn(self)

    def wall(self) -> Optional[float]:
        """Submit → resolve wall (queue wait included: the latency the
        priority classes exist to bound), or None while pending."""
        done = self.t_done
        return None if done is None else done - self.t_submit


class VerifyScheduler:
    """Single dispatch queue with priority classes. Thread-safe; one
    daemon dispatcher thread, started on the first submit."""

    def __init__(
        self,
        promote_after_s: float = DEFAULT_PROMOTE_AFTER_S,
        promote_every: int = DEFAULT_PROMOTE_EVERY,
    ) -> None:
        self.promote_after_s = promote_after_s
        self.promote_every = max(1, promote_every)
        self._cv = threading.Condition()
        self._queues: Tuple[deque, ...] = (deque(), deque(), deque())
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._promo_credit = 0
        # host-pool backpressure: chunks in flight on the shared pool,
        # bounded to the worker count, so a late live ticket waits at
        # most one chunk wall per worker
        self._inflight = 0
        self._max_slots: Optional[int] = None
        self.enqueued_lanes = 0
        self.done_lanes = 0
        self.enqueued_by_class = [0, 0, 0]
        self.done_by_class = [0, 0, 0]
        self.depth_hwm = 0
        self.promoted = 0
        self.device_dispatches = 0
        self.host_chunks = 0
        self.degraded = 0
        self.tickets = 0

    # --- submission ----------------------------------------------------

    def submit(
        self,
        items: Sequence,
        priority: int = PRIORITY_CATCHUP,
        label: str = "",
        device=None,
        backend: Optional[str] = None,
    ) -> VerifyTicket:
        """Queue (pubkey, msg, sig) lanes for verification on
        ``device`` under a priority class; returns a VerifyTicket at
        once. ``backend`` names the registered backend that verifies
        the ticket; None is the process default, read when the ticket
        is routed."""
        dev = resolve(device)
        priority = _clamp_priority(priority)
        ticket = VerifyTicket(list(items), priority, label, dev)
        ticket.backend = backend
        if not ticket.items:
            # an empty batch resolves to (False, []) like BatchVerifier
            ticket.t_done = ticket.t_submit
            ticket._event.set()
            return ticket
        with self._cv:
            if self._closed:
                raise RuntimeError("verify scheduler closed")
            self.tickets += 1
            n = len(ticket.items)
            self.enqueued_lanes += n
            self.enqueued_by_class[priority] += n
            self._queues[priority].append(ticket)
            depth = self.enqueued_lanes - self.done_lanes
            if depth > self.depth_hwm:
                self.depth_hwm = depth
            if self._thread is None:
                self._thread = threading.Thread(
                    target=self._loop, name="verify-sched", daemon=True
                )
                self._thread.start()
            self._cv.notify_all()
        return ticket

    # --- dispatcher ----------------------------------------------------

    def _slots(self) -> int:
        if self._max_slots is None:
            from .parallel_verify import engine

            self._max_slots = max(1, engine().workers)
        return self._max_slots

    def _pick_locked(self) -> Optional[VerifyTicket]:
        """Highest-priority non-empty class, with the bounded aging
        promotion. Caller holds the lock."""
        best_cls = None
        for cls in (PRIORITY_LIVE, PRIORITY_LIGHT, PRIORITY_CATCHUP):
            if self._queues[cls]:
                best_cls = cls
                break
        if best_cls is None:
            return None
        now = time.perf_counter()
        aged = None
        for cls in range(best_cls + 1, len(self._queues)):
            q = self._queues[cls]
            if q and now - q[0].t_submit > self.promote_after_s:
                if aged is None or q[0].t_submit < aged.t_submit:
                    aged = q[0]
        if aged is not None:
            self._promo_credit += 1
            if self._promo_credit >= self.promote_every:
                self._promo_credit = 0
                self.promoted += 1
                return aged
        return self._queues[best_cls][0]

    def _loop(self) -> None:
        while True:
            with self._cv:
                ticket = None
                while True:
                    if self._inflight < self._slots():
                        ticket = self._pick_locked()
                    if ticket is not None or self._closed:
                        break
                    # bounded wait: aging must be re-evaluated even
                    # with no new submissions
                    self._cv.wait(0.05)
                if ticket is None:
                    return
                if ticket._routed:
                    chunk = ticket._chunks.popleft()
                    if not ticket._chunks:
                        self._queues[ticket.priority].remove(ticket)
                else:
                    chunk = None
                    self._queues[ticket.priority].remove(ticket)
            if chunk is None:
                try:
                    self._route(ticket)
                except Exception as e:
                    _log.error(
                        "verify route failed; the ticket raises",
                        backend=ticket.backend or "?",
                        err=repr(e),
                        lanes=len(ticket.items),
                    )
                    self._fail(ticket, e)
                continue
            try:
                self._run_chunk(ticket, chunk)
            except Exception as e:
                _log.error(
                    "host chunk failed; per-item host verification",
                    err=repr(e),
                    lanes=len(chunk),
                )
                for i in chunk:
                    ticket.oks[i] = _host_verify_one(ticket.items[i])
                self._unit_done(ticket)

    # --- routing -------------------------------------------------------

    def _route(self, ticket: VerifyTicket) -> None:
        """First pop: split lanes by curve, take the calibrated routing
        decision, dispatch the device part asynchronously, queue the
        host part as calibrated chunks."""
        items = ticket.items
        backend = ticket.backend or crypto_batch.default_backend()
        ticket.backend = backend
        if backend not in _ROUTED_BACKENDS:
            # a custom registered backend keeps its semantics: build it
            # and resolve the whole ticket on the dispatcher thread
            verifier = crypto_batch.create_batch_verifier(device=ticket.device, backend=backend)
            for pk, msg, sig in items:
                verifier.add(pk, msg, sig)
            _, oks = verifier.verify()
            ticket.oks[:] = oks
            ticket._routed = True
            self._finish(ticket)
            return
        ed_idx, ed_items, other_idx = crypto_batch.split_curves(items)
        if backend == "mesh":
            # the operator's choice: the cards whenever one is visible,
            # no calibration gate; the floor keeps tiny batches on the
            # host, and with no card the ticket degrades to it
            from .mesh_backend import mesh_devices, use_mesh

            devices = mesh_devices()
            use_device = use_mesh(len(ed_items), devices)
            if not devices:
                ticket.backend = "mesh-degraded"
                with self._cv:
                    self.degraded += 1
        else:
            use_device = backend == "cuda" and crypto_batch.route_to_device(
                len(ed_items), ticket.device
            )
        # lanes of other curves: verified inline at route time
        for i in other_idx:
            pk, msg, sig = items[i]
            ticket.oks[i] = pk.verify(msg, sig)
        ticket._routed = True
        if use_device and ed_idx:
            self._dispatch_device(ticket, ed_idx, ed_items)
        else:
            self._queue_host_chunks(ticket, ed_idx)

    def _dispatch_device(self, ticket: VerifyTicket, ed_idx, ed_items) -> None:
        """Asynchronous device dispatch of the ed25519 lanes. A daemon
        watcher blocks on the dispatch's CUDA event, feeds the
        calibration with the wall from just before the dispatch
        (host packing included) when the route was not forced and the
        ticket is a "cuda" one on a CUDA device, and resolves the
        ticket; any failure there resolves the ticket with a
        DeviceRouteError. A failure of the dispatch itself propagates
        to the dispatcher loop, which does the same."""
        from ..ops import ed25519 as _ed

        t0 = time.perf_counter()
        handle = _ed.verify_batch_async(ed_items, device=ticket.device)
        with self._cv:
            self.device_dispatches += 1
            ticket._units_left += 1
        n_ed = len(ed_items)
        cal = crypto_batch.calibration
        observe = (
            crypto_batch._MIN_DEVICE_BATCH > 1
            and ticket.device.type == "cuda"
            and ticket.backend == "cuda"
        )

        def _watch():
            try:
                handle.wait()
                if observe:
                    cal.observe_device(n_ed, time.perf_counter() - t0)
                verdicts = handle.result()
            except Exception as e:
                _log.error(
                    "device resolve failed; the ticket raises",
                    err=repr(e),
                    lanes=n_ed,
                )
                self._fail(ticket, e)
                return
            for i, v in zip(ed_idx, verdicts):
                ticket.oks[i] = bool(v)
            self._unit_done(ticket)

        threading.Thread(target=_watch, name="verify-sched-dev", daemon=True).start()

    def _queue_host_chunks(self, ticket: VerifyTicket, ed_idx) -> None:
        """Chunk the host-routed ed25519 lanes (the preemption
        granularity) and requeue the ticket at the FRONT of its class,
        so its chunks drain before later arrivals of that class."""
        if not ed_idx:
            self._finish(ticket)
            return
        from .parallel_verify import engine

        chunk = engine().chunk_size(len(ed_idx))
        chunks = [ed_idx[s : s + chunk] for s in range(0, len(ed_idx), chunk)]
        with self._cv:
            ticket._chunks.extend(chunks)
            ticket._units_left += len(chunks)
            self._queues[ticket.priority].appendleft(ticket)
            self._cv.notify_all()

    # --- host execution ------------------------------------------------

    def _run_chunk(self, ticket: VerifyTicket, idx_chunk) -> None:
        """One host chunk: on the shared pool when it pays (slot-bounded
        so priorities hold at chunk granularity), inline on the
        dispatcher thread otherwise (serial tier, small tickets, the
        sequential "cpu" backend)."""
        from .parallel_verify import _verify_chunk, engine

        eng = engine()
        chunk_items = [ticket.items[i] for i in idx_chunk]
        with self._cv:
            self.host_chunks += 1
        pool = None
        if ticket.backend != "cpu" and len(ticket.items) >= eng.min_parallel:
            pool = eng._ensure_pool()
        if pool is None:
            oks, wall = _verify_chunk(chunk_items, eng.tier)
            self._chunk_resolved(ticket, idx_chunk, oks, wall, eng)
            return
        if eng.tier == "process":
            chunk_items = [(pk, bytes(m), bytes(s)) for pk, m, s in chunk_items]
        with self._cv:
            self._inflight += 1
        try:
            fut = pool.submit(_verify_chunk, chunk_items, eng.tier)
        except RuntimeError:
            # pool shut down underneath us (teardown): inline
            with self._cv:
                self._inflight -= 1
            oks, wall = _verify_chunk(chunk_items, eng.tier)
            self._chunk_resolved(ticket, idx_chunk, oks, wall, eng)
            return
        eng._chunk_submitted()

        def _done(f):
            eng._chunk_done()
            with self._cv:
                self._inflight -= 1
                self._cv.notify_all()
            try:
                oks, wall = f.result()
            except Exception:  # a worker died: the host path still answers
                oks = [_host_verify_one(ticket.items[i]) for i in idx_chunk]
                wall = 0.0
            self._chunk_resolved(ticket, idx_chunk, oks, wall, eng)

        fut.add_done_callback(_done)

    def _chunk_resolved(self, ticket, idx_chunk, oks, wall, eng) -> None:
        for i, ok in zip(idx_chunk, oks):
            ticket.oks[i] = bool(ok)
        if wall:
            n = len(idx_chunk)
            eng._observe_chunk(n, wall)
            if ticket.backend == "cuda":
                # the host-vs-device EWMA is fed only on the backend
                # whose routing reads it
                crypto_batch.calibration.observe_host(n, wall)
        self._unit_done(ticket)

    # --- completion ----------------------------------------------------

    def _unit_done(self, ticket: VerifyTicket) -> None:
        with self._cv:
            ticket._units_left -= 1
            last = ticket._units_left <= 0 and not ticket._chunks
        if last:
            self._finish(ticket)

    def _fail(self, ticket: VerifyTicket, exc: BaseException) -> None:
        if not isinstance(exc, DeviceRouteError):
            err = DeviceRouteError(f"verify route failed ({len(ticket.items)} lanes): {exc!r}")
            err.__cause__ = exc
            exc = err
        with self._cv:
            self.degraded += 1
            if ticket._error is None:
                ticket._error = exc
        self._finish(ticket)

    def _finish(self, ticket: VerifyTicket) -> None:
        with self._cv:
            if ticket.t_done is not None:
                return
            ticket.t_done = time.perf_counter()
            n = len(ticket.items)
            self.done_lanes += n
            self.done_by_class[ticket.priority] += n
            self._cv.notify_all()
        tr = global_tracer()
        if tr.enabled:
            dur_ns = int((ticket.t_done - ticket.t_submit) * 1e9)
            tr.complete(
                "crypto.sched.dispatch",
                time.monotonic_ns() - dur_ns,
                dur_ns,
                tid="crypto.sched",
                cls=CLASS_NAMES[ticket.priority],
                backend=ticket.backend or "?",
                lanes=len(ticket.items),
            )
        ticket._event.set()
        ticket._run_callbacks()

    # --- observability / lifecycle -------------------------------------

    def queue_stats(self) -> dict:
        """Backpressure snapshot: pending lanes overall and per class.
        No ``maxsize``: the queue is unbounded by design, depth is
        load, not overload."""
        with self._cv:
            depth = self.enqueued_lanes - self.done_lanes
            out = {
                "depth": max(depth, 0),
                "high_watermark": self.depth_hwm,
                "enqueued": self.enqueued_lanes,
                "dropped": 0,
                "inflight_chunks": self._inflight,
                "promoted": self.promoted,
                "device_dispatches": self.device_dispatches,
                "host_chunks": self.host_chunks,
                "degraded": self.degraded,
            }
            for cls, name in enumerate(CLASS_NAMES):
                out[f"{name}_depth"] = (
                    self.enqueued_by_class[cls] - self.done_by_class[cls]
                )
            return out

    def stats(self) -> dict:
        with self._cv:
            return {
                "tickets": self.tickets,
                "lanes": self.enqueued_lanes,
                "by_class": {
                    name: self.enqueued_by_class[cls]
                    for cls, name in enumerate(CLASS_NAMES)
                },
                "promoted": self.promoted,
                "device_dispatches": self.device_dispatches,
                "host_chunks": self.host_chunks,
                "degraded": self.degraded,
            }

    def drain(self, timeout: float = 30.0) -> bool:
        """Block until every submitted lane resolved."""
        deadline = time.perf_counter() + timeout
        with self._cv:
            while self.done_lanes < self.enqueued_lanes:
                left = deadline - time.perf_counter()
                if left <= 0:
                    return False
                self._cv.wait(min(left, 0.1))
        return True

    def close(self) -> None:
        """Stop the dispatcher after the queue drains; a ticket still
        queued then (the drain ran out of time, or the dispatcher
        stopped with every slot busy) resolves with a DeviceRouteError:
        it was not verified."""
        self.drain(timeout=5.0)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        with self._cv:
            left = {id(tk): tk for q in self._queues for tk in q}
            for q in self._queues:
                q.clear()
        for tk in left.values():
            self._fail(tk, RuntimeError("verify scheduler closed before the ticket was verified"))


async def resolved(ticket: Optional[VerifyTicket]) -> Optional[Tuple[bool, List[bool]]]:
    """Await ``ticket`` on the running event loop without holding a
    thread; its ``result()`` (None for no ticket)."""
    if ticket is None:
        return None
    if not ticket.done():
        loop = asyncio.get_running_loop()
        fut = loop.create_future()

        def wake(_ticket) -> None:
            try:
                loop.call_soon_threadsafe(_set_done, fut)
            except RuntimeError:
                pass  # the loop closed: nobody waits any more

        ticket.add_done_callback(wake)
        await fut
    return ticket.result(0)


def _set_done(fut) -> None:
    if not fut.done():
        fut.set_result(None)


def _host_verify_one(item) -> bool:
    """Per-item host verification of a failed host chunk's lanes."""
    pk, msg, sig = item
    try:
        return bool(pk.verify(msg, sig))
    except Exception:
        return False


# --- process-wide default scheduler --------------------------------------

_SCHED: Optional[VerifyScheduler] = None
_SCHED_LOCK = threading.Lock()


def scheduler() -> VerifyScheduler:
    """The shared scheduler every verify consumer submits through
    (``types/validation``, the vote coalescer). Created on first use."""
    global _SCHED
    with _SCHED_LOCK:
        if _SCHED is None:
            _SCHED = VerifyScheduler()
        return _SCHED


def set_scheduler(s: Optional[VerifyScheduler]) -> None:
    """Swap the process-wide scheduler (tests, reconfiguration); the
    old one is closed."""
    global _SCHED
    with _SCHED_LOCK:
        old, _SCHED = _SCHED, s
    if old is not None and old is not s:
        old.close()


def sched_stats_if_running() -> Optional[dict]:
    """Queue gauges of the shared scheduler, or None when none was
    built: reporting must never create it (and start its thread)."""
    with _SCHED_LOCK:
        s = _SCHED
    return None if s is None else s.queue_stats()
