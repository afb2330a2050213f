"""Async coalescing signature-verification queue (the consensus round's
vote batcher).

The port's counterpart of the JAX package's ``crypto/coalesce.py``. The
reference verifies live votes one at a time on the CPU (types/vote.go:237
via consensus/state.go:2175 addVote). A device dispatch has a fixed
cost, so the win comes from verifying a round's vote WAVE (one vote per
validator, arriving in a burst) as one lane batch: requests arriving
within ``window_s`` (or until ``max_pending``) go to the verify
scheduler as ONE ``PRIORITY_LIVE`` ticket, each submitter getting its
own future. Verified signatures land in the shared SignatureCache, so
the state machine's inline re-verify is a cache hit.

Departure from the JAX package (the scheduler's, see
``crypto/scheduler.py``): when the dispatch fails, every future of the
wave gets the exception; the wave is not re-verified on the host.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional, Tuple

from ..device import resolve
from ..utils.log import get_logger
from . import scheduler as crypto_sched
from .scheduler import PRIORITY_LIVE

_log = get_logger("coalesce")

# window long enough to collect a gossip burst, short enough to add no
# visible latency to a round (consensus timeouts are 100ms+)
DEFAULT_WINDOW_S = 0.002
DEFAULT_MAX_PENDING = 8192


class CoalescingVerifier:
    """Window-batched async verifier with per-request futures, on
    ``device`` (``None`` is the GPU and raises without one)."""

    def __init__(
        self,
        cache=None,
        window_s: float = DEFAULT_WINDOW_S,
        max_pending: int = DEFAULT_MAX_PENDING,
        priority: int = PRIORITY_LIVE,
        device=None,
    ):
        self.cache = cache
        self.window_s = window_s
        self.max_pending = max_pending
        # the consensus vote wave IS the live round: LIVE by default
        self.priority = priority
        self.device = resolve(device)
        self._pending: List[Tuple] = []
        self._timer: Optional[asyncio.Task] = None
        self._inflight: set = set()
        self.submitted = 0
        self.dispatches = 0
        self.cache_hits = 0

    def submit(self, pub_key, sign_bytes: bytes, sig: bytes) -> asyncio.Future:
        """Queue one (pubkey, sign_bytes, sig) for verification; returns
        a future resolving to the bool verdict. Call on the event loop
        thread."""
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        self.submitted += 1
        if self.cache is not None and self.cache.contains(
            sign_bytes, sig, pub_key.key_bytes
        ):
            self.cache_hits += 1
            fut.set_result(True)
            return fut
        self._pending.append((pub_key, sign_bytes, sig, fut))
        if len(self._pending) >= self.max_pending:
            self._flush_now()
        elif self._timer is None:
            self._timer = loop.create_task(self._window())
        return fut

    def _flush_now(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        t = asyncio.ensure_future(self._dispatch())
        self._inflight.add(t)
        t.add_done_callback(self._inflight.discard)

    def flush(self) -> None:
        """Dispatch whatever is pending now (no-op when empty): callers
        that know the natural batch boundary need not wait out the
        window timer."""
        if self._pending:
            self._flush_now()

    async def _window(self) -> None:
        try:
            await asyncio.sleep(self.window_s)
        except asyncio.CancelledError:
            return
        self._timer = None
        await self._dispatch()

    async def _dispatch(self) -> None:
        items, self._pending = self._pending, []
        if not items:
            return
        self.dispatches += 1
        try:
            ticket = crypto_sched.scheduler().submit(
                [(pk, sb, sig) for pk, sb, sig, _fut in items],
                priority=self.priority,
                label="vote-wave",
                device=self.device,
            )
            # the blocking resolve rides a worker thread: the loop
            # stays free
            _, oks = await asyncio.to_thread(ticket.result)
        except asyncio.CancelledError:
            raise
        except Exception as e:
            _log.error("vote-wave dispatch failed", n=len(items), err=repr(e))
            for *_, fut in items:
                if not fut.done():
                    fut.set_exception(e)
            return
        for (pk, sb, sig, fut), ok in zip(items, oks):
            if ok and self.cache is not None:
                self.cache.add(sb, sig, pk.key_bytes)
            if not fut.done():
                fut.set_result(bool(ok))

    async def drain(self) -> None:
        """Flush pending work and wait for in-flight dispatches."""
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
        await self._dispatch()
        while self._inflight:
            await asyncio.gather(*list(self._inflight), return_exceptions=True)
