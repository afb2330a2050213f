"""Self-healing reconnect plane: never-give-up budgeted redial.

A copy of the JAX package's ``p2p/reconnect.py``. The reference
abandoned a persistent peer after a finite attempt budget: pong-timeout
conn deaths during a partition plus one-sided reconnect exhaustion left
a healed minority PERMANENTLY isolated, a liveness violation the BFT
fault model does not tolerate.

This plane replaces the give-up with two lanes that together never
abandon a persistent peer:

- **fast lane** — per-peer task: full-jitter exponential backoff
  (``utils/backoff.py``, the one shared policy) up to a per-peer
  attempt *budget*. A healed network converges at backoff speed.
- **slow lane** — after the fast budget is spent the peer is PARKED,
  not dropped: one periodic sweep redials every parked peer forever.
  The lane bounds steady-state dial load to
  ``len(slow_lane) / slow_interval_s`` regardless of how long the
  outage lasts.

Any successful handshake resets the peer's backoff (the next flap
starts fast again) and un-parks it. Address resolution consults the
PEX address book FIRST when the switch has one; the port has no PEX
yet (``addr_book`` stays None), so a peer is redialed at its static
``persistent_addrs`` entry.

Starvation: a node with ZERO peers for ``starvation_s`` is starving;
cumulative zero-peer time is ``starvation_seconds()``.

Observability: every death→re-establish cycle is one ``p2p.reconnect``
span (args: attempts, lane) on the switch's tracer; attempt and flap
counts ride its counter stream.
"""

from __future__ import annotations

import asyncio
import time
from typing import Dict, Optional, Set

from ..utils.backoff import Backoff
from ..utils.log import get_logger

_log = get_logger("p2p.reconnect")

DEFAULT_BASE_S = 1.0
DEFAULT_CAP_S = 30.0
# fast-lane dial budget per outage, NOT a give-up bound: spending it
# hands the peer to the slow lane
DEFAULT_FAST_ATTEMPTS = 12
DEFAULT_SLOW_INTERVAL_S = 30.0
DEFAULT_STARVATION_S = 10.0


class ReconnectPlane:
    """Owns persistent-peer redial for a Switch. All entry points are loop-synchronous; only the lane routines
    await."""

    def __init__(
        self,
        switch,
        base_s: float = DEFAULT_BASE_S,
        cap_s: float = DEFAULT_CAP_S,
        fast_attempts: int = DEFAULT_FAST_ATTEMPTS,
        slow_interval_s: float = DEFAULT_SLOW_INTERVAL_S,
        starvation_s: float = DEFAULT_STARVATION_S,
    ):
        self.switch = switch
        self.base_s = base_s
        self.cap_s = max(cap_s, base_s)
        self.fast_attempts = max(1, int(fast_attempts))
        self.slow_interval_s = slow_interval_s
        self.starvation_s = starvation_s
        self._backoffs: Dict[str, Backoff] = {}
        self._fast_tasks: Dict[str, asyncio.Task] = {}
        self.slow_lane: Set[str] = set()
        self._spans: Dict[str, object] = {}  # open p2p.reconnect spans
        self._attempts_this_outage: Dict[str, int] = {}
        self._sweep_task: Optional[asyncio.Task] = None
        self._stopped = False
        # counters
        self.attempts_total = 0
        self.dial_failures_total = 0
        self.flaps_total = 0
        self.slow_parks_total = 0
        self.recoveries_total = 0
        # zero-peer clock: episodes accumulate into starvation_total_s;
        # the running episode is added by starvation_seconds()
        self._zero_since: Optional[float] = time.monotonic()
        self.starvation_total_s = 0.0

    # --- lifecycle ----------------------------------------------------

    def start(self) -> None:
        if self._sweep_task is None:
            self._sweep_task = asyncio.create_task(self._sweep_routine())

    def stop(self) -> None:
        """Synchronous cancel of every lane task (safe from both the
        graceful stop chain and the abort floor — nothing awaits)."""
        self._stopped = True
        if self._sweep_task is not None:
            self._sweep_task.cancel()
            self._sweep_task = None
        for t in self._fast_tasks.values():
            t.cancel()
        self._fast_tasks.clear()
        self.slow_lane.clear()
        self._spans.clear()

    # --- switch hooks -------------------------------------------------

    def on_peer_connected(self, peer) -> bool:
        """Any successful handshake: reset the peer's backoff, un-park
        it, close its reconnect span. Returns True when the node was
        STARVING until this connection (the switch then triggers the
        PEX re-learn storm)."""
        pid = peer.peer_id
        bo = self._backoffs.get(pid)
        if bo is not None:
            bo.reset()
        was_scheduled = pid in self.slow_lane or pid in self._fast_tasks
        self.slow_lane.discard(pid)
        t = self._fast_tasks.get(pid)
        if t is not None and t is not asyncio.current_task():
            t.cancel()
            self._fast_tasks.pop(pid, None)
        span = self._spans.pop(pid, None)
        if span is not None:
            span.set(
                attempts=self._attempts_this_outage.pop(pid, 0),
                recovered=True,
            )
            span.end()
            self.recoveries_total += 1
        elif was_scheduled:
            self.recoveries_total += 1
        was_starving = self.starving()
        if self._zero_since is not None:
            self.starvation_total_s += self.zero_peers_for_s()
            self._zero_since = None
        return was_starving

    def _book_addr(self, peer_id: str) -> str:
        """Book-form ("id@addr") of what we would dial, so failure
        bookkeeping can CREATE the entry for a persistent peer that
        was never PEX-learned (otherwise its history silently no-ops
        against an absent entry)."""
        addr = self.switch.persistent_addrs.get(peer_id)
        if not addr:
            return ""
        return addr if "@" in addr else f"{peer_id}@{addr}"

    def on_peer_removed(self, peer, had_error: bool) -> None:
        """Conn death. On error paths: counts the flap, records the
        failure in the address book, and (for persistent peers)
        schedules the fast lane. Graceful hang-ups (seed-mode serve,
        operator drop) roll only the zero-peer clock."""
        pid = peer.peer_id
        sw = self.switch
        if had_error:
            self.flaps_total += 1
            sw.tracer.counter(
                "p2p.peer_flaps", self.flaps_total, tid="p2p"
            )
            book = getattr(sw, "addr_book", None)
            if book is not None:
                book.mark_failed(pid, self._book_addr(pid))
        if sw.num_peers() == 0 and self._zero_since is None:
            self._zero_since = time.monotonic()
        if had_error and peer.persistent and not self._stopped:
            self.schedule(pid)

    def note_dial_failure(self, peer_id: str) -> None:
        """An explicitly-requested persistent dial failed before any
        peer existed (boot dial against a partitioned/crashed target):
        the plane owns the retry from here."""
        self.dial_failures_total += 1
        book = getattr(self.switch, "addr_book", None)
        if book is not None:
            book.mark_failed(peer_id, self._book_addr(peer_id))
        self.schedule(peer_id)

    # --- scheduling ---------------------------------------------------

    def is_scheduled(self, peer_id: str) -> bool:
        return peer_id in self._fast_tasks or peer_id in self.slow_lane

    def schedule(self, peer_id: str) -> None:
        """Idempotent entry: start the fast lane for a dead persistent
        peer (no-op while either lane already owns it)."""
        if self._stopped or self.is_scheduled(peer_id):
            return
        if peer_id in self.switch.peers or peer_id in self.switch.banned:
            return
        if not self.resolve_addr(peer_id):
            return
        if peer_id not in self._spans:
            self._spans[peer_id] = self.switch.tracer.span(
                "p2p.reconnect", tid="p2p", peer=peer_id[:12]
            )
            self._attempts_this_outage[peer_id] = 0
        self._fast_tasks[peer_id] = asyncio.create_task(
            self._fast_routine(peer_id)
        )

    def resolve_addr(self, peer_id: str) -> Optional[str]:
        """Current best address: the PEX book's live entry beats the
        boot-time persistent snapshot (nodes move; PEX re-learns)."""
        sw = self.switch
        book = getattr(sw, "addr_book", None)
        if book is not None:
            ka = book.addrs.get(peer_id)
            if ka is not None and ka.addr:
                return ka.addr
        return sw.persistent_addrs.get(peer_id)

    # --- lanes --------------------------------------------------------

    def _backoff_for(self, peer_id: str) -> Backoff:
        bo = self._backoffs.get(peer_id)
        if bo is None:
            bo = self._backoffs[peer_id] = Backoff(
                base_s=self.base_s, cap_s=self.cap_s
            )
        return bo

    def abandon(self, peer_id: str) -> None:
        """The ONE sanctioned abandonment: the peer got banned — drop
        it from every lane (its open span is discarded unrecorded)."""
        self.slow_lane.discard(peer_id)
        t = self._fast_tasks.pop(peer_id, None)
        if t is not None and t is not asyncio.current_task():
            t.cancel()
        self._spans.pop(peer_id, None)
        self._attempts_this_outage.pop(peer_id, None)

    async def _try_dial(self, peer_id: str, lane: str) -> bool:
        if peer_id in self.switch.banned:
            self.abandon(peer_id)
            return True  # stop retrying; NOT a recovery (span dropped)
        addr = self.resolve_addr(peer_id)
        if addr is None:
            return False
        sw = self.switch
        self.attempts_total += 1
        if peer_id in self._attempts_this_outage:
            self._attempts_this_outage[peer_id] += 1
        sw.tracer.counter(
            "p2p.reconnect.attempts", self.attempts_total, tid="p2p"
        )
        book = getattr(sw, "addr_book", None)
        if book is not None:
            book.mark_attempt(peer_id)
        try:
            await sw.dial_peer(addr, peer_id)
            return True
        except asyncio.CancelledError:
            raise
        except Exception as e:
            self.dial_failures_total += 1
            if book is not None:
                book.mark_failed(peer_id, self._book_addr(peer_id))
            _log.debug(
                "reconnect dial failed",
                peer=peer_id[:12], lane=lane, err=repr(e),
            )
            return False

    async def _fast_routine(self, peer_id: str) -> None:
        try:
            backoff = self._backoff_for(peer_id)
            attempt = 0
            while attempt < self.fast_attempts:
                await asyncio.sleep(backoff.next_delay())
                if self._stopped or peer_id in self.switch.peers:
                    return
                attempt += 1
                if await self._try_dial(peer_id, lane="fast"):
                    return
            # fast budget spent: the peer is PARKED for the periodic
            # sweep, never abandoned
            self._park_slow_lane(peer_id)
        except asyncio.CancelledError:
            raise
        finally:
            self._fast_tasks.pop(peer_id, None)

    def _park_slow_lane(self, peer_id: str) -> None:
        if self._stopped or peer_id in self.switch.peers:
            return
        self.slow_lane.add(peer_id)
        self.slow_parks_total += 1
        span = self._spans.get(peer_id)
        if span is not None:
            span.set(slow_lane=True)
        _log.info(
            "reconnect fast budget spent, parked in slow lane",
            peer=peer_id[:12], budget=self.fast_attempts,
        )

    async def _sweep_routine(self) -> None:
        try:
            while not self._stopped:
                await asyncio.sleep(self.slow_interval_s)
                for peer_id in sorted(self.slow_lane):
                    if self._stopped:
                        return
                    if peer_id in self.switch.peers:
                        self.slow_lane.discard(peer_id)
                        continue
                    if await self._try_dial(peer_id, lane="slow"):
                        self.slow_lane.discard(peer_id)
        except asyncio.CancelledError:
            raise

    # --- starvation ---------------------------------------------------

    def expects_peers(self) -> bool:
        """Whether zero peers is a PROBLEM: the node has persistent
        peers configured, learned addresses, or has lost peers before.
        A single-node net with nothing to dial is not starving."""
        sw = self.switch
        if sw.persistent_addrs or self.flaps_total:
            return True
        book = getattr(sw, "addr_book", None)
        return book is not None and book.size() > 0

    def zero_peers_for_s(self) -> float:
        if self._zero_since is None or not self.expects_peers():
            return 0.0
        return time.monotonic() - self._zero_since

    def starving(self) -> bool:
        """Zero peers for at least ``starvation_s``."""
        return self.zero_peers_for_s() >= self.starvation_s

    def starvation_seconds(self) -> float:
        """Cumulative zero-peer seconds (completed episodes + the
        running one)."""
        return self.starvation_total_s + self.zero_peers_for_s()

    # --- introspection ------------------------------------------------

    def stats(self) -> dict:
        return {
            "attempts_total": self.attempts_total,
            "dial_failures_total": self.dial_failures_total,
            "flaps_total": self.flaps_total,
            "slow_parks_total": self.slow_parks_total,
            "recoveries_total": self.recoveries_total,
            "fast_lane": len(self._fast_tasks),
            "slow_lane": len(self.slow_lane),
            "starving_for_s": round(self.zero_peers_for_s(), 3),
            "starvation_seconds": round(self.starvation_seconds(), 3),
        }
