"""Block pool: pipelined block download from peers (reference blocksync/pool.go).

A copy of the JAX package's ``blocksync/pool.py``.

Requesters fetch a sliding window of heights concurrently; blocks are
handed to the verify loop strictly in order. Peer quality feedback:
timeouts and bad blocks ban the peer (fork feature: banned peers +
adaptive peer sorting, reference blocksync/pool.go:79-84,504-522);
faster peers get picked first (simple EWMA latency score).
"""

from __future__ import annotations

import asyncio
import random
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

REQUEST_TIMEOUT_S = 10.0
MAX_PENDING = 64
BAN_DURATION_S = 60.0


def _now() -> float:
    """Monotonic clock, module-level so tests can fake ban expiry
    without touching the event loop's time.monotonic."""
    return time.monotonic()


class PeerError(Exception):
    def __init__(self, peer_id: str, msg: str):
        super().__init__(msg)
        self.peer_id = peer_id


@dataclass
class PoolPeer:
    peer_id: str
    client: object  # BlockSyncPeerClient: async request_block(h)
    base: int = 0
    height: int = 0
    latency_ewma: float = 1.0
    pending: int = 0

    def serves(self, height: int) -> bool:
        return self.base <= height <= self.height


class BlockPool:
    """Downloads [start_height ..] keeping ``self.max_pending`` in
    flight (defaults to MAX_PENDING; the reactor raises it to cover
    its verify-window lookahead — see start_requesters)."""

    def __init__(self, start_height: int):
        self.start_height = start_height
        self.height = start_height  # next height to hand to verify loop
        self.max_pending = MAX_PENDING  # see start_requesters note
        self.peers: Dict[str, PoolPeer] = {}
        # bans live on the POOL, not the PoolPeer: a banned peer that
        # disconnects and re-dials (peer churn) must still be banned,
        # or a byzantine feeder can launder its ban with a reconnect
        self.banned_until: Dict[str, float] = {}
        self.blocks: Dict[int, Tuple[object, str]] = {}  # h -> (block, peer)
        # backpressure telemetry: worst buffered-window size since
        # start (the pool's pending window is the blocksync bounded
        # queue)
        self.blocks_hwm = 0
        # soft per-height exclusions (e.g. "peer lacks the extended
        # commit for h"): skipped when alternatives exist, ignored
        # otherwise — never a liveness risk, unlike a ban
        self.excluded: Dict[int, set] = {}
        self._tasks: Dict[int, asyncio.Task] = {}
        self._new_block = asyncio.Event()
        self._stopped = False
        self.start_time = _now()

    # --- peers --------------------------------------------------------

    def set_peer_range(self, peer_id: str, client, base: int, height: int):
        p = self.peers.get(peer_id)
        if p is None:
            self.peers[peer_id] = PoolPeer(
                peer_id, client, base=base, height=height
            )
        else:
            p.base, p.height = base, height
        # a taller peer may unlock new heights (peers can appear/grow
        # AFTER the pool started in the networked path)
        self.start_requesters()

    def remove_peer(self, peer_id: str) -> None:
        self.peers.pop(peer_id, None)
        for h, (blk, pid) in list(self.blocks.items()):
            if pid == peer_id and h >= self.height:
                del self.blocks[h]
                self._maybe_spawn(h)

    def ban_peer(self, peer_id: str, reason: str = "") -> None:
        self.banned_until[peer_id] = _now() + BAN_DURATION_S

    def _prune_bans(self, now: float) -> None:
        """Expired bans are deleted, not just ignored — long syncs churn
        through many one-shot peer ids and the dict must not grow with
        every peer ever banned."""
        for pid in [p for p, t in self.banned_until.items() if t <= now]:
            del self.banned_until[pid]

    def banned_peers(self) -> List[str]:
        """Currently-banned peer ids (introspection for checkers)."""
        now = _now()
        self._prune_bans(now)
        return list(self.banned_until)

    def max_peer_height(self) -> int:
        return max((p.height for p in self.peers.values()), default=0)

    def exclude_peer_for_height(self, height: int, peer_id: str) -> None:
        """Prefer other peers for this one height (no ban)."""
        self.excluded.setdefault(height, set()).add(peer_id)

    def clear_exclusions(self, height: int) -> None:
        self.excluded.pop(height, None)

    def _pick_peer(self, height: int) -> Optional[PoolPeer]:
        now = _now()
        self._prune_bans(now)
        in_range = [p for p in self.peers.values() if p.serves(height)]
        candidates = [
            p
            for p in in_range
            if p.peer_id not in self.banned_until
        ]
        excl = self.excluded.get(height)
        if not candidates:
            # starvation guard: when EVERY peer serving this height is
            # banned, fetching from the least-loaded, least-recently-
            # banned one beats stalling the sync until a ban expires
            # (the liveness counterpart of the soft exclusions above);
            # the requester's failure-path sleep paces the retries.
            # Soft exclusions still steer here — a peer structurally
            # unable to serve this height (e.g. no extended commit)
            # yields to a banned-but-capable alternative
            if not in_range:
                return None
            pool = in_range
            if excl:
                pool = [p for p in in_range if p.peer_id not in excl] or in_range
            return min(
                pool,
                key=lambda p: (
                    p.pending,
                    self.banned_until.get(p.peer_id, 0.0),
                ),
            )
        if excl:
            preferred = [p for p in candidates if p.peer_id not in excl]
            if preferred:
                candidates = preferred
        # adaptive sorting: prefer low latency, few pending requests
        candidates.sort(
            key=lambda p: (p.pending, p.latency_ewma, random.random())
        )
        return candidates[0]

    # --- requesters ---------------------------------------------------
    #
    # max_pending is an instance attribute so the reactor can raise it
    # to cover its verify-window LOOKAHEAD: the pipelined dispatch
    # needs ~2x verify_window buffered blocks or the next-window
    # pre-dispatch never has a tail to work with (found empirically:
    # a 128-wide bench replay had predispatched=0 with the fixed
    # 64-deep pool).

    def start_requesters(self) -> None:
        top = min(
            self.height + self.max_pending - 1, self.max_peer_height()
        )
        for h in range(self.height, top + 1):
            self._maybe_spawn(h)

    def _maybe_spawn(self, height: int) -> None:
        if (
            self._stopped
            or height in self.blocks
            or height in self._tasks
            or height < self.height
            or height > self.max_peer_height()
            or height >= self.height + self.max_pending
        ):
            return
        self._tasks[height] = asyncio.create_task(self._fetch(height))

    async def _fetch(self, height: int) -> None:
        try:
            while not self._stopped:
                peer = self._pick_peer(height)
                if peer is None:
                    await asyncio.sleep(0.05)
                    continue
                peer.pending += 1
                t0 = _now()
                try:
                    block = await asyncio.wait_for(
                        peer.client.request_block(height), REQUEST_TIMEOUT_S
                    )
                    dt = _now() - t0
                    peer.latency_ewma = 0.8 * peer.latency_ewma + 0.2 * dt
                    if block is None:
                        raise PeerError(peer.peer_id, f"no block {height}")
                    self.blocks[height] = (block, peer.peer_id)
                    if len(self.blocks) > self.blocks_hwm:
                        self.blocks_hwm = len(self.blocks)
                    self._new_block.set()
                    return
                except asyncio.CancelledError:
                    raise
                except Exception:
                    # any client failure (timeout, missing block, broken
                    # transport) bans the peer and retries elsewhere;
                    # the requester itself must never die silently. The
                    # sleep paces retries when the starvation guard
                    # keeps handing back a banned, fast-failing peer
                    traceback.print_exc()
                    self.ban_peer(peer.peer_id)
                    await asyncio.sleep(0.05)
                finally:
                    peer.pending -= 1
        finally:
            if self._tasks.get(height) is asyncio.current_task():
                self._tasks.pop(height, None)

    # --- ordered consumption ------------------------------------------

    def peek_window(self, n: int) -> List[Tuple[int, object, str]]:
        """Contiguous run of up to n+1 buffered blocks from pool.height
        (for coalesced commit verification across heights)."""
        out = []
        h = self.height
        while len(out) <= n and h in self.blocks:
            blk, pid = self.blocks[h]
            out.append((h, blk, pid))
            h += 1
        return out

    def pop_request(self) -> None:
        self.blocks.pop(self.height, None)
        self.height += 1
        self.start_requesters()

    def redo_request(self, height: int, ban_peer: Optional[str]) -> None:
        """Invalid block: drop it + all buffered blocks from its peer,
        ban the peer, refetch (reference pool.go
        RemovePeerAndRedoAllPeerRequests)."""
        if ban_peer:
            self.ban_peer(ban_peer, "bad block")
        self.blocks.pop(height, None)
        for h, (blk, pid) in list(self.blocks.items()):
            if pid == ban_peer and h >= self.height:
                del self.blocks[h]
        self.start_requesters()

    def queue_stats(self) -> dict:
        """Pending-window backpressure. A full window is normal flow
        control while syncing, so the bound is reported as a soft
        target, not a "maxsize"."""
        return {
            "depth": len(self.blocks),
            "high_watermark": self.blocks_hwm,
            "dropped": 0,
            "window_target": self.max_pending,
        }

    def is_caught_up(self) -> bool:
        """Reference blocksync/pool.go:227 IsCaughtUp: at least one
        peer (peers only exist once their status arrived, so heights
        are known), and our chain reaches maxPeerHeight-1 (block H
        needs H+1's commit to verify)."""
        if not self.peers:
            return False
        mx = self.max_peer_height()
        return mx == 0 or self.height >= mx - 1

    async def wait_for_block(self, timeout: float = 0.2) -> None:
        try:
            await asyncio.wait_for(self._new_block.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self._new_block.clear()

    def stop(self) -> None:
        self._stopped = True
        for t in self._tasks.values():
            t.cancel()
        self._tasks.clear()
