"""Snapshot syncer (reference statesync/syncer.go:150,246,327,363).

Flow: collect snapshot advertisements -> pick best (highest height,
light-verified app hash) -> OfferSnapshot to app -> fetch + apply
chunks in order (refetch / sender-rejection honored) -> verify app
Info against the trusted app hash -> return the light-verified State
+ commit for store bootstrap.

A copy of the JAX package's ``statesync/syncer.py``, with three
additions. A snapshot's key includes its ``metadata``, as the
reference's ``snapshot.Key()`` does, and the offered snapshot carries
it (the JAX syncer keys by height, format, chunks and hash and offers
no metadata): an advertisement with other metadata is another
snapshot, served only by the peers that advertised it, and a rejected
snapshot is banned by that whole key, so a peer that advertises an
honest snapshot with made-up metadata, or a made-up chunk count, can
get only its own advertisement rejected. ``last_sync`` keeps the
walls of the last successful restore: light checks, chunk fetch and
apply, chunks and bytes. The fetchers take chunks in order, the lowest
index that is neither received nor in flight (the reference's
``chunkQueue.Allocate``), where each JAX fetcher walks the wanted list
with a counter of its own: that walk leaves a chunk behind for up to
~0.85 of the snapshot's chunks at a time, and its fetchers ask for the
same chunk of the same peer, so a reply goes to one of them and the
others wait out the chunk timeout; on a slower host the apply loop's
own chunk timeout then ends the attempt (ROADMAP C16). An exception from the state provider escapes
``_sync_one`` and ``sync_any`` unchanged, as in the JAX syncer: a
failed verify route (``crypto.scheduler.DeviceRouteError``) ends the
sync with no snapshot banned or rejected for it (ROADMAP C3)."""

from __future__ import annotations

import asyncio
import random
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Set, Tuple

from ..abci import types as abci
from ..utils.backoff import Backoff
from ..utils.log import get_logger
from .chunks import ChunkQueue

_log = get_logger("statesync")

DISCOVERY_SLEEP_S = 0.3
# while the pool is EMPTY, re-broadcast the snapshot request this
# often: advertisements are one-shot per request, so after a rejected
# or timed-out snapshot attempt drains the pool, a syncer that never
# re-asks would idle out the whole discovery window even though its
# peers hold (by now newer) snapshots
REDISCOVERY_INTERVAL_S = 2.0
CHUNK_TIMEOUT_S = 10.0
MAX_CHUNK_FETCHERS = 4
# chunk-request retry backoff (utils/backoff.py full jitter): fast
# first retry, capped well under the chunk timeout so a flaky peer
# gets several tries before the whole snapshot attempt times out
RETRY_BACKOFF_BASE_S = 0.05
RETRY_BACKOFF_CAP_S = 2.0


class SyncError(Exception):
    pass


class SnapshotRejected(SyncError):
    pass


@dataclass(frozen=True)
class SnapshotKey:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


@dataclass
class SnapshotPool:
    """Advertised snapshots and which peers can serve them."""

    snapshots: Dict[SnapshotKey, Set[str]] = field(default_factory=dict)
    # every advertisement ever received (diagnostics: distinguishes
    # "nothing discovered" from "everything rejected")
    discovered_total: int = 0

    def add(self, peer_id: str, snap: abci.Snapshot) -> None:
        key = SnapshotKey(
            snap.height,
            snap.format,
            snap.chunks,
            bytes(snap.hash),
            bytes(snap.metadata or b""),
        )
        self.snapshots.setdefault(key, set()).add(peer_id)
        self.discovered_total += 1

    def remove_peer(self, peer_id: str) -> None:
        for peers in self.snapshots.values():
            peers.discard(peer_id)

    def reject(self, key: SnapshotKey) -> None:
        self.snapshots.pop(key, None)

    def best(self) -> Optional[Tuple[SnapshotKey, Set[str]]]:
        live = {
            k: p for k, p in self.snapshots.items() if p
        }
        if not live:
            return None
        key = max(live, key=lambda k: (k.height, k.format))
        return key, live[key]


class Syncer:
    def __init__(
        self,
        proxy,  # AppConns (snapshot + query)
        state_provider,
        request_chunk: Callable,  # async (peer_id, height, format, index) -> Optional[bytes]
        discovery_time_s: float = 5.0,
        chunk_timeout_s: float = CHUNK_TIMEOUT_S,
        rng: Optional[random.Random] = None,
        request_snapshots: Optional[Callable] = None,  # () -> None
    ):
        self.proxy = proxy
        self.provider = state_provider
        self.request_chunk = request_chunk
        self.request_snapshots = request_snapshots
        self.pool = SnapshotPool()
        self.discovery_time_s = discovery_time_s
        self.chunk_timeout_s = chunk_timeout_s
        self.banned_snapshots: Set[SnapshotKey] = set()
        # peers that served corrupt/unappliable chunks (the app said
        # RETRY on their chunk, or named them in reject_senders):
        # banned for the rest of THIS sync — mirrors the blocksync
        # pool's peer bans, and like them survives reconnect churn
        self.banned_peers: Set[str] = set()
        self._rng = rng or random.Random()
        # walls and sizes of the last successful restore
        self.last_sync: Dict[str, float] = {}

    # --- entry --------------------------------------------------------

    async def sync_any(self):
        """Try snapshots until one applies. Returns (state, commit)."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.discovery_time_s
        last_request = loop.time()  # the caller just broadcast one
        while True:
            pick = self.pool.best()
            if pick is None:
                now = loop.time()
                if now > deadline:
                    raise SyncError(
                        "no viable snapshots discovered in time "
                        f"(advertisements={self.pool.discovered_total}"
                        f", rejected={len(self.banned_snapshots)})"
                    )
                if (
                    self.request_snapshots is not None
                    and now - last_request >= REDISCOVERY_INTERVAL_S
                ):
                    # re-ask: a rejected/timed-out attempt drained the
                    # pool; peers hold (by now newer) snapshots
                    last_request = now
                    self.request_snapshots()
                await asyncio.sleep(DISCOVERY_SLEEP_S)
                continue
            key, peers = pick
            if key in self.banned_snapshots:
                self.pool.reject(key)
                continue
            try:
                result = await self._sync_one(key, peers)
                # shared-verification accounting (light/serving.py):
                # how much of the light-verified restore rode the
                # cross-client header cache vs was verified fresh —
                # the "joining node shares work with light sessions"
                # story made auditable per sync
                stats_fn = getattr(self.provider, "cache_stats", None)
                if stats_fn is not None:
                    try:
                        _log.info(
                            "light-verified restore complete",
                            height=key.height,
                            **stats_fn(),
                        )
                    except Exception:
                        pass
                return result
            except SnapshotRejected as e:
                # logged: a run that ends in "no viable snapshots"
                # after REJECTING offers is a different failure than
                # one that never discovered any — the error text alone
                # cannot tell them apart
                _log.error(
                    "snapshot rejected",
                    height=key.height,
                    err=repr(e),
                )
                self.banned_snapshots.add(key)
                self.pool.reject(key)
            except asyncio.TimeoutError:
                _log.error(
                    "snapshot attempt timed out", height=key.height
                )
                self.pool.reject(key)

    async def _sync_one(self, key: SnapshotKey, peers: Set[str]):
        # light-verify the app hash BEFORE trusting anything the
        # snapshot claims (reference syncer.go:246 Sync)
        t0 = time.perf_counter()
        app_hash = await asyncio.to_thread(
            self.provider.app_hash, key.height
        )
        t1 = time.perf_counter()
        snap = abci.Snapshot(
            height=key.height,
            format=key.format,
            chunks=key.chunks,
            hash=key.hash,
            metadata=key.metadata,
        )
        resp = self.proxy.snapshot.offer_snapshot(snap, app_hash)
        if resp.result != abci.OFFER_SNAPSHOT_ACCEPT:
            if resp.result == abci.OFFER_SNAPSHOT_ABORT:
                raise SyncError("app aborted snapshot restore")
            raise SnapshotRejected(f"app rejected snapshot ({resp.result})")

        queue = ChunkQueue(key.chunks)
        applied_bytes = 0
        in_flight: Set[int] = set()  # chunk indexes some fetcher is asking for
        fetchers = [
            asyncio.create_task(
                self._fetch_routine(queue, key, list(peers), in_flight)
            )
            for _ in range(min(MAX_CHUNK_FETCHERS, max(1, len(peers))))
        ]
        try:
            while not queue.done():
                index, chunk, sender = await queue.next(
                    self.chunk_timeout_s
                )
                r = self.proxy.snapshot.apply_snapshot_chunk(
                    index, chunk, sender
                )
                if r.result == abci.APPLY_CHUNK_ACCEPT:
                    # marked BEFORE directives: a reject_senders ban
                    # in the same response must not rewind the chunk
                    # the app just accepted
                    queue.mark_applied(index)
                    applied_bytes += len(chunk)
                # app-directed punishment/refetch rides ANY verdict
                # (reference syncer.go:363): a chunk can apply while
                # the app still fingers earlier senders as corrupt
                self._apply_directives(queue, r)
                if r.result == abci.APPLY_CHUNK_ACCEPT:
                    continue
                if r.result == abci.APPLY_CHUNK_RETRY:
                    # the sender served a chunk the app could not
                    # apply: ban it for this sync (all its queued
                    # chunks are suspect too) and refetch elsewhere
                    self._ban_sender(queue, sender, "chunk retry")
                    queue.discard(index)
                    continue
                if r.result in (
                    abci.APPLY_CHUNK_REJECT_SNAPSHOT,
                    abci.APPLY_CHUNK_RETRY_SNAPSHOT,
                ):
                    raise SnapshotRejected("app rejected chunk set")
                raise SyncError(f"chunk apply aborted ({r.result})")
        finally:
            for f in fetchers:
                f.cancel()

        # verify the app landed exactly where the light client says
        info = self.proxy.query.info(abci.RequestInfo())
        if info.last_block_height != key.height:
            raise SnapshotRejected(
                f"app restored to height {info.last_block_height}, "
                f"snapshot was {key.height}"
            )
        if bytes(info.last_block_app_hash) != bytes(app_hash):
            raise SnapshotRejected("app hash mismatch after restore")

        t2 = time.perf_counter()
        state = await asyncio.to_thread(self.provider.state, key.height)
        commit = await asyncio.to_thread(
            self.provider.commit, key.height
        )
        t3 = time.perf_counter()
        self.last_sync = {
            "height": key.height,
            "chunks": key.chunks,
            "bytes": applied_bytes,
            "light_s": (t1 - t0) + (t3 - t2),
            "chunks_s": t2 - t1,
        }
        return state, commit

    def _ban_sender(
        self, queue: ChunkQueue, sender: str, why: str
    ) -> None:
        if not sender or sender in self.banned_peers:
            return
        self.banned_peers.add(sender)
        dropped = queue.discard_sender(sender)
        _log.info(
            "statesync: banned peer serving corrupt chunks",
            peer=sender[:12],
            why=why,
            chunks_discarded=len(dropped),
        )

    def _apply_directives(
        self, queue: ChunkQueue, r: abci.ResponseApplySnapshotChunk
    ) -> None:
        """Honor the app's refetch_chunks / reject_senders fields."""
        for sender in r.reject_senders or ():
            self._ban_sender(queue, sender, "reject_senders")
        for idx in r.refetch_chunks or ():
            queue.discard(idx)

    async def _fetch_routine(
        self, queue: ChunkQueue, key: SnapshotKey, peers: List[str], in_flight: Set[int]
    ) -> None:
        # full-jitter exponential backoff per fetcher: a flaky peer
        # retries fast at first, and a thundering re-request herd
        # after a shared failure spreads out (utils/backoff.py)
        backoff = Backoff(
            base_s=RETRY_BACKOFF_BASE_S,
            cap_s=RETRY_BACKOFF_CAP_S,
            rng=self._rng,
        )
        try:
            while not queue.done():
                alive = [
                    p for p in peers if p not in self.banned_peers
                ]
                if not alive:
                    # every peer of this snapshot is banned: nothing
                    # can complete it — let the apply loop time out
                    # and reject the snapshot
                    return
                free = queue.wanted() - set(queue.chunks) - in_flight
                if not free:
                    await asyncio.sleep(0.05)
                    continue
                index = min(free)
                peer = alive[index % len(alive)]
                in_flight.add(index)
                try:
                    chunk = await asyncio.wait_for(
                        self.request_chunk(
                            peer, key.height, key.format, index
                        ),
                        self.chunk_timeout_s,
                    )
                except asyncio.CancelledError:
                    raise
                except Exception:
                    await asyncio.sleep(backoff.next_delay())
                    continue
                finally:
                    in_flight.discard(index)
                if chunk is not None:
                    backoff.reset()
                    queue.add(index, chunk, peer)
                else:
                    # peer answered "don't have it": back off before
                    # asking the rotation again
                    await asyncio.sleep(backoff.next_delay())
        except asyncio.CancelledError:
            raise
