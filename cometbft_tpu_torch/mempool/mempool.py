"""Mempools: clist-equivalent, nop (ADR-111), app-side (fork feature).

A copy of the JAX package's ``mempool/mempool.py``. CListMempool
(reference mempool/clist_mempool.go): CheckTx through the mempool ABCI
connection, an LRU cache of tx keys and the senders of each tx (gossip
echo suppression), an ordered pool with the insertion log the gossip
routines read (``txs_after``, ``iter_txs``), reap by max bytes/gas,
``lock``/``unlock`` around the commit, the post-commit ``update`` and
its recheck, ``txs_available`` and the ``notify`` hook. The batched
ingest path ``check_tx_batch`` does one cache pass, one ABCI batch
call when the app connection has one and one pool pass; verdicts are
identical to serial ``check_tx``. With ``async_recheck`` (the config's
default, as in the JAX package) ``update`` snapshots the pool and
returns; a background thread rechecks the snapshot in chunks, verdicts
apply height- and generation-guarded, txs not yet rechecked are masked
from reap, and ``flush`` aborts a recheck in flight. ``NopMempool``
disables the mempool; ``AppMempool`` relays InsertTx / ReapTxs to an
app that owns its pool, behind a ``utils.guard.TTLGuard``.
``tx_keys`` hashes a batch of ``_NATIVE_HASH_MIN`` or more in one
native call (``sha256_many`` of ``utils/wirecodec.py``) when the lane
is built. The cache's and the pool's locks are the runtime
sanitizer's ``mempool.txcache`` and ``mempool.pool``, and ``update``,
the commit path's entry, adopts the pool's owner thread on first use
(``analysis/runtime.py``; raw locks and no checks when it is off).
"""

from __future__ import annotations

import bisect
import hashlib
import threading
import traceback
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..abci import types as abci
from ..analysis.runtime import get_sanitizer, sanitized_lock
from ..trace import NOOP as TRACE_NOOP


def tx_key(tx: bytes) -> bytes:
    return hashlib.sha256(tx).digest()


# below this many txs the native call's fixed cost beats the win
_NATIVE_HASH_MIN = 4

# async recheck issues its ABCI batches in chunks of this many txs so
# the shared app mutex is released between them (consensus' next
# FinalizeBlock must not queue behind a whole-pool batch)
_RECHECK_CHUNK = 256

# cache-duplicate reject log, shared by the serial path and the
# batch path's intra-batch duplicate resolution (matching on it
# decides whether a duplicate re-enters the next round)
_LOG_CACHE_DUP = "tx already in cache"


def tx_keys(txs: Sequence[bytes]) -> List[bytes]:
    """All tx keys in one pass: the native batch hasher when it is
    built, hashlib otherwise; the same digests either way."""
    if len(txs) >= _NATIVE_HASH_MIN:
        from ..utils import wirecodec

        nat = wirecodec.module()
        if nat is not None:
            try:
                return list(nat.sha256_many(txs))
            except Exception:  # pragma: no cover - non-bytes items
                pass
    sha = hashlib.sha256
    return [sha(t).digest() for t in txs]


class TxCache:
    """LRU of recently seen tx KEYS (reference mempool/cache.go).

    Keyed API: callers hash once (tx_key / tx_keys) and pass the
    32-byte key — the cache never rehashes the full tx."""

    def __init__(self, size: int = 10000):
        self.size = size
        self._od: "OrderedDict[bytes, None]" = OrderedDict()
        self._lock = sanitized_lock(threading.Lock(), "mempool.txcache")

    def push(self, key: bytes) -> bool:
        """False if already present."""
        with self._lock:
            return self._push_locked(key)

    def _push_locked(self, key: bytes) -> bool:
        if key in self._od:
            self._od.move_to_end(key)
            return False
        self._od[key] = None
        while len(self._od) > self.size:
            self._od.popitem(last=False)
        return True

    def push_many(self, keys: Sequence[bytes]) -> List[bool]:
        """Batch push under ONE lock acquisition; duplicates within
        the batch reject exactly like sequential pushes would."""
        with self._lock:
            return [self._push_locked(k) for k in keys]

    def remove(self, key: bytes) -> None:
        with self._lock:
            self._od.pop(key, None)

    def has(self, key: bytes) -> bool:
        with self._lock:
            return key in self._od


@dataclass
class MempoolTx:
    tx: bytes
    height: int  # height when entering the pool
    gas_wanted: int = 0
    senders: set = field(default_factory=set)


class Mempool:
    """Interface (reference mempool/mempool.go Mempool)."""

    # tracing plane (trace/): the node build swaps in the per-node
    # tracer; class-level NOOP keeps every flavor's call sites
    # unconditional
    tracer = TRACE_NOOP

    def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        raise NotImplementedError

    def check_tx_batch(
        self, txs: List[bytes], senders: Optional[List[str]] = None
    ) -> List[abci.ResponseCheckTx]:
        """Default: the serial path per tx (flavors without a batched
        ingest plane stay correct)."""
        if senders is None:
            senders = [""] * len(txs)
        return [self.check_tx(t, s) for t, s in zip(txs, senders)]

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        raise NotImplementedError

    def update(self, height, txs, results) -> None:
        raise NotImplementedError

    def lock(self):
        raise NotImplementedError

    def unlock(self):
        raise NotImplementedError

    def size(self) -> int:
        raise NotImplementedError

    def txs_available(self) -> threading.Event:
        raise NotImplementedError

    def flush(self) -> None:
        raise NotImplementedError

    def iter_txs(self) -> List[bytes]:
        raise NotImplementedError


class CListMempool(Mempool):
    def __init__(
        self,
        proxy_app,
        height: int = 0,
        cache_size: int = 10000,
        max_tx_bytes: int = 1024 * 1024,
        max_txs: int = 5000,
        recheck: bool = True,
        notify: Optional[Callable[[], None]] = None,
        async_recheck: bool = False,
    ):
        self.proxy = proxy_app
        self.height = height
        self.cache = TxCache(cache_size)
        self.pool: "OrderedDict[bytes, MempoolTx]" = OrderedDict()
        # monotonic insertion log: gossip routines keep a per-peer seq
        # cursor instead of rescanning the pool (the reference's clist
        # waiter, mempool/reactor.go:217)
        self._seq = 0
        self._log: List[tuple] = []  # (seq, tx_key), insertion order
        self.max_tx_bytes = max_tx_bytes
        self.max_txs = max_txs
        self.recheck = recheck
        self.async_recheck = async_recheck
        self._lock = sanitized_lock(threading.RLock(), "mempool.pool")
        self._txs_available = threading.Event()
        self._notify = notify
        # async-recheck state, all guarded by self._lock: keys of the
        # current recheck snapshot (masked from reap), the generation
        # the snapshot belongs to (bumped every update/flush so a
        # superseded recheck drops its verdicts wholesale), and the
        # lazily-built single-thread executor the recheck runs on
        self._recheck_pending: set = set()
        self._recheck_gen = 0
        self._recheck_executor = None

    # --- ingress ------------------------------------------------------

    def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        tr = self.tracer
        if not tr.enabled:
            return self._check_tx(tx, sender)
        with tr.span("mempool.insert", tid="mempool", bytes=len(tx)) as sp:
            res = self._check_tx(tx, sender)
            sp.set(ok=res.is_ok())
        # unlocked len read (like update's counter): a size() here
        # would re-take the pool lock once per tx just for the stamp
        tr.counter("mempool.size", len(self.pool), tid="mempool")
        return res

    def _check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        if len(tx) > self.max_tx_bytes:
            return abci.ResponseCheckTx(code=1, log="tx too large")
        key = tx_key(tx)
        if not self.cache.push(key):
            with self._lock:
                return self._cache_dup_locked(key, sender)
        res = self.proxy.check_tx(abci.RequestCheckTx(tx=tx))
        with self._lock:
            res = self._admit_locked(tx, key, sender, res)
        if res.is_ok():
            self._txs_available.set()
            if self._notify:
                self._notify()
        return res

    def _cache_dup_locked(
        self, key: bytes, sender: str
    ) -> abci.ResponseCheckTx:
        """Cache-duplicate reject; caller holds self._lock. Records
        the extra sender for gossip echo suppression."""
        if sender:
            mt = self.pool.get(key)
            if mt is not None:
                mt.senders.add(sender)
        return abci.ResponseCheckTx(code=1, log=_LOG_CACHE_DUP)

    def _admit_locked(
        self, tx: bytes, key: bytes, sender: str, res: abci.ResponseCheckTx
    ) -> abci.ResponseCheckTx:
        """Post-ABCI pool insertion; caller holds self._lock."""
        if res.is_ok():
            if len(self.pool) >= self.max_txs:
                self.cache.remove(key)
                return abci.ResponseCheckTx(code=1, log="mempool full")
            mt = MempoolTx(tx=tx, height=self.height, gas_wanted=res.gas_wanted)
            if sender:
                mt.senders.add(sender)
            self.pool[key] = mt
            self._seq += 1
            self._log.append((self._seq, key))
            # txs_available is set by the CALLER — once per tx on the
            # serial path, once per BATCH on the batched one (Event.set
            # takes a condition lock + notify_all; per-item it was ~25%
            # of the serial ingest wall)
        else:
            self.cache.remove(key)
        return res

    def check_tx_batch(
        self, txs: List[bytes], senders: Optional[List[str]] = None
    ) -> List[abci.ResponseCheckTx]:
        """Batched ingest: hash all keys in one pass, precheck under
        one cache lock, ONE check_tx_batch ABCI call for the
        survivors (per-tx fallback inside _proxy_check_tx_batch),
        admit under one pool lock. Verdicts are identical to running
        check_tx serially over the same txs."""
        n = len(txs)
        if n == 0:
            return []
        if senders is None:
            senders = [""] * n
        with self.tracer.span(
            "mempool.batch", tid="mempool", txs=n
        ) as sp:
            out: List[Optional[abci.ResponseCheckTx]] = [None] * n
            remaining: List[int] = []
            for i, tx in enumerate(txs):
                if len(tx) > self.max_tx_bytes:
                    out[i] = abci.ResponseCheckTx(
                        code=1, log="tx too large"
                    )
                else:
                    remaining.append(i)
            keys: Dict[int, bytes] = dict(
                zip(remaining, tx_keys([txs[i] for i in remaining]))
            )
            n_ok = n_checked = 0
            # Round-based so verdicts are EXACTLY serial-equivalent
            # even with intra-batch duplicates: the first occurrence
            # of a key processes this round; later occurrences wait
            # on its verdict — a cache-removing outcome (app reject /
            # pool full) means the serial loop would have re-checked
            # the duplicate through the app, so it re-enters the next
            # round. Real workloads resolve in one round; a batch of
            # k identical rejected txs degrades to k rounds, i.e. to
            # the serial cost, never worse.
            while remaining:
                first_of: Dict[bytes, int] = {}
                round_items: List[int] = []
                deferred: List[int] = []
                for i in remaining:
                    if keys[i] in first_of:
                        deferred.append(i)
                    else:
                        first_of[keys[i]] = i
                        round_items.append(i)
                fresh = self.cache.push_many(
                    [keys[i] for i in round_items]
                )
                dups: List[int] = []
                pending: List[int] = []
                for i, f in zip(round_items, fresh):
                    (pending if f else dups).append(i)
                results = (
                    self._proxy_check_tx_batch(
                        [abci.RequestCheckTx(tx=txs[i]) for i in pending]
                    )
                    if pending
                    else []
                )
                n_checked += len(pending)
                remaining = []
                with self._lock:
                    for i in dups:
                        out[i] = self._cache_dup_locked(
                            keys[i], senders[i]
                        )
                    for i, res in zip(pending, results):
                        out[i] = self._admit_locked(
                            txs[i], keys[i], senders[i], res
                        )
                        if out[i].is_ok():
                            n_ok += 1
                    for i in deferred:
                        pres = out[first_of[keys[i]]]
                        if pres.is_ok() or pres.log == _LOG_CACHE_DUP:
                            out[i] = self._cache_dup_locked(
                                keys[i], senders[i]
                            )
                        else:
                            remaining.append(i)
            if n_ok:
                self._txs_available.set()
                if self._notify:
                    self._notify()
            sp.set(ok=n_ok, checked=n_checked)
        self.tracer.counter("mempool.size", len(self.pool), tid="mempool")
        return out  # type: ignore[return-value]

    def _proxy_check_tx_batch(
        self, reqs: List[abci.RequestCheckTx]
    ) -> List[abci.ResponseCheckTx]:
        """One batched ABCI call when the proxy supports the fork
        extension, an automatic per-tx fallback loop otherwise
        (mirrors how InsertTx/ReapTxs degrade in abci/types.py)."""
        fn = getattr(self.proxy, "check_tx_batch", None)
        if fn is not None:
            try:
                res = fn(reqs)
            except NotImplementedError:
                res = None
            if res is not None:
                if len(res) != len(reqs):
                    # a short list would silently zip-truncate
                    # verdicts downstream (None entries, unresolved
                    # ingest futures) — fail the batch loudly instead
                    raise RuntimeError(
                        "check_tx_batch returned "
                        f"{len(res)} responses for {len(reqs)} requests"
                    )
                return res
        return [self.proxy.check_tx(r) for r in reqs]

    # --- egress -------------------------------------------------------

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        out, total_b, total_g = [], 0, 0
        with self.tracer.span("mempool.reap", tid="mempool") as sp:
            with self._lock:
                pending = self._recheck_pending
                for k, mt in self.pool.items():
                    if pending and k in pending:
                        # recheck verdict still in flight: a proposer
                        # must not include a tx the app may be about
                        # to invalidate post-commit
                        continue
                    nb = total_b + len(mt.tx)
                    ng = total_g + mt.gas_wanted
                    if max_bytes >= 0 and nb > max_bytes:
                        break
                    if max_gas >= 0 and ng > max_gas:
                        break
                    out.append(mt.tx)
                    total_b, total_g = nb, ng
            sp.set(txs=len(out), bytes=total_b)
        return out

    def iter_txs(self) -> List[bytes]:
        with self._lock:
            return [mt.tx for mt in self.pool.values()]

    def tx_senders(self, key: bytes):
        """Peers that gave us this tx (gossip echo suppression,
        reference mempool/reactor.go broadcastTxRoutine)."""
        with self._lock:
            mt = self.pool.get(key)
            return set(mt.senders) if mt else ()

    def txs_after(self, seq: int) -> List[tuple]:
        """(seq, tx, senders) for pooled txs inserted after `seq` —
        the per-peer gossip cursor."""
        with self._lock:
            i = bisect.bisect_right(self._log, seq, key=lambda e: e[0])
            out = []
            for s, k in self._log[i:]:
                mt = self.pool.get(k)
                if mt is not None:
                    out.append((s, mt.tx, set(mt.senders)))
            return out

    def size(self) -> int:
        with self._lock:
            return len(self.pool)

    def recheck_pending(self) -> int:
        """Txs masked from reap while their recheck is in flight."""
        with self._lock:
            return len(self._recheck_pending)

    # --- post-commit --------------------------------------------------

    def lock(self):
        self._lock.acquire()

    def unlock(self):
        self._lock.release()

    def update(self, height: int, txs: List[bytes], results) -> None:
        """Called with the mempool LOCKED, between FinalizeBlock and
        releasing consensus (reference clist_mempool.go:583). With
        async_recheck the recheck leaves the critical section: wall
        time here no longer scales with the pooled tx count."""
        # loop-affinity: the commit path's entry; the first caller
        # adopts ownership
        san = get_sanitizer()
        if san.enabled:
            san.touch_adopt("mempool.pool")
        self.height = height
        committed_keys = tx_keys(txs) if txs else []
        for key, res in zip(committed_keys, results):
            if res.is_ok():
                self.cache.push(key)  # keep committed txs in cache
            else:
                self.cache.remove(key)
            self.pool.pop(key, None)
        # any in-flight recheck is stale the moment a block commits:
        # bump the generation so its verdicts are dropped wholesale
        # and reset the reap mask (re-populated if we re-snapshot)
        self._recheck_gen += 1
        self._recheck_pending = set()
        scheduled = False
        if self.recheck and self.pool:
            if self.async_recheck:
                scheduled = self._schedule_recheck(height)
            else:
                self._recheck_txs()
        if len(self._log) > 4 * len(self.pool) + 1024:
            self._log = [e for e in self._log if e[1] in self.pool]
        if scheduled:
            # availability decided when the verdicts land (the whole
            # pool is masked right now); an empty pool can't happen
            # here — recheck only scheduled when self.pool is truthy
            pass
        elif self.pool:
            self._txs_available.set()
            if self._notify:
                self._notify()
        else:
            self._txs_available.clear()
        self.tracer.counter("mempool.size", len(self.pool), tid="mempool")

    def _recheck_txs(self) -> None:
        """Synchronous recheck (async_recheck off): one batched ABCI
        call for the whole pool, still inside the consensus critical
        section."""
        snapshot = [(k, self.pool[k].tx) for k in self.pool.keys()]
        results = self._proxy_check_tx_batch(
            [
                abci.RequestCheckTx(tx=tx, type_=abci.CHECK_TX_TYPE_RECHECK)
                for _, tx in snapshot
            ]
        )
        for (k, _), res in zip(snapshot, results):
            if not res.is_ok():
                mt = self.pool.pop(k, None)
                if mt is not None:
                    self.cache.remove(k)

    def _schedule_recheck(self, height: int) -> bool:
        """Snapshot the pool, mask it from reap, and hand the batch to
        the background executor. Caller holds self._lock (update runs
        inside the consensus critical section)."""
        snapshot = [(k, mt.tx) for k, mt in self.pool.items()]
        self._recheck_pending = {k for k, _ in snapshot}
        ex = self._recheck_executor
        if ex is None:
            from concurrent.futures import ThreadPoolExecutor

            ex = self._recheck_executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="mempool-recheck"
            )
        ex.submit(self._run_recheck, self._recheck_gen, height, snapshot)
        return True

    def _run_recheck(
        self, gen: int, height: int, snapshot: List[Tuple[bytes, bytes]]
    ) -> None:
        """Background half of the async recheck. Height/generation
        guarded: if another update (or flush) landed while an ABCI
        chunk was in flight, the remaining verdicts are stale — the
        newer update's own recheck owns the pool — so they are
        dropped wholesale and the pending mask is left to the newer
        owner. The snapshot is rechecked in CHUNKS so the shared app
        mutex is released between them: one whole-pool batch would
        head-of-line-block the next height's FinalizeBlock for the
        full recheck wall (the stall this plane exists to kill).
        Verdicts apply per chunk, so reap unmasks progressively."""
        try:
            with self.tracer.span(
                "mempool.recheck", tid="mempool",
                txs=len(snapshot), height=height,
            ) as sp:
                removed = 0
                for lo in range(0, len(snapshot), _RECHECK_CHUNK):
                    chunk = snapshot[lo:lo + _RECHECK_CHUNK]
                    try:
                        results = self._proxy_check_tx_batch(
                            [
                                abci.RequestCheckTx(
                                    tx=tx,
                                    type_=abci.CHECK_TX_TYPE_RECHECK,
                                )
                                for _, tx in chunk
                            ]
                        )
                    except Exception:
                        # app unreachable mid-recheck: fail open
                        # (keep these txs, unmask them) — the next
                        # update rechecks again
                        traceback.print_exc()
                        results = [abci.ResponseCheckTx()] * len(chunk)
                    with self._lock:
                        if gen != self._recheck_gen or height != self.height:
                            sp.set(stale=True)
                            return
                        for (k, _), res in zip(chunk, results):
                            self._recheck_pending.discard(k)
                            if not res.is_ok():
                                mt = self.pool.pop(k, None)
                                if mt is not None:
                                    self.cache.remove(k)
                                    removed += 1
                with self._lock:
                    if gen != self._recheck_gen or height != self.height:
                        sp.set(stale=True)
                        return
                    self._recheck_pending = set()
                    has_txs = bool(self.pool)
                    # availability decided UNDER the lock: a clear()
                    # outside it could clobber the event a concurrent
                    # admission just set
                    if has_txs:
                        self._txs_available.set()
                    else:
                        self._txs_available.clear()
                sp.set(removed=removed)
            if has_txs and self._notify:
                self._notify()
            self.tracer.counter(
                "mempool.size", len(self.pool), tid="mempool"
            )
        except Exception:  # pragma: no cover - belt and braces
            # executor futures swallow exceptions silently; a recheck
            # crash must at least leave a trace and unmask the pool
            traceback.print_exc()
            with self._lock:
                if gen == self._recheck_gen:
                    self._recheck_pending = set()

    def txs_available(self) -> threading.Event:
        return self._txs_available

    def flush(self) -> None:
        with self._lock:
            self.pool.clear()
            self._recheck_gen += 1  # abort any in-flight recheck
            self._recheck_pending = set()
            self._txs_available.clear()


class NopMempool(Mempool):
    """ADR-111: mempool disabled (reference mempool/nop_mempool.go)."""

    def check_tx(self, tx, sender=""):
        return abci.ResponseCheckTx(code=1, log="mempool disabled")

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return []

    def update(self, height, txs, results):
        pass

    def lock(self):
        pass

    def unlock(self):
        pass

    def size(self):
        return 0

    def txs_available(self) -> threading.Event:
        return threading.Event()  # never set

    def flush(self):
        pass

    def iter_txs(self):
        return []


class AppMempool(Mempool):
    """Fork feature: the application owns the pool; the node only relays
    InsertTx / ReapTxs (reference mempool/app_mempool.go:23-50) with a
    TTL'd dedup guard in front (internal/guard)."""

    def __init__(self, proxy_app, guard_ttl_s: float = 60.0, guard_size: int = 100_000):
        from ..utils.guard import TTLGuard

        self.proxy = proxy_app
        self.guard = TTLGuard(ttl_s=guard_ttl_s, max_size=guard_size)
        self._txs_available = threading.Event()

    def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        if not self.guard.check_and_set(tx_key(tx)):
            return abci.ResponseCheckTx(code=1, log="duplicate (guard)")
        ok = self.proxy.insert_tx(tx)
        if ok:
            self._txs_available.set()
        return abci.ResponseCheckTx(
            code=abci.CODE_TYPE_OK if ok else 1
        )

    def reap_max_bytes_max_gas(self, max_bytes, max_gas):
        return self.proxy.reap_txs(max_bytes, max_gas)

    def update(self, height, txs, results):
        self._txs_available.clear()

    def lock(self):
        pass

    def unlock(self):
        pass

    def size(self):
        return -1  # unknown: app-owned

    def txs_available(self) -> threading.Event:
        return self._txs_available

    def flush(self):
        pass

    def iter_txs(self):
        # the JAX class defines iter_txs twice and the second, this one,
        # is the one that runs: the app's own pool, reaped without caps
        return self.proxy.reap_txs(-1, -1)
