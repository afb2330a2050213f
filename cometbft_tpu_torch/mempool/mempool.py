"""The transaction pool that block proposals reap and peers gossip
(reference mempool/clist_mempool.go).

The part of the JAX package's ``CListMempool`` that the chain
generator, the block executor and the p2p reactors call: ``check_tx``
through the app's mempool connection with an LRU cache of tx keys and
the senders of each tx (gossip echo suppression), the batched ingest
path ``check_tx_batch`` (one cache pass, one ABCI batch call when the
app connection has one, one pool pass; verdicts identical to serial
``check_tx``), the insertion log the gossip routines read
(``txs_after``, ``iter_txs``), ``reap_max_bytes_max_gas``,
``lock``/``unlock`` around the commit, ``update`` (drop committed txs,
then recheck the rest through the app), ``size`` and ``flush``. Tx keys hash with
hashlib (the JAX package's native batch hasher is not ported), the
recheck is synchronous, and the other mempool flavours are not ported.
"""

from __future__ import annotations

import bisect
import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

from ..abci import types as abci

# cache-duplicate reject log, shared by the serial path and the
# batch path's intra-batch duplicate resolution (matching on it
# decides whether a duplicate re-enters the next round)
_LOG_CACHE_DUP = "tx already in cache"


def tx_key(tx: bytes) -> bytes:
    return hashlib.sha256(tx).digest()


def tx_keys(txs: Sequence[bytes]) -> List[bytes]:
    sha = hashlib.sha256
    return [sha(t).digest() for t in txs]


class TxCache:
    """LRU of recently seen tx keys (reference mempool/cache.go)."""

    def __init__(self, size: int = 10000):
        self.size = size
        self._od: "OrderedDict[bytes, None]" = OrderedDict()
        self._lock = threading.Lock()

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
    height: int  # height when it entered the pool
    gas_wanted: int = 0
    senders: set = field(default_factory=set)


class CListMempool:
    def __init__(
        self,
        proxy_app,
        height: int = 0,
        cache_size: int = 10000,
        max_tx_bytes: int = 1024 * 1024,
        max_txs: int = 5000,
        recheck: bool = True,
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
        self._lock = threading.RLock()

    # --- ingress ------------------------------------------------------

    def check_tx(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        if len(tx) > self.max_tx_bytes:
            return abci.ResponseCheckTx(code=1, log="tx too large")
        key = tx_key(tx)
        if not self.cache.push(key):
            with self._lock:
                return self._cache_dup_locked(key, sender)
        res = self.proxy.check_tx(abci.RequestCheckTx(tx=tx))
        with self._lock:
            return self._admit_locked(tx, key, sender, res)

    def _cache_dup_locked(self, key: bytes, sender: str) -> abci.ResponseCheckTx:
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
        else:
            self.cache.remove(key)
        return res

    def check_tx_batch(
        self, txs: List[bytes], senders: Optional[List[str]] = None
    ) -> List[abci.ResponseCheckTx]:
        """Batched ingest: all keys in one pass, precheck under one
        cache lock, ONE check_tx_batch ABCI call for the survivors
        (per-tx fallback inside _proxy_check_tx_batch), admit under one
        pool lock. Verdicts are identical to running check_tx serially
        over the same txs."""
        n = len(txs)
        if n == 0:
            return []
        if senders is None:
            senders = [""] * n
        out: List[Optional[abci.ResponseCheckTx]] = [None] * n
        remaining: List[int] = []
        for i, tx in enumerate(txs):
            if len(tx) > self.max_tx_bytes:
                out[i] = abci.ResponseCheckTx(code=1, log="tx too large")
            else:
                remaining.append(i)
        keys: Dict[int, bytes] = dict(zip(remaining, tx_keys([txs[i] for i in remaining])))
        # Round-based so verdicts are EXACTLY serial-equivalent even
        # with intra-batch duplicates: the first occurrence of a key
        # processes this round; later occurrences wait on its verdict —
        # a cache-removing outcome (app reject / pool full) means the
        # serial loop would have re-checked the duplicate through the
        # app, so it re-enters the next round.
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
            fresh = self.cache.push_many([keys[i] for i in round_items])
            dups: List[int] = []
            pending: List[int] = []
            for i, f in zip(round_items, fresh):
                (pending if f else dups).append(i)
            results = (
                self._proxy_check_tx_batch([abci.RequestCheckTx(tx=txs[i]) for i in pending])
                if pending
                else []
            )
            remaining = []
            with self._lock:
                for i in dups:
                    out[i] = self._cache_dup_locked(keys[i], senders[i])
                for i, res in zip(pending, results):
                    out[i] = self._admit_locked(txs[i], keys[i], senders[i], res)
                for i in deferred:
                    pres = out[first_of[keys[i]]]
                    if pres.is_ok() or pres.log == _LOG_CACHE_DUP:
                        out[i] = self._cache_dup_locked(keys[i], senders[i])
                    else:
                        remaining.append(i)
        return out  # type: ignore[return-value]

    def _proxy_check_tx_batch(
        self, reqs: List[abci.RequestCheckTx]
    ) -> List[abci.ResponseCheckTx]:
        """One batched ABCI call when the proxy supports the fork
        extension, an automatic per-tx fallback loop otherwise."""
        fn = getattr(self.proxy, "check_tx_batch", None)
        if fn is not None:
            try:
                res = fn(reqs)
            except NotImplementedError:
                res = None
            if res is not None:
                if len(res) != len(reqs):
                    # a short list would silently zip-truncate
                    # verdicts downstream — fail the batch loudly
                    raise RuntimeError(
                        f"check_tx_batch returned {len(res)} responses for {len(reqs)} requests"
                    )
                return res
        return [self.proxy.check_tx(r) for r in reqs]

    # --- egress -------------------------------------------------------

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int) -> List[bytes]:
        out, total_b, total_g = [], 0, 0
        with self._lock:
            for mt in self.pool.values():
                nb = total_b + len(mt.tx)
                ng = total_g + mt.gas_wanted
                if max_bytes >= 0 and nb > max_bytes:
                    break
                if max_gas >= 0 and ng > max_gas:
                    break
                out.append(mt.tx)
                total_b, total_g = nb, ng
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

    def flush(self) -> None:
        """Drop every pooled tx (the RPC's ``unsafe_flush_mempool``)."""
        with self._lock:
            self.pool.clear()

    # --- post-commit --------------------------------------------------

    def lock(self):
        self._lock.acquire()

    def unlock(self):
        self._lock.release()

    def update(self, height: int, txs: List[bytes], results) -> None:
        """Called with the mempool locked, after FinalizeBlock and the
        app's Commit (reference clist_mempool.go:583)."""
        self.height = height
        for key, res in zip(tx_keys(txs), results):
            if res.is_ok():
                self.cache.push(key)  # committed txs stay in the cache
            else:
                self.cache.remove(key)
            self.pool.pop(key, None)
        if self.recheck and self.pool:
            for key, mt in list(self.pool.items()):
                res = self.proxy.check_tx(
                    abci.RequestCheckTx(tx=mt.tx, type_=abci.CHECK_TX_TYPE_RECHECK)
                )
                if not res.is_ok():
                    self.pool.pop(key, None)
                    self.cache.remove(key)
        if len(self._log) > 4 * len(self.pool) + 1024:
            self._log = [e for e in self._log if e[1] in self.pool]
