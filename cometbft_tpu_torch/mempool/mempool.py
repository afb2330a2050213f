"""The transaction pool that block proposals reap (reference
mempool/clist_mempool.go).

The part of the JAX package's ``CListMempool`` that the chain
generator and the block executor call: ``check_tx`` through the app's
mempool connection with an LRU cache of tx keys, ``reap_max_bytes_max_gas``,
``lock``/``unlock`` around the commit, ``update`` (drop committed txs,
then recheck the rest through the app) and ``size``. The batched
ingest plane, the asynchronous recheck, gossip cursors and the other
mempool flavours are not ported.
"""

from __future__ import annotations

import hashlib
import threading
from collections import OrderedDict
from dataclasses import dataclass
from typing import List

from ..abci import types as abci


def tx_key(tx: bytes) -> bytes:
    return hashlib.sha256(tx).digest()


class TxCache:
    """LRU of recently seen tx keys (reference mempool/cache.go)."""

    def __init__(self, size: int = 10000):
        self.size = size
        self._od: "OrderedDict[bytes, None]" = OrderedDict()
        self._lock = threading.Lock()

    def push(self, key: bytes) -> bool:
        """False if already present."""
        with self._lock:
            if key in self._od:
                self._od.move_to_end(key)
                return False
            self._od[key] = None
            while len(self._od) > self.size:
                self._od.popitem(last=False)
            return True

    def remove(self, key: bytes) -> None:
        with self._lock:
            self._od.pop(key, None)


@dataclass
class MempoolTx:
    tx: bytes
    height: int  # height when it entered the pool
    gas_wanted: int = 0


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
        self.max_tx_bytes = max_tx_bytes
        self.max_txs = max_txs
        self.recheck = recheck
        self._lock = threading.RLock()

    def check_tx(self, tx: bytes) -> abci.ResponseCheckTx:
        if len(tx) > self.max_tx_bytes:
            return abci.ResponseCheckTx(code=1, log="tx too large")
        key = tx_key(tx)
        if not self.cache.push(key):
            return abci.ResponseCheckTx(code=1, log="tx already in cache")
        res = self.proxy.check_tx(abci.RequestCheckTx(tx=tx))
        with self._lock:
            if not res.is_ok():
                self.cache.remove(key)
            elif len(self.pool) >= self.max_txs:
                self.cache.remove(key)
                return abci.ResponseCheckTx(code=1, log="mempool full")
            else:
                self.pool[key] = MempoolTx(tx=tx, height=self.height, gas_wanted=res.gas_wanted)
        return res

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

    def size(self) -> int:
        with self._lock:
            return len(self.pool)

    def lock(self):
        self._lock.acquire()

    def unlock(self):
        self._lock.release()

    def update(self, height: int, txs: List[bytes], results) -> None:
        """Called with the mempool locked, after FinalizeBlock and the
        app's Commit (reference clist_mempool.go:583)."""
        self.height = height
        for tx, res in zip(txs, results):
            key = tx_key(tx)
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
