"""Micro-batching ingest queue in front of the mempool.

Every tx source that used to call ``mempool.check_tx`` synchronously
on the event loop (p2p ``MempoolReactor.receive``, the RPC
broadcast_tx_* routes) enqueues here instead. A single drainer task
coalesces whatever is pending — up to ``batch_max_txs`` txs or
``batch_flush_ms`` after the first one arrived — and runs ONE
``mempool.check_tx_batch`` off-loop (``asyncio.to_thread``), so:

- the event loop never blocks on an ABCI round-trip;
- per-tx costs (client lock, cache lock, pool lock, key hashing) are
  paid once per batch.

Two entries: ``submit_nowait`` (fire-and-forget, p2p inbound —
bounded queue, drops + counts under overload) and ``await submit``
(RPC paths that must return the CheckTx verdict).

A copy of the JAX package's ``mempool/ingest.py``: the queue is the obs
plane's instrumented one, and ``queue_stats`` is the node's
``mempool.ingest`` registry entry.
"""

from __future__ import annotations

import asyncio
from typing import List, Optional, Tuple

from ..abci import types as abci
from ..obs.queues import InstrumentedQueue
from ..utils.log import get_logger

_log = get_logger("mempool.ingest")

_Item = Tuple[bytes, str, Optional["asyncio.Future"]]


class IngestQueue:
    def __init__(
        self,
        mempool,
        batch_max_txs: int = 256,
        batch_flush_ms: float = 2.0,
        max_queue: int = 10_000,
    ):
        self.mempool = mempool
        self.batch_max_txs = max(1, batch_max_txs)
        self.flush_s = max(0.0, batch_flush_ms) / 1000.0
        self.max_queue = max_queue
        self._q: Optional[InstrumentedQueue] = None
        self._task: Optional[asyncio.Task] = None
        # counters (metrics surface + tests)
        self.submitted = 0
        self.dropped = 0
        self.batches = 0
        self.checked = 0

    # --- lifecycle ----------------------------------------------------

    @property
    def running(self) -> bool:
        return self._task is not None and not self._task.done()

    def start(self) -> None:
        if self.running:
            return
        from ..utils.tasks import spawn

        self._q = InstrumentedQueue(self.max_queue, name="mempool.ingest")
        self._task = spawn(self._drain(), name="mempool-ingest")

    async def stop(self) -> None:
        t, self._task = self._task, None
        if t is not None:
            t.cancel()
            try:
                # bounded: a drain batch stuck in the ABCI executor
                # must not wedge the reactor stop
                await asyncio.wait_for(t, 5.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                pass
        q, self._q = self._q, None
        if q is not None:
            while not q.empty():
                self._resolve(
                    q.get_nowait(),
                    abci.ResponseCheckTx(code=1, log="ingest stopped"),
                )

    def queue_stats(self):
        """Backpressure telemetry (obs/queues.py registry entry);
        ``dropped`` is the plane-lifetime shed count — the live queue
        is rebuilt on every start()."""
        q = self._q
        if q is None:
            return None
        s = q.stats()
        s["dropped"] = self.dropped
        return s

    # --- entries ------------------------------------------------------

    def submit_nowait(self, tx: bytes, sender: str = "") -> bool:
        """Fire-and-forget enqueue (p2p inbound). False = not running
        or queue full (overload backpressure: the tx is dropped, the
        peer will re-gossip it)."""
        q = self._q
        if q is None:
            return False
        try:
            q.put_nowait((tx, sender, None))
        except asyncio.QueueFull:
            self.dropped += 1
            q.count_drop()  # unified shed counter (obs/queues.py)
            return False
        self.submitted += 1
        return True

    async def submit(self, tx: bytes, sender: str = "") -> abci.ResponseCheckTx:
        """Enqueue and await the CheckTx verdict (RPC broadcast)."""
        q = self._q
        if q is None:
            raise RuntimeError("ingest queue is not running")
        fut = asyncio.get_running_loop().create_future()
        await q.put((tx, sender, fut))
        self.submitted += 1
        return await fut

    # --- drainer ------------------------------------------------------

    @staticmethod
    def _resolve(item: _Item, res: abci.ResponseCheckTx) -> None:
        fut = item[2]
        if fut is not None and not fut.done():
            fut.set_result(res)

    async def _collect(self, q: "asyncio.Queue") -> List[_Item]:
        """One coalescing window: block for the first item, then keep
        taking until the batch is full or flush_ms elapsed since the
        first arrival."""
        batch: List[_Item] = [await q.get()]
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.flush_s
        try:
            while len(batch) < self.batch_max_txs:
                if not q.empty():
                    batch.append(q.get_nowait())
                    continue
                remaining = deadline - loop.time()
                if remaining <= 0:
                    break
                try:
                    batch.append(
                        await asyncio.wait_for(q.get(), remaining)
                    )
                except asyncio.TimeoutError:
                    break
        except asyncio.CancelledError:
            # stop() mid-window: items already popped off the queue
            # would otherwise leave their RPC callers awaiting forever
            for item in batch:
                self._resolve(
                    item,
                    abci.ResponseCheckTx(code=1, log="ingest stopped"),
                )
            raise
        return batch

    async def _drain(self) -> None:
        q = self._q
        while True:
            batch = await self._collect(q)
            txs = [b[0] for b in batch]
            senders = [b[1] for b in batch]
            try:
                results = await asyncio.to_thread(
                    self.mempool.check_tx_batch, txs, senders
                )
            except asyncio.CancelledError:
                for item in batch:
                    self._resolve(
                        item,
                        abci.ResponseCheckTx(code=1, log="ingest stopped"),
                    )
                raise
            except Exception as e:
                # an app/proxy blow-up fails THIS batch, not the plane
                _log.error("ingest batch failed", err=repr(e))
                for item in batch:
                    self._resolve(
                        item,
                        abci.ResponseCheckTx(
                            code=1, log=f"ingest failed: {e!r}"
                        ),
                    )
                continue
            self.batches += 1
            self.checked += len(batch)
            for item, res in zip(batch, results):
                self._resolve(item, res)
