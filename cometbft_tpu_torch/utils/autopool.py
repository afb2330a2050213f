"""Auto-scaling worker pool (fork feature, reference
internal/autopool/pool.go:10-13 + scaler.go).

Workers drain a shared FIFO queue of callables; a scaler task grows the
pool when the queue stays deep and shrinks it when idle, between
min/max bounds, every ``SCALE_INTERVAL_S``. The switch uses it to
process reactor messages (``Switch(use_autopool=True)``, dispatch =
``pool.submit``) so one slow reactor callback does not serialize every
peer's traffic, as the fork's lp2p reactor set does. A copy of the JAX
package's ``utils/autopool.py``.
"""

from __future__ import annotations

import asyncio
import traceback
from typing import Callable, Optional

SCALE_INTERVAL_S = 0.5
GROW_QUEUE_DEPTH = 32  # grow when backlog exceeds this per worker
SHRINK_IDLE_ROUNDS = 4  # shrink after this many idle scale checks


class AutoPool:
    def __init__(
        self,
        min_workers: int = 1,
        max_workers: int = 8,
        queue_size: int = 10_000,
    ):
        self.min_workers = min_workers
        self.max_workers = max_workers
        self.queue: asyncio.Queue = asyncio.Queue(queue_size)
        self._workers: list = []
        self._scaler: Optional[asyncio.Task] = None
        self._idle_rounds = 0
        self.processed = 0
        # the most workers the pool has had at once
        self.max_size = 0
        self._stopped = False

    # --- lifecycle ----------------------------------------------------

    def start(self) -> None:
        for _ in range(self.min_workers):
            self._spawn()
        self._scaler = asyncio.create_task(self._scale_routine())

    async def stop(self) -> None:
        self._stopped = True
        if self._scaler:
            self._scaler.cancel()
        for w in self._workers:
            w.cancel()
        for w in self._workers:
            try:
                await w
            except asyncio.CancelledError:
                if not w.cancelled():
                    raise  # outer cancel of stop() itself: propagate
            except Exception:
                pass  # worker exceptions already logged in _worker
        self._workers.clear()

    # --- submission ---------------------------------------------------

    def submit(self, fn: Callable, *args) -> bool:
        """Queue fn(*args); False if the pool is saturated."""
        if self._stopped:
            return False
        try:
            self.queue.put_nowait((fn, args))
        except asyncio.QueueFull:
            return False
        return True

    # --- internals ----------------------------------------------------

    def _spawn(self) -> None:
        self._workers.append(asyncio.create_task(self._worker()))
        self.max_size = max(self.max_size, len(self._workers))

    async def _worker(self) -> None:
        while True:
            fn, args = await self.queue.get()
            try:
                r = fn(*args)
                if asyncio.iscoroutine(r):
                    await r
            except asyncio.CancelledError:
                raise
            except Exception:
                traceback.print_exc()
            finally:
                self.processed += 1

    async def _scale_routine(self) -> None:
        while True:
            await asyncio.sleep(SCALE_INTERVAL_S)
            depth = self.queue.qsize()
            n = len(self._workers)
            if depth > GROW_QUEUE_DEPTH * n and n < self.max_workers:
                self._spawn()
                self._idle_rounds = 0
            elif depth == 0:
                self._idle_rounds += 1
                if self._idle_rounds >= SHRINK_IDLE_ROUNDS and n > self.min_workers:
                    w = self._workers.pop()
                    w.cancel()
                    self._idle_rounds = 0
            else:
                self._idle_rounds = 0

    @property
    def size(self) -> int:
        return len(self._workers)
