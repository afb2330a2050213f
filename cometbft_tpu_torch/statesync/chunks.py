"""Chunk queue (reference statesync/chunks.go): ordered delivery of
snapshot chunks to the app, with refetch support. A copy of the JAX
package's ``statesync/chunks.py``."""

from __future__ import annotations

import asyncio
from typing import Dict, Optional, Set


class ChunkQueue:
    def __init__(self, total: int):
        self.total = total
        self.chunks: Dict[int, bytes] = {}
        self.senders: Dict[int, str] = {}
        self.next_index = 0
        # indexes the APP ACCEPTED (syncer marks them): a sender ban
        # must not rewind these — re-applying an accepted chunk the
        # app never asked to refetch corrupts append-style restores
        self.applied: set = set()
        self._available = asyncio.Event()

    def wanted(self) -> Set[int]:
        return {
            i for i in range(self.total) if i not in self.chunks
        }

    def add(self, index: int, chunk: bytes, sender: str) -> bool:
        if index < 0 or index >= self.total or index in self.chunks:
            return False
        self.chunks[index] = chunk
        self.senders[index] = sender
        if index == self.next_index:
            self._available.set()
        return True

    def discard(self, index: int) -> None:
        """App asked for a refetch of this chunk."""
        self.chunks.pop(index, None)
        self.senders.pop(index, None)
        # an explicit refetch of an accepted chunk re-applies it
        self.applied.discard(index)
        if index <= self.next_index:
            self.next_index = min(self.next_index, index)
            self._available.clear()

    def mark_applied(self, index: int) -> None:
        """The app accepted this chunk (syncer calls on ACCEPT)."""
        self.applied.add(index)

    def discard_sender(self, sender: str) -> list:
        """Drop every UNAPPLIED queued chunk served by ``sender`` (it
        just got banned for serving corrupt data — everything it
        delivered and the app has not yet accepted is suspect,
        reference chunks.go DiscardSender). Chunks the app already
        ACCEPTED stay: re-applying them unasked would corrupt
        append-style restores; the app can still name them via
        ``refetch_chunks`` explicitly. Returns the discarded
        indexes."""
        dropped = [
            i
            for i, s in list(self.senders.items())
            if s == sender and i not in self.applied
        ]
        for i in dropped:
            self.discard(i)
        return dropped

    async def next(self, timeout: float = 10.0):
        """(index, chunk, sender) in strict order."""
        while self.next_index not in self.chunks:
            self._available.clear()
            await asyncio.wait_for(self._available.wait(), timeout)
        i = self.next_index
        self.next_index += 1
        if self.next_index in self.chunks:
            self._available.set()
        return i, self.chunks[i], self.senders.get(i, "")

    def done(self) -> bool:
        return self.next_index >= self.total
