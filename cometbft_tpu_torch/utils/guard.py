"""TTL'd LRU dedup cache (fork feature, reference internal/guard/guard.go).

A copy of the JAX package's ``utils/guard.py``: the app-side mempool
puts it in front of ``InsertTx`` so a tx seen within its TTL is refused
before it reaches the app.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict


class TTLGuard:
    def __init__(self, ttl_s: float = 60.0, max_size: int = 100_000):
        self.ttl = ttl_s
        self.max_size = max_size
        self._od: "OrderedDict[bytes, float]" = OrderedDict()
        self._lock = threading.Lock()

    def check_and_set(self, key: bytes) -> bool:
        """True if key was NOT present (and is now recorded)."""
        now = time.monotonic()
        with self._lock:
            exp = self._od.get(key)
            if exp is not None and exp > now:
                return False
            self._od[key] = now + self.ttl
            self._od.move_to_end(key)
            # opportunistic pruning
            while len(self._od) > self.max_size:
                self._od.popitem(last=False)
            if len(self._od) % 1024 == 0:
                stale = [k for k, e in self._od.items() if e <= now]
                for k in stale:
                    del self._od[k]
            return True

    def __len__(self) -> int:
        return len(self._od)
