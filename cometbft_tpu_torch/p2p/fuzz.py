"""FuzzedConnection: network fault injection without a cluster.

A copy of the JAX package's ``p2p/fuzz.py``; ``FuzzConnConfig`` is the
``[fuzz]`` section of the port's config and takes no attribute it
lacks (slots).

Reference p2p/fuzz.go:14 — wraps a connection and randomly drops,
delays, or kills traffic so reactor/peer code is exercised under
pathological networks in ordinary tests. Wraps our SecretConnection
surface (write_msg/read_chunk) instead of a raw socket: the faults
land between the mux/mconnection layer and the wire, which is where
the reference's net.Conn wrapper sits relative to its stack.

Config: [fuzz] section (reference config/config.go:896
FuzzConnConfig), applied by the transport when enabled.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass
from typing import Optional

MODE_DROP = "drop"
MODE_DELAY = "delay"


@dataclass(slots=True)
class FuzzConnConfig:
    enable: bool = False
    mode: str = MODE_DROP
    max_delay_ms: int = 3000
    prob_drop_rw: float = 0.2
    prob_drop_conn: float = 0.00
    prob_sleep: float = 0.00
    seed: Optional[int] = None


class FuzzedConnection:
    """Same surface as SecretConnection; every read/write may be
    dropped (write reports success, bytes vanish), delayed, or the
    whole connection torn down, per config probabilities."""

    def __init__(self, sconn, config: FuzzConnConfig, rng=None):
        self._sconn = sconn
        self._cfg = config
        # rng injection: the chaos link plane (chaos/links.LinkTable)
        # composes a per-link seeded stream so fuzz decisions replay
        # deterministically alongside link faults
        self._rng = rng or random.Random(getattr(config, "seed", None))
        self._dead = False

    # counters for tests/metrics
    dropped_writes = 0
    dropped_reads = 0

    def __getattr__(self, name):
        # identity/lifecycle passthrough (local_pubkey, close, ...)
        return getattr(self._sconn, name)

    async def _fuzz(self) -> bool:
        """Apply one fault decision; returns True if the op should be
        swallowed."""
        cfg = self._cfg
        if self._dead:
            raise ConnectionError("fuzzed connection killed")
        if cfg.mode == MODE_DELAY:
            if cfg.prob_sleep > 0 and self._rng.random() < cfg.prob_sleep:
                await asyncio.sleep(
                    self._rng.uniform(0, cfg.max_delay_ms / 1000.0)
                )
            return False
        # drop mode
        r = self._rng.random()
        if r < cfg.prob_drop_conn:
            self._dead = True
            self._sconn.close()
            raise ConnectionError("fuzzed connection killed")
        if r < cfg.prob_drop_conn + cfg.prob_drop_rw:
            return True
        return False

    async def write_msg(self, data: bytes) -> int:
        if await self._fuzz():
            self.dropped_writes += 1
            return len(data)  # lie: bytes vanish on the floor
        return await self._sconn.write_msg(data)

    async def read_chunk(self) -> bytes:
        while True:
            chunk = await self._sconn.read_chunk()
            if await self._fuzz():
                self.dropped_reads += 1
                continue  # swallow this chunk, keep reading
            return chunk

    async def read_msg(self) -> bytes:
        return await self.read_chunk()

    def close(self) -> None:
        self._sconn.close()


def maybe_fuzz(sconn, config: Optional[FuzzConnConfig]):
    """Wrap when fuzzing is enabled (transport hook)."""
    if config is not None and config.enable:
        return FuzzedConnection(sconn, config)
    return sconn
