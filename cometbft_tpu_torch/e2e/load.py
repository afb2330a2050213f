"""Load generation + commit-latency reporting.

A copy of the JAX package's ``e2e/load.py``.

Reference analog: test/loadtime — a tm-load-test-based generator whose
txs embed their creation timestamp, plus a `report` tool that scans
committed blocks and turns tx timestamps into a latency distribution
(test/loadtime/README.md). Here both halves are one module driven over
the JSON-RPC client: `LoadGenerator.run()` pushes timestamped txs at a
target rate over N logical connections; `latency_report()` walks the
chain and aggregates per-tx commit latency.

Tx format (self-describing, kvstore-compatible key=value so the
universal fake app accepts it, like the reference's e2e app payloads):
b"load:" + seq(16 hex) + "=" + time_ns(19 digits) + ":" + random
padding to `tx_size` bytes.
"""

from __future__ import annotations

import asyncio
import math
import os
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

TX_PREFIX = b"load:"


def make_tx(seq: int, tx_size: int = 256, now_ns: Optional[int] = None) -> bytes:
    body = b"%s%016x=%019d:" % (TX_PREFIX, seq, now_ns or time.time_ns())
    pad = tx_size - len(body)
    if pad > 0:
        body += os.urandom((pad + 1) // 2).hex().encode()[:pad]
    return body


def parse_tx(tx: bytes) -> Optional[int]:
    """Returns the embedded send time_ns, or None for non-load txs."""
    if not tx.startswith(TX_PREFIX):
        return None
    try:
        _, val = tx.split(b"=", 1)
        return int(val.split(b":", 1)[0])
    except (IndexError, ValueError):
        return None


@dataclass
class LoadResult:
    sent: int = 0
    accepted: int = 0
    rejected: int = 0
    duration_s: float = 0.0

    @property
    def send_rate(self) -> float:
        return self.sent / self.duration_s if self.duration_s else 0.0


class LoadGenerator:
    """Rate-controlled tx spammer (reference test/loadtime/cmd/load +
    runner/load.go): `connections` concurrent submitters sharing a
    target aggregate rate, each tx timestamped at send."""

    def __init__(
        self,
        client,  # rpc.client.HTTPClient (or anything with broadcast_tx_sync)
        rate: float = 100.0,  # txs/sec aggregate
        connections: int = 1,
        tx_size: int = 256,
    ):
        self.client = client
        self.rate = rate
        self.connections = connections
        self.tx_size = tx_size
        self._seq = 0

    async def run(self, duration_s: float) -> LoadResult:
        res = LoadResult()
        t0 = time.monotonic()
        interval = self.connections / self.rate

        async def submitter(ci: int) -> None:
            next_at = t0 + (ci / self.rate)
            while True:
                now = time.monotonic()
                if now >= t0 + duration_s:
                    return
                if now < next_at:
                    await asyncio.sleep(min(next_at - now, 0.05))
                    continue
                next_at += interval
                self._seq += 1
                tx = make_tx(self._seq, self.tx_size)
                res.sent += 1
                try:
                    r = await self.client.broadcast_tx_sync(tx)
                    if int(r.get("code", 0)) == 0:
                        res.accepted += 1
                    else:
                        res.rejected += 1
                except asyncio.CancelledError:
                    raise  # gather() cancellation must propagate
                except Exception:
                    res.rejected += 1

        await asyncio.gather(
            *(submitter(i) for i in range(self.connections))
        )
        res.duration_s = time.monotonic() - t0
        return res


@dataclass
class LatencyReport:
    """Per-tx commit latency distribution (reference
    test/loadtime/report: min/max/avg/stddev per experiment)."""

    count: int = 0
    min_s: float = 0.0
    max_s: float = 0.0
    mean_s: float = 0.0
    stddev_s: float = 0.0
    p50_s: float = 0.0
    p95_s: float = 0.0
    heights: int = 0
    # block interval stats (reference test/e2e/runner/benchmark.go)
    block_interval_mean_s: float = 0.0
    block_interval_max_s: float = 0.0

    def to_dict(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "min_s": round(self.min_s, 4),
            "max_s": round(self.max_s, 4),
            "mean_s": round(self.mean_s, 4),
            "stddev_s": round(self.stddev_s, 4),
            "p50_s": round(self.p50_s, 4),
            "p95_s": round(self.p95_s, 4),
            "heights": self.heights,
            "block_interval_mean_s": round(self.block_interval_mean_s, 4),
            "block_interval_max_s": round(self.block_interval_max_s, 4),
        }


def _percentile(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q * len(sorted_vals)))
    return sorted_vals[idx]


async def latency_report(
    client, from_height: int, to_height: int
) -> LatencyReport:
    """Walk [from_height, to_height], matching each load-tx's embedded
    send time against its block's commit timestamp."""
    lats: List[float] = []
    block_times: List[int] = []
    for h in range(from_height, to_height + 1):
        blk = await client.block_decoded(h)
        block_times.append(blk.header.time_ns)
        for tx in blk.data.txs:
            sent_ns = parse_tx(tx)
            if sent_ns is not None:
                lats.append((blk.header.time_ns - sent_ns) / 1e9)
    rep = LatencyReport(heights=to_height - from_height + 1)
    if lats:
        lats.sort()
        rep.count = len(lats)
        rep.min_s = lats[0]
        rep.max_s = lats[-1]
        rep.mean_s = sum(lats) / len(lats)
        rep.stddev_s = math.sqrt(
            sum((x - rep.mean_s) ** 2 for x in lats) / len(lats)
        )
        rep.p50_s = _percentile(lats, 0.50)
        rep.p95_s = _percentile(lats, 0.95)
    if len(block_times) >= 2:
        gaps = [
            (b - a) / 1e9 for a, b in zip(block_times, block_times[1:])
        ]
        rep.block_interval_mean_s = sum(gaps) / len(gaps)
        rep.block_interval_max_s = max(gaps)
    return rep
