"""Seeded workload plane for chaos runs (the scenario factory's
workload axis, docs/CHAOS.md "Scenario factory").

A copy of the JAX package's ``chaos/workload.py``: for one seed the
tx stream is byte-equal to the JAX driver's.

A ``WorkloadSpec`` declares the tx-storm shape; a ``WorkloadDriver``
pumps deterministic txs into the running net for the whole schedule,
riding the mempool's ingest plane when present (``MempoolReactor.ingest``
micro-batches + sheds under overload) and falling back to direct
``mempool.check_tx``. Tx payloads are a pure function of (workload
seed, sequence number), so two same-seed runs submit byte-identical
tx streams — the workload is part of the replay contract exactly
like the link-fault decision streams.

Patterns:

- ``sustained`` — a steady ``tps`` trickle, the baseline load every
  scenario should survive;
- ``bursty`` — ``burst_txs`` back-to-back txs, then ``burst_gap_s``
  of silence: exercises ingest-queue backpressure + shed counters;
- ``none`` — no workload (pure fault schedules).

``tx_bytes`` pads every tx to a fixed size (large-tx storms stress
gossip framing + WAL record sizes). Specs round-trip through JSON so
a scenario file fully describes its run.
"""

from __future__ import annotations

import asyncio
import json
import random
from dataclasses import asdict, dataclass
from typing import Optional

PATTERNS = ("none", "sustained", "bursty")


@dataclass
class WorkloadSpec:
    pattern: str = "sustained"
    tps: float = 40.0  # sustained: target submissions/s
    burst_txs: int = 64  # bursty: txs per burst
    burst_gap_s: float = 0.5  # bursty: silence between bursts
    tx_bytes: int = 32  # min tx size (padded), caps at max_tx_bytes
    targets: int = 2  # submit through the first N running nodes

    def __post_init__(self):
        if self.pattern not in PATTERNS:
            raise ValueError(f"unknown workload pattern {self.pattern!r}")
        if self.tx_bytes < 16:
            raise ValueError("tx_bytes >= 16 (key=value framing)")

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_dict(cls, d: dict) -> "WorkloadSpec":
        return cls(**d)


class WorkloadDriver:
    """Background task pumping the spec's tx stream into the net.

    ``start(net)`` spawns the loop; ``stop()`` is bounded by
    construction (one cancel, the loop never blocks on a slow node —
    submissions are fire-and-forget). Counters: ``submitted`` (txs
    handed to an ingest plane or mempool), ``shed`` (ingest queue
    full — backpressure did its job, the tx is dropped by design)."""

    def __init__(self, spec: WorkloadSpec, seed: int):
        self.spec = spec
        self.seed = seed
        self.rng = random.Random(f"workload|{seed}")
        self.submitted = 0
        self.shed = 0
        self._seq = 0
        self._task: Optional[asyncio.Task] = None

    # --- tx stream (pure function of seed + seq) ----------------------

    def _next_tx(self) -> bytes:
        i = self._seq
        self._seq += 1
        key = b"w%d-%08d" % (self.seed & 0xFFFF, i)
        pad = self.spec.tx_bytes - len(key) - 1
        val = bytes(
            self.rng.randrange(97, 123) for _ in range(max(1, pad))
        )
        return key + b"=" + val

    # --- submission ---------------------------------------------------

    def _submit_one(self, net) -> None:
        running = net.running_nodes()
        if not running:
            return
        tx = self._next_tx()
        _, node = running[self._seq % min(self.spec.targets, len(running))]
        ingest = getattr(
            getattr(node, "mempool_reactor", None), "ingest", None
        )
        if ingest is not None and ingest.running:
            if ingest.submit_nowait(tx, sender="workload"):
                self.submitted += 1
            else:
                self.shed += 1
            return
        try:
            node.parts.mempool.check_tx(tx)
            self.submitted += 1
        except Exception:
            self.shed += 1  # node died mid-submit: the storm goes on

    async def _run(self, net) -> None:
        spec = self.spec
        if spec.pattern == "none":
            return
        while True:
            if spec.pattern == "sustained":
                self._submit_one(net)
                await asyncio.sleep(1.0 / max(1.0, spec.tps))
            else:  # bursty
                for _ in range(spec.burst_txs):
                    self._submit_one(net)
                await asyncio.sleep(spec.burst_gap_s)

    # --- lifecycle ----------------------------------------------------

    def start(self, net) -> "WorkloadDriver":
        from ..utils.tasks import spawn

        if self.spec.pattern != "none" and self._task is None:
            self._task = spawn(self._run(net), name="chaos-workload")
        return self

    async def stop(self) -> None:
        t, self._task = self._task, None
        if t is not None:
            t.cancel()
            try:
                await asyncio.wait_for(t, 5.0)
            except (asyncio.TimeoutError, asyncio.CancelledError):
                pass

    def stats(self) -> dict:
        return {
            "pattern": self.spec.pattern,
            "submitted": self.submitted,
            "shed": self.shed,
        }
