"""Link fault plane: per-(src, dst) network faults for MemoryTransport.

A copy of the JAX package's ``chaos/links.py``, composed over the
port's ``p2p/fuzz.FuzzedConnection``; for one seed the per-link
decision streams equal the JAX table's.

The LinkTable is the pluggable ``link_hook`` of
``p2p.transport.MemoryTransport``: every in-memory connection side is
wrapped in a ChaosConnection that consults the table's mutable
per-directed-link state on each write. Supported faults:

- **partition** (``up=False``): writes blackhole silently (the
  connection stays up; reliability comes from the consensus reactor's
  gossip retransmission once the link heals) and new dials are
  refused;
- **loss**: one-way drop probability per message;
- **latency + jitter**: fixed delay plus uniform jitter per message
  (applied in the sender's write path, preserving per-link ordering
  like a real FIFO link);
- **duplication**: the message is written twice;
- **reordering**: the message is held back and swapped with the next
  write on the same link (a held message still pending at close is
  dropped — reordering degrades to loss at stream end).

Determinism: the table owns a master ``random.Random(seed)`` (used by
the nemesis scheduler for schedule-level draws); each directed link
draws from its own ``random.Random`` derived from the master seed and
the link's stable (src, dst) key. Per-link decision streams are
therefore a pure function of (seed, link, op index) — independent of
cross-link scheduler interleaving — which is what makes a failing run
replayable: same seed + same schedule => same decision stream on
every link. Each decision is appended to a bounded per-link log (the
fault trace).

Reordering/duplication caveat: faults land between the mux layer and
the wire, so a reordered or duplicated mid-message chunk corrupts
MConnection framing and tears the connection down — which the p2p
stack must survive (persistent-peer reconnect). Invariant schedules
that want steady progress keep those probabilities at 0 and use
partitions/loss/latency instead.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Tuple

from ..p2p.fuzz import FuzzConnConfig, FuzzedConnection

# decision codes recorded in the per-link trace
DROP_PARTITION = "P"
DROP_LOSS = "L"
DUPLICATE = "2"
HOLD_REORDER = "R"
PASS = "."

_TRACE_LIMIT = 20_000


@dataclass
class LinkState:
    """Mutable fault state of one directed link."""

    up: bool = True
    loss: float = 0.0
    latency_s: float = 0.0
    jitter_s: float = 0.0
    duplicate: float = 0.0
    reorder: float = 0.0


class LinkTable:
    """Per-(src, dst) link states + seeded randomness + fault trace.

    Satisfies MemoryTransport's ``link_hook`` protocol:
    ``allow_dial(src, dst)`` and ``wrap(sconn, src, dst)``.
    """

    def __init__(
        self,
        seed: int,
        default: Optional[LinkState] = None,
        fuzz_config: Optional[FuzzConnConfig] = None,
    ):
        self.seed = seed
        self.rng = random.Random(seed)  # master: nemesis-level draws
        self.default = default or LinkState()
        self.fuzz_config = fuzz_config  # optional composed conn fuzzer
        self._links: Dict[Tuple[str, str], LinkState] = {}
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self._decisions: Dict[Tuple[str, str], List[str]] = {}

    # --- state --------------------------------------------------------

    def link(self, src: str, dst: str) -> LinkState:
        key = (src, dst)
        st = self._links.get(key)
        if st is None:
            st = self._links[key] = replace(self.default)
        return st

    def set_link(self, src: str, dst: str, **fields) -> None:
        """Mutate one directed link while the network runs."""
        st = self.link(src, dst)
        for k, v in fields.items():
            if not hasattr(st, k):
                raise ValueError(f"unknown link fault field {k!r}")
            setattr(st, k, v)

    def set_symmetric(self, a: str, b: str, **fields) -> None:
        self.set_link(a, b, **fields)
        self.set_link(b, a, **fields)

    def partition(self, groups: Iterable[Iterable[str]]) -> None:
        """Partition the named nodes into isolated groups: links
        between different groups go down, links within a group come
        back up. Nodes absent from every group are untouched."""
        gs = [list(g) for g in groups]
        for i, ga in enumerate(gs):
            for j, gb in enumerate(gs):
                for a in ga:
                    for b in gb:
                        if a != b:
                            self.link(a, b).up = i == j

    def heal(self) -> None:
        """Bring every link back up (other faults keep their state)."""
        for st in self._links.values():
            st.up = True

    # --- transport hook protocol --------------------------------------

    def allow_dial(self, src: str, dst: str) -> bool:
        return self.link(src, dst).up and self.link(dst, src).up

    def wrap(self, sconn, src: str, dst: str):
        if self.fuzz_config is not None and self.fuzz_config.enable:
            # compose with the point fuzzer (p2p/fuzz.py), sharing the
            # link's deterministic stream
            sconn = FuzzedConnection(
                sconn, self.fuzz_config, rng=self.rng_for(src, dst)
            )
        return ChaosConnection(sconn, self, src, dst)

    # --- determinism / trace ------------------------------------------

    def rng_for(self, src: str, dst: str) -> random.Random:
        """The directed link's private stream: derived from the master
        seed + stable link key, persistent across reconnects, so its
        decision sequence depends only on the link's own op index."""
        key = (src, dst)
        rng = self._rngs.get(key)
        if rng is None:
            rng = self._rngs[key] = random.Random(
                f"{self.seed}|{src}->{dst}"
            )
        return rng

    def record(self, src: str, dst: str, code: str) -> None:
        log = self._decisions.setdefault((src, dst), [])
        if len(log) < _TRACE_LIMIT:
            log.append(code)

    def decision_log(self, src: str, dst: str) -> str:
        return "".join(self._decisions.get((src, dst), []))

    def decision_counts(self) -> Dict[str, Dict[str, int]]:
        """{src->dst: {code: count}} summary for reports."""
        out: Dict[str, Dict[str, int]] = {}
        for (src, dst), log in sorted(self._decisions.items()):
            counts: Dict[str, int] = {}
            for c in log:
                counts[c] = counts.get(c, 0) + 1
            out[f"{src[:8]}->{dst[:8]}"] = counts
        return out


class ChaosConnection:
    """SecretConnection-surface wrapper applying the (src, dst) link's
    faults to every outbound message. Reads pass through — one-way
    semantics come from each side wrapping its own write direction."""

    def __init__(self, sconn, table: LinkTable, src: str, dst: str):
        self._sconn = sconn
        self._table = table
        self._src = src
        self._dst = dst
        self._rng = table.rng_for(src, dst)
        self._held: Optional[bytes] = None

    def __getattr__(self, name):
        # identity/lifecycle passthrough (remote_pubkey, ...)
        return getattr(self._sconn, name)

    async def write_msg(self, data: bytes) -> int:
        st = self._table.link(self._src, self._dst)
        rec = self._table.record
        if not st.up:
            rec(self._src, self._dst, DROP_PARTITION)
            return len(data)  # blackhole: sender believes it sent
        if st.loss > 0 and self._rng.random() < st.loss:
            rec(self._src, self._dst, DROP_LOSS)
            return len(data)
        if st.latency_s > 0 or st.jitter_s > 0:
            delay = st.latency_s
            if st.jitter_s > 0:
                delay += self._rng.random() * st.jitter_s
            if delay > 0:
                await asyncio.sleep(delay)
        out = [data]
        if (
            st.reorder > 0
            and self._held is None
            and self._rng.random() < st.reorder
        ):
            self._held = data
            rec(self._src, self._dst, HOLD_REORDER)
            return len(data)
        if self._held is not None:
            out.append(self._held)  # delivered AFTER the newer message
            self._held = None
        if st.duplicate > 0 and self._rng.random() < st.duplicate:
            out.append(data)
            rec(self._src, self._dst, DUPLICATE)
        else:
            rec(self._src, self._dst, PASS)
        n = 0
        for frame in out:
            n += await self._sconn.write_msg(frame)
        return n

    async def read_chunk(self) -> bytes:
        return await self._sconn.read_chunk()

    async def read_msg(self) -> bytes:
        return await self._sconn.read_msg()

    def close(self) -> None:
        self._held = None  # reorder hold-back degrades to loss at close
        self._sconn.close()
