"""Follower replicas: the serving-fleet deployment shape (a copy of
the JAX package's ``fleet/follower.py``).

A ``FollowerNode`` is a NON-validator: no privval, no mempool
proposing — it tail-follows the committee's committed chain (the
blocksync shape, in-process: a bounded tail loop applying heights in
order from a commit source) and runs the full read stack per replica:

- ``ReplicaFanout`` — height-batched, replica-paced event delivery to
  routed subscriber sessions. Unlike the validator-side FanoutHub
  (rpc/fanout.py), a follower needs no per-subscriber elastic
  queue+writer-task machinery: the tail applies heights at its own
  pace, delivery for a height completes before the tail advances, and
  a client that cannot keep up is SHED to the router — which can
  re-admit it elsewhere and replay the gap from the store losslessly
  (the failover path doubles as slow-client recovery). That trades
  12µs/frame of queue+task indirection for ~2µs of splice+send, which
  is what lets a fleet's aggregate delivered-frames/s scale past the
  single hub's (``chip_smoke.py`` phase 19a measures both).
- ``LightServingPlane`` (light/serving.py) — optional per replica,
  with a shared-process ``VerifiedHeaderCache`` so single-flight
  verification holds FLEET-wide, not per replica. The plane verifies
  on its own device (the card's light tickets, ``PRIORITY_LIGHT``).
- the indexer read barrier — when an ``IndexerService`` rides the
  replica, ``read_barrier()`` awaits its sealed-vs-flushed barrier so
  indexed reads are read-your-writes per replica; the router's
  consistency tokens generalize the same barrier cross-replica.

``NodeReplica`` adapts a real running ``node.Node`` (validator or
blocksync follower) to the same replica surface so the router can
front mixed deployments.
"""

from __future__ import annotations

import asyncio
import json
from typing import Callable, Dict, List, Optional, Set

from ..rpc.fanout import _event_attrs, _event_json
from ..trace import NOOP
from ..types import events as ev
from ..utils.log import get_logger
from ..utils.tasks import spawn

_log = get_logger("fleet.follower")

# bounded wait for the cancelled tail task to unwind on kill/stop: a
# wedged source read must not hang fleet teardown
TAIL_STOP_WAIT_S = 2.0

# cooperative-yield stride inside a height's delivery batch: direct
# sends to in-process sinks don't otherwise yield, and the tail must
# not monopolize the loop for a 10k-subscriber height
YIELD_EVERY = 1024


def _tx_result_empty():
    from ..abci import types as abci

    return abci.ExecTxResult(code=0)


def height_events(
    block, results_fn: Optional[Callable] = None
) -> List[ev.Event]:
    """The canonical event bundle for one committed height, built
    FROM THE STORE BLOCK — used by both the live tail and failover
    replay so a replayed frame is byte-identical to the live frame it
    stands in for (rpc/fanout.py frame shape)."""
    h = block.header.height
    out = [
        ev.Event(
            ev.EVENT_NEW_BLOCK,
            {"block": block, "block_id": None, "result_events": []},
            {"height": str(h)},
        )
    ]
    txs = block.data.txs if block.data is not None else []
    for i, tx in enumerate(txs):
        import hashlib

        res = (
            results_fn(block, i, tx)
            if results_fn is not None
            else _tx_result_empty()
        )
        out.append(
            ev.Event(
                ev.EVENT_TX,
                {"height": h, "index": i, "tx": tx, "result": res},
                {"hash": hashlib.sha256(tx).hexdigest()},
            )
        )
    return out


def event_payload(e: ev.Event, query_str: str, attrs=None) -> str:
    """One group-shared payload, identical in structure and key order
    to FanoutHub._deliver's encoding (splice ``prefix + payload + '}'``
    per subscriber)."""
    if attrs is None:
        attrs = _event_attrs(e)
    return json.dumps(
        {"query": query_str, "data": _event_json(e), "events": attrs}
    )


# --- commit sources ---------------------------------------------------


class StoreSource:
    """Tail source over a committee node's block store (the in-process
    stand-in for blocksync tail-follow: same data, same ordering, no
    sockets). ``results_fn(block, i, tx)`` supplies ExecTxResults for
    Tx events when the deployment has them (followers replaying
    finalize responses); default is an empty result."""

    def __init__(self, block_store, results_fn=None):
        self._store = block_store
        self.results_fn = results_fn

    def height(self) -> int:
        return self._store.height()

    def base(self) -> int:
        try:
            return self._store.base()
        except Exception:
            return 1

    def load_block(self, height: int):
        return self._store.load_block(height)

    async def wait_beyond(self, height: int, timeout_s: float) -> None:
        """Park until the source head passes ``height`` (bounded);
        store-backed sources poll — stream sources override with a
        real wakeup."""
        deadline = asyncio.get_running_loop().time() + timeout_s
        while self.height() <= height:
            if asyncio.get_running_loop().time() >= deadline:
                return
            await asyncio.sleep(0.005)


class StreamSource(StoreSource):
    """In-process committee feed for tests/bench: blocks are pushed
    via ``advance`` and tails wake immediately (no poll latency)."""

    def __init__(self, results_fn=None):
        self._blocks: Dict[int, object] = {}
        self._height = 0
        self.results_fn = results_fn
        self._advanced: asyncio.Event = asyncio.Event()

    def height(self) -> int:
        return self._height

    def base(self) -> int:
        return 1

    def load_block(self, height: int):
        return self._blocks.get(height)

    def advance(self, block) -> None:
        h = block.header.height
        self._blocks[h] = block
        if h > self._height:
            self._height = h
        self._advanced.set()

    async def wait_beyond(self, height: int, timeout_s: float) -> None:
        if self.height() > height:
            return
        self._advanced.clear()
        if self.height() > height:  # advance raced the clear
            return
        try:
            await asyncio.wait_for(self._advanced.wait(), timeout_s)
        except asyncio.TimeoutError:
            pass


# --- replica-paced fan-out --------------------------------------------


class _FleetGroup:
    __slots__ = ("query_str", "query", "members")

    def __init__(self, query_str: str, query):
        self.query_str = query_str
        self.query = query
        self.members: Set = set()


class ReplicaFanout:
    """Height-batched delivery to routed sessions: attrs once per
    event, ONE encode per (event, query group), one direct-awaited
    ``send_str`` per member frame. Membership snapshots are taken per
    HEIGHT (at ``deliver`` entry), so a session attached mid-height
    receives nothing for that height — its first live height is a
    clean boundary, which is what makes the router's replay splice
    lossless (router.py)."""

    def __init__(self, name: str = "", tracer=NOOP):
        self.name = name
        self.tracer = tracer
        self._groups: Dict[str, _FleetGroup] = {}
        self.encodes = 0
        self.delivered = 0
        self.dropped = 0  # sends that raised: member failed mid-frame

    def attach(self, member) -> None:
        g = self._groups.get(member.query_str)
        if g is None:
            g = _FleetGroup(member.query_str, member.query)
            self._groups[member.query_str] = g
        g.members.add(member)

    def detach(self, member) -> None:
        g = self._groups.get(member.query_str)
        if g is not None:
            g.members.discard(member)
            if not g.members:
                self._groups.pop(member.query_str, None)

    def members(self) -> int:
        return sum(len(g.members) for g in self._groups.values())

    async def deliver(self, events: List[ev.Event], height: int) -> None:
        """Deliver one height's event bundle to every member attached
        at entry; advance each surviving member's ``on_height`` only
        after ALL its frames for the height went out."""
        snapshot = [
            (g, list(g.members))
            for g in list(self._groups.values())
            if g.members
        ]
        if not snapshot:
            return
        failed: Set = set()
        sends = 0
        for e in events:
            attrs = _event_attrs(e)  # once per event
            for g, members in snapshot:
                if not g.query.matches(attrs):
                    continue
                payload = event_payload(e, g.query_str, attrs)
                self.encodes += 1
                for m in members:
                    if m in failed:
                        continue
                    try:
                        await m.send_str(m._prefix + payload + "}")
                        self.delivered += 1
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        # a dead sink degrades ITS session only; the
                        # router reaps it via the on_failed callback
                        self.dropped += 1
                        failed.add(m)
                    sends += 1
                    if sends % YIELD_EVERY == 0:
                        await asyncio.sleep(0)
        for g, members in snapshot:
            for m in members:
                if m in failed:
                    self.detach(m)
                    m.on_send_failed()
                else:
                    m.on_height(height)

    def stats(self) -> dict:
        return {
            "groups": len(self._groups),
            "members": self.members(),
            "encodes": self.encodes,
            "delivered": self.delivered,
            "dropped": self.dropped,
        }


# --- the follower replica ---------------------------------------------


class FollowerNode:
    """Non-validator read replica tail-following a commit source."""

    role = "follower"
    # delivery is replica-paced (ReplicaFanout calls on_height); the
    # router needs no frame-sniffing height fallback on this path
    HUB_DELIVERY = False

    def __init__(
        self,
        name: str,
        source,
        *,
        light_plane=None,
        indexer_service=None,
        poll_s: float = 0.05,
        tracer=NOOP,
    ):
        self.name = name
        self.source = source
        self.tracer = tracer
        self.poll_s = poll_s
        self.fanout = ReplicaFanout(name=name, tracer=tracer)
        self.light_plane = light_plane
        self.indexer_service = indexer_service
        self.alive = False
        self.stalled = False  # lag injection (tests)
        self.draining = False
        self._served = 0
        self._tail_task: Optional[asyncio.Future] = None
        self._barriers: List[tuple] = []  # (height, asyncio.Event)
        self.on_death: Optional[Callable] = None
        self.heights_applied = 0

    # --- lifecycle ----------------------------------------------------

    async def start(self, from_height: Optional[int] = None) -> None:
        """Join at the current committee head (``from_height`` pins a
        deeper starting point for tests) and tail forward."""
        if self._tail_task is not None:
            return
        self._served = (
            self.source.height() if from_height is None else from_height
        )
        self.alive = True
        self._tail_task = spawn(
            self._tail(), name=f"fleet-tail-{self.name}"
        )

    async def stop(self) -> None:
        """Graceful: stop the tail, leave serving state readable."""
        self.alive = False
        t, self._tail_task = self._tail_task, None
        if t is not None and not t.done():
            t.cancel()
            try:
                await asyncio.wait_for(
                    asyncio.gather(t, return_exceptions=True),
                    TAIL_STOP_WAIT_S,
                )
            except asyncio.TimeoutError:
                pass
        self._fire_barriers(dead=True)

    async def kill(self) -> None:
        """Replica death (the JAX chaos ``replica_kill``): tail torn down,
        sessions stranded mid-stream — the router's failover must
        re-admit them elsewhere with zero lost commits."""
        await self.stop()
        cb = self.on_death
        if cb is not None:
            cb(self)

    async def drain(self, timeout_s: float = 5.0) -> dict:
        """Rotate-out: stop admitting new serving work and resolve
        in-flight light requests (bounded). The tail
        keeps following so the replica can be rotated back in."""
        self.draining = True
        if self.light_plane is not None:
            return await asyncio.to_thread(
                self.light_plane.drain, timeout_s
            )
        return {"drained": True, "waited_s": 0.0}

    def resume_serving(self) -> None:
        self.draining = False
        if self.light_plane is not None:
            self.light_plane.resume()

    # --- the tail -----------------------------------------------------

    async def _tail(self) -> None:
        try:
            while True:
                applied = False
                while not self.stalled and self._served < self.source.height():
                    h = self._served + 1
                    block = self.source.load_block(h)
                    if block is None:
                        break  # pruned/not yet visible: re-poll
                    events = height_events(
                        block, getattr(self.source, "results_fn", None)
                    )
                    await self.fanout.deliver(events, h)
                    self._served = h
                    self.heights_applied += 1
                    self._fire_barriers()
                    applied = True
                if applied:
                    await asyncio.sleep(0)
                elif (
                    self.stalled
                    or self._served < self.source.height()
                ):
                    # stalled (lag injection) or the next block isn't
                    # visible yet: wait_beyond would return
                    # immediately (head already past us) — poll, don't
                    # busy-spin the shared loop
                    await asyncio.sleep(self.poll_s)
                else:
                    await self.source.wait_beyond(
                        self._served, self.poll_s
                    )
        except asyncio.CancelledError:
            raise
        except Exception:
            _log.error("follower tail died", name=self.name)
            import traceback

            traceback.print_exc()
            self.alive = False
            cb = self.on_death
            if cb is not None:
                cb(self)

    # --- height barrier (the consistency-token seam) ------------------

    def served_height(self) -> int:
        return self._served

    def lag_heights(self) -> int:
        return max(0, self.source.height() - self._served)

    async def wait_height(self, height: int, timeout_s: float) -> bool:
        """Height barrier: True once this replica has served through
        ``height``; False on timeout or replica death (the caller
        must route away, NEVER serve stale)."""
        if self._served >= height:
            return True
        if not self.alive:
            return False
        evt = asyncio.Event()
        self._barriers.append((height, evt))
        try:
            await asyncio.wait_for(evt.wait(), timeout_s)
        except asyncio.TimeoutError:
            return False
        return self._served >= height

    def _fire_barriers(self, dead: bool = False) -> None:
        if not self._barriers:
            return
        keep = []
        for height, evt in self._barriers:
            if dead or self._served >= height:
                evt.set()
            else:
                keep.append((height, evt))
        self._barriers = keep

    async def read_barrier(self, timeout_s: float = 5.0) -> None:
        """Indexed-read barrier: everything this replica has sealed is
        flushed (state/indexer.py) — per-replica read-your-writes."""
        if self.indexer_service is not None:
            await self.indexer_service.barrier(timeout_s)

    # --- session membership (router-facing) ---------------------------

    def attach(self, member) -> None:
        self.fanout.attach(member)

    async def detach_member(self, member) -> None:
        self.fanout.detach(member)

    def members(self) -> int:
        return self.fanout.members()

    # --- introspection ------------------------------------------------

    def status(self) -> dict:
        return {
            "name": self.name,
            "role": self.role,
            "alive": self.alive,
            "stalled": self.stalled,
            "draining": self.draining,
            "served_height": self._served,
            "lag_heights": self.lag_heights(),
            "sessions": self.fanout.members(),
            "fanout": self.fanout.stats(),
            "light": self.light_plane.stats()
            if self.light_plane is not None
            else None,
        }


class NodeReplica:
    """Adapter: a real running ``node.Node`` behind the same replica
    surface the router speaks (served_height / wait_height / attach).
    Sessions attach through the node's FanoutHub — per-subscriber
    elastic queues, real-socket shape — and the routed session tracks
    delivered heights by parsing frames (router.py)."""

    def __init__(self, node, name: Optional[str] = None):
        self.node = node
        self.name = name or getattr(
            node.config.base, "moniker", ""
        ) or "node"
        self.alive = True
        self.stalled = False
        self.draining = False
        self.on_death: Optional[Callable] = None
        self._subs: Dict[object, object] = {}

    # sessions ride the node's FanoutHub (per-subscriber queues, no
    # on_height signal) — the router parses frame heights on this path
    HUB_DELIVERY = True

    @property
    def role(self) -> str:
        return (
            "validator"
            if getattr(self.node.parts, "privval", None) is not None
            else "follower"
        )

    @property
    def light_plane(self):
        return getattr(self.node, "light_serving_plane", None)

    @property
    def fanout(self):
        return self.node.rpc_server.fanout

    def served_height(self) -> int:
        return self.node.height

    def lag_heights(self) -> int:
        return 0  # a live node's own head IS its committee view

    async def wait_height(self, height: int, timeout_s: float) -> bool:
        deadline = asyncio.get_running_loop().time() + timeout_s
        while self.node.height < height:
            if (
                not self.alive
                or asyncio.get_running_loop().time() >= deadline
            ):
                return False
            await asyncio.sleep(0.01)
        return True

    def attach(self, member) -> None:
        self._subs[member] = self.fanout.attach(
            member, member.query_str, member.query, member.sub_id
        )

    async def detach_member(self, member) -> None:
        sub = self._subs.pop(member, None)
        if sub is not None:
            await self.fanout.detach(sub)

    def members(self) -> int:
        return len(self._subs)

    def status(self) -> dict:
        return {
            "name": self.name,
            "role": self.role,
            "alive": self.alive,
            "stalled": self.stalled,
            "draining": self.draining,
            "served_height": self.served_height(),
            "lag_heights": self.lag_heights(),
            "sessions": len(self._subs),
        }
