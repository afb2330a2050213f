"""RPC Environment: the node internals the route handlers read
(reference rpc/core/env.go + node/node.go:754-788 ConfigureRPC).

A copy of the JAX package's ``rpc/env.py`` without the fields of the
planes the port lacks (the loop watchdog and the serving fleet,
ROADMAP A10): the routes that read them answer as the JAX routes do
when those fields are None. ``retention`` is the node's storage
lifecycle plane, whose stats the ``health`` route reports. ``add_evidence`` is the node's
``Node.add_evidence``, which ``broadcast_evidence`` awaits: the commit
checks' tickets resolve on the loop, and a failed verify route raises
to the caller with the evidence kept on the reactor's retry list (C3).
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

from ..utils.tasks import spawn


@dataclass
class Environment:
    chain_id: str = ""
    block_store: object = None
    state_store: object = None
    mempool: object = None
    evidence_pool: object = None
    consensus_state: object = None  # may be None (inspect mode)
    event_bus: object = None
    proxy: object = None  # AppConns
    genesis: object = None
    tx_indexer: object = None
    block_indexer: object = None
    switch: object = None  # p2p switch, may be None
    node_info: object = None
    privval_pubkey: object = None
    config: object = None
    mempool_reactor: object = None
    queues: object = None  # obs.QueueRegistry
    # () -> light.serving.VerifiedHeaderCache | None, read lazily: a
    # co-resident serving plane may set the node's shared header cache
    # after this Environment was built
    light_header_cache_fn: object = None
    indexer_service: object = None  # batched per-height index drain
    # storage lifecycle plane (store/retention.py): health verdict and
    # stats
    retention: object = None
    # async (evidence) -> None: the node's pool behind its evidence
    # reactor's retry list
    add_evidence: object = None
    # height-keyed commit waiters, shared by every broadcast_tx_commit:
    # lazily built so inspect-mode envs never subscribe
    _commit_waiters: object = None

    def commit_waiters(self):
        """The ONE CommitWaiterMap for this env (one lossless sync
        bus listener total, O(1) publish cost in in-flight commit
        RPCs)."""
        if self._commit_waiters is None:
            from .fanout import CommitWaiterMap

            self._commit_waiters = CommitWaiterMap(self.event_bus)
        return self._commit_waiters

    async def close(self) -> None:
        """Release env-owned background plumbing (the commit-waiter
        listener); bounded, safe to call twice."""
        cw = self._commit_waiters
        self._commit_waiters = None
        if cw is not None:
            try:
                await asyncio.wait_for(cw.close(), 5.0)
            except asyncio.TimeoutError:
                pass

    def submit_tx(self, tx: bytes):
        """CheckTx: the synchronous direct path (the async routes
        prefer ``submit_tx_async``)."""
        return self.mempool.check_tx(tx)

    def _ingest(self):
        """The mempool reactor's running ingest queue, or None."""
        ing = getattr(self.mempool_reactor, "ingest", None)
        return ing if ing is not None and ing.running else None

    async def submit_tx_async(self, tx: bytes):
        """Broadcast entry for async routes: enqueue on the mempool
        ingest plane (batched CheckTx, event loop never blocks) and
        await the verdict; the direct path off-loop when the plane
        isn't running (inspect mode)."""
        ing = self._ingest()
        if ing is not None:
            return await ing.submit(tx)
        return await asyncio.to_thread(self.submit_tx, tx)

    def submit_tx_nowait(self, tx: bytes) -> None:
        """Fire-and-forget broadcast (broadcast_tx_async route)."""
        ing = self._ingest()
        if ing is not None:
            # a full queue DROPS the tx (counted by the queue): that
            # is the overload backpressure the bounded queue exists
            # for
            ing.submit_nowait(tx)
            return
        spawn(asyncio.to_thread(self.submit_tx, tx), name="broadcast-tx-async")

    @classmethod
    def from_node(cls, node) -> "Environment":
        p = node.parts
        return cls(
            chain_id=node.genesis.chain_id,
            block_store=p.block_store,
            state_store=p.state_store,
            mempool=p.mempool,
            evidence_pool=p.evpool,
            consensus_state=p.cs,
            event_bus=p.event_bus,
            proxy=p.proxy,
            genesis=node.genesis,
            tx_indexer=p.tx_indexer,
            block_indexer=p.block_indexer,
            switch=node.switch,
            node_info=node.node_info,
            privval_pubkey=(p.privval.pub_key() if p.privval is not None else None),
            config=node.config,
            mempool_reactor=node.mempool_reactor,
            queues=node.queues,
            light_header_cache_fn=lambda: node.light_header_cache,
            indexer_service=p.indexer_service,
            retention=p.retention,
            add_evidence=node.add_evidence,
        )
