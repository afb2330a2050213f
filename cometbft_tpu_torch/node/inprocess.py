"""In-process node construction and local test networks.

The part of the JAX package's ``node/inprocess.py`` that replay and
in-process consensus need (reference consensus/common_test.go
randConsensusNet): ``build_node`` wires the kv stores, the kvstore app
behind a local ABCI client, the mempool (``config.mempool.type_``:
``clist``, with ``async_recheck``; ``app``, the app-side mempool; or
``nop``), the block executor, the ABCI
handshake, the event bus (which the executor publishes each block's
events on), the tx and block indexers with their ``IndexerService``
when ``config.tx_index.indexer`` is ``"kv"`` (one kv db,
``tx_index.db`` under ``home`` on disk), the evidence pool (``evpool``,
over its own in-memory kv, as in the JAX package), the consensus
state machine (``cs``, with a WAL on disk when ``wal=True``), the
on-disk ``SnapshotStore`` (``<home>/snapshots``) when
``config.storage.snapshot_interval`` is set, which a default kvstore
writes through (and which an injected app without one is given), and
the storage lifecycle plane (``retention``, ``store/retention.py``),
always built and idle until a ``[storage]`` knob is set; with one set,
the default kvstore keeps its state in ``<home>/app_state.json``, so a
pruned node's restart replays only its retained tail. With
``config.base.proxy_app`` set and no app given, the app runs out of
process: the node dials it (``abci/socket_client.connect_app_conns``,
over gRPC when ``base.abci`` is ``"grpc"``, else four sockets) and
``parts.app`` is None; ``tx_index.indexer = "psql"`` goes through the
Postgres sink's gate (``state/psql_sink.py``);
``LocalNet`` connects
N nodes' state machines by in-memory delivery; ``make_genesis`` makes a genesis whose
keys come from a seeded ``np.random.default_rng``, as ``bench.py``'s
replay corpus does, and ``make_privvals`` file-backed signers over
them. The networked node over these parts is ``node/node.py``'s
``Node``. With ``config.instrumentation.trace_enabled`` (the default)
``build_node`` makes the node's ring tracer (``parts.tracer``, sized
``trace_ring_size``, anchored by ``record_clock_anchor``), hands it to
the consensus state (and so its WAL), the mempool, the block
executor, the indexer service and the retention plane, and enables
the process-wide tracer, as the JAX ``build_node`` does. With
``config.instrumentation.sanitizer`` (``test_config`` sets it)
``build_node`` enables the runtime sanitizer (``analysis/runtime.py``)
before any plane builds its locks,
and a non-empty ``config.crypto.batch_backend`` becomes the
process-wide verify backend (``crypto/batch.config_backend``: the JAX
name "tpu" is "cuda"; "mesh" splits the lanes over every CUDA device).

``device`` is where the node's signature checks run: None is the GPU
and raises without one; ``device="cpu"`` runs them on the host plane.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import time
import traceback
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np

from ..abci.client import AppConns
from ..analysis import runtime as sanitizer
from ..config import Config
from ..config.config import test_config
from ..consensus.reactor import CommitBlockMessage
from ..consensus.replay import Handshaker
from ..consensus.state import ConsensusState
from ..crypto import batch as crypto_batch
from ..crypto.batch import config_backend
from ..crypto.keys import Ed25519PrivKey
from ..device import resolve
from ..evidence.pool import EvidencePool
from ..mempool.mempool import AppMempool, CListMempool, Mempool, NopMempool
from ..models.kvstore import KVStoreApplication
from ..privval import FilePV
from ..state import native_finalize
from ..state.execution import BlockExecutor
from ..state.indexer import BlockIndexer, IndexerService, TxIndexer
from ..state.state_types import State
from ..state.store import Store as StateStore
from ..statesync.snapshots import SnapshotStore
from ..store.block_store import BlockStore
from ..store.retention import RetentionPlane
from ..trace import NOOP as TRACE_NOOP
from ..trace import Tracer, enable_global
from ..types import events as ev
from ..types.genesis import GenesisDoc
from ..types.validator_set import Validator
from ..utils import kv, wirecodec


def record_clock_anchor(tracer) -> None:
    """Stamp a monotonic→wall clock anchor on a freshly-built ring.

    The pair (one monotonic_ns and one time_ns read back-to-back)
    lets the cross-node timeline tool (trace/timeline.py) rebase
    rings from different processes onto one wall-clock axis. It lives
    HERE — in node assembly, not in trace/ — because nothing in the
    tracing plane reads the wall clock; the anchor rides
    ``tracer.meta`` (authoritative, survives ring laps) plus a
    best-effort ``clock.anchor`` instant for raw-event consumers.
    Idempotent per tracer."""
    if not getattr(tracer, "enabled", False) or tracer.meta.get("anchor_mono_ns"):
        return
    mono = time.monotonic_ns()
    wall = time.time_ns()
    tracer.meta["anchor_mono_ns"] = mono
    tracer.meta["anchor_wall_ns"] = wall
    tracer.instant_at("clock.anchor", mono, tid="main", wall_ns=wall)


@dataclass
class NodeParts:
    genesis: GenesisDoc
    app: object
    proxy: AppConns
    block_db: kv.KV
    state_db: kv.KV
    block_store: BlockStore
    state_store: StateStore
    state: State
    mempool: Mempool
    block_exec: BlockExecutor
    device: object
    config: Optional[Config] = None
    privval: Optional[FilePV] = None
    event_bus: Optional[ev.EventBus] = None
    cs: Optional[ConsensusState] = None
    evpool: Optional[EvidencePool] = None
    index_db: Optional[kv.KV] = None
    tx_indexer: Optional[TxIndexer] = None
    block_indexer: Optional[BlockIndexer] = None
    indexer_service: Optional[IndexerService] = None
    # the storage lifecycle plane: always built, a no-op until a
    # [storage] knob is set; Node.start spawns its reconcile loop
    retention: Optional[RetentionPlane] = None
    # on-disk chunked snapshots; None when snapshot generation is off
    snapshot_store: Optional[SnapshotStore] = None
    # the per-node tracing plane; NOOP when [instrumentation]
    # trace_enabled = false
    tracer: Tracer = TRACE_NOOP

    def close_stores(self) -> None:
        """Release the store handles and a remote app's connections.
        Idempotent."""
        for db in (self.block_db, self.state_db, self.index_db):
            if db is not None:
                db.close()
        for conn in {id(c): c for c in (self.proxy.consensus, self.proxy.mempool, self.proxy.query,
                                        self.proxy.snapshot)}.values():
            close = getattr(conn, "close", None)
            if close is not None:
                close()


def build_node(
    genesis: GenesisDoc,
    app=None,
    db_backend: str = "memdb",
    home: Optional[str] = None,
    device=None,
    privval: Optional[FilePV] = None,
    config: Optional[Config] = None,
    wal: bool = False,
) -> NodeParts:
    """Stores (``"memdb"``, or ``"sqlite"`` or ``"logdb"`` under
    ``home``; a ``config`` names its own backend), the app (a fresh
    kvstore unless given), mempool and executor, then the handshake, which runs InitChain or
    replays stored blocks; then the consensus state machine, signing
    with ``privval`` (None: a full node that votes on nothing), with
    ``config.consensus`` (``test_config``'s short timeouts by default)
    and a WAL at ``<home>/cs.wal`` (a fresh directory without ``home``)
    when ``wal`` is set. It is built, not started."""
    device = resolve(device)
    if config is None:
        config = test_config(home or ".")
        config.base.db_backend = db_backend
    db_backend = config.base.db_backend
    if config.instrumentation.sanitizer:
        # the runtime concurrency sanitizer: enabled before any plane
        # below builds its locks (wrapping is decided at construction,
        # which is what makes disabled mode free); per process, like
        # the lock-order graph it feeds
        sanitizer.enable()
    if config.crypto.batch_backend:
        # the operator's verify backend ([crypto] batch_backend); empty
        # inherits the process-wide default
        crypto_batch.set_default_backend(config_backend(config.crypto.batch_backend))
    # the native lanes' one-time g++ builds run on daemon threads now,
    # so no event loop waits on them; until a build lands, its callers
    # run their portable paths
    wirecodec.prewarm()
    native_finalize.prewarm()
    # tracing plane: one ring per node; the planes shared by every node
    # (the verify scheduler, the host plane) land on the process-wide
    # tracer, enabled the first time any tracing node is built
    tracer = TRACE_NOOP
    if config.instrumentation.trace_enabled:
        tracer = Tracer(name=config.base.moniker or "node", size=config.instrumentation.trace_ring_size)
        record_clock_anchor(tracer)
        record_clock_anchor(enable_global())
    if db_backend != "memdb":
        if not home:
            raise ValueError(f"the {db_backend} backend needs a home directory")
        os.makedirs(home, exist_ok=True)
    storage = config.storage
    snapshot_store = None
    if storage.snapshot_interval > 0:
        snapshot_store = SnapshotStore(
            os.path.join(home, "snapshots") if home else tempfile.mkdtemp(prefix="snapshots_"),
            keep_recent=storage.snapshot_keep_recent,
        )
    if app is None and config.base.proxy_app:
        # out-of-process app (reference proxy_app, node/setup.go:119
        # createAndStartProxyAppConns)
        from ..abci.socket_client import connect_app_conns

        transport = "grpc" if config.base.abci == "grpc" else "socket"
        proxy = connect_app_conns(config.base.proxy_app, transport)
    else:
        if app is None:
            # a pruned node cannot replay from block 1 at its handshake:
            # the blocks below its base are gone. With a lifecycle knob
            # on, the default app keeps its committed state on disk, so
            # a restart replays only the retained tail
            lifecycle_on = bool(
                storage.retain_blocks or storage.retain_states or storage.retain_index
                or storage.snapshot_interval
            )
            app = KVStoreApplication(
                persist_path=os.path.join(home, "app_state.json") if home and lifecycle_on else None,
                snapshot_store=snapshot_store,
            )
        elif snapshot_store is not None and getattr(app, "snapshot_store", False) is None:
            # an injected kvstore-style app with the seam unset gets the
            # node's store
            app.snapshot_store = snapshot_store
        proxy = AppConns.local(app)

    def open_db(name: str) -> kv.KV:
        if db_backend == "memdb":
            return kv.MemKV()
        return kv.open_kv(db_backend, os.path.join(home, name))

    block_db, state_db = open_db("blockstore.db"), open_db("state.db")
    block_store = BlockStore(block_db)
    state_store = StateStore(state_db)
    state = state_store.load()
    if state is None:
        state = genesis.make_genesis_state()
        state_store.save(state)
    state = Handshaker(state_store, state, block_store, genesis).handshake(proxy)
    event_bus = ev.EventBus()
    # indexing (reference [tx_index] indexer = "kv" | "null"): the
    # service accumulates a height's events on the bus and flushes ONE
    # write_batch per height, from an async drain once Node.start
    # upgrades it
    index_db = tx_indexer = block_indexer = indexer_service = None
    if config.tx_index.indexer == "kv":
        index_db = open_db("tx_index.db")
        tx_indexer = TxIndexer(index_db)
        block_indexer = BlockIndexer(index_db)
        indexer_service = IndexerService(tx_indexer, block_indexer, event_bus)
        indexer_service.tracer = tracer
        indexer_service.start()
    elif config.tx_index.indexer == "psql":
        from ..state.psql_sink import PsqlSink

        PsqlSink(config.tx_index.psql_conn, genesis.chain_id)  # raises: only the gate is ported
    elif config.tx_index.indexer != "null":
        raise ValueError(f"unknown tx_index.indexer {config.tx_index.indexer!r}")
    evpool = EvidencePool(kv.MemKV(), state_store, block_store, device=device)
    # mempool flavor by config: clist | app (fork) | nop (ADR-111)
    if config.mempool.type_ == "app":
        mempool = AppMempool(proxy.mempool)
    elif config.mempool.type_ == "nop":
        mempool = NopMempool()
    else:
        mempool = CListMempool(
            proxy.mempool,
            cache_size=config.mempool.cache_size,
            max_tx_bytes=config.mempool.max_tx_bytes,
            max_txs=config.mempool.size,
            recheck=config.mempool.recheck,
            async_recheck=config.mempool.async_recheck,
        )
    block_exec = BlockExecutor(
        state_store,
        proxy.consensus,
        mempool,
        evidence_pool=evpool,
        block_store=block_store,
        block_time_tolerance_ns=config.consensus.block_time_tolerance_ns,
        device=device,
        event_bus=event_bus,
    )
    wal_path = None
    if wal:
        wal_path = os.path.join(home or tempfile.mkdtemp(), "cs.wal")
    cs = ConsensusState(
        config.consensus,
        state,
        block_exec,
        block_store,
        mempool,
        priv_validator=privval,
        event_bus=event_bus,
        wal_path=wal_path,
        evidence_pool=evpool,
        device=device,
    )
    cs.tracer = tracer
    mempool.tracer = tracer
    block_exec.tracer = tracer
    # the retention plane owns all pruning once enabled: the executor's
    # inline prune hands the app's retain_height to it
    retention = RetentionPlane(
        storage,
        block_store,
        state_store,
        tx_indexer=tx_indexer,
        block_indexer=block_indexer,
        evpool=evpool,
        snapshot_store=snapshot_store,
        proxy=proxy,
        wal_path=wal_path,
        home=home,
        tracer=tracer,
    )
    if retention.enabled:
        block_exec.retention_hook = retention.notify_retain_height
    return NodeParts(
        genesis=genesis,
        app=app,
        proxy=proxy,
        block_db=block_db,
        state_db=state_db,
        block_store=block_store,
        state_store=state_store,
        state=state,
        mempool=mempool,
        block_exec=block_exec,
        device=device,
        config=config,
        privval=privval,
        event_bus=event_bus,
        cs=cs,
        evpool=evpool,
        index_db=index_db,
        tx_indexer=tx_indexer,
        block_indexer=block_indexer,
        indexer_service=indexer_service,
        retention=retention,
        snapshot_store=snapshot_store,
        tracer=tracer,
    )


def make_genesis(
    n_validators: int,
    chain_id: str = "test-chain",
    power: int = 10,
    genesis_time_ns: int = 0,
    seed: int = 7,
) -> Tuple[GenesisDoc, List[Ed25519PrivKey]]:
    """(GenesisDoc, private keys in validator-set order). Each key is
    ``from_seed(rng.bytes(32))`` of ``np.random.default_rng(seed)``.
    The genesis is backdated an hour by default, so chains generated
    from it at 1 s a block stay in the past."""
    rng = np.random.default_rng(seed)
    privs = [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(n_validators)]
    gen = GenesisDoc(
        chain_id=chain_id,
        validators=[Validator(p.pub_key(), power) for p in privs],
        genesis_time_ns=genesis_time_ns or time.time_ns() - 3_600_000_000_000,
    )
    order = {v.address: i for i, v in enumerate(gen.validator_set().validators)}
    privs.sort(key=lambda p: order[p.pub_key().address()])
    return gen, privs


def make_privvals(privs, root: Optional[str] = None) -> List[FilePV]:
    """File-backed signers over raw keys (the JAX package's
    ``make_genesis`` returns these): key and state files in a fresh
    directory each, under ``root`` when given."""
    pvs = []
    for p in privs:
        d = tempfile.mkdtemp(prefix="pv_", dir=root)
        pv = FilePV(p, os.path.join(d, "key.json"), os.path.join(d, "state.json"))
        pv.save_key()
        pv.save_state()
        pvs.append(pv)
    return pvs


class LocalNet:
    """Fully-connected in-memory delivery between consensus states.

    Delivery is flood-with-dedup plus a CATCH-UP healer (the reactor's
    gossipDataForCatchup analog): a node whose round state trails a
    peer's committed height is periodically re-fed that block + commit
    through the normal commit_block path. The flood alone has no
    retransmission, so any delivery skew (batched vote windows, WAL
    group-commit broadcast deferral, loop contention) could strand a
    node in COMMIT waiting for parts nobody will ever resend — the
    real p2p reactor heals this with per-peer gossip routines, and the
    harness must match that delivery contract."""

    def __init__(
        self,
        nodes: List[NodeParts],
        drop: Optional[Callable] = None,
        heal_interval_s: float = 0.05,
    ):
        self.nodes = nodes
        self.drop = drop  # (src_idx, dst_idx, kind, payload) -> bool
        self.heal_interval_s = heal_interval_s
        self._healer: Optional[asyncio.Task] = None
        for i, n in enumerate(nodes):
            n.cs.add_broadcast_hook(self._make_hook(i))

    def _make_hook(self, src: int):
        def hook(kind, payload):
            for j, other in enumerate(self.nodes):
                if j == src:
                    continue
                if self.drop and self.drop(src, j, kind, payload):
                    continue
                try:
                    other.cs.enqueue_nowait(kind, payload, f"node{src}")
                except asyncio.QueueFull:
                    pass

        return hook

    async def start(self):
        for n in self.nodes:
            await n.cs.start()
        if self.heal_interval_s > 0 and len(self.nodes) > 1:
            self._healer = asyncio.create_task(self._heal_loop())

    async def _heal_loop(self):
        """Re-feed committed blocks to lagging nodes (reference
        consensus/reactor.go gossipDataForCatchup, harness-sized)."""
        while True:
            await asyncio.sleep(self.heal_interval_s)
            try:
                stores = [n.block_store.height() for n in self.nodes]
                for j, n in enumerate(self.nodes):
                    h = n.cs.rs.height
                    for i, m in enumerate(self.nodes):
                        if i == j or stores[i] < h:
                            continue
                        if self.drop and self.drop(i, j, "commit_block", None):
                            continue
                        block = m.block_store.load_block(h)
                        commit = m.block_store.load_seen_commit(h) or m.block_store.load_block_commit(h)
                        if block is None or commit is None:
                            continue
                        try:
                            n.cs.enqueue_nowait(
                                "commit_block",
                                CommitBlockMessage(block, commit, m.block_store.load_extended_commit(h)),
                                f"node{i}",
                            )
                        except asyncio.QueueFull:
                            pass
                        break
            except asyncio.CancelledError:
                raise
            except Exception:
                traceback.print_exc()

    async def stop(self):
        if self._healer is not None:
            self._healer.cancel()
            self._healer = None
        for n in self.nodes:
            # bounded: one wedged state machine must not hang the
            # whole test net's teardown
            try:
                await asyncio.wait_for(n.cs.stop(), 15.0)
            except asyncio.TimeoutError:
                pass

    async def wait_for_height(self, height: int, timeout: float = 30.0):
        async def waiter():
            while True:
                if all(n.block_store.height() >= height for n in self.nodes):
                    return
                await asyncio.sleep(0.02)

        await asyncio.wait_for(waiter(), timeout)
