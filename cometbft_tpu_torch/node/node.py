"""Full node assembly: transport + switch + reactors + consensus
(reference node/node.go:285 NewNode, :616 OnStart, node/setup.go).

Startup phases mirror the reference: (statesync ->) blocksync ->
consensus. When blocksync is enabled the consensus state machine is
built but NOT started; once the pool reports caught-up the node switches to
consensus (reference consensus/reactor.go:121 SwitchToConsensus). With
the fork's AdaptiveSync, blocksync pipelines verified blocks straight
into the RUNNING consensus state machine instead (reference
blocksync/reactor_adaptive.go).

A copy of the JAX package's ``node/node.py``: the constructor,
``start``, ``stop``, ``kill``, ``dial``, ``listen_addr``, ``height``,
``block_id_hash_at``, the statesync phase (``_statesync_routine``:
discover and restore an app snapshot whose app hash and state the
light client verifies on the node's device, bootstrap the stores, hand
off to blocksync, adaptive or not; a failure is fatal and kept in
``statesync_error``, a failed verify route as the ``DeviceRouteError``
chained to the card's error), the statesync reactor that serves this
node's snapshots, the storage lifecycle plane's start and stop
(``parts.retention``, reported as ``store.retention``) and the
blocksync-to-consensus hand-off. With
``rpc.laddr`` set the node serves JSON-RPC and websocket events
(``rpc/``), started after the switch and the indexer's drain and
stopped first, in the JAX order; ``queues`` is the obs registry its
``health`` route reads. The node
runs its signature checks on ``device`` (None is the GPU, and raises
without one; ``device="cpu"`` the host plane or the plain kernels): the
consensus state machine, the consensus reactor's vote waves, the
blocksync windows and the evidence pool all take it. The evidence
reactor gossips the pool on channel 0x38; ``add_evidence`` hands the
pool evidence directly, where the JAX node's RPC ``broadcast_evidence``
does, with the reactor's retry when the verify route fails (C3). The
fork's network plane, as in the JAX node: ``p2p.use_libp2p_equivalent``
picks the lp2p switch (``lp2p/``, stream-multiplexed, with the node's
send and receive rates), ``p2p.use_autopool`` drains reactor messages
through the autopool on either switch, ``mempool.type_ = "app"`` runs
the app-side mempool behind an ``AppMempoolReactor``, and the address
book (``<home>/addrbook.json``, seeded from ``p2p.seeds``) is the
switch's ``addr_book``, crawled by a ``PexReactor`` on channel 0x00
when ``p2p.pex`` is on (the default). With ``rpc.grpc_laddr`` set the
node serves the gRPC broadcast API (``rpc/grpc_api.py``) on the same
RPC environment, whose ``CommitWaiterMap`` its BroadcastTx waits on,
with or without JSON-RPC; with ``base.proxy_app`` set its app runs out
of process (``build_node`` dials it). The operations plane, as in the
JAX node: the node's ring tracer (``parts.tracer``) goes to the switch
and the blocksync reactor, and the switch stamps outbound messages
(``instrumentation.trace_msg_stamp``; arrivals from stamping peers are
recorded either way); ``instrumentation.prometheus`` serves
``utils/metrics.NodeMetrics`` at ``prometheus_listen_addr``,
``pprof_laddr`` the debug server, ``loop_watchdog`` runs the loop
watchdog (``loop_watchdog``, built here, started with the node) and
``watchdog_stall_s`` the stuck-task watchdog (``watchdog``); ``stop``
and ``kill`` run their stages under an ``obs.ShutdownGuard``
(``shutdown_guard``, per-stage budget ``shutdown_stage_budget_s``, the
switch at three times it). A metrics or debug server that cannot bind,
or a missing ``prometheus_client``, fails ``start`` (the node is
stopped again first). The node's TCP transport wraps each connection
per the config's ``[fuzz]`` section (``p2p/fuzz.py``; off by default),
as the JAX node's does. ``CMT_NODE_VERSION`` in the environment sets
the version the node presents in its node info (the e2e runner's
upgrade perturbation), as in the JAX node.
"""

from __future__ import annotations

import asyncio
import os
import traceback
from typing import Optional

from ..blocksync.net_reactor import BlockSyncNetReactor
from ..config import Config
from ..consensus.reactor import ConsensusReactor
from ..device import resolve
from ..evidence.reactor import EvidenceReactor
from ..mempool.reactor import AppMempoolReactor, MempoolReactor
from ..obs import LoopWatchdog, QueueRegistry, ShutdownGuard
from ..p2p import AddrBook, NodeInfo, NodeKey, PexReactor, Switch, TCPTransport
from ..statesync.reactor import StateSyncReactor
from ..types.genesis import GenesisDoc
from ..utils.log import get_logger
from ..utils.tasks import spawn
from .inprocess import NodeParts, build_node

_log = get_logger("node")


def _strip_proto(addr: str) -> str:
    for p in ("tcp://", "unix://"):
        if addr.startswith(p):
            return addr[len(p):]
    return addr


class Node:
    """A running full node / validator."""

    def __init__(
        self,
        config: Config,
        genesis: GenesisDoc,
        privval=None,
        app=None,
        node_key: Optional[NodeKey] = None,
        transport: Optional[object] = None,
        home: Optional[str] = None,
        device=None,
    ):
        self.config = config
        self.genesis = genesis
        self.device = resolve(device)
        self.parts: NodeParts = build_node(
            genesis, app=app, config=config, home=home, wal=bool(home),
            privval=privval, device=self.device,
        )
        self.node_key = node_key or NodeKey.generate()
        self.node_info = NodeInfo(
            node_id=self.node_key.node_id,
            network=genesis.chain_id,
            moniker=config.base.moniker,
        )
        # e2e upgrade perturbation: a restarted process can present a
        # bumped software version (the single-binary analog of the
        # reference's docker-image swap, test/e2e/runner/perturb.go:37)
        _v = os.environ.get("CMT_NODE_VERSION")
        if _v:
            self.node_info.version = _v
        if transport is None:
            # fault injection by config (reference FuzzConnConfig);
            # maybe_fuzz treats disabled as passthrough
            transport = TCPTransport(self.node_key, self.node_info, fuzz_config=config.fuzz)
        self.transport = transport
        # self-healing connectivity plane knobs ([p2p])
        reconnect_config = {
            "base_s": config.p2p.reconnect_base_s,
            "cap_s": config.p2p.reconnect_cap_s,
            "fast_attempts": config.p2p.reconnect_fast_attempts,
            "slow_interval_s": config.p2p.reconnect_slow_interval_s,
            "starvation_s": config.p2p.starvation_s,
        }
        if config.p2p.use_libp2p_equivalent:
            # fork feature: alternative stream-multiplexed switcher
            # (reference lp2p selection at node/node.go:476-575)
            from ..lp2p import Lp2pSwitch

            self.switch = Lp2pSwitch(
                self.transport,
                self.node_info,
                send_rate=config.p2p.send_rate,
                recv_rate=config.p2p.recv_rate,
                use_autopool=config.p2p.use_autopool,
                reconnect_config=reconnect_config,
            )
        else:
            self.switch = Switch(
                self.transport,
                self.node_info,
                mconn_config={
                    "send_rate": config.p2p.send_rate,
                    "recv_rate": config.p2p.recv_rate,
                    "flush_throttle_s": config.p2p.flush_throttle_ms / 1000.0,
                },
                use_autopool=config.p2p.use_autopool,
                reconnect_config=reconnect_config,
            )
        self.switch.min_peers = config.p2p.min_peers
        # a reactor's failed verify route counts where the state
        # machine's do (C3)
        self.switch.loop_errors = self.parts.cs.loop_errors

        blocksync_active = config.blocksync.enable and not config.statesync.enable
        adaptive = config.blocksync.adaptive_sync
        # consensus gossip stays off until every sync phase completes
        # (the statesync hand-off activates blocksync, which switches to
        # consensus), unless blocksync ingests into the running state
        # machine
        sync_pending = config.statesync.enable or (blocksync_active and not adaptive)
        self.consensus_reactor = ConsensusReactor(
            self.parts.cs,
            self.parts.block_store,
            wait_sync=sync_pending,
        )
        if config.mempool.type_ == "app":
            self.mempool_reactor = AppMempoolReactor(self.parts.mempool, broadcast=config.mempool.broadcast)
        else:
            self.mempool_reactor = MempoolReactor(
                self.parts.mempool,
                broadcast=config.mempool.broadcast,
                batch_max_txs=config.mempool.batch_max_txs,
                batch_flush_ms=config.mempool.batch_flush_ms,
            )
        self.evidence_reactor = EvidenceReactor(self.parts.evpool)
        self.blocksync_reactor = BlockSyncNetReactor(
            self.parts.state,
            self.parts.block_exec,
            self.parts.block_store,
            on_caught_up=self._on_caught_up,
            block_ingestor=self.parts.cs if adaptive else None,
            active=blocksync_active,
            local_blocks_chain=self._local_blocks_chain,
            device=self.device,
        )
        self.statesync_reactor = StateSyncReactor(self.parts.proxy, enabled=config.statesync.enable)
        # serve floor: a chunk being streamed to a joiner pins its
        # height against pruning
        self.statesync_reactor.retention = self.parts.retention
        self.addr_book = AddrBook(
            os.path.join(home, "addrbook.json") if home else None,
            our_id=self.node_key.node_id,
        )
        for seed in (config.p2p.seeds or "").split(","):
            if seed.strip():
                self.addr_book.add_address(seed.strip())
        # the reconnect plane consults the book for re-learned
        # addresses and records dial/conn failures into it
        self.switch.addr_book = self.addr_book
        self.pex_reactor = (
            PexReactor(
                self.addr_book,
                seed_mode=config.p2p.seed_mode,
                target_outbound=config.p2p.max_num_outbound_peers,
            )
            if config.p2p.pex
            else None
        )
        self.switch.add_reactor("consensus", self.consensus_reactor)
        self.switch.add_reactor("mempool", self.mempool_reactor)
        self.switch.add_reactor("evidence", self.evidence_reactor)
        self.switch.add_reactor("blocksync", self.blocksync_reactor)
        self.switch.add_reactor("statesync", self.statesync_reactor)
        if self.pex_reactor is not None:
            self.switch.add_reactor("pex", self.pex_reactor)
        # tracing plane: point the networked planes at the node ring
        # (consensus/mempool/WAL got theirs in build_node)
        self.switch.tracer = self.parts.tracer
        self.blocksync_reactor.inner.tracer = self.parts.tracer
        # cross-node causal tracing: stamp outbound consensus/mempool/
        # blocksync messages with a trace context so peers record
        # correlated receive instants. Origin is the moniker (the ring
        # label). trace_msg_stamp gates only the OUTBOUND stamp — a
        # node with it off still records arrivals from stamping peers.
        inst = config.instrumentation
        if self.parts.tracer.enabled:
            self.switch.enable_stamping(
                self.parts.tracer,
                config.base.moniker or self.node_key.node_id[:8],
                outbound=inst.trace_msg_stamp,
            )
        self._adaptive = adaptive
        self._cs_started = False
        self.rpc_server = None
        self.rpc_env = None
        self.grpc_server = None
        self._statesync_task = None
        self.statesync_error = None
        # the last restore's LightClientStateProvider (its client's
        # hops, the header cache's stats), kept after it is closed
        self.statesync_provider = None
        # cross-client verified-header cache (light/serving.py): a
        # co-resident serving plane and this node's statesync restore
        # share verification work through it; made by
        # _statesync_routine when none was injected
        self.light_header_cache = None
        self.metrics = None
        self.metrics_server = None
        self.debug_server = None
        self.watchdog = None
        # last _shutdown's ShutdownGuard (stalled-stage flight
        # records); set when stop()/kill() runs
        self.shutdown_guard = None
        # the loop watchdog is built here (started in start(): it needs
        # the running loop) so Environment.from_node and the metrics
        # attach hold a stable reference
        self.loop_watchdog = (
            LoopWatchdog(
                tracer=self.parts.tracer,
                interval_s=inst.loop_lag_interval_ms / 1e3,
                stall_s=inst.loop_stall_ms / 1e3,
                name=config.base.moniker or "node",
            )
            if inst.loop_watchdog
            else None
        )
        self.queues = QueueRegistry()
        self._register_queues()

    def _register_queues(self) -> None:
        """Point the backpressure registry (obs/queues.py) at every
        bounded queue in the hot planes. Entries are callables read at
        scrape time: planes rebuild queues across start/stop."""
        from ..crypto.parallel_verify import dispatch_stats_if_running
        from ..crypto.scheduler import sched_stats_if_running

        q = self.queues
        ing = getattr(self.mempool_reactor, "ingest", None)
        if ing is not None:
            q.register("mempool.ingest", ing.queue_stats)
        q.register("consensus.inbox", lambda: None if self.parts.cs.queue is None else self.parts.cs.queue.stats())
        q.register("events.subs", self.parts.event_bus.queue_stats)

        def p2p_send():
            depth = hwm = dropped = enqueued = 0
            seen = False
            for peer in list(self.switch.peers.values()):
                mc = getattr(peer, "mconn", None)
                if mc is None or not hasattr(mc, "send_queue_stats"):
                    continue
                seen = True
                st = mc.send_queue_stats()
                depth += st["depth"]
                hwm = max(hwm, st["high_watermark"])
                dropped += st["dropped"]
                enqueued += st["enqueued"]
            if not seen:
                return None
            return {"depth": depth, "high_watermark": hwm, "dropped": dropped, "enqueued": enqueued}

        q.register("p2p.send", p2p_send)
        q.register("crypto.verify.dispatch", dispatch_stats_if_running)
        q.register(
            "rpc.fanout",
            lambda: None if self.rpc_server is None else self.rpc_server.fanout.queue_stats(),
        )
        svc = self.parts.indexer_service
        if svc is not None:
            q.register("state.index", svc.queue_stats)
        q.register("blocksync.window", lambda: self.blocksync_reactor.inner.pool.queue_stats())
        q.register("crypto.sched", sched_stats_if_running)
        ret = self.parts.retention
        q.register("store.retention", lambda: ret.stats() if ret.enabled else None)

    # --- phase switching ----------------------------------------------

    def _local_blocks_chain(self, state) -> bool:
        """True when our own validator holds >=1/3 voting power, so
        blocksync cannot progress without our votes (reference
        blocksync/reactor.go:448 localNodeBlocksTheChain)."""
        pv = self.parts.privval
        if pv is None:
            return False
        try:
            _, val = state.validators.get_by_address(pv.pub_key().address())
        except Exception:
            return False
        if val is None:
            return False
        return val.voting_power >= state.validators.total_voting_power() / 3

    async def _statesync_routine(self) -> None:
        """Phase 1: snapshot restore, then the hand-off to blocksync
        (reference node/setup.go:560 performStateSync)."""
        from ..light.serving import VerifiedHeaderCache
        from ..statesync.stateprovider import LightClientStateProvider

        cfg = self.config.statesync
        try:
            # with two or more RPC servers the restore client has
            # witnesses that cross-check what it verifies, so it may
            # share the node's header cache with a co-resident serving
            # plane; with one, the sole (untrusted) primary's answers
            # must reach only a cache private to this restore
            if len(cfg.rpc_servers) >= 2:
                header_cache = self.light_header_cache
                if header_cache is None:
                    header_cache = self.light_header_cache = VerifiedHeaderCache(self.genesis.chain_id)
            else:
                header_cache = VerifiedHeaderCache(self.genesis.chain_id)
            # the constructor light-verifies the trust root over HTTP:
            # off this event loop
            provider = await asyncio.to_thread(
                LightClientStateProvider,
                self.genesis.chain_id,
                cfg.rpc_servers,
                cfg.trust_height,
                bytes.fromhex(cfg.trust_hash) if isinstance(cfg.trust_hash, str) else cfg.trust_hash,
                int(cfg.trust_period_s * 1e9),
                genesis=self.genesis,
                header_cache=header_cache,
                device=self.device,
            )
            self.statesync_provider = provider
            try:
                state = await self.statesync_reactor.sync(
                    provider,
                    self.parts.state_store,
                    self.parts.block_store,
                    discovery_time_s=cfg.discovery_time_s,
                    chunk_timeout_s=cfg.chunk_request_timeout_s,
                )
            finally:
                await asyncio.to_thread(provider.close)
            self.parts.state = state
            _log.info(
                "statesync complete, switching to blocksync",
                height=state.last_block_height,
                adaptive=self._adaptive,
            )
            if self._adaptive:
                # adaptive: consensus runs during blocksync and is the
                # block ingestor, so it starts on the synced state
                self.parts.cs.update_to_state(state)
                await self.parts.cs.start()
                self._cs_started = True
                self.consensus_reactor.switch_to_consensus()
            await self.blocksync_reactor.activate(state)
        except asyncio.CancelledError:
            raise  # node stop cancels the statesync task
        except Exception as e:
            # a statesync failure is fatal (reference node/setup.go
            # performStateSync): a node that cannot bootstrap must not
            # linger half-alive
            self.statesync_error = e
            traceback.print_exc()
            _log.error("statesync failed, stopping node", err=repr(e))
            spawn(self.stop(), name="node-stop")

    def _on_caught_up(self, state) -> None:
        spawn(self._switch_to_consensus(state), name="switch-to-consensus")

    async def _switch_to_consensus(self, state) -> None:
        _log.info("switching to consensus", height=state.last_block_height)
        if self._cs_started:
            self.consensus_reactor.switch_to_consensus()
            return
        try:
            self.parts.cs.update_to_state(state)
            await self.parts.cs.start()
            self._cs_started = True
            self.consensus_reactor.switch_to_consensus()
        except asyncio.CancelledError:
            raise  # node stop cancels the handoff task
        except Exception:
            traceback.print_exc()

    # --- lifecycle ----------------------------------------------------

    @property
    def listen_addr(self) -> str:
        return self.transport.listen_addr

    async def start(self) -> None:
        if self.config.instrumentation.prometheus:
            # before anything listens: without prometheus_client the
            # node cannot export what its config asks for
            from ..utils.metrics import NodeMetrics

            self.metrics = NodeMetrics(self.genesis.chain_id)
        await self.transport.listen(_strip_proto(self.config.p2p.laddr))
        await self.switch.start()
        _log.info(
            "node started",
            node_id=self.node_info.node_id[:12],
            laddr=self.listen_addr,
            chain=self.genesis.chain_id,
            height=self.parts.block_store.height(),
        )
        if self.parts.indexer_service is not None:
            await self.parts.indexer_service.start_async(
                self.parts.block_store, self.parts.state_store
            )
        # the storage lifecycle plane: a no-op unless a [storage] knob
        # is set
        await self.parts.retention.start()
        if self.config.rpc.laddr:
            from ..rpc import Environment, RPCServer

            self.rpc_env = Environment.from_node(self)
            self.rpc_server = RPCServer(self.rpc_env)
            await self.rpc_server.start(_strip_proto(self.config.rpc.laddr))
        if self.config.rpc.grpc_laddr:
            # the gRPC broadcast API, with or without JSON-RPC, on the
            # env's CommitWaiterMap (the JSON-RPC route's waiters)
            from ..rpc import Environment
            from ..rpc.grpc_api import GRPCBroadcastServer

            self.rpc_env = self.rpc_env or Environment.from_node(self)
            self.grpc_server = GRPCBroadcastServer(
                self.rpc_env,
                _strip_proto(self.config.rpc.grpc_laddr),
                asyncio.get_running_loop(),
                timeout_s=self.config.rpc.timeout_broadcast_tx_commit_s,
            )
            self.grpc_server.start()
        try:
            await self._start_instrumentation()
        except BaseException:
            # a server that cannot bind fails the start, the node
            # stopped again first
            await self.stop()
            raise
        # consensus starts now unless a sync phase must complete first
        if self.config.statesync.enable:
            self._statesync_task = asyncio.create_task(self._statesync_routine())
        elif not self.blocksync_reactor.active or self._adaptive:
            await self.parts.cs.start()
            self._cs_started = True
        if self.config.p2p.persistent_peers:
            self.switch.dial_peers_async(
                [a.strip() for a in self.config.p2p.persistent_peers.split(",") if a.strip()],
                persistent=True,
            )

    async def _start_instrumentation(self) -> None:
        """The metrics and debug servers and both watchdogs, in the
        JAX node's order."""
        inst = self.config.instrumentation
        if self.metrics is not None:
            from ..utils.metrics import MetricsServer

            self.metrics.attach(self)
            self.metrics_server = MetricsServer(self.metrics)
            await self.metrics_server.start(_strip_proto(inst.prometheus_listen_addr))
        if inst.pprof_laddr:
            # reference node/node.go:624-627: profiling listener by config
            from ..utils.debug import DebugServer

            self.debug_server = DebugServer(inst.pprof_laddr)
            await self.debug_server.start()
        if self.loop_watchdog is not None:
            # loop-lag heartbeat + stall flight recorder
            self.loop_watchdog.start()
        if inst.watchdog_stall_s > 0:
            from ..utils.debug import StuckTaskWatchdog

            self.watchdog = StuckTaskWatchdog(
                interval_s=min(5.0, inst.watchdog_stall_s / 2),
                stall_s=inst.watchdog_stall_s,
            )
            self.watchdog.start()

    async def kill(self) -> None:
        """Simulated process crash for in-process tests: tear every
        task down abruptly — consensus abandons its WAL without
        flushing (ConsensusState.crash), nothing performs a graceful
        handoff — then release store handles so a restarted Node on
        the same home recovers exclusively through WAL replay + ABCI
        handshake replay (consensus/replay.py)."""
        await self._shutdown(graceful=False)

    async def stop(self) -> None:
        await self._shutdown(graceful=True)

    async def _shutdown(self, graceful: bool) -> None:
        """Bounded, staged teardown (obs/shutdown.py): every await
        below runs under a per-stage budget with stop→cancel→abandon
        escalation, so one wedged sub-plane can never hang the whole
        stop path — the breach is flight-recorded into the trace ring
        and the remaining stages (store-handle release above all)
        still run."""
        guard = ShutdownGuard(
            tracer=self.parts.tracer,
            name=self.config.base.moniker or "node",
            budget_s=self.config.instrumentation.shutdown_stage_budget_s,
        )
        self.shutdown_guard = guard
        if self.watchdog is not None:
            self.watchdog.stop()
        if self.loop_watchdog is not None:
            self.loop_watchdog.stop()
        if self._statesync_task is not None:
            self._statesync_task.cancel()
        # kill(): servers still close (an in-process restart must be
        # able to rebind) — the crash/graceful split is consensus' WAL
        # handling only
        if self.metrics_server is not None:
            await guard.stage("metrics", self.metrics_server.stop())
        if self.debug_server is not None:
            await guard.stage("debug", self.debug_server.stop())
        if self.grpc_server is not None:
            self.grpc_server.stop()  # returns at once; grace 0.5 s
        if self.rpc_server is not None:
            await guard.stage("rpc", self.rpc_server.stop())
        if self.rpc_env is not None:
            # commit-waiter drain: after both servers so no route can
            # re-create it mid-teardown
            await guard.stage("rpc_env", self.rpc_env.close())
        if self._cs_started:
            await guard.stage("consensus", self.parts.cs.stop() if graceful else self.parts.cs.crash())
        # the switch stage gets 3x: it contains per-plane bounded stops
        # of its own which must get a chance to run before escalation
        if not await guard.stage("switch", self.switch.stop(), budget_s=guard.budget_s * 3):
            # an abandoned graceful stop must STILL kill every conn fd
            # synchronously — a zombie conn makes remotes dup-discard
            # this node's next incarnation's dials
            try:
                self.switch.abort()
            except Exception:
                traceback.print_exc()
        if self.parts.indexer_service is not None:
            await guard.stage("indexer", self.parts.indexer_service.stop())
        # before the stores close: a reconcile pass in its worker
        # thread must finish (or be abandoned, bounded) while its dbs
        # are still open
        await guard.stage("retention", self.parts.retention.stop())
        # release store handles last: a restart in the same process
        # must be able to reopen every database, even when every stage
        # above was abandoned
        await guard.stage("stores", asyncio.to_thread(self.parts.close_stores))
        if not guard.clean:
            _log.error(
                "shutdown completed with stalled stages",
                node=self.config.base.moniker,
                stages=[r["stage"] for r in guard.stalls],
                abandoned=guard.abandoned,
            )

    # --- convenience --------------------------------------------------

    async def dial(self, addr: str, persistent: bool = False):
        return await self.switch.dial_peer(addr, persistent=persistent)

    async def add_evidence(self, ev) -> None:
        """Hand evidence to this node's pool: pending and gossiped when
        this returns; a refusal raises the pool's error; a failed
        verify route raises ``DeviceRouteError`` and the evidence
        reactor checks it again until it has a verdict. The commit
        checks' tickets are awaited on the node's event loop."""
        await self.evidence_reactor.add_evidence(ev)

    @property
    def height(self) -> int:
        return self.parts.block_store.height()

    def block_id_hash_at(self, height: int) -> Optional[bytes]:
        """Committed block ID hash at a height, or None — the
        commit-introspection surface tests compare across nodes."""
        meta = self.parts.block_store.load_block_meta(height)
        return None if meta is None else bytes(meta.block_id.hash)
