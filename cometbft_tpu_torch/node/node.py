"""Full node assembly: transport + switch + reactors + consensus
(reference node/node.go:285 NewNode, :616 OnStart, node/setup.go).

Startup phases mirror the reference: blocksync -> consensus. When
blocksync is enabled the consensus state machine is built but NOT
started; once the pool reports caught-up the node switches to
consensus (reference consensus/reactor.go:121 SwitchToConsensus). With
the fork's AdaptiveSync, blocksync pipelines verified blocks straight
into the RUNNING consensus state machine instead (reference
blocksync/reactor_adaptive.go).

A copy of the JAX package's ``node/node.py``: the constructor,
``start``, ``stop``, ``kill``, ``dial``, ``listen_addr``, ``height``,
``block_id_hash_at`` and the blocksync-to-consensus hand-off. The node
runs its signature checks on ``device`` (None is the GPU, and raises
without one; ``device="cpu"`` the host plane or the plain kernels): the
consensus state machine, the consensus reactor's vote waves, the
blocksync windows and the evidence pool all take it. The evidence
reactor gossips the pool on channel 0x38; ``add_evidence`` hands the
pool evidence directly, where the JAX node's RPC ``broadcast_evidence``
does, with the reactor's retry when the verify route fails (C3). Not
ported, and refused with ``NotImplementedError`` when the config asks
for them (ROADMAP A8, A10): lp2p, PEX and seeds, the statesync
reactor, RPC and gRPC, the app and nop mempools, the reactor autopool,
the metrics and profiling servers and the stuck-task watchdog. The obs
plane's loop watchdog, queue registry and staged shutdown guard (A10)
are replaced by plain per-stage timeouts in ``_shutdown``; the indexer
and retention do not exist in the port.
"""

from __future__ import annotations

import asyncio
import traceback
from typing import Optional

from ..blocksync.net_reactor import BlockSyncNetReactor
from ..config import Config
from ..consensus.reactor import ConsensusReactor
from ..device import resolve
from ..evidence.reactor import EvidenceReactor
from ..mempool.reactor import MempoolReactor
from ..p2p import NodeInfo, NodeKey, Switch, TCPTransport
from ..types.genesis import GenesisDoc
from ..utils.log import get_logger
from ..utils.tasks import spawn
from .inprocess import NodeParts, build_node

_log = get_logger("node")

# per-stage budget of _shutdown (the JAX default
# shutdown_stage_budget_s); the switch stage gets three
SHUTDOWN_STAGE_BUDGET_S = 5.0


def _strip_proto(addr: str) -> str:
    for p in ("tcp://", "unix://"):
        if addr.startswith(p):
            return addr[len(p):]
    return addr


def _refuse_unported(config: Config) -> None:
    """NotImplementedError for a setting whose plane the port lacks,
    naming the ROADMAP item that carries it."""
    asked = [
        (config.p2p.use_libp2p_equivalent, "p2p.use_libp2p_equivalent (lp2p)", "A8"),
        (config.p2p.pex, "p2p.pex (the PEX reactor)", "A8"),
        (config.p2p.seeds or config.p2p.seed_mode, "p2p.seeds / p2p.seed_mode (PEX)", "A8"),
        (config.p2p.use_autopool, "p2p.use_autopool (the reactor autopool)", "A8"),
        (config.statesync.enable, "statesync.enable (the statesync reactor)", "A8"),
        (config.rpc.laddr, "rpc.laddr (the RPC server)", "A8"),
        (config.rpc.grpc_laddr, "rpc.grpc_laddr (the gRPC broadcast API)", "A8"),
        (config.mempool.type_ != "clist", f"mempool.type_={config.mempool.type_!r}", "A8"),
        (config.instrumentation.prometheus, "instrumentation.prometheus (the metrics server)", "A10"),
        (config.instrumentation.pprof_laddr, "instrumentation.pprof_laddr (the debug server)", "A10"),
        (config.instrumentation.watchdog_stall_s > 0, "instrumentation.watchdog_stall_s", "A10"),
    ]
    for on, what, item in asked:
        if on:
            raise NotImplementedError(
                f"{what} is not ported to cometbft_tpu_torch yet (ROADMAP {item})"
            )


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
        _refuse_unported(config)
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
        if transport is None:
            transport = TCPTransport(self.node_key, self.node_info)
        self.transport = transport
        # self-healing connectivity plane knobs ([p2p])
        reconnect_config = {
            "base_s": config.p2p.reconnect_base_s,
            "cap_s": config.p2p.reconnect_cap_s,
            "fast_attempts": config.p2p.reconnect_fast_attempts,
            "slow_interval_s": config.p2p.reconnect_slow_interval_s,
            "starvation_s": config.p2p.starvation_s,
        }
        self.switch = Switch(
            self.transport,
            self.node_info,
            mconn_config={
                "send_rate": config.p2p.send_rate,
                "recv_rate": config.p2p.recv_rate,
                "flush_throttle_s": config.p2p.flush_throttle_ms / 1000.0,
            },
            reconnect_config=reconnect_config,
        )
        self.switch.min_peers = config.p2p.min_peers
        # a reactor's failed verify route counts where the state
        # machine's do (C3)
        self.switch.loop_errors = self.parts.cs.loop_errors

        blocksync_active = config.blocksync.enable
        adaptive = config.blocksync.adaptive_sync
        # consensus gossip stays off until blocksync completes, unless
        # blocksync ingests into the running state machine
        sync_pending = blocksync_active and not adaptive
        self.consensus_reactor = ConsensusReactor(
            self.parts.cs,
            self.parts.block_store,
            wait_sync=sync_pending,
        )
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
        self.switch.add_reactor("consensus", self.consensus_reactor)
        self.switch.add_reactor("mempool", self.mempool_reactor)
        self.switch.add_reactor("evidence", self.evidence_reactor)
        self.switch.add_reactor("blocksync", self.blocksync_reactor)
        self._adaptive = adaptive
        self._cs_started = False

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
        await self.transport.listen(_strip_proto(self.config.p2p.laddr))
        await self.switch.start()
        _log.info(
            "node started",
            node_id=self.node_info.node_id[:12],
            laddr=self.listen_addr,
            chain=self.genesis.chain_id,
            height=self.parts.block_store.height(),
        )
        # consensus starts now unless blocksync must complete first
        if not self.blocksync_reactor.active or self._adaptive:
            await self.parts.cs.start()
            self._cs_started = True
        if self.config.p2p.persistent_peers:
            self.switch.dial_peers_async(
                [a.strip() for a in self.config.p2p.persistent_peers.split(",") if a.strip()],
                persistent=True,
            )

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

    async def _stage(self, name: str, aw, budget_s: float) -> bool:
        """One bounded shutdown stage; False when it ran out of budget
        (it is then cancelled and the remaining stages still run)."""
        try:
            await asyncio.wait_for(aw, budget_s)
            return True
        except asyncio.TimeoutError:
            _log.error("shutdown stage exceeded its budget", node=self.config.base.moniker, stage=name)
            return False

    async def _shutdown(self, graceful: bool) -> None:
        budget = SHUTDOWN_STAGE_BUDGET_S
        if self._cs_started:
            await self._stage(
                "consensus",
                self.parts.cs.stop() if graceful else self.parts.cs.crash(),
                budget,
            )
        # the switch stage gets 3x: it contains per-plane bounded stops
        # of its own which must get a chance to run before escalation
        if not await self._stage("switch", self.switch.stop(), budget * 3):
            # an abandoned graceful stop must STILL kill every conn fd
            # synchronously — a zombie conn makes remotes dup-discard
            # this node's next incarnation's dials
            try:
                self.switch.abort()
            except Exception:
                traceback.print_exc()
        # release store handles last: a restart in the same process
        # must be able to reopen every database
        await self._stage("stores", asyncio.to_thread(self.parts.close_stores), budget)

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
