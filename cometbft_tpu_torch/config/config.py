"""Node configuration (reference config/config.go): the parts a node
reads.

A copy of the JAX package's ``config/config.py`` cut to what
``node.inprocess.build_node``, ``consensus.state.ConsensusState`` and
``node.node.Node`` read, with the JAX defaults: ``ConsensusConfig``
whole; of ``BaseConfig`` the moniker and the store backend; of
``P2PConfig``, ``MempoolConfig`` and ``BlockSyncConfig`` the fields
the port reads, which leaves out the JAX package's external address,
peer caps, packet payload size, handshake and dial timeouts, mempool
byte cap and async recheck; of ``RPCConfig`` the listen addresses, of
``StateSyncConfig`` ``enable`` and of ``InstrumentationConfig`` the
metrics, profiling and watchdog switches. Those sections take no other
attribute (slots), so setting a field the port lacks raises
``AttributeError`` instead of doing nothing. ``Node`` refuses the
settings whose planes the port does not have yet (RPC, PEX, statesync,
lp2p, the autopool, the metrics and debug servers) with
``NotImplementedError``; two of them default differently from the JAX
package so that a default ``Node`` builds: ``rpc.laddr`` is empty and
``p2p.pex`` is off. ``test_config`` sets
the reference's short test timeouts (config.TestConfig) and an
ephemeral p2p port. The storage, indexer, crypto and fleet sections
and the TOML round trip are not ported.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class BaseConfig:
    chain_id: str = ""
    moniker: str = "tpu-node"
    db_backend: str = "sqlite"


@dataclass(slots=True)
class RPCConfig:
    # the port has no RPC server: a listen address makes Node raise
    # (the JAX default is "tcp://127.0.0.1:26657")
    laddr: str = ""
    grpc_laddr: str = ""


@dataclass(slots=True)
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    seeds: str = ""
    persistent_peers: str = ""
    flush_throttle_ms: int = 10
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    # the port has no PEX reactor: on makes Node raise (the JAX
    # default is on)
    pex: bool = False
    seed_mode: bool = False
    use_libp2p_equivalent: bool = False  # fork: lp2p transport selection
    use_autopool: bool = False  # fork: autopool reactor msg draining
    # --- self-healing connectivity plane (p2p/reconnect.py) -----------
    # full-jitter backoff for the per-peer fast reconnect lane
    reconnect_base_s: float = 1.0
    reconnect_cap_s: float = 30.0
    # fast-lane dial BUDGET per outage (not a give-up bound: spending
    # it parks the peer in the never-give-up slow lane)
    reconnect_fast_attempts: int = 12
    # slow-lane sweep period: steady-state redial load for peers whose
    # fast budget is spent
    reconnect_slow_interval_s: float = 30.0
    # zero peers for this long = starving
    starvation_s: float = 10.0
    # connectivity verdict: degraded below this many peers (once the
    # node has evidence it is meant to be connected)
    min_peers: int = 1


@dataclass(slots=True)
class MempoolConfig:
    type_: str = "clist"  # clist | nop | app (fork)
    recheck: bool = True
    broadcast: bool = True
    size: int = 5000
    cache_size: int = 10000
    max_tx_bytes: int = 1024 * 1024
    # ingest plane: micro-batch coalescing in front of CheckTx — max
    # txs per batch, and how long the drainer waits after the first tx
    # before flushing a partial batch
    batch_max_txs: int = 256
    batch_flush_ms: float = 2.0


@dataclass(slots=True)
class StateSyncConfig:
    # the port has no statesync reactor: on makes Node raise
    enable: bool = False


@dataclass(slots=True)
class BlockSyncConfig:
    enable: bool = True
    adaptive_sync: bool = False  # fork feature (config.go:1194)


@dataclass(slots=True)
class InstrumentationConfig:
    # the metrics and profiling servers and the stuck-task watchdog
    # are not ported: setting any of these makes Node raise
    prometheus: bool = False
    pprof_laddr: str = ""
    watchdog_stall_s: float = 0.0


@dataclass
class ConsensusConfig:
    wal_file: str = "data/cs.wal/wal"
    timeout_propose_s: float = 3.0
    timeout_propose_delta_s: float = 0.5
    timeout_prevote_s: float = 1.0
    timeout_prevote_delta_s: float = 0.5
    timeout_precommit_s: float = 1.0
    timeout_precommit_delta_s: float = 0.5
    timeout_commit_s: float = 1.0
    skip_timeout_commit: bool = False
    create_empty_blocks: bool = True
    create_empty_blocks_interval_s: float = 0.0
    peer_gossip_sleep_s: float = 0.1
    peer_query_maj23_sleep_s: float = 2.0
    # max allowed difference between proposed block time and wall clock
    # (reference config/config.go:1265-1286, default 60s; 0 disables)
    block_time_tolerance_ns: int = 60_000_000_000
    # --- live-consensus fast path (docs/PERF.md) ---------------------
    # WAL group commit: sync-barrier records written within this
    # window coalesce into ONE fsync (consensus/wal.py write_group);
    # externalization (own vote/proposal broadcast) is deferred until
    # the covering fsync lands, so the WAL-before-act contract holds
    # with a bounded (~window) barrier. Routing is calibrated: the
    # seam only engages when the measured fsync cost exceeds the
    # ticket-handoff cost (slow sync-through disks), so a cached-NVMe
    # box keeps the strict inline barrier automatically. 0 disables
    # the seam entirely (the reference's one-fsync-per-barrier path).
    wal_group_commit_ms: float = 2.0
    # in-round vote-verify micro-batching: peer votes for the current
    # height arriving within this window are signature-verified as one
    # batch through the crypto coalesce/parallel engine and resolve as
    # cache hits in add_vote (the blocksync pre-verify pattern applied
    # to live rounds). 0 (default) = serial inline verification — the
    # batch only wins once committee vote waves are large enough to
    # out-earn the dispatch handoff; the p2p reactor's always-on
    # coalescing serves networked nodes either way, closing each wave
    # by its own rule (consensus/reactor.py), not by this window.
    vote_batch_window_ms: float = 0.0
    # pipelined finalize: block persist + WAL end-height + ABCI apply
    # run off-loop (one in-flight height, barrier before the next
    # commit) while the loop keeps relaying gossip; next-height
    # messages park and replay at height entry. Off = the reference's
    # blocking finalize.
    finalize_pipeline: bool = False
    # native finalize lane riding the pipeline (docs/PERF.md): the
    # hash/encode/persist leg of the ABCI apply (one GIL-releasing
    # native pass per block, state/native_finalize.py) takes a second
    # to_thread hop so the loop keeps relaying gossip through it.
    # Only engages when finalize_pipeline is on; off = the apply runs
    # whole on-loop exactly like the serial path.
    finalize_offload_apply: bool = True

    def propose_timeout(self, round_: int) -> float:
        return self.timeout_propose_s + self.timeout_propose_delta_s * round_

    def prevote_timeout(self, round_: int) -> float:
        return self.timeout_prevote_s + self.timeout_prevote_delta_s * round_

    def precommit_timeout(self, round_: int) -> float:
        return (
            self.timeout_precommit_s + self.timeout_precommit_delta_s * round_
        )


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)
    root_dir: str = "."

    def path(self, rel: str) -> str:
        return os.path.join(self.root_dir, rel)


def default_config(root_dir: str = ".") -> Config:
    c = Config()
    c.root_dir = root_dir
    return c


def test_config(root_dir: str = ".") -> Config:
    """Short timeouts for in-process tests (reference config.TestConfig)."""
    c = default_config(root_dir)
    c.consensus.timeout_propose_s = 0.4
    c.consensus.timeout_propose_delta_s = 0.1
    c.consensus.timeout_prevote_s = 0.2
    c.consensus.timeout_prevote_delta_s = 0.1
    c.consensus.timeout_precommit_s = 0.2
    c.consensus.timeout_precommit_delta_s = 0.1
    c.consensus.timeout_commit_s = 0.1
    c.consensus.peer_gossip_sleep_s = 0.01
    c.base.db_backend = "memdb"
    c.p2p.laddr = "tcp://127.0.0.1:0"  # ephemeral port per test node
    return c
