"""Node configuration (reference config/config.go): the parts a node
reads, with the TOML round trip the command line uses.

A copy of the JAX package's ``config/config.py`` with the JAX defaults
and every section: ``ConsensusConfig``, ``BaseConfig``,
``StateSyncConfig`` and ``InstrumentationConfig`` whole (the moniker,
the store backend, the log level, the remote signer's listen address
``priv_validator_laddr``, the app's kind ``abci``: ``kvstore``,
``kvstore-appmem``, ``socket`` or ``grpc``, and its address
``proxy_app`` when it runs out of process; the file layout fields and
``filter_peers``, which neither package reads but both write; the
metrics, profiling, tracing, watchdog, shutdown and runtime sanitizer
fields); the ``[fuzz]`` section (``p2p/fuzz.FuzzConnConfig``, which
``Node``'s TCP transport applies), ``[crypto]`` (``CryptoConfig``:
``build_node`` applies ``batch_backend``) and ``[fleet]``
(``FleetConfig``, the serving fleet's router knobs); of
``P2PConfig``, ``MempoolConfig``, ``RPCConfig`` and ``StorageConfig``
the fields the port reads, which leaves out the JAX package's external
address, inbound peer cap, packet payload size, handshake and dial
timeouts, mempool byte cap, RPC connection caps and
``discard_abci_responses`` (``JAX_UNREAD``). Every section takes no
other attribute (slots), so setting a field the port lacks raises
``AttributeError`` instead of doing nothing. ``load_toml`` reads a
JAX-written ``config.toml`` whole: a ``JAX_UNREAD`` key at its JAX
default is skipped, and any other key or section the port lacks, or a
``JAX_UNREAD`` key set to another value, raises ``ValueError`` (the JAX
loader skips both). One setting defaults differently from the JAX
package: ``rpc.laddr`` is empty, so that a node serves RPC only when
asked (the JAX ``test_config`` gives every test node an ephemeral RPC
port; here a test sets ``rpc.laddr`` itself; ROADMAP C10).
``test_config`` sets the reference's short test timeouts
(config.TestConfig), an ephemeral p2p port and, as the JAX one does,
the runtime sanitizer on.
"""
from __future__ import annotations

import os
import tomllib
from dataclasses import asdict, dataclass, field, fields
from typing import List

from ..p2p.fuzz import FuzzConnConfig


@dataclass(slots=True)
class BaseConfig:
    chain_id: str = ""
    moniker: str = "tpu-node"
    db_backend: str = "sqlite"
    db_dir: str = "data"
    log_level: str = "info"
    genesis_file: str = "config/genesis.json"
    priv_validator_key_file: str = "config/priv_validator_key.json"
    priv_validator_state_file: str = "data/priv_validator_state.json"
    node_key_file: str = "config/node_key.json"
    # when set, keys live with a remote signer that dials in here
    # (reference PrivValidatorListenAddr)
    priv_validator_laddr: str = ""
    abci: str = "kvstore"
    # out-of-process app: the address of an abci.server.ABCIServer or
    # GRPCServer (reference proxy_app); when set the node dials it
    # (over gRPC when abci is "grpc") instead of building an app
    proxy_app: str = ""
    filter_peers: bool = False


@dataclass(slots=True)
class RPCConfig:
    # empty: no RPC server (the JAX default is "tcp://127.0.0.1:26657")
    laddr: str = ""
    # the gRPC broadcast API (Ping, BroadcastTx) beside JSON-RPC
    # (reference GRPCListenAddress, rpc/grpc/api.go); "" = disabled
    grpc_laddr: str = ""
    timeout_broadcast_tx_commit_s: float = 10.0
    # expose the unsafe route set (reference --rpc.unsafe: dial_seeds,
    # dial_peers, unsafe_flush_mempool); never enable on public nodes
    unsafe: bool = False


@dataclass(slots=True)
class TxIndexConfig:
    indexer: str = "kv"  # kv | null | psql
    # connection string for the psql sink (reference [tx-index]
    # psql-conn); required when indexer = "psql"
    psql_conn: str = ""


@dataclass(slots=True)
class P2PConfig:
    laddr: str = "tcp://0.0.0.0:26656"
    seeds: str = ""
    persistent_peers: str = ""
    # the PEX crawl's outbound target (p2p/pex.py)
    max_num_outbound_peers: int = 10
    flush_throttle_ms: int = 10
    send_rate: int = 5_120_000
    recv_rate: int = 5_120_000
    pex: bool = True
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
    # post-commit recheck off the consensus critical section:
    # update() snapshots and returns; verdicts apply in the
    # background, height-guarded, with unrechecked txs masked from
    # reap. Off = the reference's synchronous recheck-inside-update.
    async_recheck: bool = True


@dataclass(slots=True)
class StateSyncConfig:
    enable: bool = False
    rpc_servers: List[str] = field(default_factory=list)
    trust_height: int = 0
    trust_hash: str = ""
    trust_period_s: float = 168 * 3600.0
    discovery_time_s: float = 15.0
    # how long the syncer waits for one chunk (the JAX package keeps
    # this field but its syncer uses a constant 10 s)
    chunk_request_timeout_s: float = 10.0


@dataclass(slots=True)
class BlockSyncConfig:
    enable: bool = True
    adaptive_sync: bool = False  # fork feature (config.go:1194)


@dataclass(slots=True)
class InstrumentationConfig:
    # the metrics server (utils/metrics.py): /metrics on
    # prometheus_listen_addr; Node.start fails when it cannot export
    prometheus: bool = False
    prometheus_listen_addr: str = ":26660"
    # profiling listener (reference pprof_laddr, node/node.go:624):
    # serves /debug/pprof/{stacks,profile,heap} when set
    pprof_laddr: str = ""
    # stuck-await watchdog (utils/debug.StuckTaskWatchdog): tasks
    # suspended at the same await point longer than this are reported
    # with their stack; 0 disables
    watchdog_stall_s: float = 0.0
    # the per-node tracing plane (trace/): a fixed-memory event ring;
    # the disabled fast path is a single attribute check
    trace_enabled: bool = True
    # events retained per node (ring slots, preallocated; oldest
    # events are overwritten once the ring laps)
    trace_ring_size: int = 16384
    # cross-node causal tracing: consensus/mempool/blocksync p2p
    # messages carry a compact trace-context stamp (p2p/tracewire.py).
    # Decoding and receive-side arrival recording are always on while
    # the tracer is enabled; this gates only the OUTBOUND stamp
    trace_msg_stamp: bool = True
    # the loop watchdog (obs/watchdog.py): a heartbeat measures the
    # event loop's scheduling lag and a monitor thread flight-records
    # a stall (thread + task stacks into the trace ring)
    loop_watchdog: bool = True
    # heartbeat period (the lag-sample rate; detection latency ~
    # interval + stall threshold)
    loop_lag_interval_ms: float = 100.0
    # loop blocked longer than this => flight record
    loop_stall_ms: float = 500.0
    # bounded shutdown (obs/shutdown.py): per-stage budget of
    # Node._shutdown; an overrunning stage is flight-recorded,
    # cancelled and, if it ignores the cancel, abandoned so the
    # remaining stages (store release above all) still run
    shutdown_stage_budget_s: float = 5.0
    # runtime concurrency sanitizer (analysis/runtime.py): lock-order
    # graph with cycle detection, loop-affinity guard on hot-plane
    # objects, stall attribution. PER-PROCESS and construction-time
    # (build_node enables it before any plane builds its locks); off,
    # the raw locks come back unwrapped. test_config turns it on
    sanitizer: bool = False


@dataclass(slots=True)
class StorageConfig:
    # --- retention plane (store/retention.py) --------------------------
    # blocks/states/index rows kept behind the committed head; 0 =
    # retain everything (reference semantics — pruning entirely off).
    # The effective prune target is min-reconciled with the app's
    # retain_height from ABCI Commit; node-side windows only ever
    # TIGHTEN what the app allows, never override it upward.
    retain_blocks: int = 0
    retain_states: int = 0
    retain_index: int = 0
    # background reconcile cadence + per-batch height budget: each
    # batch is ONE atomic write_batch (deletes + base-marker advance)
    # so a crash mid-prune resumes idempotently
    prune_interval_s: float = 10.0
    prune_batch: int = 100
    # node-side snapshot generation (statesync/snapshots.py): take an
    # on-disk chunked app snapshot every `snapshot_interval` heights
    # (0 = off), rotating to the newest `snapshot_keep_recent`
    snapshot_interval: int = 0
    snapshot_keep_recent: int = 2


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


@dataclass(slots=True)
class CryptoConfig:
    """Signature-verification backend knobs. ``batch_backend`` names an
    entry of the ``crypto/batch.py`` registry, applied at node build
    (``node/inprocess.build_node``): "cuda" (the card's lanes),
    "cpu" (serial host baseline), "cpu-parallel" (the multi-core host
    plane) or "mesh" (the lanes on the cards with no calibration gate,
    split over every CUDA device when there are more than one, the
    host plane with none: ``crypto/mesh_backend.py``); the JAX
    name "tpu" means the device route, so "cuda". Empty (the default)
    inherits the process-wide default. The other three fields are kept
    so that JAX-written files load; neither package reads them."""

    batch_backend: str = ""  # "" (inherit) | cuda | tpu (= cuda) | cpu | cpu-parallel | mesh
    min_batch_for_tpu: int = 2
    coalesce_window_ms: float = 2.0
    max_lanes: int = 131072


@dataclass(slots=True)
class FleetConfig:
    """Serving-fleet knobs (``fleet/``): the SessionRouter in front of N
    follower replicas admits at most max_sessions concurrent routed
    sessions, holds consistency-token barrier waits to token_wait_s,
    degrades a replica stalled past max_lag_heights behind the committee
    head (checked every lag_poll_s), and on failover replays at most
    resume_replay_max heights from the store per resumed session
    (beyond that the session is shed rather than resumed with a
    gap)."""

    max_sessions: int = 4096
    admit_timeout_s: float = 0.25
    max_lag_heights: int = 8
    lag_poll_s: float = 0.1
    token_wait_s: float = 2.0
    resume_replay_max: int = 512
    drain_timeout_s: float = 5.0


@dataclass
class Config:
    base: BaseConfig = field(default_factory=BaseConfig)
    rpc: RPCConfig = field(default_factory=RPCConfig)
    p2p: P2PConfig = field(default_factory=P2PConfig)
    mempool: MempoolConfig = field(default_factory=MempoolConfig)
    statesync: StateSyncConfig = field(default_factory=StateSyncConfig)
    storage: StorageConfig = field(default_factory=StorageConfig)
    blocksync: BlockSyncConfig = field(default_factory=BlockSyncConfig)
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
    tx_index: TxIndexConfig = field(default_factory=TxIndexConfig)
    instrumentation: InstrumentationConfig = field(default_factory=InstrumentationConfig)
    fuzz: FuzzConnConfig = field(default_factory=FuzzConnConfig)
    crypto: CryptoConfig = field(default_factory=CryptoConfig)
    fleet: FleetConfig = field(default_factory=FleetConfig)
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
    # tests run with the runtime concurrency sanitizer on, as the JAX
    # test_config does
    c.instrumentation.sanitizer = True
    return c


_SECTIONS = (
    "base", "rpc", "p2p", "mempool", "statesync", "blocksync", "consensus",
    "storage", "tx_index", "instrumentation", "fuzz", "crypto", "fleet",
)

# keys a JAX-written config.toml holds that nothing in the port reads,
# with their JAX defaults: load_toml skips one at that value
JAX_UNREAD = {
    ("rpc", "max_open_connections"): 900,
    ("rpc", "max_subscription_clients"): 100,
    ("p2p", "external_address"): "",
    ("p2p", "max_num_inbound_peers"): 40,
    ("p2p", "max_packet_msg_payload_size"): 1024,
    ("p2p", "handshake_timeout_s"): 20.0,
    ("p2p", "dial_timeout_s"): 3.0,
    ("mempool", "max_txs_bytes"): 64 * 1024 * 1024,
    ("storage", "discard_abci_responses"): False,
}


def load_toml(path: str) -> Config:
    """The config a ``config.toml`` holds (``root_dir`` two levels up,
    as in ``<home>/config/config.toml``); absent keys keep their
    defaults. A section or key the port lacks raises ``ValueError``,
    unless it is a ``JAX_UNREAD`` key at its JAX default."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    c = default_config(os.path.dirname(os.path.dirname(path)) or ".")
    unknown = sorted(set(raw) - set(_SECTIONS))
    if unknown:
        raise ValueError(f"{path}: sections {unknown} are not in cometbft_tpu_torch's config")
    for section, values in raw.items():
        obj = getattr(c, section)
        names = {f.name for f in fields(obj)}
        for k, v in values.items():
            if k not in names:
                if (section, k) in JAX_UNREAD and v == JAX_UNREAD[section, k]:
                    continue
                raise ValueError(f"{path}: [{section}] {k} is not in cometbft_tpu_torch's config")
            setattr(obj, k, v)
    return c


def write_toml(cfg: Config, path: str) -> None:
    """Write every section's fields as TOML (the JAX writer's format)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def emit(name, obj):
        lines = [f"[{name}]"]
        for k, v in asdict(obj).items():
            if v is None:
                continue  # TOML has no null; an absent key loads as its default
            if isinstance(v, bool):
                lines.append(f"{k} = {'true' if v else 'false'}")
            elif isinstance(v, (int, float)):
                lines.append(f"{k} = {v}")
            elif isinstance(v, list):
                inner = ", ".join(f'"{x}"' for x in v)
                lines.append(f"{k} = [{inner}]")
            else:
                lines.append(f'{k} = "{v}"')
        return "\n".join(lines)

    with open(path, "w") as f:
        f.write("\n\n".join(emit(n, getattr(cfg, n)) for n in _SECTIONS) + "\n")
