"""Node configuration (reference config/config.go): the parts a node
that runs consensus reads.

A copy of the JAX package's ``config/config.py`` cut to what
``node.inprocess.build_node`` and ``consensus.state.ConsensusState``
read: ``ConsensusConfig`` whole, and of ``BaseConfig`` the moniker and
the store backend. ``test_config`` sets the reference's short test
timeouts (config.TestConfig). The other sections (RPC, p2p, mempool,
statesync, storage, indexer, instrumentation, crypto, fleet) and the
TOML round trip wait for the node and network slice.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field


@dataclass
class BaseConfig:
    chain_id: str = ""
    moniker: str = "tpu-node"
    db_backend: str = "sqlite"


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
    # out-earn the dispatch handoff (docs/PERF.md); the p2p reactor's
    # always-on coalescing continues to serve networked nodes either
    # way.
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
    consensus: ConsensusConfig = field(default_factory=ConsensusConfig)
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
    return c
