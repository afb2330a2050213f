"""Offline state bootstrap (reference node.BootstrapState,
node/node.go:161-280).

Populates an (empty) node home with light-client-verified state at a
chosen height so the node can start directly in blocksync from there —
statesync without the snapshot transfer, for operators who restore app
state out-of-band (e.g. from their own backup).

A copy of the JAX package's ``node/bootstrap.py``; the light checks
run on ``device`` (None is the GPU, and raises without one), and the
stores it opens are closed when it returns. The command line's
``bootstrap-state`` calls it (``cmd/main.py``).
"""

from __future__ import annotations

import os
from typing import Optional


def bootstrap_state(
    config,
    genesis,
    home: str,
    height: Optional[int] = None,
    device=None,
) -> int:
    """Verify state at `height` (default: the statesync trust height)
    via the light client against config.statesync.rpc_servers, and
    persist it into the node's state/block stores. Returns the
    bootstrapped height.

    Refuses to overwrite a store that already has newer state
    (reference node/node.go:189-199)."""
    from ..state.store import Store as StateStore
    from ..statesync.stateprovider import LightClientStateProvider
    from ..store.block_store import BlockStore
    from ..utils import kv

    cfg = config.statesync
    if not cfg.rpc_servers:
        raise ValueError(
            "bootstrap-state requires [statesync] rpc_servers"
        )
    height = height or cfg.trust_height
    if height <= 0:
        raise ValueError("bootstrap-state requires a positive height")

    def open_db(name: str):
        if config.base.db_backend == "memdb":
            return kv.MemKV()
        return kv.open_kv(config.base.db_backend, os.path.join(home, name))

    state_db, block_db = open_db("state.db"), open_db("blockstore.db")
    try:
        state_store = StateStore(state_db)
        block_store = BlockStore(block_db)
        existing = state_store.load()
        if existing is not None and existing.last_block_height >= height:
            raise RuntimeError(
                f"state store already at height "
                f"{existing.last_block_height} >= {height}; refusing to "
                "rewind via bootstrap (use rollback)"
            )
        trust_hash = (
            bytes.fromhex(cfg.trust_hash) if isinstance(cfg.trust_hash, str) else cfg.trust_hash
        )
        provider = LightClientStateProvider(
            genesis.chain_id,
            list(cfg.rpc_servers),
            cfg.trust_height,
            trust_hash,
            int(cfg.trust_period_s * 1e9),
            genesis=genesis,
            device=device,
        )
        try:
            state = provider.state(height)
            commit = provider.commit(height)
        finally:
            provider.close()
        state_store.bootstrap(state)
        # seen commit lets the consensus reactor serve/verify the
        # bootstrapped height and blocksync anchor at height+1
        block_store.save_seen_commit(height, commit)
    finally:
        state_db.close()
        block_db.close()
    return height
