"""In-process node assembly: what a node that replays blocks is made of.

The part of the JAX package's ``node/inprocess.py`` that block replay
needs: ``build_node`` wires the kv stores, the kvstore app behind a
local ABCI client, the mempool, the block executor and the ABCI
handshake; ``make_genesis`` makes a genesis whose keys come from a
seeded ``np.random.default_rng``, as ``bench.py``'s replay corpus does.
Consensus, p2p, the private validator, the evidence pool, the indexer,
retention and snapshots are not ported.

``device`` is where the node's commit checks run: None is the GPU and
raises without one; ``device="cpu"`` runs them on the host plane.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from ..abci.client import AppConns
from ..consensus.replay import Handshaker
from ..crypto.keys import Ed25519PrivKey
from ..device import resolve
from ..mempool.mempool import CListMempool
from ..models.kvstore import KVStoreApplication
from ..state.execution import BlockExecutor
from ..state.state_types import State
from ..state.store import Store as StateStore
from ..store.block_store import BlockStore
from ..types.genesis import GenesisDoc
from ..types.validator_set import Validator
from ..utils import kv


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
    mempool: CListMempool
    block_exec: BlockExecutor
    device: object

    def close_stores(self) -> None:
        """Release the store handles. Idempotent."""
        for db in (self.block_db, self.state_db):
            db.close()


def build_node(
    genesis: GenesisDoc,
    app=None,
    db_backend: str = "memdb",
    home: Optional[str] = None,
    device=None,
) -> NodeParts:
    """Stores (``"memdb"``, or ``"sqlite"`` under ``home``), the app (a
    fresh kvstore unless given), mempool and executor, then the
    handshake, which runs InitChain or replays stored blocks."""
    device = resolve(device)
    app = app if app is not None else KVStoreApplication()
    proxy = AppConns.local(app)
    if db_backend == "memdb":
        block_db, state_db = kv.MemKV(), kv.MemKV()
    else:
        if not home:
            raise ValueError(f"the {db_backend} backend needs a home directory")
        os.makedirs(home, exist_ok=True)
        block_db = kv.open_kv(db_backend, os.path.join(home, "blockstore.db"))
        state_db = kv.open_kv(db_backend, os.path.join(home, "state.db"))
    block_store = BlockStore(block_db)
    state_store = StateStore(state_db)
    state = state_store.load()
    if state is None:
        state = genesis.make_genesis_state()
        state_store.save(state)
    state = Handshaker(state_store, state, block_store, genesis).handshake(proxy)
    mempool = CListMempool(proxy.mempool)
    block_exec = BlockExecutor(
        state_store, proxy.consensus, mempool, block_store=block_store, device=device
    )
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
