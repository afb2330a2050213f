"""Chain generator: a valid chain built directly, without consensus.

A copy of the JAX package's ``utils/chaingen.py``. Each block is made
by the node's executor, signed by every validator's key (precommits
over the canonical sign bytes) and applied through the executor, so
the product is a valid chain that replay can take. ``StorePeerClient``
serves a node's stored blocks as a blocksync peer;
``TamperingPeerClient`` adds a tx to one height's block.
``RotatingLightProvider`` mints light blocks on demand over validator
sets that rotate by epoch, the shape of BASELINE config 4's bisection
(the JAX package's ``bench.py::bench_bisect``).
"""

from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..light.provider import Provider
from ..light.types import LightBlock
from ..node.inprocess import NodeParts, build_node
from ..types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig, Header, PartSetHeader
from ..types.genesis import GenesisDoc
from ..types.validator_set import Validator, ValidatorSet
from ..types.vote import PRECOMMIT, Vote


def make_chain(
    genesis: GenesisDoc,
    privs,
    n_blocks: int,
    txs_per_block: int = 1,
    node: Optional[NodeParts] = None,
    device=None,
) -> NodeParts:
    """A NodeParts whose stores hold ``n_blocks`` more blocks; a new
    node on ``device`` unless ``node`` is given."""
    node = node or build_node(genesis, device=device)
    state = node.state_store.load()
    chain_id = state.chain_id
    # block times strictly increasing and in the past: 1 s a block when
    # the genesis backdate allows it, else a shorter step that still
    # ends 60 s before now
    now = time.time_ns()
    margin_ns = 60 * 1_000_000_000
    t = state.last_block_time_ns or (now - margin_ns - (n_blocks + 1) * 1_000_000_000)
    step_ns = 1_000_000_000
    if t + (n_blocks + 1) * step_ns > now - margin_ns:
        step_ns = max(1, (now - margin_ns - t) // (n_blocks + 1))
    addr_to_priv = {p.pub_key().address(): p for p in privs}
    for h in range(state.last_block_height + 1, state.last_block_height + 1 + n_blocks):
        proposer = state.validators.get_proposer()
        last_commit = node.block_store.load_seen_commit(h - 1) if h > state.initial_height else None
        for i in range(txs_per_block):
            node.mempool.check_tx(b"h%d_%d=v%d" % (h, i, h))
        t += step_ns
        block, parts = node.block_exec.create_proposal_block(
            h, state, last_commit, proposer.address, time_ns=t
        )
        bid = BlockID(block.hash(), parts.header)
        sigs = []
        for i, val in enumerate(state.validators.validators):
            vote = Vote(
                type_=PRECOMMIT,
                height=h,
                round=0,
                block_id=bid,
                timestamp_ns=t,
                validator_address=val.address,
                validator_index=i,
            )
            sigs.append(
                CommitSig(
                    block_id_flag=BLOCK_ID_FLAG_COMMIT,
                    validator_address=val.address,
                    timestamp_ns=t,
                    signature=addr_to_priv[val.address].sign(vote.sign_bytes(chain_id)),
                )
            )
        commit = Commit(height=h, round=0, block_id=bid, signatures=sigs)
        node.block_store.save_block(block, parts, commit)
        state = node.block_exec.apply_verified_block(state, bid, block)
    node.state = state
    return node


class StorePeerClient:
    """A blocksync peer serving a node's stored blocks (the in-memory
    stand-in for a network peer)."""

    def __init__(self, node: NodeParts, delay_s: float = 0.0):
        self.node = node
        self.delay_s = delay_s

    @property
    def base(self) -> int:
        return self.node.block_store.base()

    @property
    def height(self) -> int:
        return self.node.block_store.height()

    async def request_block(self, height: int):
        if self.delay_s:
            await asyncio.sleep(self.delay_s)
        blk = self.node.block_store.load_block(height)
        if blk is not None:
            # the extended commit travels beside the block, as on the wire
            ec = self.node.block_store.load_extended_commit(height)
            if ec:
                blk._ec_bytes = ec
        return blk


class TamperingPeerClient(StorePeerClient):
    """Serves a corrupted block at one height (bad-peer testing)."""

    def __init__(self, node, bad_height: int):
        super().__init__(node)
        self.bad_height = bad_height

    async def request_block(self, height: int):
        blk = await super().request_block(height)
        if blk is not None and height == self.bad_height:
            blk.data.txs = list(blk.data.txs) + [b"evil=1"]
            blk.data._hash = None
            if hasattr(blk, "_raw_bytes"):  # decoded objects are immutable
                del blk._raw_bytes
        return blk


class RotatingLightProvider(Provider):
    """Mints a signed light block at any height on demand (the
    reference's light bench shape, light/client_benchmark_test.go:
    bisection checks commits and validator-set hashes between hops,
    not the hash chain). The set signing height h is the ``n_vals``
    keys ``keys[e * shift : e * shift + n_vals]`` of epoch ``e = h //
    epoch``, each of power 10; header h's time is ``t0_ns + h`` s.

    Adversaries for refusal checks: ``forge_at`` heights carry one
    signature (the first lane) with a byte flipped; ``app_hash`` set
    makes a fork that is valid in itself (the same signers over other
    headers). ``fetched`` lists the heights served, in order."""

    def __init__(self, chain_id, keys, n_vals, epoch, shift, t0_ns, forge_at=(), app_hash=b""):
        self.chain_id = chain_id
        self.keys = list(keys)
        self.n_vals, self.epoch, self.shift = n_vals, epoch, shift
        self.t0_ns = t0_ns
        self.forge_at = set(forge_at)
        self.app_hash = app_hash
        self.fetched: list = []
        self.reported: list = []
        self._sets: dict = {}
        self._by_addr = {k.pub_key().address(): k for k in self.keys}

    def vals_at(self, height: int) -> ValidatorSet:
        e = height // self.epoch
        if e not in self._sets:
            window = self.keys[e * self.shift : e * self.shift + self.n_vals]
            self._sets[e] = ValidatorSet([Validator(k.pub_key(), 10) for k in window])
        return self._sets[e]

    def light_block(self, height: int) -> LightBlock:
        self.fetched.append(height)
        vals = self.vals_at(height)
        header = Header(
            chain_id=self.chain_id,
            height=height,
            time_ns=self.t0_ns + height * 1_000_000_000,
            validators_hash=vals.hash(),
            next_validators_hash=self.vals_at(height + 1).hash(),
            app_hash=self.app_hash,
        )
        bid = BlockID(header.hash(), PartSetHeader(1, header.hash()))
        sigs = []
        for i, val in enumerate(vals.validators):
            vote = Vote(
                type_=PRECOMMIT,
                height=height,
                round=0,
                block_id=bid,
                timestamp_ns=header.time_ns,
                validator_address=val.address,
                validator_index=i,
            )
            sig = self._by_addr[val.address].sign(vote.sign_bytes(self.chain_id))
            if i == 0 and height in self.forge_at:
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            sigs.append(
                CommitSig(
                    block_id_flag=BLOCK_ID_FLAG_COMMIT,
                    validator_address=val.address,
                    timestamp_ns=header.time_ns,
                    signature=sig,
                )
            )
        return LightBlock(header, Commit(height=height, round=0, block_id=bid, signatures=sigs), vals)

    def report_evidence(self, ev) -> None:
        self.reported.append(ev)
