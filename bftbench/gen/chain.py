"""A signed chain for joiners to catch up on: a frozen copy of
``utils/chaingen.py::make_chain`` (each block made by a source node's
executor from its mempool, signed by every validator, applied) with the
txs given per height; copies of
``StorePeerClient`` and of ``chip_smoke.py::_forging_peer``. The votes
are signed in this process (``sign.py``)."""

from __future__ import annotations

import dataclasses

from .sign import Signer

# the chain's clock: block h is GENESIS_NS + h seconds
GENESIS_NS = 1_735_689_600 * 10**9


def bench_txs(n_blocks: int, per_block: int) -> list:
    """The replay bench's txs (``make_chain`` in ``utils/chaingen.py``,
    as ``bench.py``'s replay calls it): ``h<height>_<i>=v<height>``."""
    return [[b"h%d_%d=v%d" % (h, i, h) for i in range(per_block)] for h in range(1, n_blocks + 1)]


def make_txs(rng, n_blocks: int, per_block: int, tx_bytes: int, key_space: int) -> list:
    """``key=value`` txs of ``tx_bytes`` bytes: the key one of
    ``key_space`` accounts, the value hex from the seed."""
    out = []
    for h in range(1, n_blocks + 1):
        keys = rng.integers(0, key_space, size=per_block)
        txs = []
        for i, k in enumerate(keys):
            key = b"acct%06d" % k
            head = b"%s=h%d.%d." % (key, h, i)
            body = rng.bytes((tx_bytes - len(head) + 1) // 2).hex().encode()
            txs.append(head + body[: tx_bytes - len(head)])
        out.append(txs)
    return out


class Corpus:
    """The chain: the source node, the validators' key seeds, the
    genesis, and each height's txs and commit as signed."""

    def __init__(self, source, seeds, genesis, txs, commits):
        self.source = source
        self.seeds = seeds
        self.genesis = genesis
        self.txs = txs
        self.commits = commits

    @property
    def top(self) -> int:
        return self.source.block_store.height()


def make_corpus(chain_id: str, n_vals: int, power: int, txs, rng, device) -> Corpus:
    """A source node on ``device`` whose store holds one block for each
    entry of ``txs``, every block committed by all ``n_vals`` validators."""
    from cometbft_tpu_torch.config.config import default_config
    from cometbft_tpu_torch.node.inprocess import build_node
    from cometbft_tpu_torch.types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig
    from cometbft_tpu_torch.types.genesis import GenesisDoc
    from cometbft_tpu_torch.types.validator_set import Validator
    from cometbft_tpu_torch.types.vote import PRECOMMIT, Vote

    seeds = [rng.bytes(32) for _ in range(n_vals)]
    privs = make_keys_from(seeds)
    genesis = GenesisDoc(chain_id=chain_id, genesis_time_ns=GENESIS_NS,
                         validators=[Validator(p.pub_key(), power) for p in privs])
    cfg = default_config(".")
    cfg.base.db_backend = "memdb"
    cfg.tx_index.indexer = "null"
    node = build_node(genesis, config=cfg, device=device)
    state = node.state_store.load()
    by_addr = {p.pub_key().address(): s for p, s in zip(privs, seeds)}
    t = state.last_block_time_ns or GENESIS_NS
    commits = {}
    signer = Signer()
    for h, block_txs in enumerate(txs, start=state.last_block_height + 1):
        proposer = state.validators.get_proposer()
        last_commit = node.block_store.load_seen_commit(h - 1) if h > state.initial_height else None
        for tx in block_txs:
            res = node.mempool.check_tx(tx)
            if getattr(res, "code", 0):
                raise ValueError(f"the mempool refused a generated tx at {h}")
        t += 1_000_000_000
        block, parts = node.block_exec.create_proposal_block(h, state, last_commit, proposer.address, time_ns=t)
        if list(block.data.txs) != list(block_txs):
            raise ValueError(f"block {h} does not hold the generated txs")
        bid = BlockID(block.hash(), parts.header)
        vals = state.validators.validators
        # a precommit's sign bytes hold neither its validator nor its
        # index: every vote of the commit signs the same bytes
        msg = Vote(type_=PRECOMMIT, height=h, round=0, block_id=bid, timestamp_ns=t,
                   validator_address=b"", validator_index=0).sign_bytes(chain_id)
        sigs = signer.sign([(by_addr[v.address], msg) for v in vals])
        commit = Commit(height=h, round=0, block_id=bid, signatures=[
            CommitSig(block_id_flag=BLOCK_ID_FLAG_COMMIT, validator_address=v.address, timestamp_ns=t,
                      signature=s) for v, s in zip(vals, sigs)])
        node.block_store.save_block(block, parts, commit)
        state = node.block_exec.apply_verified_block(state, bid, block)
        commits[h] = commit
    node.state = state
    return Corpus(node, seeds, genesis, txs, commits)


def make_keys_from(seeds):
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    return [Ed25519PrivKey.from_seed(s) for s in seeds]


class StorePeerClient:
    """A blocksync peer serving a node's stored blocks (the in-memory
    stand-in for a network peer)."""

    def __init__(self, node):
        self.node = node

    @property
    def base(self) -> int:
        return self.node.block_store.base()

    @property
    def height(self) -> int:
        return self.node.block_store.height()

    async def request_block(self, height: int):
        blk = self.node.block_store.load_block(height)
        if blk is not None:
            ec = self.node.block_store.load_extended_commit(height)
            if ec:
                blk._ec_bytes = ec
        return blk


FORGED_LANE = 17  # a lane the light check reads: among the first 2/3


def forged_lane(n_sigs: int) -> int:
    return min(FORGED_LANE, n_sigs // 2)


class ForgingPeerClient(StorePeerClient):
    """Serves block ``bad_height`` with its last commit carrying one
    signature corrupted (byte 5 of lane ``forged_lane``); it serves
    ``bad_height - 1`` too, honestly, so the failed commit names this
    peer alone, as the sender of both blocks."""

    def __init__(self, node, bad_height: int):
        super().__init__(node)
        self.bad_height = bad_height

    async def request_block(self, height):
        blk = await super().request_block(height)
        if blk is not None and height == self.bad_height:
            lc = blk.last_commit
            i = forged_lane(len(lc.signatures))
            sig = bytearray(lc.signatures[i].signature)
            sig[5] ^= 0x40
            lc.signatures[i] = dataclasses.replace(lc.signatures[i], signature=bytes(sig))
            lc._hash = None
            for o in (blk, lc):
                if hasattr(o, "_raw_bytes"):
                    del o._raw_bytes
        return blk


