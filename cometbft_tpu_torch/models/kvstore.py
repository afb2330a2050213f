"""kvstore: the example application (reference abci/example/kvstore).

The part of the JAX package's ``models/kvstore.py`` that block replay
drives: transactions are ``key=value`` bytes, or ``val:<hex pubkey>!<power>``
validator updates; the app hash is SHA-256 over the height and every
committed pair in key order, kept incremental by a sorted chunk cache
so a block costs its own writes, not the whole state. Queries read
the committed state; ProcessProposal refuses a block with a malformed
tx; vote extensions are bound to (height, block hash), as in the
reference's e2e app; every Misbehavior that FinalizeBlock delivers is
kept in ``misbehavior_seen``, the app-side slashing record. The
provable hash (and so query proofs), snapshots and the persistence
file are not ported.
"""

from __future__ import annotations

import bisect
import hashlib
import json
from typing import Dict, List

from ..abci import types as abci

VALIDATOR_TX_PREFIX = b"val:"


class KVStoreApplication(abci.Application):
    def __init__(self):
        self.state: Dict[bytes, bytes] = {}
        self.height = 0
        # (committed state, sorted keys, chunks) and finalize's overlay
        self._chunk_cache = None
        self._chunk_cache_next = None
        self.app_hash = self._hash_state(self.height, self.state)
        self.staged: Dict[bytes, bytes] = {}
        self.val_updates: List[abci.ValidatorUpdate] = []
        self._pending = None
        # (block height, type, validator address, power, evidence height)
        self.misbehavior_seen: List[tuple] = []
        self.extensions_verified = 0  # accepted VerifyVoteExtension calls

    # --- hashing ------------------------------------------------------

    @staticmethod
    def _chunk(k: bytes, v: bytes) -> bytes:
        return len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big") + v

    def _chunks_for(self, state: Dict[bytes, bytes]):
        """Sorted (keys, chunks) for ``state``: cached for the committed
        state, and a sorted overlay of the changed keys for finalize's
        prospective state, which commit() promotes."""
        cache = self._chunk_cache
        if cache is None or cache[0] is not self.state:
            keys = sorted(self.state)
            cache = (self.state, keys, [self._chunk(k, self.state[k]) for k in keys])
            self._chunk_cache = cache
        if state is self.state:
            return cache[1], cache[2]
        keys, chunks = list(cache[1]), list(cache[2])
        for k in sorted(k for k in state if state[k] != self.state.get(k)):
            i = bisect.bisect_left(keys, k)
            ch = self._chunk(k, state[k])
            if i < len(keys) and keys[i] == k:
                chunks[i] = ch
            else:
                keys.insert(i, k)
                chunks.insert(i, ch)
        self._chunk_cache_next = (state, keys, chunks)
        return keys, chunks

    def _hash_state(self, height: int, state: Dict[bytes, bytes]) -> bytes:
        h = hashlib.sha256()
        h.update(height.to_bytes(8, "big"))
        for ch in self._chunks_for(state)[1]:
            h.update(ch)
        return h.digest()

    # --- info ---------------------------------------------------------

    def info(self, req):
        return abci.ResponseInfo(
            data=json.dumps({"size": len(self.state)}),
            version="kvstore-tpu-0.1",
            app_version=1,
            last_block_height=self.height,
            last_block_app_hash=self.app_hash,
        )

    def query(self, req):
        if req.path == "/store" or req.path == "":
            v = self.state.get(req.data)
            return abci.ResponseQuery(
                code=abci.CODE_TYPE_OK if v is not None else 1,
                key=req.data,
                value=v or b"",
                height=self.height,
            )
        return abci.ResponseQuery(code=1, log=f"unknown path {req.path}")

    # --- mempool ------------------------------------------------------

    @staticmethod
    def _valid_tx(tx: bytes) -> bool:
        if tx.startswith(VALIDATOR_TX_PREFIX):
            try:
                pk, power = tx[len(VALIDATOR_TX_PREFIX) :].split(b"!", 1)
                bytes.fromhex(pk.decode())
                int(power)
                return True
            except Exception:
                return False
        return b"=" in tx

    def check_tx(self, req):
        if not self._valid_tx(req.tx):
            return abci.ResponseCheckTx(code=1, log="invalid tx format")
        return abci.ResponseCheckTx(gas_wanted=1)

    # --- consensus ----------------------------------------------------

    def init_chain(self, req):
        self.height = req.initial_height - 1
        if req.app_state_bytes:
            st = json.loads(req.app_state_bytes)
            self.state = {bytes.fromhex(k): bytes.fromhex(v) for k, v in st.items()}
        self.app_hash = self._hash_state(self.height, self.state)
        return abci.ResponseInitChain(app_hash=self.app_hash)

    def process_proposal(self, req):
        for tx in req.txs:
            if not self._valid_tx(tx):
                return abci.ResponseProcessProposal(status=abci.PROCESS_PROPOSAL_REJECT)
        return abci.ResponseProcessProposal()

    # --- vote extensions (reference test/e2e/app shape) ---------------

    def extend_vote(self, req):
        """Deterministic extension content bound to (height, hash)."""
        return abci.ResponseExtendVote(vote_extension=b"ext|%d|" % req.height + req.hash[:8])

    def verify_vote_extension(self, req):
        ok = req.vote_extension.startswith(b"ext|%d|" % req.height)
        self.extensions_verified += 1 if ok else 0
        return abci.ResponseVerifyVoteExtension(
            status=abci.VERIFY_VOTE_EXT_ACCEPT if ok else abci.VERIFY_VOTE_EXT_REJECT
        )

    def _exec_tx(self, tx: bytes) -> abci.ExecTxResult:
        if not self._valid_tx(tx):
            return abci.ExecTxResult(code=1, log="invalid tx")
        if tx.startswith(VALIDATOR_TX_PREFIX):
            pk, power = tx[len(VALIDATOR_TX_PREFIX) :].split(b"!", 1)
            self.val_updates.append(
                abci.ValidatorUpdate(
                    pub_key_type="ed25519",
                    pub_key_bytes=bytes.fromhex(pk.decode()),
                    power=int(power),
                )
            )
            return abci.ExecTxResult(
                events=[abci.Event("val_update", [("power", power.decode(), True)])]
            )
        k, v = tx.split(b"=", 1)
        self.staged[k] = v
        return abci.ExecTxResult(
            events=[
                abci.Event(
                    "app",
                    [("creator", "kvstore", True), ("key", k.decode(errors="replace"), True)],
                )
            ]
        )

    def finalize_block(self, req):
        self.staged = {}
        self.val_updates = []
        for mb in req.misbehavior:
            self.misbehavior_seen.append(
                (req.height, mb.type_, bytes(mb.validator_address), mb.validator_power, mb.height)
            )
        results = [self._exec_tx(tx) for tx in req.txs]
        pending = dict(self.state)
        pending.update(self.staged)
        app_hash = self._hash_state(req.height, pending)
        self._pending = (req.height, pending, app_hash)
        return abci.ResponseFinalizeBlock(
            tx_results=results,
            validator_updates=list(self.val_updates),
            app_hash=app_hash,
        )

    def commit(self):
        height, pending, app_hash = self._pending
        self.height = height
        self.state = pending
        self.app_hash = app_hash
        self.staged = {}
        nxt = self._chunk_cache_next
        if nxt is not None and nxt[0] is pending:
            self._chunk_cache = nxt
            self._chunk_cache_next = None
        return abci.ResponseCommit()
