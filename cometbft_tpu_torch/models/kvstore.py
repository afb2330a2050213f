"""kvstore: the example application (reference abci/example/kvstore).

The part of the JAX package's ``models/kvstore.py`` that block replay
drives: transactions are ``key=value`` bytes, or ``val:<hex pubkey>!<power>``
validator updates; the app hash is SHA-256 over the height and every
committed pair in key order, kept incremental by a sorted chunk cache
so a block costs its own writes, not the whole state. Queries read
the committed state; ProcessProposal refuses a block with a malformed
tx; vote extensions are bound to (height, block hash), as in the
reference's e2e app; every Misbehavior that FinalizeBlock delivers is
kept in ``misbehavior_seen``, the app-side slashing record. With
``prove=True`` the app hash is SHA-256(height || merkle root over the
sorted KV leaves) and ``Query(prove=True)`` returns the proof-op chain
a light client checks against a verified AppHash (``crypto/merkle``'s
``ProofRuntime``); off by default, so every chain keeps the flat hash.

Snapshots, as in the JAX package: every 10th committed height the whole
state is one JSON blob (``{"height", "state": {hex key: hex value}}``,
keys sorted), cut into ``SNAPSHOT_CHUNK`` = 1,024-byte chunks, kept in
RAM (the newest four) or, with ``snapshot_store``, written through the
on-disk ``statesync.snapshots.SnapshotStore``; OfferSnapshot takes
format 1, ApplySnapshotChunk buffers chunks in order and, at the last,
checks the blob's SHA-256 against the snapshot's hash and restores.
``persist_path`` keeps the committed state in a JSON file across
restarts (the reference's PersistentKVStoreApplication), and
``retain_height`` makes Commit advertise ``height - retain_height``.
One addition the JAX app lacks, off by default: with
``chunk_hashes=True`` a snapshot's ``metadata`` carries the SHA-256 of
each chunk, 32 bytes apiece, and a restore by such an app, when the
offered snapshot carries such metadata, checks every chunk as it
arrives and answers ``APPLY_CHUNK_RETRY`` for one that differs, so the
syncer bans its sender and fetches the chunk elsewhere (a checksumming
app, as a Cosmos SDK app's snapshot metadata does). The metadata is
advisory: the blob's hash at the last chunk decides the restore. An
app without the option (the default, and every JAX app) reads no
metadata, and a corrupt chunk rejects the whole snapshot at the end,
as in the JAX package.
"""

from __future__ import annotations

import bisect
import hashlib
import json
import os
from typing import Dict, List

from ..abci import types as abci
from ..crypto import merkle
from ..utils import proto

VALIDATOR_TX_PREFIX = b"val:"


class KVStoreApplication(abci.Application):
    SNAPSHOT_CHUNK = 1024

    def __init__(
        self,
        persist_path: str = None,
        prove: bool = False,
        retain_height: int = 0,
        snapshot_store=None,
        chunk_hashes: bool = False,
    ):
        self.state: Dict[bytes, bytes] = {}
        self.height = 0
        self.prove = prove
        # Commit advertises height - retain_height (0: the app allows
        # no pruning, the reference's semantics)
        self.retain_height = retain_height
        # None: snapshots in RAM only, gone on restart
        self.snapshot_store = snapshot_store
        self.chunk_hashes = chunk_hashes
        self.persist_path = persist_path
        if persist_path:
            self._load_persisted()
        self._proof_cache = None  # (height, sorted keys, proofs)
        # (committed state, sorted keys, chunks) and finalize's overlay
        self._chunk_cache = None
        self._chunk_cache_next = None
        self.app_hash = self._hash_state(self.height, self.state)
        self.staged: Dict[bytes, bytes] = {}
        self.val_updates: List[abci.ValidatorUpdate] = []
        self._pending = None
        self.snapshots: Dict[int, bytes] = {}
        self._restore_buf: List[bytes] = []
        self._restore_target = None  # (snapshot, app hash, chunk digests or None)
        # (block height, type, validator address, power, evidence height)
        self.misbehavior_seen: List[tuple] = []
        self.extensions_verified = 0  # accepted VerifyVoteExtension calls

    def _load_persisted(self) -> None:
        if not os.path.exists(self.persist_path):
            return
        with open(self.persist_path) as f:
            st = json.load(f)
        self.height = st["height"]
        self.state = {bytes.fromhex(k): bytes.fromhex(v) for k, v in st["state"].items()}

    def _persist(self) -> None:
        if not self.persist_path:
            return
        os.makedirs(os.path.dirname(self.persist_path), exist_ok=True)
        tmp = self.persist_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"height": self.height, "state": {k.hex(): v.hex() for k, v in self.state.items()}},
                f,
            )
        os.replace(tmp, self.persist_path)

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
        keys, chunks = self._chunks_for(state)
        if self.prove:
            root = merkle.hash_from_byte_slices([merkle.kv_leaf(k, state[k]) for k in keys])
            return hashlib.sha256(height.to_bytes(8, "big") + root).digest()
        h = hashlib.sha256()
        h.update(height.to_bytes(8, "big"))
        for ch in chunks:
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
            proof_ops = b""
            if req.prove and self.prove:
                proof_ops = merkle.encode_proof_ops(self._query_proof(req.data, v))
            return abci.ResponseQuery(
                code=abci.CODE_TYPE_OK if v is not None else 1,
                key=req.data,
                value=v or b"",
                height=self.height,
                proof_ops=proof_ops,
            )
        return abci.ResponseQuery(code=1, log=f"unknown path {req.path}")

    def _query_proof(self, key: bytes, value):
        """Proof-op chain for one committed key (or its absence):
        inclusion or absence against the sorted-KV merkle root, then
        the app-hash binding op. The proofs are built once a committed
        height and cached."""
        cache = self._proof_cache
        if cache is None or cache[0] != self.height:
            keys = sorted(self.state)
            _, proofs = merkle.proofs_from_byte_slices(
                [merkle.kv_leaf(k, self.state[k]) for k in keys]
            )
            cache = self._proof_cache = (self.height, keys, proofs)
        _, keys, proofs = cache

        def neighbor(i: int) -> bytes:
            return proto.field_message(
                1,
                proto.field_bytes(1, merkle.encode_proof(proofs[i]))
                + proto.field_bytes(2, keys[i])
                + proto.field_bytes(3, self.state[keys[i]]),
            )

        if value is not None:
            idx = bisect.bisect_left(keys, key)
            first = merkle.ProofOp(merkle.OP_KV_VALUE, key, merkle.encode_proof(proofs[idx]))
        else:
            pos = bisect.bisect_left(keys, key)
            nbs = b""
            if keys:
                if pos == 0:
                    nbs = neighbor(0)
                elif pos == len(keys):
                    nbs = neighbor(len(keys) - 1)
                else:
                    nbs = neighbor(pos - 1) + neighbor(pos)
            first = merkle.ProofOp(merkle.OP_KV_ABSENCE, key, nbs)
        app_op = merkle.ProofOp(merkle.OP_APP_HASH, b"", proto.field_varint(1, self.height))
        return [first, app_op]

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
        if self.height % 10 == 0:
            self._take_snapshot()
        self._persist()
        return abci.ResponseCommit(
            retain_height=max(0, self.height - self.retain_height) if self.retain_height > 0 else 0
        )

    # --- snapshots ----------------------------------------------------

    def _chunk_digests(self, blob: bytes) -> bytes:
        c = self.SNAPSHOT_CHUNK
        return b"".join(hashlib.sha256(blob[i : i + c]).digest() for i in range(0, len(blob), c))

    def _take_snapshot(self) -> None:
        blob = json.dumps(
            {"height": self.height, "state": {k.hex(): v.hex() for k, v in sorted(self.state.items())}}
        ).encode()
        if self.snapshot_store is not None:
            # chunk size matches the wire chunking, so served chunks are
            # those of the RAM snapshots byte for byte
            self.snapshot_store.save(
                self.height, blob, format_=1,
                metadata=self._chunk_digests(blob) if self.chunk_hashes else b"",
                chunk_size=self.SNAPSHOT_CHUNK,
            )
            return
        self.snapshots[self.height] = blob
        while len(self.snapshots) > 4:
            del self.snapshots[min(self.snapshots)]

    def list_snapshots(self):
        if self.snapshot_store is not None:
            return self.snapshot_store.list_snapshots()
        return [
            abci.Snapshot(
                height=h,
                format=1,
                chunks=(len(blob) + self.SNAPSHOT_CHUNK - 1) // self.SNAPSHOT_CHUNK,
                hash=hashlib.sha256(blob).digest(),
                metadata=self._chunk_digests(blob) if self.chunk_hashes else b"",
            )
            for h, blob in sorted(self.snapshots.items())
        ]

    def load_snapshot_chunk(self, height, format_, chunk):
        if self.snapshot_store is not None:
            return self.snapshot_store.load_chunk(height, format_, chunk)
        blob = self.snapshots.get(height, b"")
        off = chunk * self.SNAPSHOT_CHUNK
        return blob[off : off + self.SNAPSHOT_CHUNK]

    def offer_snapshot(self, snapshot, app_hash):
        if snapshot.format != 1:
            return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_REJECT_FORMAT)
        self._restore_buf = []
        # the chunk digests are checked only by an app that opted in:
        # the metadata comes from whichever peers advertised the snapshot
        md = bytes(snapshot.metadata or b"")
        digests = (
            [md[i : i + 32] for i in range(0, len(md), 32)]
            if self.chunk_hashes and snapshot.chunks and len(md) == 32 * snapshot.chunks
            else None
        )
        self._restore_target = (snapshot, app_hash, digests)
        return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_ACCEPT)

    def apply_snapshot_chunk(self, index, chunk, sender):
        snapshot, app_hash, digests = self._restore_target
        if digests is not None and hashlib.sha256(chunk).digest() != digests[index]:
            # this chunk is not the one the snapshot lists: its sender
            # is banned and the chunk fetched again elsewhere
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_RETRY)
        self._restore_buf.append(chunk)
        if len(self._restore_buf) == snapshot.chunks:
            blob = b"".join(self._restore_buf)
            if hashlib.sha256(blob).digest() != snapshot.hash:
                return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_REJECT_SNAPSHOT)
            st = json.loads(blob)
            self.height = st["height"]
            self.state = {bytes.fromhex(k): bytes.fromhex(v) for k, v in st["state"].items()}
            self.app_hash = self._hash_state(self.height, self.state)
        return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ACCEPT)
