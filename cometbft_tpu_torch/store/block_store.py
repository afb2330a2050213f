"""Block store: blocks, parts, metas, commits by height (reference store/store.go).

A copy of the JAX package's ``store/block_store.py`` without pruning,
with a plain lock.

Key layout (all big-endian heights for ordered iteration):
  H:<height>     -> block meta (block id + header, proto)
  P:<height>:<i> -> block part bytes
  C:<height>     -> last commit for height (i.e. commit FOR height, stored
                    under the height it certifies, reference SaveBlock)
  SC:<height>    -> "seen commit" (the commit this node saw for its own
                    last block)
  EC:<height>    -> extended commit (vote extensions)
  BH:<hash>      -> height (lookup by block hash)
  base/height    -> store bounds
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import List, Optional

from ..crypto.merkle import Proof
from ..types.block import Block, BlockID, Commit, Header
from ..types.part_set import Part, PartSet
from ..utils import codec, kv, proto


def _hkey(prefix: bytes, h: int) -> bytes:
    return prefix + h.to_bytes(8, "big")


def _commit_bytes(commit: Commit) -> bytes:
    """Wire form, reusing the decode-time memo when present (see
    codec.decode_commit: decoded objects are immutable by convention)."""
    return getattr(commit, "_raw_bytes", None) or codec.encode_commit(commit)


@dataclass
class BlockMeta:
    block_id: BlockID
    block_size: int
    header: Header
    num_txs: int

    def encode(self) -> bytes:
        return (
            proto.field_message(1, self.block_id.encode())
            + proto.field_varint(2, self.block_size)
            + proto.field_message(3, codec.encode_header(self.header))
            + proto.field_varint(4, self.num_txs)
        )

    @classmethod
    def decode(cls, b: bytes) -> "BlockMeta":
        m = proto.parse(b)
        return cls(
            block_id=codec.decode_block_id(proto.get1(m, 1, b"")),
            block_size=proto.get1(m, 2, 0),
            header=codec.decode_header(proto.get1(m, 3, b"")),
            num_txs=proto.get1(m, 4, 0),
        )


class BlockStore:
    def __init__(self, db: kv.KV):
        self.db = db
        self._lock = threading.RLock()
        self._base = int.from_bytes(db.get(b"base") or b"\0" * 8, "big")
        self._height = int.from_bytes(db.get(b"height") or b"\0" * 8, "big")

    def base(self) -> int:
        return self._base

    def height(self) -> int:
        return self._height

    def size(self) -> int:
        return 0 if self._height == 0 else self._height - self._base + 1

    # --- save ---------------------------------------------------------

    @staticmethod
    def _block_sets(
        block: Block, part_set: PartSet, seen_commit: Commit
    ) -> List:
        """The per-block KV writes shared by save_block and
        save_block_batch (everything except base/height bookkeeping)."""
        h = block.height
        bid = BlockID(block.hash(), part_set.header)
        meta = BlockMeta(
            block_id=bid,
            block_size=part_set.byte_size,
            header=block.header,
            num_txs=len(block.data.txs),
        )
        sets = [
            (_hkey(b"H:", h), meta.encode()),
            (b"BH:" + block.hash(), h.to_bytes(8, "big")),
            # SC always re-encodes canonically: in the blocksync loop
            # the seen commit is sliced from block h+1's wire bytes,
            # whose canonical-encoding (psh) check only runs one
            # iteration LATER — trusting its decode-time memo here
            # would persist a byzantine peer's non-canonical encoding.
            # C: (below) may reuse the memo: it comes from THIS block,
            # which every save path has already canonicality-checked.
            (_hkey(b"SC:", h), codec.encode_commit(seen_commit)),
        ]
        for i in range(part_set.header.total):
            part = part_set.get_part(i)
            sets.append(
                (
                    _hkey(b"P:", h) + i.to_bytes(4, "big"),
                    _encode_part(part),
                )
            )
        if block.last_commit is not None:
            sets.append(
                (_hkey(b"C:", h - 1), _commit_bytes(block.last_commit))
            )
        return sets

    def save_block(
        self, block: Block, part_set: PartSet, seen_commit: Commit
    ) -> None:
        self.save_block_batch([(block, part_set, seen_commit)])

    def save_block_batch(self, entries) -> None:
        """Persist a contiguous ascending run of blocks in ONE atomic
        db.write_batch (entries: [(block, part_set, seen_commit)]).

        The blocksync window pipeline stages a whole verified window
        and flushes it here — one sqlite transaction / one memdb lock
        round per window instead of per block (docs/PERF.md host
        plane). The batch is all-or-nothing, so the store can never be
        observed mid-window; crash-wise a flushed window leaves the
        store AHEAD of the state, which is the handshake-supported
        direction (consensus/replay.py replays store blocks the app
        has not seen)."""
        if not entries:
            return
        with self._lock:
            expect = self._height
            sets: List = []
            for block, part_set, seen_commit in entries:
                h = block.height
                if expect > 0 and h != expect + 1:
                    raise ValueError(
                        f"non-contiguous block save: have {expect}, "
                        f"got {h}"
                    )
                sets.extend(
                    self._block_sets(block, part_set, seen_commit)
                )
                expect = h
            if self._base == 0:
                self._base = entries[0][0].height
                sets.append(
                    (b"base", self._base.to_bytes(8, "big"))
                )
            sets.append((b"height", expect.to_bytes(8, "big")))
            self.db.write_batch(sets)
            self._height = expect

    def save_extended_commit(self, height: int, ec_bytes: bytes) -> None:
        self.db.set(_hkey(b"EC:", height), ec_bytes)

    def delete_latest_block(self) -> None:
        """Remove the tip block (reference store.go DeleteLatestBlock,
        used by rollback --hard)."""
        h = self._height
        if h == 0:
            return
        meta = self.load_block_meta(h)
        deletes = [
            _hkey(b"H:", h),
            _hkey(b"C:", h - 1),
            _hkey(b"SC:", h),
            _hkey(b"EC:", h),
        ]
        if meta is not None:
            deletes.append(b"BH:" + meta.block_id.hash)
            for i in range(meta.block_id.part_set_header.total):
                deletes.append(_hkey(b"P:", h) + i.to_bytes(4, "big"))
        with self._lock:
            self._height = h - 1
            self.db.write_batch(
                [(b"height", (h - 1).to_bytes(8, "big"))], deletes
            )

    # --- load ---------------------------------------------------------

    def load_block_meta(self, height: int) -> Optional[BlockMeta]:
        b = self.db.get(_hkey(b"H:", height))
        return BlockMeta.decode(b) if b else None

    def load_block(self, height: int) -> Optional[Block]:
        meta = self.load_block_meta(height)
        if meta is None:
            return None
        parts = []
        for i in range(meta.block_id.part_set_header.total):
            pb = self.db.get(_hkey(b"P:", height) + i.to_bytes(4, "big"))
            if pb is None:
                return None
            parts.append(_decode_part(pb))
        data = b"".join(p.bytes_ for p in parts)
        return codec.decode_block(data)

    def load_block_commit(self, height: int) -> Optional[Commit]:
        b = self.db.get(_hkey(b"C:", height))
        return codec.decode_commit(b) if b else None

    def load_seen_commit(self, height: int) -> Optional[Commit]:
        b = self.db.get(_hkey(b"SC:", height))
        return codec.decode_commit(b) if b else None

    def load_extended_commit(self, height: int) -> Optional[bytes]:
        return self.db.get(_hkey(b"EC:", height))


def _encode_part(part: Part) -> bytes:
    pf = (
        proto.field_varint(1, part.proof.total)
        + proto.field_varint(2, part.proof.index)
        + proto.field_bytes(3, part.proof.leaf_hash)
        + b"".join(proto.field_bytes(4, a) for a in part.proof.aunts)
    )
    return (
        proto.field_varint(1, part.index)
        + proto.field_bytes(2, part.bytes_)
        + proto.field_message(3, pf)
    )


def _decode_part(b: bytes) -> Part:
    m = proto.parse(b)
    pm = proto.parse(proto.get1(m, 3, b""))
    return Part(
        index=proto.get1(m, 1, 0),
        bytes_=proto.get1(m, 2, b""),
        proof=Proof(
            total=proto.get1(pm, 1, 0),
            index=proto.get1(pm, 2, 0),
            leaf_hash=proto.get1(pm, 3, b""),
            aunts=pm.get(4, []),
        ),
    )
