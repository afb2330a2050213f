"""Block, Header, Data, Commit (reference types/block.go).

A copy of the JAX package's ``types/block.py``. Hashes follow the
reference: ``Header.hash()`` is the merkle root of the proto-encoded
header fields in order (types/block.go:409-447), ``Commit.hash()`` the
merkle root of the encoded CommitSigs, ``Data.hash()`` the merkle root
of the transactions' SHA-256 hashes.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List, Optional

from ..crypto import merkle
from ..utils import proto

# BlockIDFlag (types/block.go:605)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


def tx_hash(tx: bytes) -> bytes:
    return hashlib.sha256(tx).digest()


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash

    def encode(self) -> bytes:
        return proto.field_varint(1, self.total) + proto.field_bytes(2, self.hash)


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def is_complete(self) -> bool:
        return len(self.hash) == 32 and self.part_set_header.total > 0

    def key(self) -> bytes:
        return (
            self.hash
            + self.part_set_header.total.to_bytes(4, "big")
            + self.part_set_header.hash
        )

    def encode(self) -> bytes:
        return proto.field_bytes(1, self.hash) + proto.field_message(
            2, self.part_set_header.encode()
        )


NIL_BLOCK_ID = BlockID()


@dataclass(frozen=True)
class Header:
    version_block: int = 11
    version_app: int = 0
    chain_id: str = ""
    height: int = 0
    time_ns: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> Optional[bytes]:
        """Merkle root of the encoded fields (types/block.go:409)."""
        if not self.validators_hash:
            return None
        ver = proto.field_varint(1, self.version_block) + proto.field_varint(
            2, self.version_app
        )
        return merkle.hash_from_byte_slices(
            [
                ver,
                self.chain_id.encode(),
                proto.varint(self.height),
                proto.timestamp(self.time_ns),
                self.last_block_id.encode(),
                self.last_commit_hash,
                self.data_hash,
                self.validators_hash,
                self.next_validators_hash,
                self.consensus_hash,
                self.app_hash,
                self.last_results_hash,
                self.evidence_hash,
                self.proposer_address,
            ]
        )


@dataclass(frozen=True)
class CommitSig:
    # the native wire codec reads these four attributes by name
    # (native/wirecodec.cpp, encode_commit and commit_merkle_root)
    block_id_flag: int = BLOCK_ID_FLAG_ABSENT
    validator_address: bytes = b""
    timestamp_ns: int = 0
    signature: bytes = b""

    @classmethod
    def absent(cls) -> "CommitSig":
        return cls()

    def for_block(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_COMMIT

    def is_absent(self) -> bool:
        return self.block_id_flag == BLOCK_ID_FLAG_ABSENT

    def block_id(self, commit_block_id: BlockID) -> BlockID:
        """The BlockID this sig endorsed (the commit's, or nil)."""
        if self.block_id_flag == BLOCK_ID_FLAG_COMMIT:
            return commit_block_id
        return NIL_BLOCK_ID

    def encode(self) -> bytes:
        return (
            proto.field_varint(1, self.block_id_flag)
            + proto.field_bytes(2, self.validator_address)
            + proto.field_message(3, proto.timestamp(self.timestamp_ns))
            + proto.field_bytes(4, self.signature)
        )

    def validate_basic(self) -> None:
        if self.block_id_flag not in (
            BLOCK_ID_FLAG_ABSENT,
            BLOCK_ID_FLAG_COMMIT,
            BLOCK_ID_FLAG_NIL,
        ):
            raise ValueError(f"unknown BlockIDFlag {self.block_id_flag}")
        if self.is_absent():
            if self.validator_address or self.signature:
                raise ValueError("absent CommitSig with data")
        else:
            if len(self.validator_address) != 20:
                raise ValueError("invalid validator address size")
            if not self.signature or len(self.signature) > 96:
                raise ValueError("invalid signature size")


@dataclass(frozen=True)
class ExtendedCommitSig(CommitSig):
    """CommitSig carrying the vote extension and its signature
    (reference types/block.go ExtendedCommitSig, ABCI 2.0)."""

    extension: bytes = b""
    extension_signature: bytes = b""

    def strip(self) -> CommitSig:
        return CommitSig(
            block_id_flag=self.block_id_flag,
            validator_address=self.validator_address,
            timestamp_ns=self.timestamp_ns,
            signature=self.signature,
        )


@dataclass
class ExtendedCommit:
    """Commit whose signatures carry vote extensions (reference
    types/block.go ExtendedCommit); the block store keeps its bytes."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    extended_signatures: List[ExtendedCommitSig] = field(default_factory=list)

    def to_commit(self) -> "Commit":
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.block_id,
            signatures=[s.strip() for s in self.extended_signatures],
        )


@dataclass
class Commit:
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: List[CommitSig] = field(default_factory=list)
    _hash: Optional[bytes] = field(default=None, repr=False, compare=False)

    def size(self) -> int:
        return len(self.signatures)

    def hash(self) -> bytes:
        if self._hash is None:
            from ..utils import wirecodec

            nat = wirecodec.module()
            if nat is not None:
                try:  # one call: the sigs' encodings and the RFC 6962 fold
                    self._hash = nat.commit_merkle_root(self.signatures)
                    return self._hash
                except Exception:  # pragma: no cover - odd sig shapes
                    pass
            self._hash = merkle.hash_from_byte_slices([cs.encode() for cs in self.signatures])
        return self._hash

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round in commit")
        if self.height >= 1:
            if self.block_id.is_nil():
                raise ValueError("commit cannot be for nil block")
            if not self.signatures:
                raise ValueError("no signatures in commit")
            for cs in self.signatures:
                cs.validate_basic()


@dataclass
class Data:
    txs: List[bytes] = field(default_factory=list)
    _hash: Optional[bytes] = field(default=None, repr=False, compare=False)

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([tx_hash(tx) for tx in self.txs])
        return self._hash


@dataclass
class Block:
    """A block; ``evidence`` holds its duplicate-vote and light-client
    attack evidence (``evidence/types.py``)."""

    header: Header
    data: Data = field(default_factory=Data)
    evidence: list = field(default_factory=list)
    last_commit: Optional[Commit] = None

    def hash(self) -> Optional[bytes]:
        return self.header.hash()

    @property
    def height(self) -> int:
        return self.header.height

    @property
    def chain_id(self) -> str:
        return self.header.chain_id

    def encode(self) -> bytes:
        from ..utils import codec

        return codec.encode_block(self)

    def validate_basic(self) -> None:
        if self.header.height < 1:
            raise ValueError("block height must be >= 1")
        if self.header.height > 1:
            if self.last_commit is None:
                raise ValueError("nil LastCommit at height > 1")
            self.last_commit.validate_basic()
        if self.last_commit is not None and self.header.last_commit_hash != self.last_commit.hash():
            raise ValueError("wrong LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise ValueError("wrong DataHash")
