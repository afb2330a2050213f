"""BlockID, PartSetHeader, CommitSig, Commit, ExtendedCommit
(reference types/block.go).

The parts of the JAX package's ``types/block.py`` that commit
verification needs: block identity, the per-validator commit
signature with its flag, the commit, and the extended commit whose
signatures carry vote extensions (``verify_extended_commit``). Hashing
of headers, data and commits is not ported yet.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

# BlockIDFlag (types/block.go:605)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3


@dataclass(frozen=True)
class PartSetHeader:
    total: int = 0
    hash: bytes = b""

    def is_zero(self) -> bool:
        return self.total == 0 and not self.hash


@dataclass(frozen=True)
class BlockID:
    hash: bytes = b""
    part_set_header: PartSetHeader = field(default_factory=PartSetHeader)

    def is_nil(self) -> bool:
        return not self.hash and self.part_set_header.is_zero()

    def key(self) -> bytes:
        return (
            self.hash
            + self.part_set_header.total.to_bytes(4, "big")
            + self.part_set_header.hash
        )


NIL_BLOCK_ID = BlockID()


@dataclass(frozen=True)
class CommitSig:
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


@dataclass
class Commit:
    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    signatures: List[CommitSig] = field(default_factory=list)

    def size(self) -> int:
        return len(self.signatures)


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
    types/block.go ExtendedCommit)."""

    height: int = 0
    round: int = 0
    block_id: BlockID = field(default_factory=BlockID)
    extended_signatures: List[ExtendedCommitSig] = field(default_factory=list)

    def to_commit(self) -> Commit:
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.block_id,
            signatures=[s.strip() for s in self.extended_signatures],
        )
