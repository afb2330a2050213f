"""PartSet: a block cut into merkle-proven parts (reference types/part_set.go).

A copy of the JAX package's ``types/part_set.py``. A block travels
and is stored as 64 KB parts, each with an inclusion proof against the
``PartSetHeader`` hash the validators sign, so a part can be checked
before the block is whole.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from ..crypto import merkle
from .block import PartSetHeader

BLOCK_PART_SIZE = 65536


@dataclass
class Part:
    index: int
    bytes_: bytes
    proof: merkle.Proof

    def validate_basic(self) -> None:
        if self.index < 0:
            raise ValueError("negative part index")
        if len(self.bytes_) > BLOCK_PART_SIZE:
            raise ValueError("part too big")
        if self.proof.index != self.index:
            raise ValueError("part proof index mismatch")


class PartSet:
    """Built whole from data, or assembled part by part from a header."""

    def __init__(self, header: PartSetHeader):
        self.header = header
        self.parts: List[Optional[Part]] = [None] * header.total
        self.count = 0
        self.byte_size = 0

    @classmethod
    def from_data(cls, data: bytes, part_size: int = BLOCK_PART_SIZE) -> "PartSet":
        chunks = [data[i : i + part_size] for i in range(0, len(data), part_size)] or [b""]
        root, proofs = merkle.proofs_from_byte_slices(chunks)
        ps = cls(PartSetHeader(total=len(chunks), hash=root))
        for i, (c, pr) in enumerate(zip(chunks, proofs)):
            ps.parts[i] = Part(index=i, bytes_=c, proof=pr)
        ps.count = len(chunks)
        ps.byte_size = len(data)
        return ps

    def add_part(self, part: Part) -> bool:
        """Check the part's proof against the header and insert it.
        False for a duplicate; raises on an invalid proof."""
        part.validate_basic()
        if part.index >= self.header.total:
            raise ValueError("part index out of range")
        if self.parts[part.index] is not None:
            return False
        if not part.proof.verify(self.header.hash, part.bytes_):
            raise ValueError("invalid part proof")
        self.parts[part.index] = part
        self.count += 1
        self.byte_size += len(part.bytes_)
        return True

    def is_complete(self) -> bool:
        return self.count == self.header.total

    def get_part(self, i: int) -> Optional[Part]:
        return self.parts[i] if 0 <= i < len(self.parts) else None

    def assemble(self) -> bytes:
        if not self.is_complete():
            raise ValueError("part set is incomplete")
        return b"".join(p.bytes_ for p in self.parts)
