"""Light block: a signed header with its validator set (reference
types/light.go). A copy of the JAX package's ``light/types.py``."""

from __future__ import annotations

from dataclasses import dataclass

from ..types.block import Commit, Header
from ..types.validator_set import ValidatorSet


@dataclass
class LightBlock:
    header: Header
    commit: Commit
    validator_set: ValidatorSet

    @property
    def height(self) -> int:
        return self.header.height

    def hash(self) -> bytes:
        return self.header.hash()

    def validate_basic(self, chain_id: str) -> None:
        if self.header.chain_id != chain_id:
            raise ValueError("light block from wrong chain")
        if self.commit.height != self.header.height:
            raise ValueError("commit height != header height")
        if self.commit.block_id.hash != self.header.hash():
            raise ValueError("commit is not for this header")
        if self.validator_set.hash() != self.header.validators_hash:
            raise ValueError("validator set does not match header")
