"""Vote (reference types/vote.go): what a validator signs.

The part of the JAX package's ``types/vote.py`` that the chain
generator uses: a precommit's fields and its canonical sign bytes.
Single-vote verification, extensions and proposals wait for the
consensus slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import canonical
from .block import BlockID

PREVOTE = canonical.PREVOTE_TYPE
PRECOMMIT = canonical.PRECOMMIT_TYPE


@dataclass
class Vote:
    type_: int
    height: int
    round: int
    block_id: BlockID
    timestamp_ns: int
    validator_address: bytes
    validator_index: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_sign_bytes(
            chain_id, self.type_, self.height, self.round, self.block_id, self.timestamp_ns
        )
