"""Vote (reference types/vote.go): what a validator signs.

The part of the JAX package's ``types/vote.py`` that the chain
generator, the evidence types and the light client's detector use: a
vote's fields with its extension, its canonical sign bytes, the basic
checks, and single-signature verification through the port's host
keys (``crypto/keys.py``). Proposals wait for the consensus slice.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..crypto.keys import PubKey
from . import canonical
from .block import BlockID

PREVOTE = canonical.PREVOTE_TYPE
PRECOMMIT = canonical.PRECOMMIT_TYPE


def is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE, PRECOMMIT)


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
    extension: bytes = b""
    extension_signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_sign_bytes(
            chain_id, self.type_, self.height, self.round, self.block_id, self.timestamp_ns
        )

    def verify(self, chain_id: str, pub_key: PubKey) -> bool:
        """Single-signature verify on the host (reference :228-237)."""
        if pub_key.address() != self.validator_address:
            return False
        return pub_key.verify(self.sign_bytes(chain_id), self.signature)

    def is_nil(self) -> bool:
        return self.block_id.is_nil()

    def validate_basic(self) -> None:
        if not is_vote_type_valid(self.type_):
            raise ValueError("invalid vote type")
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if len(self.validator_address) != 20:
            raise ValueError("invalid validator address")
        if self.validator_index < 0:
            raise ValueError("negative validator index")
        if not self.signature or len(self.signature) > 96:
            raise ValueError("invalid signature size")

    def key(self):
        return (self.type_, self.height, self.round, self.block_id.key())
