"""Vote and Proposal (reference types/vote.go, types/proposal.go).

A copy of the JAX package's ``types/vote.py``: a vote's fields with its
extension, its canonical sign bytes and the extension's, the basic
checks, and single-signature verification through the port's host
keys (``crypto/keys.py``); a proposal with its sign bytes, checks and
verification. ``Vote.verify`` is the consensus round's per-vote check;
whole vote waves go to the card through ``crypto/coalesce.py``.
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

    def extension_sign_bytes(self, chain_id: str) -> bytes:
        return canonical.vote_extension_sign_bytes(
            chain_id, self.height, self.round, self.extension
        )

    def verify(self, chain_id: str, pub_key: PubKey) -> bool:
        """Single-signature verify on the host (reference :228-237)."""
        if pub_key.address() != self.validator_address:
            return False
        return pub_key.verify(self.sign_bytes(chain_id), self.signature)

    def verify_with_extension(self, chain_id: str, pub_key: PubKey) -> bool:
        if not self.verify(chain_id, pub_key):
            return False
        if self.type_ == PRECOMMIT and not self.block_id.is_nil():
            if self.extension or self.extension_signature:
                return pub_key.verify(self.extension_sign_bytes(chain_id), self.extension_signature)
        return True

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


@dataclass
class Proposal:
    height: int
    round: int
    pol_round: int
    block_id: BlockID
    timestamp_ns: int
    signature: bytes = b""

    def sign_bytes(self, chain_id: str) -> bytes:
        return canonical.proposal_sign_bytes(
            chain_id,
            self.height,
            self.round,
            self.pol_round,
            self.block_id,
            self.timestamp_ns,
        )

    def verify(self, chain_id: str, pub_key: PubKey) -> bool:
        return pub_key.verify(self.sign_bytes(chain_id), self.signature)

    def validate_basic(self) -> None:
        if self.height < 0 or self.round < 0:
            raise ValueError("negative height/round")
        if self.pol_round < -1 or self.pol_round >= self.round:
            raise ValueError("invalid POLRound")
        if not self.block_id.is_complete():
            raise ValueError("proposal BlockID must be complete")
        if not self.signature or len(self.signature) > 96:
            raise ValueError("invalid signature size")
