"""Evidence types (reference types/evidence.go).

A copy of the JAX package's ``evidence/types.py``, with the same
encodings and hashes byte for byte:

- ``DuplicateVoteEvidence``: two conflicting votes by one validator;
- ``LightClientAttackEvidence``: a conflicting light block, the common
  height and the byzantine validators, derived by ``byzantine_from``.

The evidence pool and blocks that carry evidence wait for a later
slice.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import List

from ..types.block import BLOCK_ID_FLAG_COMMIT
from ..types.vote import Vote
from ..utils import codec, proto


@dataclass
class DuplicateVoteEvidence:
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp_ns: int = 0

    TYPE = 1

    @classmethod
    def from_votes(cls, a, b, val_power, total_power, time_ns):
        # canonical order: lexicographic by block id key (types/evidence.go)
        if a.block_id.key() > b.block_id.key():
            a, b = b, a
        return cls(a, b, total_power, val_power, time_ns)

    def height(self) -> int:
        return self.vote_a.height

    def addresses(self) -> List[bytes]:
        return [self.vote_a.validator_address]

    def encode(self) -> bytes:
        return (
            proto.field_varint(1, self.TYPE)
            + proto.field_message(2, codec.encode_vote(self.vote_a))
            + proto.field_message(3, codec.encode_vote(self.vote_b))
            + proto.field_varint(4, self.total_voting_power)
            + proto.field_varint(5, self.validator_power)
            + proto.field_message(6, proto.timestamp(self.timestamp_ns))
        )

    def hash(self) -> bytes:
        return hashlib.sha256(self.encode()).digest()

    def validate_basic(self) -> None:
        a, b = self.vote_a, self.vote_b
        if a is None or b is None:
            raise ValueError("missing vote")
        if a.block_id.key() >= b.block_id.key():
            raise ValueError("votes not in canonical order / identical")
        if (a.height, a.round, a.type_, a.validator_address) != (
            b.height,
            b.round,
            b.type_,
            b.validator_address,
        ):
            raise ValueError("votes do not conflict (different HRS/validator)")


@dataclass
class LightClientAttackEvidence:
    conflicting_block: object  # light.types.LightBlock
    common_height: int
    byzantine_validators: list = field(default_factory=list)
    total_voting_power: int = 0
    timestamp_ns: int = 0

    TYPE = 2

    def height(self) -> int:
        return self.common_height

    def encode(self) -> bytes:
        lb = self.conflicting_block
        signed_header = proto.field_message(1, codec.encode_header(lb.header)) + proto.field_message(
            2, codec.encode_commit(lb.commit)
        )
        return (
            proto.field_varint(1, self.TYPE)
            + proto.field_message(2, signed_header)
            + proto.field_message(3, codec.encode_validator_set(lb.validator_set))
            + proto.field_varint(4, self.common_height)
            + proto.field_varint(5, self.total_voting_power)
            + proto.field_message(6, proto.timestamp(self.timestamp_ns))
            + b"".join(
                proto.field_message(7, codec.encode_validator(v)) for v in self.byzantine_validators
            )
        )

    def hash(self) -> bytes:
        return hashlib.sha256(self.encode()).digest()

    def validate_basic(self) -> None:
        if self.common_height < 1:
            raise ValueError("invalid common height")
        if self.conflicting_block is None:
            raise ValueError("missing conflicting block")

    def byzantine_from(self, common_vals) -> list:
        """The attack's byzantine set, derived (not trusted from the
        wire): signers of the conflicting commit that sit in the common
        validator set, by descending power (reference types/evidence.go
        GetByzantineValidators, the lunatic-attack arm)."""
        out = []
        for cs in self.conflicting_block.commit.signatures:
            if cs.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                continue
            _, val = common_vals.get_by_address(cs.validator_address)
            if val is not None:
                out.append(val)
        out.sort(key=lambda v: (-v.voting_power, v.address))
        return out


def decode_evidence(b: bytes):
    from ..light.types import LightBlock

    m = proto.parse(b)
    t = proto.get1(m, 1, 0)
    if t == DuplicateVoteEvidence.TYPE:
        return DuplicateVoteEvidence(
            vote_a=codec.decode_vote(proto.get1(m, 2, b"")),
            vote_b=codec.decode_vote(proto.get1(m, 3, b"")),
            total_voting_power=proto.get1(m, 4, 0),
            validator_power=proto.get1(m, 5, 0),
            timestamp_ns=proto.parse_timestamp(proto.get1(m, 6, b"")),
        )
    if t == LightClientAttackEvidence.TYPE:
        shm = proto.parse(proto.get1(m, 2, b""))
        lb = LightBlock(
            header=codec.decode_header(proto.get1(shm, 1, b"")),
            commit=codec.decode_commit(proto.get1(shm, 2, b"")),
            validator_set=codec.decode_validator_set(proto.get1(m, 3, b"")),
        )
        return LightClientAttackEvidence(
            conflicting_block=lb,
            common_height=proto.get1(m, 4, 0),
            total_voting_power=proto.get1(m, 5, 0),
            timestamp_ns=proto.parse_timestamp(proto.get1(m, 6, b"")),
            byzantine_validators=[codec.decode_validator(x) for x in m.get(7, [])],
        )
    raise ValueError(f"unknown evidence type {t}")
