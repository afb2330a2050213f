"""State and consensus params (reference state/state.go, types/params.go).

A copy of the JAX package's ``state/state_types.py``: the ``State``
that validates and executes the next block, and ``ConsensusParams``
with its encoding, hash and genesis-JSON form.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

from ..crypto import merkle
from ..types.block import BlockID
from ..types.validator_set import ValidatorSet
from ..utils import proto

BLOCK_VERSION = 11


@dataclass
class BlockParams:
    max_bytes: int = 4 * 1024 * 1024  # 4MB east of reference's 21MB cap
    max_gas: int = -1


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100_000
    max_age_duration_ns: int = 48 * 3600 * 10**9
    max_bytes: int = 1024 * 1024


@dataclass
class ValidatorParams:
    pub_key_types: List[str] = field(default_factory=lambda: ["ed25519"])


@dataclass
class ABCIParams:
    vote_extensions_enable_height: int = 0


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    abci: ABCIParams = field(default_factory=ABCIParams)

    def hash(self) -> bytes:
        return merkle.hash_from_byte_slices([self.encode()])

    def to_dict(self) -> dict:
        """Genesis-JSON form (reference types/params.go in genesis)."""
        return {
            "block": {
                "max_bytes": self.block.max_bytes,
                "max_gas": self.block.max_gas,
            },
            "evidence": {
                "max_age_num_blocks": self.evidence.max_age_num_blocks,
                "max_age_duration_ns": self.evidence.max_age_duration_ns,
                "max_bytes": self.evidence.max_bytes,
            },
            "validator": {
                "pub_key_types": list(self.validator.pub_key_types)
            },
            "abci": {
                "vote_extensions_enable_height": (
                    self.abci.vote_extensions_enable_height
                )
            },
        }

    @classmethod
    def from_dict(cls, d: dict) -> "ConsensusParams":
        p = cls()
        b = d.get("block", {})
        p.block.max_bytes = int(b.get("max_bytes", p.block.max_bytes))
        p.block.max_gas = int(b.get("max_gas", p.block.max_gas))
        e = d.get("evidence", {})
        p.evidence.max_age_num_blocks = int(
            e.get("max_age_num_blocks", p.evidence.max_age_num_blocks)
        )
        p.evidence.max_age_duration_ns = int(
            e.get("max_age_duration_ns", p.evidence.max_age_duration_ns)
        )
        p.evidence.max_bytes = int(
            e.get("max_bytes", p.evidence.max_bytes)
        )
        v = d.get("validator", {})
        p.validator.pub_key_types = list(
            v.get("pub_key_types", p.validator.pub_key_types)
        )
        a = d.get("abci", {})
        p.abci.vote_extensions_enable_height = int(
            a.get(
                "vote_extensions_enable_height",
                p.abci.vote_extensions_enable_height,
            )
        )
        return p

    def vote_extensions_enabled(self, height: int) -> bool:
        h = self.abci.vote_extensions_enable_height
        return h > 0 and height >= h

    def encode(self) -> bytes:
        b = proto.field_varint(1, self.block.max_bytes) + proto.field_sfixed64(
            2, self.block.max_gas
        )
        e = (
            proto.field_varint(1, self.evidence.max_age_num_blocks)
            + proto.field_varint(2, self.evidence.max_age_duration_ns)
            + proto.field_varint(3, self.evidence.max_bytes)
        )
        v = b"".join(
            proto.field_string(1, t) for t in self.validator.pub_key_types
        )
        a = proto.field_varint(1, self.abci.vote_extensions_enable_height)
        return (
            proto.field_message(1, b)
            + proto.field_message(2, e)
            + proto.field_message(3, v)
            + proto.field_message(4, a)
        )

    @classmethod
    def decode(cls, raw: bytes) -> "ConsensusParams":
        m = proto.parse(raw)
        bm = proto.parse(proto.get1(m, 1, b""))
        em = proto.parse(proto.get1(m, 2, b""))
        vm = proto.parse(proto.get1(m, 3, b""))
        am = proto.parse(proto.get1(m, 4, b""))
        return cls(
            block=BlockParams(
                max_bytes=proto.get1(bm, 1, 4 * 1024 * 1024),
                max_gas=proto.get1(bm, 2, -1),
            ),
            evidence=EvidenceParams(
                max_age_num_blocks=proto.get1(em, 1, 100_000),
                max_age_duration_ns=proto.get1(em, 2, 48 * 3600 * 10**9),
                max_bytes=proto.get1(em, 3, 1024 * 1024),
            ),
            validator=ValidatorParams(
                pub_key_types=[x.decode() for x in vm.get(1, [])] or ["ed25519"]
            ),
            abci=ABCIParams(
                vote_extensions_enable_height=proto.get1(am, 1, 0)
            ),
        )


@dataclass
class State:
    """Everything needed to validate + execute the next block
    (reference state/state.go:38-80)."""

    chain_id: str = ""
    initial_height: int = 1
    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time_ns: int = 0
    validators: Optional[ValidatorSet] = None
    next_validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0
    last_results_hash: bytes = b""
    app_hash: bytes = b""

    def is_empty(self) -> bool:
        return self.validators is None
