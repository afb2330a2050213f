"""GenesisDoc (reference types/genesis.go): the chain's first state.

A copy of the JAX package's ``types/genesis.py``, with the same JSON
form (``to_json``/``from_json``), so a genesis round-trips between the
two packages.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass, field
from typing import List

from ..crypto.keys import pubkey_from_type_bytes
from ..state.state_types import ConsensusParams, State
from .validator_set import Validator, ValidatorSet


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time_ns: int = 0
    initial_height: int = 1
    consensus_params: ConsensusParams = field(default_factory=ConsensusParams)
    validators: List[Validator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state_bytes: bytes = b""

    def __post_init__(self):
        if not self.genesis_time_ns:
            self.genesis_time_ns = time.time_ns()

    def validate_and_complete(self) -> None:
        if not self.chain_id:
            raise ValueError("genesis doc must include chain_id")
        if self.initial_height < 1:
            raise ValueError("initial_height must be >= 1")

    def validator_set(self) -> ValidatorSet:
        return ValidatorSet(self.validators)

    def make_genesis_state(self) -> State:
        vs = self.validator_set()
        return State(
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=0,
            last_block_time_ns=self.genesis_time_ns,
            validators=vs,
            next_validators=vs.copy(),
            last_validators=None,
            last_height_validators_changed=self.initial_height,
            consensus_params=self.consensus_params,
            last_height_consensus_params_changed=self.initial_height,
            app_hash=self.app_hash,
        )

    def to_json(self) -> str:
        return json.dumps(
            {
                "chain_id": self.chain_id,
                "genesis_time_ns": self.genesis_time_ns,
                "initial_height": self.initial_height,
                "validators": [
                    {
                        "pub_key_type": v.pub_key.type_,
                        "pub_key": v.pub_key.key_bytes.hex(),
                        "power": v.voting_power,
                    }
                    for v in self.validators
                ],
                "app_hash": self.app_hash.hex(),
                "app_state": self.app_state_bytes.decode() if self.app_state_bytes else "",
                "consensus_params": self.consensus_params.to_dict(),
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, raw: str) -> "GenesisDoc":
        d = json.loads(raw)
        vals = [
            Validator(
                pubkey_from_type_bytes(v["pub_key_type"], bytes.fromhex(v["pub_key"])),
                v["power"],
            )
            for v in d.get("validators", [])
        ]
        return cls(
            chain_id=d["chain_id"],
            genesis_time_ns=d.get("genesis_time_ns", 0),
            initial_height=d.get("initial_height", 1),
            validators=vals,
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state_bytes=d.get("app_state", "").encode(),
            consensus_params=ConsensusParams.from_dict(d.get("consensus_params", {})),
        )
