"""Validator / ValidatorSet: what commit verification reads.

The parts of the JAX package's ``types/validator_set.py`` that
verification needs (reference types/validator_set.go): canonical
order (power descending, then address), lookup by index and by
address, and the total voting power. Proposer rotation and set
updates are not part of this slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from ..crypto.keys import PubKey

MAX_TOTAL_VOTING_POWER = (1 << 63) // 8


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    address: bytes = b""

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()


class ValidatorSet:
    def __init__(self, validators: Sequence[Validator]):
        vals = sorted(validators, key=lambda v: (-v.voting_power, v.address))
        self.validators: List[Validator] = vals
        self._by_address = {v.address: i for i, v in enumerate(vals)}
        if len(self._by_address) != len(vals):
            raise ValueError("duplicate validator address")
        self._total_power = None

    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        if self._total_power is None:
            tp = sum(v.voting_power for v in self.validators)
            if tp > MAX_TOTAL_VOTING_POWER:
                raise ValueError("total voting power overflow")
            self._total_power = tp
        return self._total_power

    def get_by_index(self, i: int) -> Optional[Validator]:
        if 0 <= i < len(self.validators):
            return self.validators[i]
        return None

    def get_by_address(self, addr: bytes):
        """(index, validator), or (-1, None) for an unknown address."""
        i = self._by_address.get(addr)
        if i is None:
            return -1, None
        return i, self.validators[i]
