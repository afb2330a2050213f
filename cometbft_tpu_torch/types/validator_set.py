"""Validator / ValidatorSet with proposer-priority rotation.

A copy of the JAX package's ``types/validator_set.py`` (reference
types/validator_set.go): canonical order (power descending, then
address), weighted round-robin proposer selection by accumulated
priorities with centering and rescaling (PriorityWindowSizeFactor 2),
the set hash over (pubkey, power), and ``update_with_change_set``
(power 0 removes, an unknown address adds, else the power changes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..crypto import merkle
from ..crypto.keys import PubKey
from ..utils import proto

PRIORITY_WINDOW_SIZE_FACTOR = 2
MAX_TOTAL_VOTING_POWER = (1 << 63) // 8


@dataclass
class Validator:
    pub_key: PubKey
    voting_power: int
    address: bytes = b""
    proposer_priority: int = 0

    def __post_init__(self):
        if not self.address:
            self.address = self.pub_key.address()

    def copy(self) -> "Validator":
        return Validator(self.pub_key, self.voting_power, self.address, self.proposer_priority)

    def encode(self) -> bytes:
        """SimpleValidator encoding the set hash covers (types/validator.go
        Bytes: pubkey and voting power)."""
        pk = proto.field_bytes(1, self.pub_key.key_bytes)
        return proto.field_message(1, pk) + proto.field_varint(2, self.voting_power)

    def compare_proposer_priority(self, other: "Validator") -> int:
        if self.proposer_priority != other.proposer_priority:
            return -1 if self.proposer_priority > other.proposer_priority else 1
        if self.address < other.address:
            return -1
        if self.address > other.address:
            return 1
        return 0


class ValidatorSet:
    def __init__(self, validators: Sequence[Validator]):
        vals = [v.copy() for v in validators]
        vals.sort(key=lambda v: (-v.voting_power, v.address))
        self.validators: List[Validator] = vals
        self._by_address: Dict[bytes, int] = {v.address: i for i, v in enumerate(vals)}
        if len(self._by_address) != len(vals):
            raise ValueError("duplicate validator address")
        self._hash: Optional[bytes] = None
        self._total_power: Optional[int] = None
        self.proposer: Optional[Validator] = None
        if vals:
            self.proposer = self._compute_max_priority_validator()

    def __len__(self) -> int:
        return len(self.validators)

    def size(self) -> int:
        return len(self.validators)

    def total_voting_power(self) -> int:
        """Memoized; only ``update_with_change_set`` changes powers."""
        if self._total_power is None:
            tp = sum(v.voting_power for v in self.validators)
            if tp > MAX_TOTAL_VOTING_POWER:
                raise ValueError("total voting power overflow")
            self._total_power = tp
        return self._total_power

    def has_address(self, addr: bytes) -> bool:
        return addr in self._by_address

    def get_by_address(self, addr: bytes):
        """(index, validator), or (-1, None) for an unknown address."""
        i = self._by_address.get(addr)
        if i is None:
            return -1, None
        return i, self.validators[i]

    def get_by_index(self, i: int) -> Optional[Validator]:
        if 0 <= i < len(self.validators):
            return self.validators[i]
        return None

    def hash(self) -> bytes:
        """Merkle root over (pubkey, power) in canonical order. Proposer
        priorities are not covered, so the memo survives rotation."""
        if self._hash is None:
            self._hash = merkle.hash_from_byte_slices([v.encode() for v in self.validators])
        return self._hash

    def copy(self) -> "ValidatorSet":
        vs = ValidatorSet.__new__(ValidatorSet)
        vs.validators = [v.copy() for v in self.validators]
        vs._by_address = dict(self._by_address)
        vs._hash = self._hash
        vs._total_power = self._total_power
        vs.proposer = (
            None
            if self.proposer is None
            else vs.validators[self._by_address[self.proposer.address]]
        )
        return vs

    # --- proposer rotation ----------------------------------------------

    def _compute_max_priority_validator(self) -> Validator:
        best = self.validators[0]
        for v in self.validators[1:]:
            if v.compare_proposer_priority(best) < 0:
                best = v
        return best

    def _rescale_priorities(self) -> None:
        if not self.validators:
            return
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        pmax = max(v.proposer_priority for v in self.validators)
        pmin = min(v.proposer_priority for v in self.validators)
        diff = pmax - pmin
        if diff > 0 and diff > diff_max:
            ratio = (diff + diff_max - 1) // diff_max
            for v in self.validators:
                v.proposer_priority = _int_div_round_to_zero(v.proposer_priority, ratio)

    def _shift_by_avg_proposer_priority(self) -> None:
        if not self.validators:
            return
        avg = _int_div_round_to_zero(
            sum(v.proposer_priority for v in self.validators), len(self.validators)
        )
        for v in self.validators:
            v.proposer_priority -= avg

    def increment_proposer_priority(self, times: int) -> None:
        if not self.validators:
            return
        self._rescale_priorities()
        self._shift_by_avg_proposer_priority()
        proposer = self.proposer
        for _ in range(times):
            for v in self.validators:
                v.proposer_priority += v.voting_power
            proposer = self._compute_max_priority_validator()
            proposer.proposer_priority -= self.total_voting_power()
        self.proposer = proposer

    def get_proposer(self) -> Optional[Validator]:
        return self.proposer

    # --- updates ---------------------------------------------------------

    def update_with_change_set(self, changes: Sequence[Validator]) -> None:
        """Apply validator updates: power 0 removes, a new address adds,
        else the power changes (reference updateWithChangeSet)."""
        if not changes:
            return
        seen = set()
        for c in changes:
            if c.address in seen:
                raise ValueError("duplicate address in changes")
            seen.add(c.address)
            if c.voting_power < 0:
                raise ValueError("negative voting power")
        removals = {c.address for c in changes if c.voting_power == 0}
        updates = [c for c in changes if c.voting_power > 0]
        for addr in removals:
            if addr not in self._by_address:
                raise ValueError("removing unknown validator")
        upd_by_addr = {c.address: c for c in updates}
        # new validators start at -1.125 x the new total power
        new_total = sum(c.voting_power for c in updates if c.address not in self._by_address)
        for v in self.validators:
            if v.address not in removals:
                upd = upd_by_addr.get(v.address)
                new_total += v.voting_power if upd is None else upd.voting_power
        if new_total > MAX_TOTAL_VOTING_POWER:
            raise ValueError("total voting power overflow after update")
        new_vals: List[Validator] = []
        for v in self.validators:
            if v.address in removals:
                continue
            upd = upd_by_addr.get(v.address)
            if upd is not None:
                v = v.copy()
                v.voting_power = upd.voting_power
                if isinstance(upd.pub_key, type(v.pub_key)):
                    v.pub_key = upd.pub_key
            new_vals.append(v)
        existing = {v.address for v in new_vals}
        for c in updates:
            if c.address not in existing:
                nv = c.copy()
                nv.proposer_priority = -(new_total + new_total // 8)
                new_vals.append(nv)
        if not new_vals:
            raise ValueError("validator set cannot become empty")
        new_vals.sort(key=lambda v: (-v.voting_power, v.address))
        self.validators = new_vals
        self._by_address = {v.address: i for i, v in enumerate(new_vals)}
        self._hash = None
        self._total_power = None
        self._shift_by_avg_proposer_priority()
        self.proposer = self._compute_max_priority_validator()

    def validate_basic(self) -> None:
        if not self.validators:
            raise ValueError("empty validator set")
        self.total_voting_power()


def _int_div_round_to_zero(a: int, b: int) -> int:
    """Go's integer division (truncates toward zero)."""
    q = abs(a) // abs(b)
    return -q if (a < 0) != (b < 0) else q
