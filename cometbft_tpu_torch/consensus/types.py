"""Round state + height vote set (reference consensus/types/).

A copy of the JAX package's ``consensus/types.py``; the height vote
set's lock is the runtime sanitizer's ``consensus.votes`` (the raw
RLock when the sanitizer is off).
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass
from typing import Dict, Optional

from ..analysis.runtime import sanitized_lock

from ..types.block import Block
from ..types.part_set import PartSet
from ..types.validator_set import ValidatorSet
from ..types.vote import PREVOTE, PRECOMMIT, Proposal, Vote
from ..types.vote_set import VoteSet


class Step(enum.IntEnum):
    NEW_HEIGHT = 1
    NEW_ROUND = 2
    PROPOSE = 3
    PREVOTE = 4
    PREVOTE_WAIT = 5
    PRECOMMIT = 6
    PRECOMMIT_WAIT = 7
    COMMIT = 8


class HeightVoteSet:
    """Prevotes + precommits for every round of one height
    (reference consensus/types/height_vote_set.go)."""

    def __init__(
        self,
        chain_id: str,
        height: int,
        val_set: ValidatorSet,
        sig_cache=None,
    ):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.sig_cache = sig_cache
        self.round = 0
        # keyed by round within ONE height; the whole HeightVoteSet is
        # replaced on height advance (update_to_state)
        self._prevotes: Dict[int, VoteSet] = {}  # bftlint: disable=ASY119 — keyed by round within ONE height; the whole HeightVoteSet is replaced on height advance (update_to_state)
        self._precommits: Dict[int, VoteSet] = {}  # bftlint: disable=ASY119 — keyed by round within ONE height; replaced on height advance together with _prevotes
        self._lock = sanitized_lock(threading.RLock(), "consensus.votes")
        self.set_round(0)

    def _ensure(self, round_: int) -> None:
        if round_ not in self._prevotes:
            self._prevotes[round_] = VoteSet(
                self.chain_id, self.height, round_, PREVOTE, self.val_set,
                sig_cache=self.sig_cache,
            )
            self._precommits[round_] = VoteSet(
                self.chain_id, self.height, round_, PRECOMMIT, self.val_set,
                sig_cache=self.sig_cache,
            )

    def set_round(self, round_: int) -> None:
        with self._lock:
            self._ensure(round_)
            self._ensure(round_ + 1)
            self.round = round_

    def add_vote(self, vote: Vote) -> bool:
        with self._lock:
            self._ensure(vote.round)
            vs = (
                self._prevotes if vote.type_ == PREVOTE else self._precommits
            )[vote.round]
            return vs.add_vote(vote)

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        with self._lock:
            self._ensure(round_)
            return self._prevotes[round_]

    def precommits(self, round_: int) -> Optional[VoteSet]:
        with self._lock:
            self._ensure(round_)
            return self._precommits[round_]

    def pol_info(self):
        """(round, blockID) of the most recent prevote polka, or (-1, None)."""
        with self._lock:
            for r in sorted(self._prevotes, reverse=True):
                bid = self._prevotes[r].two_thirds_majority()
                if bid is not None:
                    return r, bid
        return -1, None


@dataclass
class RoundState:
    height: int = 0
    round: int = 0
    step: Step = Step.NEW_HEIGHT
    start_time_ns: int = 0
    commit_time_ns: int = 0
    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None
    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None
    votes: Optional[HeightVoteSet] = None
    commit_round: int = -1
    last_commit: Optional[VoteSet] = None
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False
