"""VoteSet: quorum tracking for one (height, round, type).

Behavioral parity with reference types/vote_set.go: one vote per
validator (conflicts tracked for evidence), weighted 2/3 majority per
BlockID, peer-claimed majorities ("maj23") tracking, commit extraction. A copy
of the JAX package's ``types/vote_set.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .block import (
    BLOCK_ID_FLAG_COMMIT,
    BLOCK_ID_FLAG_NIL,
    BlockID,
    Commit,
    CommitSig,
    ExtendedCommit,
    ExtendedCommitSig,
)
from .validator_set import ValidatorSet
from .vote import PRECOMMIT, Vote, is_vote_type_valid


class ErrVoteConflictingVotes(Exception):
    def __init__(self, existing: Vote, new: Vote):
        super().__init__("conflicting votes from validator")
        self.existing = existing
        self.new = new


@dataclass
class _BlockVotes:
    votes_by_index: Dict[int, Vote] = field(default_factory=dict)
    sum_power: int = 0


class VoteSet:
    def __init__(
        self,
        chain_id: str,
        height: int,
        round_: int,
        type_: int,
        val_set: ValidatorSet,
        verify_signatures: bool = True,
        sig_cache=None,
    ):
        assert is_vote_type_valid(type_)
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.type_ = type_
        self.val_set = val_set
        self.verify = verify_signatures
        # shared SignatureCache: signatures pre-verified by the async
        # coalescing queue (crypto/coalesce.py) resolve as cache hits
        # here, keeping the single-writer add_vote path off the crypto
        self.sig_cache = sig_cache
        self.votes: List[Optional[Vote]] = [None] * val_set.size()
        # append-ordered log of accepted votes: the consensus
        # reactor's per-peer gossip cursors read `vote_log[i:]` so a
        # gossip tick costs O(new votes), not O(validators).
        # Append-only by design; the whole VoteSet is per-(height,
        # round, type) and dropped on height advance.
        self.vote_log: List[Vote] = []
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: Dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: Dict[str, BlockID] = {}

    def size(self) -> int:
        return self.val_set.size()

    def add_vote(self, vote: Vote) -> bool:
        """Returns True if the vote was added. Raises on conflict
        (evidence!) or invalid signature."""
        if vote is None:
            raise ValueError("nil vote")
        vote.validate_basic()
        if (
            vote.height != self.height
            or vote.round != self.round
            or vote.type_ != self.type_
        ):
            raise ValueError(
                f"vote {vote.height}/{vote.round}/{vote.type_} does not "
                f"match VoteSet {self.height}/{self.round}/{self.type_}"
            )
        idx = vote.validator_index
        val = self.val_set.get_by_index(idx)
        if val is None:
            raise ValueError(f"validator index {idx} out of range")
        if val.address != vote.validator_address:
            raise ValueError("vote address does not match validator index")

        existing = self.votes[idx]
        if existing is not None:
            if existing.block_id.key() == vote.block_id.key():
                return False  # duplicate
            # conflicting vote: verify before raising as evidence
            if self.verify and not self._verify_vote(vote, val):
                raise ValueError("invalid signature on conflicting vote")
            raise ErrVoteConflictingVotes(existing, vote)

        if self.verify and not self._verify_vote(vote, val):
            raise ValueError("invalid vote signature")

        self.votes[idx] = vote
        self.vote_log.append(vote)
        self.sum += val.voting_power
        bk = vote.block_id.key()
        bv = self.votes_by_block.setdefault(bk, _BlockVotes())
        bv.votes_by_index[idx] = vote
        bv.sum_power += val.voting_power
        if (
            self.maj23 is None
            and bv.sum_power * 3 > self.val_set.total_voting_power() * 2
        ):
            self.maj23 = vote.block_id
        return True

    def _verify_vote(self, vote: Vote, val) -> bool:
        """Single-vote verify, fronted by the shared SignatureCache.

        The address-vs-index check happened in add_vote, and the cache
        key binds (sign_bytes, sig, pubkey), so a hit is exactly as
        strong as re-running the curve math (reference
        types/signature_cache.go used at types/validation.go:82-91).
        """
        if self.sig_cache is not None:
            sb = vote.sign_bytes(self.chain_id)
            if self.sig_cache.contains(
                sb, vote.signature, val.pub_key.key_bytes
            ):
                return True
            ok = vote.verify(self.chain_id, val.pub_key)
            if ok:
                self.sig_cache.add(sb, vote.signature, val.pub_key.key_bytes)
            return ok
        return vote.verify(self.chain_id, val.pub_key)

    def get_vote(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]

    def get_vote_by_address(self, addr: bytes) -> Optional[Vote]:
        i, _ = self.val_set.get_by_address(addr)
        return None if i < 0 else self.votes[i]

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def two_thirds_majority(self) -> Optional[BlockID]:
        return self.maj23

    def has_two_thirds_any(self) -> bool:
        return self.sum * 3 > self.val_set.total_voting_power() * 2

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def bit_array(self) -> List[bool]:
        return [v is not None for v in self.votes]

    def bit_array_by_block_id(self, block_id: BlockID) -> List[bool]:
        bv = self.votes_by_block.get(block_id.key())
        out = [False] * self.size()
        if bv:
            for i in bv.votes_by_index:
                out[i] = True
        return out

    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """Record a peer's claim that +2/3 voted for block_id
        (drives targeted vote gossip; types/vote_set.go SetPeerMaj23)."""
        prev = self.peer_maj23s.get(peer_id)
        if prev is not None and prev.key() != block_id.key():
            raise ValueError("conflicting peer maj23 claims")
        self.peer_maj23s[peer_id] = block_id

    def make_commit(self) -> Commit:
        assert self.type_ == PRECOMMIT, "commit only from precommits"
        if self.maj23 is None or self.maj23.is_nil():
            raise ValueError("no +2/3 majority for a block")
        sigs = []
        for i, vote in enumerate(self.votes):
            if vote is None:
                sigs.append(CommitSig.absent())
                continue
            if vote.block_id.key() == self.maj23.key():
                flag = BLOCK_ID_FLAG_COMMIT
            elif vote.block_id.is_nil():
                flag = BLOCK_ID_FLAG_NIL
            else:
                flag = BLOCK_ID_FLAG_NIL  # vote for other block counts nil
            sigs.append(
                CommitSig(
                    block_id_flag=flag,
                    validator_address=vote.validator_address,
                    timestamp_ns=vote.timestamp_ns,
                    signature=vote.signature,
                )
            )
        return Commit(
            height=self.height,
            round=self.round,
            block_id=self.maj23,
            signatures=sigs,
        )

    def make_extended_commit(
        self, require_extensions: bool = True
    ) -> ExtendedCommit:
        """Commit + per-vote extensions (reference
        types/vote_set.go MakeExtendedCommit): the payload the proposer
        feeds to the NEXT height's PrepareProposal.

        require_extensions (reference EnsureExtension): every
        COMMIT-flag signature must carry an extension signature —
        persisting one without it would make 'extension absent' and
        'extension stripped' indistinguishable downstream."""
        base = self.make_commit()
        ext_sigs = []
        for cs, vote in zip(base.signatures, self.votes):
            is_commit = cs.block_id_flag == BLOCK_ID_FLAG_COMMIT
            if (
                require_extensions
                and is_commit
                and not (vote and vote.extension_signature)
            ):
                raise ValueError(
                    "commit vote without extension signature "
                    f"(validator {cs.validator_address.hex()[:12]})"
                )
            # extension data only rides COMMIT-flag lanes (reference
            # ExtendedCommitSig.ValidateBasic): a vote for another
            # block is downgraded to NIL and must not leak its payload
            ext_sigs.append(
                ExtendedCommitSig(
                    block_id_flag=cs.block_id_flag,
                    validator_address=cs.validator_address,
                    timestamp_ns=cs.timestamp_ns,
                    signature=cs.signature,
                    extension=(
                        vote.extension if (vote and is_commit) else b""
                    ),
                    extension_signature=(
                        vote.extension_signature
                        if (vote and is_commit)
                        else b""
                    ),
                )
            )
        return ExtendedCommit(
            height=base.height,
            round=base.round,
            block_id=base.block_id,
            extended_signatures=ext_sigs,
        )
