"""Consensus data types (reference types/). Modules are imported by
path; the vote set is also exported here."""

from .vote_set import ErrVoteConflictingVotes, VoteSet  # noqa: F401
