"""Block validation against the state (reference state/validation.go).

A copy of the JAX package's ``state/validation.py``. The LastCommit
check goes through the port's ``types.validation.verify_commit`` on
the caller's ``device`` (the GPU kernels, or the host plane, as the
verify scheduler routes it).
"""

from __future__ import annotations

from typing import Optional

from ..types.block import Block
from ..types.signature_cache import SignatureCache
from ..types.validation import verify_commit
from .state_types import State


def validate_block(
    state: State,
    block: Block,
    cache: Optional[SignatureCache] = None,
    skip_commit_check: bool = False,
    priority: Optional[int] = None,
    device=None,
) -> None:
    """``skip_commit_check``: blocksync already verified the LastCommit
    in its coalesced window (reference blocksync SkipLastCommit).
    ``priority``: the verify scheduler's class for the LastCommit check
    (catch-up by default)."""
    block.validate_basic()
    h = block.header
    if h.chain_id != state.chain_id:
        raise ValueError(f"wrong chain id {h.chain_id}")
    if h.height != state.last_block_height + 1:
        raise ValueError(f"wrong height {h.height}, expected {state.last_block_height + 1}")
    if h.last_block_id.key() != state.last_block_id.key():
        raise ValueError("wrong LastBlockID")
    if h.validators_hash != state.validators.hash():
        raise ValueError("wrong ValidatorsHash")
    if h.next_validators_hash != state.next_validators.hash():
        raise ValueError("wrong NextValidatorsHash")
    if h.consensus_hash != state.consensus_params.hash():
        raise ValueError("wrong ConsensusHash")
    if h.app_hash != state.app_hash:
        raise ValueError("wrong AppHash")
    if h.last_results_hash != state.last_results_hash:
        raise ValueError("wrong LastResultsHash")
    if not state.validators.has_address(h.proposer_address):
        raise ValueError("proposer not in validator set")
    if h.height == state.initial_height:
        if block.last_commit is not None and block.last_commit.size() > 0:
            raise ValueError("initial block cannot have LastCommit")
    else:
        if block.last_commit is None:
            raise ValueError("missing LastCommit")
        if block.last_commit.size() != state.last_validators.size():
            raise ValueError("wrong LastCommit size")
        if not skip_commit_check:
            verify_commit(
                state.chain_id,
                state.last_validators,
                state.last_block_id,
                h.height - 1,
                block.last_commit,
                cache=cache,
                priority=priority,
                device=device,
            )
    for ev in block.evidence:
        ev.validate_basic()
