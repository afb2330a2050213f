"""State re-derivation after a crash between block save and state save.

A copy of the JAX package's ``consensus/execution_compat.py``; the
handshake (``consensus/replay.py``) calls it.
"""

from __future__ import annotations

from ..crypto.keys import pubkey_from_type_bytes
from ..state.execution import decode_finalize_response, results_hash
from ..state.state_types import State
from ..types.validator_set import Validator


def rederive_state(state_store, state: State, block, meta, finalize_raw) -> State:
    """Rebuild the post-block state when the block store is one ahead of
    state.db (reference handshake replay edge case)."""
    if finalize_raw is None:
        raise RuntimeError("cannot re-derive state: missing finalize response")
    resp = decode_finalize_response(finalize_raw)
    nvals = state.next_validators.copy()
    if resp.validator_updates:
        nvals.update_with_change_set(
            [
                Validator(pubkey_from_type_bytes(u.pub_key_type, u.pub_key_bytes), u.power)
                for u in resp.validator_updates
            ]
        )
    nvals.increment_proposer_priority(1)
    new_state = State(
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        last_block_height=block.height,
        last_block_id=meta.block_id,
        last_block_time_ns=block.header.time_ns,
        validators=state.next_validators.copy(),
        next_validators=nvals,
        last_validators=state.validators.copy(),
        last_height_validators_changed=state.last_height_validators_changed,
        consensus_params=state.consensus_params,
        last_height_consensus_params_changed=state.last_height_consensus_params_changed,
        last_results_hash=results_hash(resp.tx_results),
        app_hash=resp.app_hash,
    )
    state_store.save(new_state)
    return new_state
