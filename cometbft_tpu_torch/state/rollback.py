"""State rollback (reference state/rollback.go): rewind the state one
height so the block at the current tip can be re-processed — used
after an app-hash mismatch or a faulty upgrade.

A copy of the JAX package's ``state/rollback.py``: rolls state from
height H back to H-1 using the stored historical validator sets and
consensus params, and (hard mode) deletes block H from the block store
as well."""

from __future__ import annotations

import dataclasses


class RollbackError(Exception):
    pass


def rollback_state(state_store, block_store, remove_block: bool = False):
    """Returns the rolled-back State. The reference requires the block
    store to be one ahead of (or equal to) the state store."""
    state = state_store.load()
    if state is None:
        raise RollbackError("no state found to roll back")
    rollback_height = state.last_block_height  # height to undo
    if rollback_height <= 0:
        raise RollbackError("canot rollback genesis state")
    prev_height = rollback_height - 1

    rolled_block = block_store.load_block_meta(rollback_height)
    if rolled_block is None:
        raise RollbackError(f"block at height {rollback_height} not found")
    prev_block = (
        block_store.load_block_meta(prev_height) if prev_height > 0 else None
    )

    # historical valsets: validators for H were stored when H-1 saved
    vals = state_store.load_validators(rollback_height)
    next_vals = state_store.load_validators(rollback_height + 1)
    last_vals = (
        state_store.load_validators(prev_height) if prev_height > 0 else None
    )
    if vals is None or next_vals is None:
        raise RollbackError("historical validator sets unavailable")
    params = state_store.load_consensus_params(rollback_height) or (
        state.consensus_params
    )

    # The rolled-back height may have carried the valset/params change
    # the invalid state points at; clamp the change markers so they
    # never reference a height ABOVE what the rolled-back state can
    # re-derive (reference rollback.go:69-76) — an unclamped forward
    # pointer would corrupt the S:vi record history on the next save.
    val_changed = min(
        state.last_height_validators_changed, rollback_height + 1
    )
    params_changed = min(
        state.last_height_consensus_params_changed, rollback_height
    )

    new_state = dataclasses.replace(
        state,
        last_block_height=prev_height,
        last_block_id=rolled_block.header.last_block_id,
        last_block_time_ns=(
            prev_block.header.time_ns
            if prev_block is not None
            else state.last_block_time_ns
        ),
        validators=vals,
        next_validators=next_vals,
        last_validators=last_vals,
        last_height_validators_changed=val_changed,
        consensus_params=params,
        last_height_consensus_params_changed=params_changed,
        app_hash=rolled_block.header.app_hash,
        last_results_hash=rolled_block.header.last_results_hash,
    )
    state_store.save(new_state)
    if remove_block:
        block_store.delete_latest_block()
    return new_state
