"""Handshaker: bring the app level with the block store at start.

A copy of the JAX package's ``consensus/replay.py`` (reference
consensus/replay.go): the Info handshake (:241), then ReplayBlocks
(:288) — InitChain at genesis, and the stored blocks the app has not
seen replayed through FinalizeBlock and Commit. This is the restart
path: a replay window's blocks are saved before they are applied, so
the store may be ahead of the app and of the state.
"""

from __future__ import annotations

from ..abci import types as abci
from ..state.execution import encode_finalize_response
from ..state.state_types import State
from ..types.validator_set import Validator, ValidatorSet
from .execution_compat import rederive_state


class Handshaker:
    def __init__(self, state_store, state: State, block_store, genesis_doc):
        self.state_store = state_store
        self.state = state
        self.block_store = block_store
        self.genesis = genesis_doc
        self.n_blocks_replayed = 0

    def handshake(self, proxy_app) -> State:
        info = proxy_app.query.info(abci.RequestInfo())
        return self.replay_blocks(
            proxy_app, self.state, info.last_block_height, info.last_block_app_hash
        )

    def replay_blocks(self, proxy_app, state: State, app_height: int, app_hash: bytes) -> State:
        store_height = self.block_store.height()
        if app_height == 0:
            vals = [
                abci.ValidatorUpdate(
                    pub_key_type=v.pub_key.type_,
                    pub_key_bytes=v.pub_key.key_bytes,
                    power=v.voting_power,
                )
                for v in self.genesis.validators
            ]
            resp = proxy_app.consensus.init_chain(
                abci.RequestInitChain(
                    time_ns=self.genesis.genesis_time_ns,
                    chain_id=self.genesis.chain_id,
                    validators=vals,
                    app_state_bytes=self.genesis.app_state_bytes,
                    initial_height=self.genesis.initial_height,
                )
            )
            if state.last_block_height == 0:
                if resp.validators:
                    vs = ValidatorSet(
                        [
                            Validator(pubkey_from_type_bytes(u.pub_key_type, u.pub_key_bytes), u.power)
                            for u in resp.validators
                        ]
                    )
                    state.validators = vs
                    state.next_validators = vs.copy()
                if resp.app_hash:
                    state.app_hash = resp.app_hash
                self.state_store.save(state)
            app_hash = resp.app_hash or state.app_hash
            app_height = self.genesis.initial_height - 1
        if store_height == 0:
            return state
        # replay the stored blocks the app has not seen
        for h in range(app_height + 1, store_height + 1):
            block = self.block_store.load_block(h)
            if block is None:
                raise RuntimeError(f"missing block {h} during replay")
            resp = proxy_app.consensus.finalize_block(
                abci.RequestFinalizeBlock(
                    txs=block.data.txs,
                    hash=block.hash(),
                    height=h,
                    time_ns=block.header.time_ns,
                    next_validators_hash=block.header.next_validators_hash,
                    proposer_address=block.header.proposer_address,
                )
            )
            proxy_app.consensus.commit()
            # the state's re-derivation below reads exactly this
            self.state_store.save_finalize_block_response(h, encode_finalize_response(resp))
            self.n_blocks_replayed += 1
            app_hash = resp.app_hash
        if state.last_block_height < store_height:
            state = rederive_state(
                self.state_store,
                state,
                self.block_store.load_block(store_height),
                self.block_store.load_block_meta(store_height),
                self.state_store.load_finalize_block_response(store_height),
            )
        if state.app_hash != app_hash and app_hash:
            state.app_hash = app_hash
        return state
