"""BlockExecutor: create, validate and execute blocks against the app.

The part of the JAX package's ``state/execution.py`` that block replay
and the chain generator run (reference state/execution.go):
``create_proposal_block`` (:114) and ``_make_block``, ``validate_block``
(:205) with the fork's last-validated-block cache and block-time
tolerance, ``apply_block`` / ``apply_verified_block`` (:246-258) as the
three phases ``apply_finalize``, ``apply_hash_persist`` and
``apply_complete``, ``_commit`` with the mempool update (:446-509) and
``_update_state`` (:694). Commit checks run on the executor's
``device``. The evidence pool, the event bus, pruning and vote
extensions are not ported: blocks carry no evidence here.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

from ..abci import types as abci
from ..crypto import merkle
from ..crypto.keys import pubkey_from_type_bytes
from ..device import resolve
from ..types.block import Block, BlockID, Commit, Data, Header
from ..types.part_set import PartSet
from ..types.signature_cache import SignatureCache
from ..types.validator_set import Validator
from ..utils import codec, proto
from . import native_finalize
from .state_types import BLOCK_VERSION, State
from .validation import validate_block

# fork feature, opt-in as in the reference (state/validation.go:124):
# 0 disables the wall-clock check, so historical replay is never
# refused for "future" timestamps
DEFAULT_BLOCK_TIME_TOLERANCE_NS = 0


def results_hash(tx_results: List[abci.ExecTxResult]) -> bytes:
    return merkle.hash_from_byte_slices([r.encode() for r in tx_results])


def _dec_abci_event(b: bytes) -> abci.Event:
    m = proto.parse(b)
    attrs = []
    for ab in m.get(2, []):
        am = proto.parse(ab)
        attrs.append(
            abci.EventAttribute(
                key=proto.get1(am, 1, b"").decode(),
                value=proto.get1(am, 2, b"").decode(),
                index=bool(proto.get1(am, 3, 0)),
            )
        )
    return abci.Event(type_=proto.get1(m, 1, b"").decode(), attributes=attrs)


def encode_finalize_response(resp: abci.ResponseFinalizeBlock, artifacts=None) -> bytes:
    """The stored FinalizeBlock response: results (field 1), validator
    updates (2), app hash (3), block events (4) and each tx's events
    keyed by index (5). ``artifacts`` reuses the finalize pass's
    encodings; without it they are made here (the same bytes)."""
    if artifacts is None:
        artifacts = native_finalize.finalize_pass([], resp)
    out = b"".join(proto.field_message(1, rb) for rb in artifacts.results_enc)
    for vu in resp.validator_updates:
        out += proto.field_message(
            2,
            proto.field_string(1, vu.pub_key_type)
            + proto.field_bytes(2, vu.pub_key_bytes)
            + proto.field_varint(3, vu.power),
        )
    out += proto.field_bytes(3, resp.app_hash)
    for eb in artifacts.block_events_enc:
        out += proto.field_message(4, eb)
    for i, evs in enumerate(artifacts.tx_events_enc):
        if evs:
            out += proto.field_message(
                5, proto.field_varint(1, i) + b"".join(proto.field_message(2, eb) for eb in evs)
            )
    return out


def decode_finalize_response(b: bytes) -> abci.ResponseFinalizeBlock:
    m = proto.parse(b)
    txrs = []
    for rb in m.get(1, []):
        rm = proto.parse(rb)
        txrs.append(
            abci.ExecTxResult(
                code=proto.get1(rm, 1, 0),
                data=proto.get1(rm, 2, b""),
                gas_wanted=proto.get1(rm, 5, 0),
                gas_used=proto.get1(rm, 6, 0),
                codespace=proto.get1(rm, 8, b"").decode(),
            )
        )
    for evb in m.get(5, []):
        em = proto.parse(evb)
        i = proto.get1(em, 1, 0)
        if 0 <= i < len(txrs):
            txrs[i].events = [_dec_abci_event(eb) for eb in em.get(2, [])]
    vus = []
    for vb in m.get(2, []):
        vm = proto.parse(vb)
        vus.append(
            abci.ValidatorUpdate(
                pub_key_type=proto.get1(vm, 1, b"").decode(),
                pub_key_bytes=proto.get1(vm, 2, b""),
                power=proto.get1(vm, 3, 0),
            )
        )
    return abci.ResponseFinalizeBlock(
        events=[_dec_abci_event(eb) for eb in m.get(4, [])],
        tx_results=txrs,
        validator_updates=vus,
        app_hash=proto.get1(m, 3, b""),
    )


def build_last_commit_info(lc, last_vals) -> Optional[abci.CommitInfo]:
    """CommitInfo for a block's last commit (reference
    buildLastCommitInfo): one VoteInfo per validator of height-1."""
    if lc is None or last_vals is None or not lc.signatures:
        return None
    votes = []
    for i, v in enumerate(last_vals.validators):
        flag = abci.BLOCK_ID_FLAG_ABSENT
        if i < len(lc.signatures):
            flag = lc.signatures[i].block_id_flag
        votes.append(
            abci.VoteInfo(validator_address=v.address, power=v.voting_power, block_id_flag=flag)
        )
    return abci.CommitInfo(round=lc.round, votes=votes)


class BlockExecutor:
    def __init__(
        self,
        state_store,
        proxy_consensus,
        mempool,
        block_store=None,
        signature_cache: Optional[SignatureCache] = None,
        block_time_tolerance_ns: int = DEFAULT_BLOCK_TIME_TOLERANCE_NS,
        device=None,
    ):
        self.store = state_store
        self.proxy = proxy_consensus
        self.mempool = mempool
        self.block_store = block_store
        self.sig_cache = signature_cache or SignatureCache()
        self.tolerance_ns = block_time_tolerance_ns
        # where LastCommit checks run; resolved at each check, so an
        # executor made for the GPU raises there when none is present
        self.device = device
        # fork feature: skip re-validating the block validated last
        self._last_validated: Optional[bytes] = None

    # --- proposal creation (reference :114) ---------------------------

    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_commit: Optional[Commit],
        proposer_addr: bytes,
        time_ns: Optional[int] = None,
    ) -> Tuple[Block, PartSet]:
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        txs = self.mempool.reap_max_bytes_max_gas(max_bytes - 2048, max_gas)
        t = time_ns or time.time_ns()
        req = abci.RequestPrepareProposal(
            max_tx_bytes=max_bytes - 2048,
            txs=txs,
            local_last_commit=build_last_commit_info(last_commit, state.last_validators),
            height=height,
            time_ns=t,
            next_validators_hash=state.next_validators.hash(),
            proposer_address=proposer_addr,
        )
        resp = self.proxy.prepare_proposal(req)
        block = self._make_block(height, state, resp.txs, last_commit, proposer_addr, t)
        return block, PartSet.from_data(codec.encode_block(block))

    def _make_block(self, height, state, txs, last_commit, proposer_addr, t) -> Block:
        data = Data(txs=list(txs))
        header = Header(
            version_block=BLOCK_VERSION,
            chain_id=state.chain_id,
            height=height,
            time_ns=t,
            last_block_id=state.last_block_id,
            last_commit_hash=last_commit.hash() if last_commit else b"",
            data_hash=data.hash(),
            validators_hash=state.validators.hash(),
            next_validators_hash=state.next_validators.hash(),
            consensus_hash=state.consensus_params.hash(),
            app_hash=state.app_hash,
            last_results_hash=state.last_results_hash,
            evidence_hash=merkle.hash_from_byte_slices([]),
            proposer_address=proposer_addr,
        )
        return Block(header=header, data=data, last_commit=last_commit)

    # --- validation (reference :205) ----------------------------------

    def validate_block(
        self, state: State, block: Block, skip_commit_check: bool = False, priority=None
    ) -> None:
        device = resolve(self.device)
        bh = block.hash()
        if self._last_validated == bh:
            return  # fork: last-validated-block cache (execution.go:261)
        validate_block(
            state,
            block,
            cache=self.sig_cache,
            skip_commit_check=skip_commit_check,
            priority=priority,
            device=device,
        )
        if self.tolerance_ns > 0 and block.header.time_ns > time.time_ns() + self.tolerance_ns:
            raise ValueError("block timestamp too far in the future")
        self._last_validated = bh

    # --- execution (reference :246-446) -------------------------------

    def apply_block(
        self, state: State, block_id: BlockID, block: Block, verified: bool = False
    ) -> State:
        resp = self.apply_finalize(state, block, verified=verified)
        new_state, _ = self.apply_hash_persist(state, block_id, block, resp)
        return self.apply_complete(new_state, block, resp)

    def apply_finalize(
        self, state: State, block: Block, verified: bool = False
    ) -> abci.ResponseFinalizeBlock:
        """Phase 1: validate, then ABCI FinalizeBlock."""
        if not verified:
            self.validate_block(state, block)
        req = abci.RequestFinalizeBlock(
            txs=block.data.txs,
            decided_last_commit=build_last_commit_info(block.last_commit, state.last_validators),
            hash=block.hash(),
            height=block.height,
            time_ns=block.header.time_ns,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )
        resp = self.proxy.finalize_block(req)
        if len(resp.tx_results) != len(block.data.txs):
            raise RuntimeError("app returned wrong number of tx results")
        return resp

    def apply_hash_persist(self, state: State, block_id: BlockID, block: Block, resp):
        """Phase 2: the finalize pass, then the stored response and the
        new state, both from its encodings."""
        artifacts = native_finalize.finalize_pass(block.data.txs, resp)
        self.store.save_finalize_block_response(
            block.height, encode_finalize_response(resp, artifacts)
        )
        return self._update_state(state, block_id, block, resp, artifacts), artifacts

    def apply_complete(self, new_state: State, block: Block, resp) -> State:
        """Phase 3: the app's Commit and the mempool update."""
        self._commit(block, resp)
        return new_state

    def apply_verified_block(self, state: State, block_id: BlockID, block: Block) -> State:
        """Skip validation: the commit was verified already (blocksync,
        reference :246)."""
        return self.apply_block(state, block_id, block, verified=True)

    def _commit(self, block: Block, resp) -> None:
        self.mempool.lock()
        try:
            self.proxy.commit()
            self.mempool.update(block.height, block.data.txs, resp.tx_results)
        finally:
            self.mempool.unlock()

    def _update_state(
        self, state: State, block_id: BlockID, block: Block, resp, artifacts=None
    ) -> State:
        nvals = state.next_validators.copy()
        changed = state.last_height_validators_changed
        if resp.validator_updates:
            nvals.update_with_change_set(
                [
                    Validator(pubkey_from_type_bytes(vu.pub_key_type, vu.pub_key_bytes), vu.power)
                    for vu in resp.validator_updates
                ]
            )
            # updates from block H take effect at H+2 (reference
            # state/execution.go:713)
            changed = block.height + 2
        nvals.increment_proposer_priority(1)
        params = state.consensus_params
        params_changed = state.last_height_consensus_params_changed
        if resp.consensus_param_updates is not None:
            params = resp.consensus_param_updates
            params_changed = block.height + 1
        # published validator sets are never mutated in place (every
        # mutator above runs on a fresh copy), so the previous state's
        # sets are shared into the new one, hash memos included
        new_state = State(
            chain_id=state.chain_id,
            initial_height=state.initial_height,
            last_block_height=block.height,
            last_block_id=block_id,
            last_block_time_ns=block.header.time_ns,
            validators=state.next_validators,
            next_validators=nvals,
            last_validators=state.validators,
            last_height_validators_changed=changed,
            consensus_params=params,
            last_height_consensus_params_changed=params_changed,
            last_results_hash=(
                artifacts.results_hash if artifacts is not None else results_hash(resp.tx_results)
            ),
            app_hash=resp.app_hash,
        )
        self.store.save(new_state)
        return new_state
