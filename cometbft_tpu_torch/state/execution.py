"""BlockExecutor: create, validate and execute blocks against the app.

The part of the JAX package's ``state/execution.py`` that block replay,
the chain generator and the consensus round run (reference
state/execution.go): ``create_proposal_block`` (:114, with the
extended commit's ``ExtendedCommitInfo`` when vote extensions are on)
and ``_make_block``, ``process_proposal`` (:177), ``extend_vote`` and
``verify_vote_extension`` (the ABCI 2.0 round calls), ``validate_block``
(:205) with the fork's last-validated-block cache and block-time
tolerance, ``apply_block`` / ``apply_verified_block`` (:246-258) as the
three phases ``apply_finalize``, ``apply_hash_persist`` and
``apply_complete``, ``_commit`` with the mempool update (:446-509) and
``_update_state`` (:694). Commit checks run on the executor's
``device``. With an evidence pool, a proposal carries the pool's
pending evidence, every ABCI call that takes a block hands the app its
evidence as ``Misbehavior`` (``evidence_to_misbehavior``), and the
commit phase tells the pool what was committed (``evpool.update``).
With an ``event_bus``, the commit phase publishes NewBlock,
NewBlockHeader, one Tx per tx and ValidatorSetUpdates (``_fire_events``)
with the finalize pass's flattened and encoded events, which the
indexer and the RPC fan-out read. The app's Commit ``retain_height``
goes to the retention plane's ``retention_hook`` when the node has one
(``_prune``, reference :527-545), else prunes blocks and states inline.
The crash points around FinalizeBlock, the stored response and Commit
are the JAX package's (``utils/fail.py``, reference :313-363).
"""

from __future__ import annotations

import hashlib
import time
from typing import List, Optional, Tuple

from ..abci import types as abci
from ..crypto import merkle
from ..crypto.keys import pubkey_from_type_bytes
from ..device import resolve
from ..evidence.types import DuplicateVoteEvidence, LightClientAttackEvidence
from ..types import events as ev
from ..types.block import Block, BlockID, Commit, Data, Header
from ..types.part_set import PartSet
from ..types.signature_cache import SignatureCache
from ..types.validator_set import Validator
from ..utils import codec, proto
from ..utils.fail import fail_point
from . import native_finalize
from .state_types import BLOCK_VERSION, State
from .validation import validate_block

# fork feature, opt-in as in the reference (state/validation.go:124):
# 0 disables the wall-clock check, so historical replay is never
# refused for "future" timestamps
DEFAULT_BLOCK_TIME_TOLERANCE_NS = 0


def results_hash(tx_results: List[abci.ExecTxResult]) -> bytes:
    # bftlint: disable-next=ASY123 — portable twin of the native lane; the finalize path reads artifacts.results_hash, this serves compat callers (light proxy, replay) on short lists
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


def build_extended_commit_info(ec, last_vals):
    """ExtendedCommitInfo for PrepareProposal when vote extensions are
    enabled (reference state/execution.go buildExtendedCommitInfo)."""
    if ec is None or last_vals is None:
        return None
    votes = []
    for i, v in enumerate(last_vals.validators):
        flag = abci.BLOCK_ID_FLAG_ABSENT
        ext = ext_sig = b""
        if i < len(ec.extended_signatures):
            s = ec.extended_signatures[i]
            flag = s.block_id_flag
            if flag == abci.BLOCK_ID_FLAG_COMMIT:
                # extension payloads only ride COMMIT lanes (ABCI
                # contract; defensive against a non-conforming EC)
                ext, ext_sig = s.extension, s.extension_signature
        votes.append(
            abci.ExtendedVoteInfo(
                validator_address=v.address,
                power=v.voting_power,
                block_id_flag=flag,
                vote_extension=ext,
                extension_signature=ext_sig,
            )
        )
    return abci.ExtendedCommitInfo(round=ec.round, votes=votes)


def evidence_to_misbehavior(evidence) -> List[abci.Misbehavior]:
    """ABCI Misbehavior records from block evidence (reference
    types/evidence.go ABCI(): a duplicate vote maps to one record, a
    light-client attack to one per byzantine validator)."""
    out = []
    for e in evidence:
        if isinstance(e, DuplicateVoteEvidence):
            out.append(
                abci.Misbehavior(
                    type_=abci.MISBEHAVIOR_DUPLICATE_VOTE,
                    validator_address=e.vote_a.validator_address,
                    validator_power=e.validator_power,
                    height=e.height(),
                    time_ns=e.timestamp_ns,
                    total_voting_power=e.total_voting_power,
                )
            )
        elif isinstance(e, LightClientAttackEvidence):
            for v in e.byzantine_validators:
                out.append(
                    abci.Misbehavior(
                        type_=abci.MISBEHAVIOR_LIGHT_CLIENT_ATTACK,
                        validator_address=v.address,
                        validator_power=v.voting_power,
                        height=e.common_height,
                        time_ns=e.timestamp_ns,
                        total_voting_power=e.total_voting_power,
                    )
                )
    return out


class BlockExecutor:
    def __init__(
        self,
        state_store,
        proxy_consensus,
        mempool,
        evidence_pool=None,
        block_store=None,
        signature_cache: Optional[SignatureCache] = None,
        block_time_tolerance_ns: int = DEFAULT_BLOCK_TIME_TOLERANCE_NS,
        device=None,
        event_bus: Optional[ev.EventBus] = None,
    ):
        self.store = state_store
        self.proxy = proxy_consensus
        self.mempool = mempool
        self.evpool = evidence_pool
        self.event_bus = event_bus
        self.block_store = block_store
        self.sig_cache = signature_cache or SignatureCache()
        self.tolerance_ns = block_time_tolerance_ns
        # where LastCommit checks run; resolved at each check, so an
        # executor made for the GPU raises there when none is present
        self.device = device
        # fork feature: skip re-validating the block validated last
        self._last_validated: Optional[bytes] = None
        # the app's retain_height from the last Commit, and the
        # retention plane's hook (store/retention.py), which takes it
        # when set; without a hook the executor prunes inline
        self._retain_height = 0
        self.retention_hook = None

    # --- proposal creation (reference :114) ---------------------------

    def extend_vote(self, block_hash: bytes, height: int, round_: int, time_ns: int) -> bytes:
        """App-provided vote extension for our own precommit
        (reference state/execution.go ExtendVote -> ABCI ExtendVote)."""
        resp = self.proxy.extend_vote(
            abci.RequestExtendVote(hash=block_hash, height=height, round=round_, time_ns=time_ns)
        )
        return resp.vote_extension or b""

    def verify_vote_extension(self, vote) -> bool:
        """App acceptance of a peer's vote extension (reference
        VerifyVoteExtension; rejection rejects the whole precommit)."""
        try:
            resp = self.proxy.verify_vote_extension(
                abci.RequestVerifyVoteExtension(
                    hash=vote.block_id.hash or b"",
                    validator_address=vote.validator_address,
                    height=vote.height,
                    vote_extension=vote.extension,
                )
            )
        except Exception:
            return False
        return resp.status == abci.VERIFY_VOTE_EXT_ACCEPT

    def create_proposal_block(
        self,
        height: int,
        state: State,
        last_commit: Optional[Commit],
        proposer_addr: bytes,
        time_ns: Optional[int] = None,
        extended_commit=None,
    ) -> Tuple[Block, PartSet]:
        max_bytes = state.consensus_params.block.max_bytes
        max_gas = state.consensus_params.block.max_gas
        evidence = (
            self.evpool.pending_evidence(state.consensus_params.evidence.max_bytes)
            if self.evpool
            else []
        )
        txs = self.mempool.reap_max_bytes_max_gas(max_bytes - 2048, max_gas)
        t = time_ns or time.time_ns()
        if extended_commit is not None:
            # extensions enabled at height-1: the app sees the
            # extension payloads (reference buildExtendedCommitInfo)
            lci = build_extended_commit_info(extended_commit, state.last_validators)
        else:
            lci = build_last_commit_info(last_commit, state.last_validators)
        req = abci.RequestPrepareProposal(
            max_tx_bytes=max_bytes - 2048,
            txs=txs,
            local_last_commit=lci,
            misbehavior=evidence_to_misbehavior(evidence),
            height=height,
            time_ns=t,
            next_validators_hash=state.next_validators.hash(),
            proposer_address=proposer_addr,
        )
        resp = self.proxy.prepare_proposal(req)
        block = self._make_block(height, state, resp.txs, last_commit, evidence, proposer_addr, t)
        return block, PartSet.from_data(codec.encode_block(block))

    def _make_block(self, height, state, txs, last_commit, evidence, proposer_addr, t) -> Block:
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
            evidence_hash=merkle.hash_from_byte_slices([e.hash() for e in evidence]),
            proposer_address=proposer_addr,
        )
        return Block(header=header, data=data, evidence=evidence, last_commit=last_commit)

    # --- proposal processing (reference :177) -------------------------

    def process_proposal(self, block: Block, state: State) -> bool:
        req = abci.RequestProcessProposal(
            txs=block.data.txs,
            proposed_last_commit=build_last_commit_info(block.last_commit, state.last_validators),
            misbehavior=evidence_to_misbehavior(block.evidence),
            hash=block.hash(),
            height=block.height,
            time_ns=block.header.time_ns,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )
        return self.proxy.process_proposal(req).is_accepted()

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
        new_state, artifacts = self.apply_hash_persist(state, block_id, block, resp)
        return self.apply_complete(new_state, block_id, block, resp, artifacts)

    def apply_finalize(
        self, state: State, block: Block, verified: bool = False
    ) -> abci.ResponseFinalizeBlock:
        """Phase 1: validate, then ABCI FinalizeBlock."""
        if not verified:
            self.validate_block(state, block)
        req = abci.RequestFinalizeBlock(
            txs=block.data.txs,
            decided_last_commit=build_last_commit_info(block.last_commit, state.last_validators),
            misbehavior=evidence_to_misbehavior(block.evidence),
            hash=block.hash(),
            height=block.height,
            time_ns=block.header.time_ns,
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        )
        resp = self.proxy.finalize_block(req)
        fail_point("exec-after-finalize")  # reference execution.go:313
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
        fail_point("exec-after-save-response")  # :320
        return self._update_state(state, block_id, block, resp, artifacts), artifacts

    def apply_complete(
        self, new_state: State, block_id: BlockID, block: Block, resp, artifacts=None
    ) -> State:
        """Phase 3: the app's Commit, the mempool update, the evidence
        pool's update, pruning and the block's events."""
        self._commit(block, resp)
        if self.evpool:
            self.evpool.update(new_state, block.evidence)
        self._prune()
        self._fire_events(block, block_id, resp, artifacts)
        return new_state

    def _fire_events(self, block, block_id, resp, artifacts=None) -> None:
        if self.event_bus is None:
            return
        new_block_data = {"block": block, "block_id": block_id, "result_events": resp.events}
        if artifacts is not None:
            # the once-flattened/encoded forms, so the indexer and the
            # fan-out never re-walk the attributes (events published
            # without them are flattened by each consumer)
            new_block_data["events_flat"] = artifacts.block_events_flat
            new_block_data["events_enc"] = artifacts.block_events_enc
        self.event_bus.publish_type(ev.EVENT_NEW_BLOCK, new_block_data, height=block.height)
        self.event_bus.publish_type(ev.EVENT_NEW_BLOCK_HEADER, block.header, height=block.height)
        for i, tx in enumerate(block.data.txs):
            data = {"height": block.height, "index": i, "tx": tx, "result": resp.tx_results[i]}
            if artifacts is not None:
                data["tx_hash"] = artifacts.tx_hashes[i]
                data["events_flat"] = artifacts.tx_events_flat[i]
                data["events_enc"] = artifacts.tx_events_enc[i]
                h = artifacts.tx_hashes[i].hex()
            else:
                h = hashlib.sha256(tx).hexdigest()  # bftlint: disable=ASY123 — no-artifacts fallback (replay/tests); the finalize path reuses artifacts.tx_hashes
            self.event_bus.publish_type(ev.EVENT_TX, data, hash=h)
        if resp.validator_updates:
            self.event_bus.publish_type(ev.EVENT_VALIDATOR_SET_UPDATES, resp.validator_updates)

    def apply_verified_block(self, state: State, block_id: BlockID, block: Block) -> State:
        """Skip validation: the commit was verified already (blocksync,
        reference :246)."""
        return self.apply_block(state, block_id, block, verified=True)

    def _commit(self, block: Block, resp) -> None:
        self.mempool.lock()
        try:
            fail_point("exec-before-abci-commit")  # :355
            cres = self.proxy.commit()
            fail_point("exec-after-abci-commit")  # :363
            self.mempool.update(block.height, block.data.txs, resp.tx_results)
            self._retain_height = getattr(cres, "retain_height", 0)
        finally:
            self.mempool.unlock()

    def _prune(self) -> None:
        rh = self._retain_height
        hook = self.retention_hook
        if hook is not None:
            # the retention plane owns pruning: it records the app's
            # retain_height here and deletes on its own cadence, in
            # bounded batches, off this consensus path
            if rh:
                try:
                    hook(rh)
                except Exception:
                    pass
            return
        if rh and self.block_store is not None:
            try:
                self.block_store.prune_blocks(rh)
                self.store.prune_states(rh)
            except Exception:
                pass

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
