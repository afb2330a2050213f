"""Evidence pool: verify, store and hand out misbehavior for the app to
slash (reference evidence/pool.go, evidence/verify.go).

A copy of the JAX package's ``evidence/pool.py``, with the same checks,
errors and keys (``EV:pend:`` for pending evidence, ``EV:comm:`` for
committed markers valued by the committing height):

- duplicate-vote evidence: both votes' signatures checked on the host
  against the validator set at that height (``Vote.verify``);
- light-client-attack evidence: the conflicting block checked for
  internal consistency and for conflict with the local chain, then its
  commit by ``types.validation.verify_commit_light_trusting`` against
  the common validator set and ``verify_commit_light`` against its own
  set, every signature, at ``PRIORITY_CATCHUP`` on the pool's
  ``device`` (None is the GPU, and raises without one; ``"cpu"`` the
  host plane or the plain kernels), and the claimed byzantine set and
  total power against those derived from the common set.

``add_evidence_awaited`` and ``verify_awaited`` are the forms for a
caller on an event loop (the evidence reactor, ``Node.add_evidence``):
the same checks, with the commit checks' tickets awaited there instead
of waited on.

A failed verify route is no verdict (ROADMAP C3): the scheduler's
``DeviceRouteError`` leaves ``verify`` and ``add_evidence`` (and their
awaited forms) as it is,
never as an ``EvidenceError``, and nothing is recorded, so the caller
can offer the same evidence again once the card works
(``evidence/reactor.py`` does).
"""

from __future__ import annotations

import threading
from typing import List

from ..crypto.scheduler import PRIORITY_CATCHUP
from ..device import resolve
from ..types.validation import (
    verify_commit_light,
    verify_commit_light_awaited,
    verify_commit_light_trusting,
    verify_commit_light_trusting_awaited,
)
from ..utils import kv
from .types import DuplicateVoteEvidence, LightClientAttackEvidence

PENDING_PREFIX = b"EV:pend:"
COMMITTED_PREFIX = b"EV:comm:"


class EvidenceError(Exception):
    pass


class EvidencePool:
    def __init__(self, db: kv.KV, state_store, block_store, device=None):
        self.db = db
        self.state_store = state_store
        self.block_store = block_store
        # where the light-client-attack commit checks run; resolved at
        # each check, as the block executor's device is
        self.device = device
        self._lock = threading.RLock()
        self._pending: dict = {}
        self._committed: set = set()
        self._broadcast_hooks: List = []

    def add_broadcast_hook(self, fn) -> None:
        self._broadcast_hooks.append(fn)

    # --- ingress ------------------------------------------------------

    def add_evidence(self, ev) -> None:
        with self._lock:
            if self._known(ev.hash()):
                return
            self.verify(ev)
            self._admit(ev)
        self._broadcast(ev)

    async def add_evidence_awaited(self, ev) -> None:
        """``add_evidence`` for a caller on an event loop: the
        light-client-attack commit checks are awaited there, so neither
        the loop nor a thread waits on the card."""
        if self._known(ev.hash()):
            return
        await self.verify_awaited(ev)
        with self._lock:
            if self._known(ev.hash()):
                return  # another caller admitted it meanwhile
            self._admit(ev)
        self._broadcast(ev)

    def _known(self, key: bytes) -> bool:
        with self._lock:
            return key in self._pending or key in self._committed

    def _admit(self, ev) -> None:
        key = ev.hash()
        self._pending[key] = ev
        self.db.set(PENDING_PREFIX + key, ev.encode())

    def _broadcast(self, ev) -> None:
        for fn in self._broadcast_hooks:
            try:
                fn(ev)
            except Exception:
                pass

    def verify(self, ev) -> None:
        state = self._state_for(ev)
        if isinstance(ev, DuplicateVoteEvidence):
            self._verify_duplicate_vote(ev, state)
            return
        common_vals = self._lca_conflict(ev, state)
        lb, device = ev.conflicting_block, resolve(self.device)
        # trusting verification against the common set, then full
        # verification by the conflicting block's own set
        verify_commit_light_trusting(
            state.chain_id, common_vals, lb.commit, all_signatures=True,
            priority=PRIORITY_CATCHUP, device=device,
        )
        verify_commit_light(
            state.chain_id, lb.validator_set, lb.commit.block_id, lb.height, lb.commit,
            all_signatures=True, priority=PRIORITY_CATCHUP, device=device,
        )
        self._lca_byzantine(ev, common_vals)

    async def verify_awaited(self, ev) -> None:
        """``verify`` with the commit checks awaited on the running
        event loop: the same checks in the same order."""
        state = self._state_for(ev)
        if isinstance(ev, DuplicateVoteEvidence):
            self._verify_duplicate_vote(ev, state)
            return
        common_vals = self._lca_conflict(ev, state)
        lb, device = ev.conflicting_block, resolve(self.device)
        await verify_commit_light_trusting_awaited(
            state.chain_id, common_vals, lb.commit, all_signatures=True,
            priority=PRIORITY_CATCHUP, device=device,
        )
        await verify_commit_light_awaited(
            state.chain_id, lb.validator_set, lb.commit.block_id, lb.height, lb.commit,
            all_signatures=True, priority=PRIORITY_CATCHUP, device=device,
        )
        self._lca_byzantine(ev, common_vals)

    def _state_for(self, ev):
        """The state ``ev`` is judged by, after the checks every kind
        of evidence shares."""
        state = self.state_store.load()
        if state is None:
            raise EvidenceError("no state")
        params = state.consensus_params.evidence
        age_blocks = state.last_block_height - ev.height()
        if age_blocks > params.max_age_num_blocks:
            raise EvidenceError("evidence too old (blocks)")
        if not isinstance(ev, (DuplicateVoteEvidence, LightClientAttackEvidence)):
            raise EvidenceError("unknown evidence type")
        return state

    def _verify_duplicate_vote(self, ev: DuplicateVoteEvidence, state) -> None:
        ev.validate_basic()
        vals = self.state_store.load_validators(ev.height())
        if vals is None:
            if state.validators is None:
                raise EvidenceError("no validators for evidence height")
            vals = state.validators
        _, val = vals.get_by_address(ev.vote_a.validator_address)
        if val is None:
            raise EvidenceError("validator not found for evidence")
        for v in (ev.vote_a, ev.vote_b):
            if not v.verify(state.chain_id, val.pub_key):
                raise EvidenceError("invalid signature on evidence vote")
        if ev.validator_power and ev.validator_power != val.voting_power:
            raise EvidenceError("evidence validator power mismatch")

    def _lca_conflict(self, ev: LightClientAttackEvidence, state):
        """The host checks before the commit checks; the common
        validator set."""
        ev.validate_basic()
        common_vals = self.state_store.load_validators(ev.common_height)
        if common_vals is None:
            raise EvidenceError("no validators at common height")
        lb = ev.conflicting_block
        # internally consistent (reference LightBlock.ValidateBasic,
        # types/evidence.go:385): a genuine commit under a fabricated
        # header would otherwise slash the honest signers
        try:
            lb.validate_basic(state.chain_id)
        except ValueError as e:
            raise EvidenceError(f"invalid conflicting light block: {e}")
        if ev.common_height > lb.height:
            raise EvidenceError("common height is ahead of the conflicting block")
        # it must conflict with our chain, at a height we can compare:
        # the real chain is no attack, and a lagging node refuses (the
        # reporter's gossip offers it again once we catch up)
        ours = self.block_store.load_block_meta(lb.height)
        if ours is None:
            raise EvidenceError(
                f"cannot judge conflict at height {lb.height}: block not yet available locally"
            )
        if bytes(ours.block_id.hash) == bytes(lb.hash()):
            raise EvidenceError("conflicting block matches our own chain (no attack)")
        return common_vals

    @staticmethod
    def _lca_byzantine(ev: LightClientAttackEvidence, common_vals) -> None:
        # the slashing targets are derived here, never taken from the
        # wire (reference evidence/verify.go:124-136)
        expected = ev.byzantine_from(common_vals)
        if [v.address for v in ev.byzantine_validators] != [v.address for v in expected]:
            raise EvidenceError("byzantine validators do not match the derived set")
        for claimed, exp in zip(ev.byzantine_validators, expected):
            if claimed.voting_power != exp.voting_power:
                raise EvidenceError("byzantine validator power mismatch")
        if ev.total_voting_power != common_vals.total_voting_power():
            raise EvidenceError("evidence total voting power mismatch")

    # --- egress -------------------------------------------------------

    def pending_evidence(self, max_bytes: int) -> List:
        with self._lock:
            out, total = [], 0
            for ev in self._pending.values():
                sz = len(ev.encode())
                if total + sz > max_bytes:
                    break
                out.append(ev)
                total += sz
            return out

    def check_evidence(self, evidence: List) -> None:
        """Validate a block's evidence list (reference CheckEvidence)."""
        seen = set()
        for ev in evidence:
            key = ev.hash()
            if key in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(key)
            with self._lock:
                if key in self._committed:
                    raise EvidenceError("evidence already committed")
                known = key in self._pending
            if not known:
                self.verify(ev)

    def update(self, state, block_evidence: List) -> None:
        with self._lock:
            for ev in block_evidence:
                key = ev.hash()
                self._committed.add(key)
                # the committing height: prune_below ages markers out
                # without decoding evidence
                self.db.set(COMMITTED_PREFIX + key, state.last_block_height.to_bytes(8, "big"))
                if key in self._pending:
                    del self._pending[key]
                    self.db.delete(PENDING_PREFIX + key)
            max_age = state.consensus_params.evidence.max_age_num_blocks
            for key, ev in list(self._pending.items()):
                if state.last_block_height - ev.height() > max_age:
                    del self._pending[key]
                    self.db.delete(PENDING_PREFIX + key)

    def prune_below(self, height: int) -> int:
        """Drop committed-evidence markers below ``height``, clamped so
        nothing inside the evidence max-age window goes (a marker there
        is what stops a committed duplicate from being proposed again);
        one batch. Markers without a height are kept."""
        state = self.state_store.load()
        if state is not None:
            max_age = state.consensus_params.evidence.max_age_num_blocks
            height = min(height, state.last_block_height - max_age)
        if height <= 0:
            return 0
        with self._lock:
            deletes = []
            for k, v in self.db.iter_prefix(COMMITTED_PREFIX):
                h = int.from_bytes(v, "big") if len(v) == 8 else 0
                if h and h < height:
                    deletes.append(k)
            if deletes:
                self.db.write_batch([], deletes)
                for k in deletes:
                    self._committed.discard(k[len(COMMITTED_PREFIX):])
        return len(deletes)

    def size(self) -> int:
        with self._lock:
            return len(self._pending)
