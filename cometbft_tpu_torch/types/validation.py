"""Commit verification — the seam every sync path funnels through.

Port of the JAX package's ``types/validation.py`` (reference
types/validation.go): ``verify_commit`` (:30), ``verify_commit_light``
(:65), ``verify_commit_light_trusting`` (:148), their ``_awaited``
forms awaited on an event loop, the cross-height
``verify_commits_coalesced(_async)``, the mixed light/trusting
``verify_commit_jobs_coalesced`` and ``verify_extended_commit``, with
the same error classes and messages. Every multi-signature check
builds one lane batch and submits it to the verify scheduler
(``crypto/scheduler.py``) under the caller's priority class — live >
light > catch-up/evidence (the default) — which routes it to the GPU
kernels or to the multi-core host plane by the measured crossover.
Light mode only restricts which signatures are checked (those tallied
toward the threshold).

``device`` selects where the batch may run (``None`` = the GPU, and
raises without one; ``"cpu"`` = the host plane, or the kernels' plain
versions when the device route is forced).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional

from ..crypto import scheduler as crypto_sched
from ..crypto.scheduler import (  # re-exported: consumers pass these
    PRIORITY_CATCHUP,
    PRIORITY_LIGHT,
    PRIORITY_LIVE,
)
from ..device import resolve
from .block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit
from .canonical import (
    PRECOMMIT_TYPE,
    finish_vote_sign_bytes,
    vote_extension_sign_bytes,
    vote_sign_bytes_parts,
)
from .signature_cache import SignatureCache
from .validator_set import ValidatorSet


class CommitVerifyError(Exception):
    pass


class ErrNotEnoughVotingPower(CommitVerifyError):
    pass


class ErrInvalidSignature(CommitVerifyError):
    pass


def _commit_sign_bytes(chain_id: str, commit: Commit, cs) -> bytes:
    """Sign bytes of one CommitSig, memoized on the commit per (flag
    class, timestamp): signatures sharing a timestamp encode once."""
    parts = getattr(commit, "_sb_parts", None)
    if parts is None:
        parts = {}
        commit._sb_parts = parts
    flag_commit = cs.block_id_flag == BLOCK_ID_FLAG_COMMIT
    key = (chain_id, flag_commit, cs.timestamp_ns)
    sb = parts.get(key)
    if sb is None:
        pkey = (chain_id, flag_commit)
        ps = parts.get(pkey)
        if ps is None:
            ps = vote_sign_bytes_parts(
                chain_id,
                PRECOMMIT_TYPE,
                commit.height,
                commit.round,
                cs.block_id(commit.block_id),
            )
            parts[pkey] = ps
        sb = finish_vote_sign_bytes(ps[0], ps[1], cs.timestamp_ns)
        parts[key] = sb
    return sb


def _basic_checks(
    vals: ValidatorSet, commit: Commit, height: int, block_id: Optional[BlockID]
) -> None:
    if commit is None:
        raise CommitVerifyError("nil commit")
    if vals.size() != commit.size():
        raise CommitVerifyError(
            f"validator set size {vals.size()} != commit size {commit.size()}"
        )
    if height != commit.height:
        raise CommitVerifyError(
            f"height {height} != commit height {commit.height}"
        )
    if block_id is not None and block_id.key() != commit.block_id.key():
        raise CommitVerifyError("wrong BlockID in commit")


def _run_batch_async(
    items,
    cache: Optional[SignatureCache],
    priority: Optional[int] = None,
    label: str = "",
    device=None,
):
    """items: list of (pubkey, sign_bytes, sig). Lanes already in the
    cache are skipped; the rest go to the verify scheduler as ONE
    ticket under ``priority`` (default catch-up) on ``device``.
    Returns a handle whose ``result()`` yields list[bool]; the ticket
    is pending on either route, so the caller's host work overlaps
    the verification."""
    to_verify = []
    lanes = []
    for i, item in enumerate(items):
        pk, sb, sig = item
        if cache is not None and cache.contains(sb, sig, pk.key_bytes):
            continue
        lanes.append(item)
        to_verify.append(i)
    pending = (
        crypto_sched.scheduler().submit(
            lanes,
            priority=PRIORITY_CATCHUP if priority is None else priority,
            label=label,
            device=device,
        )
        if lanes
        else None
    )
    return _BatchHandle(items, to_verify, pending, cache)


class _BatchHandle:
    """``result()`` resolves the ticket, fills verdicts over the
    cache-skipped lanes, and feeds verified signatures to the cache."""

    __slots__ = ("_items", "_to_verify", "_pending", "_cache")

    def __init__(self, items, to_verify, pending, cache) -> None:
        self._items = items
        self._to_verify = to_verify
        self._pending = pending
        self._cache = cache

    @property
    def tickets(self):
        """The scheduler tickets behind the verdicts (none when every
        lane was cached)."""
        return () if self._pending is None else (self._pending,)

    def result(self, timeout: Optional[float] = None):
        """``timeout`` bounds the wait on the ticket (``TimeoutError``
        past it); None waits for the scheduler to resolve it."""
        items, cache = self._items, self._cache
        oks = [True] * len(items)
        if self._pending is not None:
            _, verdicts = self._pending.result(timeout)
            for i, ok in zip(self._to_verify, verdicts):
                oks[i] = ok
                if ok and cache is not None:
                    pk, sb, sig = items[i]
                    cache.add(sb, sig, pk.key_bytes)
        return oks


def _run_batch(
    items,
    cache: Optional[SignatureCache],
    priority: Optional[int] = None,
    label: str = "",
    device=None,
    timeout: Optional[float] = None,
):
    """items: list of (pubkey, sign_bytes, sig). Returns list[bool]."""
    if not items:
        return []
    return _run_batch_async(items, cache, priority, label, device).result(timeout)


async def _run_batch_awaited(
    items,
    cache: Optional[SignatureCache],
    priority: Optional[int] = None,
    label: str = "",
    device=None,
):
    """``_run_batch`` with the ticket awaited on the running event
    loop: neither the loop nor a thread waits on the card."""
    if not items:
        return []
    handle = _run_batch_async(items, cache, priority, label, device)
    for ticket in handle.tickets:
        await crypto_sched.resolved(ticket)
    return handle.result()


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    cache: Optional[SignatureCache] = None,
    priority: Optional[int] = None,
    device=None,
) -> None:
    """Full verification: every non-absent signature must be valid
    (nil votes included), and >2/3 of power must have signed block_id
    (reference types/validation.go:30)."""
    device = resolve(device)
    _basic_checks(vals, commit, height, block_id)
    items = []
    tally_idx = []
    for i, cs in enumerate(commit.signatures):  # bftlint: disable=ASY117 — verifying an O(V) commit payload is O(V) by construction; once per commit received, curve math batch-verified via the lane cache
        if cs.is_absent():
            continue
        val = vals.get_by_index(i)
        if val.address != cs.validator_address:
            raise CommitVerifyError(
                f"commit sig {i} address mismatch with validator set"
            )
        items.append(
            (val.pub_key, _commit_sign_bytes(chain_id, commit, cs), cs.signature)
        )
        tally_idx.append(i)
    oks = _run_batch(items, cache, priority, "commit", device)
    tallied = 0
    for i, ok in zip(tally_idx, oks):
        if not ok:
            raise ErrInvalidSignature(f"invalid signature for validator {i}")
        if commit.signatures[i].for_block():
            tallied += vals.get_by_index(i).voting_power
    if not tallied * 3 > vals.total_voting_power() * 2:
        raise ErrNotEnoughVotingPower(
            f"tallied {tallied} <= 2/3 of {vals.total_voting_power()}"
        )


def _collect_light_lanes(
    chain_id: str,
    vals: ValidatorSet,
    block_id: Optional[BlockID],
    height: int,
    commit: Commit,
    all_signatures: bool,
    items: list,
) -> list:
    """Lane collection for LIGHT verification, shared by the serial and
    the coalesced paths so their verdicts cannot drift. Appends
    (pubkey, sign_bytes, sig) lanes to ``items``; returns
    [(lane_idx, validator_idx)]. Raises CommitVerifyError on
    structural failures."""
    _basic_checks(vals, commit, height, block_id)
    total = vals.total_voting_power()
    lanes = []
    tallied_known = 0
    for i, cs in enumerate(commit.signatures):
        if not cs.for_block():
            continue
        val = vals.get_by_index(i)
        if val.address != cs.validator_address:
            raise CommitVerifyError(f"commit sig {i} address mismatch")
        lanes.append((len(items), i))
        items.append(
            (val.pub_key, _commit_sign_bytes(chain_id, commit, cs), cs.signature)
        )
        tallied_known += val.voting_power
        if not all_signatures and tallied_known * 3 > total * 2:
            break  # enough power collected; verify just these lanes
    return lanes


def _fold_light_lanes(lanes: list, oks: list, vals: ValidatorSet, commit: Commit) -> None:
    """Tally/verdict fold for LIGHT verification."""
    tallied = 0
    for lane, i in lanes:
        if not oks[lane]:
            raise ErrInvalidSignature(f"invalid signature for validator {i}")
        if commit.signatures[i].for_block():
            tallied += vals.get_by_index(i).voting_power
    total = vals.total_voting_power()
    if not tallied * 3 > total * 2:
        raise ErrNotEnoughVotingPower(f"tallied {tallied} <= 2/3 of {total}")


def _collect_trusting_lanes(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction,
    all_signatures: bool,
    items: list,
):
    """Lane collection for TRUSTING verification (see
    _collect_light_lanes). Returns ([(lane_idx, voting_power)], total,
    need)."""
    if commit is None:
        raise CommitVerifyError("nil commit")
    if trust_level.numerator * 3 < trust_level.denominator or (
        trust_level.numerator > trust_level.denominator
    ):
        raise CommitVerifyError("trust level must be in [1/3, 1]")
    total = vals.total_voting_power()
    need = total * trust_level.numerator
    lanes = []
    seen = set()
    tallied_known = 0
    for cs in commit.signatures:
        if not cs.for_block():
            continue
        idx, val = vals.get_by_address(cs.validator_address)
        if idx < 0:
            continue
        if idx in seen:
            raise CommitVerifyError("double vote from same validator")
        seen.add(idx)
        lanes.append((len(items), val.voting_power))
        items.append(
            (val.pub_key, _commit_sign_bytes(chain_id, commit, cs), cs.signature)
        )
        tallied_known += val.voting_power
        if not all_signatures and tallied_known * trust_level.denominator > need:
            break
    return lanes, total, need


def _fold_trusting_lanes(lanes: list, oks: list, total, need, trust_level: Fraction) -> None:
    """Tally/verdict fold for TRUSTING verification."""
    tallied = 0
    for lane, power in lanes:
        if not oks[lane]:
            raise ErrInvalidSignature("invalid signature in trusted commit")
        tallied += power
    if not tallied * trust_level.denominator > need:
        raise ErrNotEnoughVotingPower(
            f"trusted tally {tallied} <= {trust_level} of {total}"
        )


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    cache: Optional[SignatureCache] = None,
    all_signatures: bool = False,
    priority: Optional[int] = None,
    device=None,
) -> None:
    """Light verification: only signatures for block_id are checked,
    and tallied up to the 2/3 threshold (reference :65;
    all_signatures=True checks every block signature, reference :96)."""
    device = resolve(device)
    items: list = []
    lanes = _collect_light_lanes(
        chain_id, vals, block_id, height, commit, all_signatures, items
    )
    oks = _run_batch(items, cache, priority, "light", device)
    _fold_light_lanes(lanes, oks, vals, commit)


async def verify_commit_light_awaited(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    cache: Optional[SignatureCache] = None,
    all_signatures: bool = False,
    priority: Optional[int] = None,
    device=None,
) -> None:
    """``verify_commit_light`` awaited on the running event loop."""
    device = resolve(device)
    items: list = []
    lanes = _collect_light_lanes(
        chain_id, vals, block_id, height, commit, all_signatures, items
    )
    oks = await _run_batch_awaited(items, cache, priority, "light", device)
    _fold_light_lanes(lanes, oks, vals, commit)


def verify_commits_coalesced_async(
    chain_id: str,
    jobs,
    cache: Optional[SignatureCache] = None,
    light: bool = True,
    priority: Optional[int] = None,
    device=None,
):
    """Enqueue ONE lane batch for every job's signatures; ``result()``
    blocks for the verdicts and returns the per-job error list. jobs:
    list of (vals, block_id, height, commit)."""
    device = resolve(device)
    items = []
    job_lanes = []
    errors: list = [None] * len(jobs)
    for j, (vals, block_id, height, commit) in enumerate(jobs):
        lanes = []
        try:
            _basic_checks(vals, commit, height, block_id)
            total = vals.total_voting_power()
            tallied_known = 0
            for i, cs in enumerate(commit.signatures):
                want = cs.for_block() if light else not cs.is_absent()
                if not want:
                    continue
                val = vals.get_by_index(i)
                if val.address != cs.validator_address:
                    raise CommitVerifyError(f"commit sig {i} address mismatch")
                lanes.append((len(items), i))
                items.append(
                    (
                        val.pub_key,
                        _commit_sign_bytes(chain_id, commit, cs),
                        cs.signature,
                    )
                )
                if light and cs.for_block():
                    tallied_known += val.voting_power
                    if tallied_known * 3 > total * 2:
                        break
        except CommitVerifyError as e:
            errors[j] = e
            lanes = []
        job_lanes.append(lanes)
    batch_handle = _run_batch_async(items, cache, priority, "coalesced", device)
    return _CoalescedHandle(batch_handle, jobs, job_lanes, errors)


class _CoalescedHandle:
    """``result()`` folds the lane verdicts back into per-job errors."""

    __slots__ = ("_batch", "_jobs", "_job_lanes", "_errors")

    def __init__(self, batch, jobs, job_lanes, errors) -> None:
        self._batch = batch
        self._jobs = jobs
        self._job_lanes = job_lanes
        self._errors = errors

    @property
    def tickets(self):
        return self._batch.tickets

    def result(self):
        oks = self._batch.result()
        errors = self._errors
        for j, (vals, block_id, height, commit) in enumerate(self._jobs):
            if errors[j] is not None:
                continue
            tallied = 0
            bad = None
            for lane, i in self._job_lanes[j]:
                if not oks[lane]:
                    bad = ErrInvalidSignature(
                        f"invalid signature for validator {i} at height {height}"
                    )
                    break
                if commit.signatures[i].for_block():
                    tallied += vals.get_by_index(i).voting_power
            if bad is not None:
                errors[j] = bad
            elif not tallied * 3 > vals.total_voting_power() * 2:
                errors[j] = ErrNotEnoughVotingPower(
                    f"height {height}: tallied {tallied} <= 2/3"
                )
        return errors


def verify_commits_coalesced(
    chain_id: str,
    jobs,
    cache: Optional[SignatureCache] = None,
    light: bool = True,
    priority: Optional[int] = None,
    device=None,
) -> list:
    """Verify MANY commits in one lane batch (cross-height
    coalescing): one None or CommitVerifyError per job."""
    return verify_commits_coalesced_async(
        chain_id, jobs, cache=cache, light=light, priority=priority, device=device
    ).result()


def verify_commit_jobs_coalesced(
    chain_id: str,
    jobs,
    cache: Optional[SignatureCache] = None,
    priority: Optional[int] = None,
    device=None,
    timeout: Optional[float] = None,
) -> list:
    """Mixed-kind coalesced verification: many light and trusting
    commit checks in ONE lane batch (a light client's bisection hop is
    one trusting and one light check).

    jobs: list of either
        ("light", vals, block_id, height, commit)
        ("trusting", vals, commit, trust_level)

    Returns one entry per job: None or the exact CommitVerifyError the
    serial path raises — collection and fold run the same helpers as
    verify_commit_light and verify_commit_light_trusting, over one
    shared lane batch. ``timeout`` bounds the wait on the batch's
    ticket (``TimeoutError`` past it: no verdict)."""
    device = resolve(device)
    items: list = []
    metas: list = []
    errors: list = [None] * len(jobs)
    for j, job in enumerate(jobs):
        kind = job[0]
        try:
            if kind == "light":
                _, vals, block_id, height, commit = job
                lanes = _collect_light_lanes(
                    chain_id, vals, block_id, height, commit, False, items
                )
                metas.append(("light", lanes, vals, commit))
            elif kind == "trusting":
                _, vals, commit, trust_level = job
                lanes, total, need = _collect_trusting_lanes(
                    chain_id, vals, commit, trust_level, False, items
                )
                metas.append(("trusting", lanes, total, need, trust_level))
            else:
                raise CommitVerifyError(f"unknown job kind {kind!r}")
        except CommitVerifyError as e:
            errors[j] = e
            metas.append(None)
    oks = _run_batch(items, cache, priority, "jobs", device, timeout)
    for j, meta in enumerate(metas):
        if meta is None:
            continue
        try:
            if meta[0] == "light":
                _, lanes, vals, commit = meta
                _fold_light_lanes(lanes, oks, vals, commit)
            else:
                _, lanes, total, need, trust_level = meta
                _fold_trusting_lanes(lanes, oks, total, need, trust_level)
        except CommitVerifyError as e:
            errors[j] = e
    return errors


def verify_commit_light_trusting(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction = Fraction(1, 3),
    cache: Optional[SignatureCache] = None,
    all_signatures: bool = False,
    priority: Optional[int] = None,
    device=None,
) -> None:
    """Trusting verification against an OLD validator set: tally the
    power of trusted validators who signed; require > trust_level of
    the trusted total (reference :148; light bisection, evidence)."""
    device = resolve(device)
    items: list = []
    lanes, total, need = _collect_trusting_lanes(
        chain_id, vals, commit, trust_level, all_signatures, items
    )
    oks = _run_batch(items, cache, priority, "trusting", device)
    _fold_trusting_lanes(lanes, oks, total, need, trust_level)


async def verify_commit_light_trusting_awaited(
    chain_id: str,
    vals: ValidatorSet,
    commit: Commit,
    trust_level: Fraction = Fraction(1, 3),
    cache: Optional[SignatureCache] = None,
    all_signatures: bool = False,
    priority: Optional[int] = None,
    device=None,
) -> None:
    """``verify_commit_light_trusting`` awaited on the running event
    loop."""
    device = resolve(device)
    items: list = []
    lanes, total, need = _collect_trusting_lanes(
        chain_id, vals, commit, trust_level, all_signatures, items
    )
    oks = await _run_batch_awaited(items, cache, priority, "trusting", device)
    _fold_trusting_lanes(lanes, oks, total, need, trust_level)


def verify_extended_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_hash: bytes,
    height: int,
    ec,
    cache: Optional[SignatureCache] = None,
    priority: Optional[int] = None,
    device=None,
) -> None:
    """Full extended-commit verification (the checks guarding the
    reference's SaveBlockWithExtendedCommit, blocksync/reactor.go:648):

      * the extended commit binds to this height and block hash;
      * the embedded plain commit fully verifies against ``vals``;
      * non-commit lanes carry no extension data;
      * every commit lane has an extension signature, and all of them
        verify in one batch.

    Raises CommitVerifyError on any failure.
    """
    device = resolve(device)
    if ec.height != height or ec.block_id.hash != block_hash:
        raise CommitVerifyError("extended commit does not bind to block")
    verify_commit(
        chain_id, vals, ec.block_id, height, ec.to_commit(),
        cache=cache, priority=priority, device=device,
    )
    items = []
    for i, s in enumerate(ec.extended_signatures):  # bftlint: disable=ASY117 — verifying an O(V) commit payload is O(V) by construction; runs once per commit-block received and the curve math is batch-verified
        if not s.for_block():
            if s.extension or s.extension_signature:
                raise CommitVerifyError(f"sig {i}: extension data on non-commit lane")
            continue
        if not s.extension_signature:
            raise CommitVerifyError(f"commit sig {i} missing extension signature")
        val = vals.get_by_index(i)
        items.append(
            (
                val.pub_key,
                vote_extension_sign_bytes(chain_id, height, ec.round, s.extension),
                s.extension_signature,
            )
        )
    if not all(_run_batch(items, cache, priority, "extension", device)):
        raise CommitVerifyError("invalid extension signature")
