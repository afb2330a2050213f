"""Commit verification — the seam every sync path funnels through.

Port of the JAX package's ``types/validation.py`` (reference
types/validation.go): ``verify_commit`` (:30), ``verify_commit_light``
(:65) and the cross-height ``verify_commits_coalesced(_async)``, with
the same error classes and messages. Every multi-signature check
builds one lane batch for the GPU (crypto/batch ``"cuda"`` backend),
which returns per-lane verdicts; light mode only restricts which
signatures are checked (those tallied toward +2/3).

``device`` selects where the batch runs (``None`` = the GPU;
``"cpu"`` = the kernels' plain versions). The priority scheduler of
the JAX package (``crypto/scheduler.py``) is not part of this slice:
batches go straight to ``crypto/batch``.
"""

from __future__ import annotations

from typing import Optional

from ..crypto import batch as crypto_batch
from ..device import resolve
from .block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit
from .canonical import PRECOMMIT_TYPE, finish_vote_sign_bytes, vote_sign_bytes_parts
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


def _run_batch_async(items, cache: Optional[SignatureCache], device=None):
    """items: list of (pubkey, sign_bytes, sig). Lanes already in the
    cache are skipped; the rest go to the batch backend as one
    dispatch. Returns a handle whose ``result()`` yields list[bool]."""
    to_verify = []
    bv = None
    for i, (pk, sb, sig) in enumerate(items):
        if cache is not None and cache.contains(sb, sig, pk.key_bytes):
            continue
        if bv is None:
            bv = crypto_batch.create_batch_verifier(device=device)
        bv.add(pk, sb, sig)
        to_verify.append(i)
    pending = bv.verify_async() if bv is not None else None
    return _BatchHandle(items, to_verify, pending, cache)


class _BatchHandle:
    """``result()`` resolves the dispatch, fills verdicts over the
    cache-skipped lanes, and feeds verified signatures to the cache."""

    __slots__ = ("_items", "_to_verify", "_pending", "_cache")

    def __init__(self, items, to_verify, pending, cache) -> None:
        self._items = items
        self._to_verify = to_verify
        self._pending = pending
        self._cache = cache

    def result(self):
        items, cache = self._items, self._cache
        oks = [True] * len(items)
        if self._pending is not None:
            _, verdicts = self._pending.result()
            for i, ok in zip(self._to_verify, verdicts):
                oks[i] = ok
                if ok and cache is not None:
                    pk, sb, sig = items[i]
                    cache.add(sb, sig, pk.key_bytes)
        return oks


def _run_batch(items, cache: Optional[SignatureCache], device=None):
    if not items:
        return []
    return _run_batch_async(items, cache, device).result()


def verify_commit(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    cache: Optional[SignatureCache] = None,
    device=None,
) -> None:
    """Full verification: every non-absent signature must be valid
    (nil votes included), and >2/3 of power must have signed block_id
    (reference types/validation.go:30)."""
    device = resolve(device)
    _basic_checks(vals, commit, height, block_id)
    items = []
    tally_idx = []
    for i, cs in enumerate(commit.signatures):
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
    oks = _run_batch(items, cache, device)
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


def verify_commit_light(
    chain_id: str,
    vals: ValidatorSet,
    block_id: BlockID,
    height: int,
    commit: Commit,
    cache: Optional[SignatureCache] = None,
    all_signatures: bool = False,
    device=None,
) -> None:
    """Light verification: only signatures for block_id are checked,
    and tallied up to the 2/3 threshold (reference :65;
    all_signatures=True checks every block signature, reference :96)."""
    device = resolve(device)
    _basic_checks(vals, commit, height, block_id)
    total = vals.total_voting_power()
    items = []
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
            break
    oks = _run_batch(items, cache, device)
    tallied = 0
    for lane, i in lanes:
        if not oks[lane]:
            raise ErrInvalidSignature(f"invalid signature for validator {i}")
        tallied += vals.get_by_index(i).voting_power
    if not tallied * 3 > total * 2:
        raise ErrNotEnoughVotingPower(f"tallied {tallied} <= 2/3 of {total}")


def verify_commits_coalesced_async(
    chain_id: str,
    jobs,
    cache: Optional[SignatureCache] = None,
    light: bool = True,
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
    batch_handle = _run_batch_async(items, cache, device)
    return _CoalescedHandle(batch_handle, jobs, job_lanes, errors)


class _CoalescedHandle:
    """``result()`` folds the lane verdicts back into per-job errors."""

    __slots__ = ("_batch", "_jobs", "_job_lanes", "_errors")

    def __init__(self, batch, jobs, job_lanes, errors) -> None:
        self._batch = batch
        self._jobs = jobs
        self._job_lanes = job_lanes
        self._errors = errors

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
    device=None,
) -> list:
    """Verify MANY commits in one GPU dispatch (cross-height
    coalescing): one None or CommitVerifyError per job."""
    return verify_commits_coalesced_async(
        chain_id, jobs, cache=cache, light=light, device=device
    ).result()
