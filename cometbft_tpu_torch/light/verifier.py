"""Light client verification (reference light/verifier.go).

A copy of the JAX package's ``light/verifier.py``:

- ``verify_adjacent`` (reference :92): the next header's validator-set
  hash must equal the trusted header's next-validators hash; its commit
  is verified against the new set (2/3).
- ``verify_non_adjacent`` (reference :30): the trusted set must have
  signed with more than the trust level (default 1/3) of its power
  (``verify_commit_light_trusting``), then the new set with 2/3
  (``verify_commit_light``).

Both check commits through the verify scheduler on ``device`` (``None``
= the GPU, which raises without one; ``"cpu"`` = the host plane, or
the kernels' plain versions when the device route is forced), with the
signature cache deduplicating lanes across bisection hops (:57, :72).
Only ``ErrNotEnoughVotingPower`` from the trusting check becomes
``ErrNewValSetCantBeTrusted``, the one error that makes the client
bisect; a failed device route raises as it is. ``engine=`` is the
serving plane's coalescing engine (``light/serving.py``): the commit
checks then join its lane batch, on the engine's device, with the same
verdicts and error types as the direct calls; ``priority=`` is the
verify scheduler's class of the direct calls (None: catch-up).
"""

from __future__ import annotations

import time
from fractions import Fraction
from typing import Optional

from ..device import resolve
from ..types.signature_cache import SignatureCache
from ..types.validation import (
    ErrNotEnoughVotingPower,
    verify_commit_light,
    verify_commit_light_trusting,
)
from ..types.validator_set import ValidatorSet
from .types import LightBlock

DEFAULT_TRUST_LEVEL = Fraction(1, 3)


class LightClientError(Exception):
    pass


class ErrOldHeaderExpired(LightClientError):
    pass


class ErrNewValSetCantBeTrusted(LightClientError):
    pass


class ErrInvalidHeader(LightClientError):
    pass


def _header_expired(h, trusting_period_ns: int, now_ns: int) -> bool:
    return h.time_ns + trusting_period_ns <= now_ns


def verify_adjacent(
    chain_id: str,
    trusted: LightBlock,
    untrusted: LightBlock,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: Optional[int] = None,
    max_clock_drift_ns: int = 10 * 10**9,
    cache: Optional[SignatureCache] = None,
    engine=None,
    priority: Optional[int] = None,
    device=None,
) -> None:
    device = resolve(device)
    now_ns = now_ns or time.time_ns()
    if untrusted.height != trusted.height + 1:
        raise ErrInvalidHeader("headers must be adjacent")
    if _header_expired(trusted.header, trusting_period_ns, now_ns):
        raise ErrOldHeaderExpired("trusted header expired")
    _verify_new_header(chain_id, trusted, untrusted, now_ns, max_clock_drift_ns)
    if untrusted.header.validators_hash != trusted.header.next_validators_hash:
        raise ErrInvalidHeader("untrusted validators hash != trusted next validators hash")
    if engine is not None:
        # cross-client coalesce seam (light/serving.py): concurrent
        # sessions' commit checks land in one lane batch, verdicts
        # serial-equivalent (same exception types as the direct call)
        engine.verify_commit_light(
            untrusted_vals, untrusted.commit.block_id, untrusted.height, untrusted.commit
        )
        return
    verify_commit_light(
        chain_id,
        untrusted_vals,
        untrusted.commit.block_id,
        untrusted.height,
        untrusted.commit,
        cache=cache,
        priority=priority,
        device=device,
    )


def verify_non_adjacent(
    chain_id: str,
    trusted: LightBlock,
    trusted_next_vals: ValidatorSet,
    untrusted: LightBlock,
    untrusted_vals: ValidatorSet,
    trusting_period_ns: int,
    now_ns: Optional[int] = None,
    max_clock_drift_ns: int = 10 * 10**9,
    trust_level: Fraction = DEFAULT_TRUST_LEVEL,
    cache: Optional[SignatureCache] = None,
    engine=None,
    priority: Optional[int] = None,
    device=None,
) -> None:
    device = resolve(device)
    now_ns = now_ns or time.time_ns()
    if untrusted.height == trusted.height + 1:
        raise ErrInvalidHeader("use verify_adjacent for adjacent headers")
    if _header_expired(trusted.header, trusting_period_ns, now_ns):
        raise ErrOldHeaderExpired("trusted header expired")
    _verify_new_header(chain_id, trusted, untrusted, now_ns, max_clock_drift_ns)
    if engine is not None:
        try:
            engine.verify_commit_light_trusting(trusted_next_vals, untrusted.commit, trust_level)
        except ErrNotEnoughVotingPower as e:
            raise ErrNewValSetCantBeTrusted(str(e))
        engine.verify_commit_light(
            untrusted_vals, untrusted.commit.block_id, untrusted.height, untrusted.commit
        )
        return
    try:
        verify_commit_light_trusting(
            chain_id,
            trusted_next_vals,
            untrusted.commit,
            trust_level=trust_level,
            cache=cache,
            priority=priority,
            device=device,
        )
    except ErrNotEnoughVotingPower as e:
        raise ErrNewValSetCantBeTrusted(str(e))
    verify_commit_light(
        chain_id,
        untrusted_vals,
        untrusted.commit.block_id,
        untrusted.height,
        untrusted.commit,
        cache=cache,
        priority=priority,
        device=device,
    )


def _verify_new_header(chain_id, trusted, untrusted, now_ns, max_clock_drift_ns) -> None:
    untrusted.validate_basic(chain_id)
    if untrusted.height <= trusted.height:
        raise ErrInvalidHeader("untrusted height <= trusted height")
    if untrusted.header.time_ns <= trusted.header.time_ns:
        raise ErrInvalidHeader("untrusted time <= trusted time")
    if untrusted.header.time_ns >= now_ns + max_clock_drift_ns:
        raise ErrInvalidHeader("untrusted header from the future")
