"""Light client: trust-minimized header sync with bisection.

The port of the JAX package's ``light/client.py`` (reference
light/client.go): sequential and skipping verification with the 9/16
bisection split (:29-32), backwards verification below the trust
root, trust-root resumption from a persisted store, a trusted store of
verified light blocks, the witness lifecycle and cross-checks
(``detector.py``), pruning.

Every hop's commit checks go through the verify scheduler on the
client's ``device`` (``None`` = the GPU, which raises without one;
``"cpu"`` = the host plane), and the signature cache carries the
overlap between hops: a 50,000-height bisection verifies only the new
(validator, height) pairs.

Departure from the JAX package (ROADMAP C3): the JAX client turns any
failure of the trust-root re-anchoring into a refused root; here a
failed verify route (``DeviceRouteError``, whatever its cause) raises
as it is, and every other failure is a refusal, as there.

The serving plane's seams (``light/serving.py``): ``header_cache``, a
shared ``VerifiedHeaderCache`` consulted before fetching or verifying
and published to only after the witness cross-check; ``verify_engine``,
the ``CoalescedCommitVerifier`` the skipping hops batch through; and
``priority``, the verify scheduler's class of this client's checks. A
client with none of them runs its checks in the catch-up class, on its
own tickets.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from fractions import Fraction
from typing import List, Optional

from ..crypto.scheduler import DeviceRouteError
from ..device import resolve
from ..types.signature_cache import SignatureCache
from ..types.validation import verify_commit_light
from ..types.validator_set import ValidatorSet
from ..utils.log import get_logger
from . import verifier
from .provider import LightBlockNotFound, Provider, ProviderError
from .store import LightStore
from .types import LightBlock

_log = get_logger("light")

SEQUENTIAL = "sequential"
SKIPPING = "skipping"

# bisection split: 9/16 of the gap (reference light/client.go:29-32)
BISECT_NUM = 9
BISECT_DEN = 16


@dataclass
class TrustOptions:
    period_ns: int
    height: int
    hash: bytes


class LightClientError(Exception):
    pass


class Client:
    def __init__(
        self,
        chain_id: str,
        trust_options: TrustOptions,
        primary: Provider,
        witnesses: Optional[List[Provider]] = None,
        store: Optional[LightStore] = None,
        verification_mode: str = SKIPPING,
        trust_level: Fraction = verifier.DEFAULT_TRUST_LEVEL,
        max_clock_drift_ns: int = 10 * 10**9,
        signature_cache: Optional[SignatureCache] = None,
        header_cache=None,
        verify_engine=None,
        priority: Optional[int] = None,
        device=None,
    ):
        self.device = resolve(device)
        self.chain_id = chain_id
        self.trust = trust_options
        self.primary = primary
        self.witnesses = witnesses or []
        # witness lifecycle state: consecutive-failure strikes per
        # provider, and whether the operator configured witnesses at
        # all (an emptied set is then an error, not a silent decay)
        self._witness_strikes: dict = {}
        self._had_witnesses = bool(self.witnesses)
        # identity check, NOT truthiness: an EMPTY persistent store
        # (fresh light home) is falsy via __len__ and `store or ...`
        # would silently discard it
        self.store = LightStore() if store is None else store
        self.mode = verification_mode
        self.trust_level = trust_level
        self.drift = max_clock_drift_ns
        self.cache = signature_cache or SignatureCache()
        # cross-client serving seams (light/serving.py): a shared
        # VerifiedHeaderCache of already-verified per-height blocks
        # (consulted before fetching/verifying; published to only
        # AFTER verification + witness cross-check) and a coalescing
        # commit-verify engine concurrent clients batch through
        self.header_cache = header_cache
        self.verify_engine = verify_engine
        # verify-scheduler class of this client's commit checks
        # (crypto/scheduler.py): serving sessions run PRIORITY_LIGHT;
        # None is the catch-up class
        self.priority = priority
        # blocks verified by the CURRENT verify_header call, held back
        # from the shared cache until the witness cross-check passes —
        # a valid-but-forked chain (a light-client attack the detector
        # would halt on) must never be published
        self._publish_pending: list = []
        self.hops = 0  # bisection hop counter (observability)
        # serializes the verify/update entry points: the light proxy
        # runs them from multiple worker threads (background head
        # tracking + concurrent request handlers) against the one
        # unlocked LightStore
        self._lock = threading.RLock()
        self._init_trust()

    def _init_trust(self) -> None:
        lb = self.store.latest()
        if lb is not None:
            # resuming from a persisted store: the CLI trust root must
            # AGREE with what we already trust at that height — a
            # silent override either way would let a typo'd (or
            # forked) root go unnoticed (reference
            # light.go checkTrustedHeaderAgainstOptions). Recovery
            # from a deliberate re-root: clear the light store.
            stored = self.store.get(self.trust.height)
            if stored is not None:
                claimed = bytes(stored.hash())
            else:
                # trust height not retained (bisection pivots +
                # pruning keep a sparse store): fetch the primary's
                # header at that height and ANCHOR it to the persisted
                # trust chain before using it as the comparison basis
                # — an unanchored header would let a colluding primary
                # confirm a mis-rooted configuration (the check exists
                # to catch exactly that). An unreachable primary
                # tolerates with a prominent warning (the daemon
                # resumes from the store and re-dials).
                try:
                    fetched = self.primary.light_block(
                        self.trust.height
                    )
                except Exception:
                    _log.error(
                        "trust-root cross-check SKIPPED: primary "
                        "unreachable and persisted store does not "
                        "retain the trust height",
                        height=self.trust.height,
                    )
                    return
                try:
                    lowest = self.store.lowest()
                    if fetched.height < lowest.height:
                        self._verify_backwards(lowest, fetched)
                    else:
                        anchor = self.store.latest_before(
                            fetched.height
                        )
                        self._verify_skipping(
                            anchor or lowest, fetched, time.time_ns()
                        )
                except DeviceRouteError:
                    # no verdict on the header: the card failed (C3)
                    raise
                except verifier.ErrOldHeaderExpired:
                    raise LightClientError(
                        f"cannot confirm the configured trust root: "
                        f"the persisted anchor near height "
                        f"{self.trust.height} is outside the trust "
                        "period (re-root with a fresh height/hash "
                        "after clearing the light store)"
                    )
                except (
                    ProviderError,
                    ConnectionError,
                    OSError,
                    TimeoutError,
                ):
                    _log.error(
                        "trust-root cross-check SKIPPED: could not "
                        "anchor the primary's header to the stored "
                        "chain (provider error)",
                        height=self.trust.height,
                    )
                    return
                except Exception:
                    # any VERIFICATION failure (hash-chain break,
                    # invalid commit/header, valset mismatch — raised
                    # as assorted types by validate_basic and the
                    # commit verifiers) means the primary's header
                    # does NOT anchor: refuse, never skip — skipping
                    # here would let a colluding primary confirm a
                    # mis-rooted config by serving an unverifiable
                    # header
                    raise LightClientError(
                        f"primary's header at trust height "
                        f"{self.trust.height} does not chain to the "
                        "persisted trusted store (primary diverged "
                        "or store corrupt)"
                    )
                claimed = bytes(fetched.hash())
            if claimed != bytes(self.trust.hash):
                raise LightClientError(
                    f"trusted store conflicts with the configured "
                    f"trust root at height {self.trust.height} "
                    "(re-rooting requires clearing the light store)"
                )
            return
        lb = self.primary.light_block(self.trust.height)
        if lb.hash() != self.trust.hash:
            raise LightClientError(
                "trusted hash does not match primary's header"
            )
        lb.validate_basic(self.chain_id)
        # verify the commit is by the block's own valset (2/3)
        verify_commit_light(
            self.chain_id,
            lb.validator_set,
            lb.commit.block_id,
            lb.height,
            lb.commit,
            cache=self.cache,
            priority=self.priority,
            device=self.device,
        )
        self.store.save(lb)

    # --- public API ----------------------------------------------------

    def trusted_light_block(self, height: int = 0) -> Optional[LightBlock]:
        return self.store.latest() if height == 0 else self.store.get(height)

    def verify_light_block_at_height(
        self, height: int, now_ns: Optional[int] = None
    ) -> LightBlock:
        # shared-cache fast path OUTSIDE the client lock: a thousand
        # sessions hitting a cached height must not serialize behind
        # one client's in-flight bisection (light/serving.py)
        if self.header_cache is not None and height:
            cached = self.header_cache.get(height)
            if cached is not None:
                with self._lock:
                    self.store.save(cached)
                return cached
        with self._lock:
            now_ns = now_ns or time.time_ns()
            got = self.store.get(height)
            if got is not None:
                return got
            target = self._primary_block(height)
            return self.verify_header(target, now_ns)

    def update(self, now_ns: Optional[int] = None) -> Optional[LightBlock]:
        """Verify the primary's latest header (reference Client.Update)."""
        with self._lock:
            latest = self._primary_block(0)
            trusted = self.store.latest()
            if trusted is not None and latest.height <= trusted.height:
                return trusted
            return self.verify_header(latest, now_ns or time.time_ns())

    # --- primary lifecycle ---------------------------------------------

    def _primary_block(self, height: int) -> LightBlock:
        """Fetch from the primary, REPLACING it with a responsive
        witness when it fails (reference light/client.go:1000-1016 +
        findNewPrimary :1045): the first witness that serves the
        height is promoted (and leaves the witness rotation); the old
        primary is appended to the BACK of the witness list, where the
        ordinary witness lifecycle (strikes / invalid-conflict
        removal / divergence evidence) judges it from then on — the
        reference's remove-vs-demote split keys on its typed provider
        errors, which our transports collapse into ProviderError, so
        demote-and-let-the-detector-decide is the honest equivalent.

        A primary NOT-FOUND still probes the witnesses (a pruned or
        lagging primary is replaced by a witness that retains the
        height — reference treats ErrLightBlockNotFound as a
        findNewPrimary trigger) but WITHOUT striking them: a query for
        a not-yet-produced height (the proxy serves user-chosen
        heights) must surface to the caller, never burn the witness
        set."""
        # a height another session already VERIFIED needs no fetch at
        # all — the shared cache is better than any provider (its
        # entries are post-verification, post-cross-check). peek, not
        # get: internal probes of ONE request must not inflate the
        # request-level hit/miss counters
        if self.header_cache is not None and height:
            cached = self.header_cache.peek(height)
            if cached is not None:
                return cached
        try:
            return self.primary.light_block(height)
        except LightBlockNotFound as e:
            primary_err, primary_not_found = e, True
        except Exception as e:
            primary_err, primary_not_found = e, False
        bad = []
        for i, w in enumerate(self.witnesses):
            try:
                lb = w.light_block(height)
            except LightBlockNotFound:
                # this witness lacks the height too: no strike (it may
                # be the caller's future-height poll), but keep
                # probing — a LATER witness may retain it
                continue
            except Exception:
                if not primary_not_found and self.note_witness_failure(
                    w
                ):
                    bad.append(i)
                continue
            old = self.primary
            self.primary = w
            _log.error(
                "replacing primary with a witness",
                height=height,
                reason=(
                    "primary pruned/lags the height"
                    if primary_not_found
                    else "primary unresponsive"
                ),
                primary_error=repr(primary_err),
                remaining_witnesses=len(self.witnesses) - 1,
            )
            # promoted witness leaves the rotation; the demoted
            # primary joins its tail. Removal CANNOT empty the set
            # here (the demotion refills it), so do it directly
            # rather than through remove_witnesses' emptiness check.
            self.witnesses.pop(i)
            self.clear_witness_failures(w)
            self.witnesses.append(old)
            self.remove_witnesses(bad)
            return lb
        self.remove_witnesses(bad)
        if primary_not_found:
            # not an outage: the primary says the height doesn't
            # exist and no witness could serve it either — surface
            # the not-found (a witness's not-found must NOT mask a
            # real primary outage, so only the primary's own
            # classification picks this branch)
            raise primary_err
        raise LightClientError(
            f"primary unreachable and no witness could serve "
            f"height {height} as a replacement"
        ) from primary_err

    def verify_header(self, target: LightBlock, now_ns: int) -> LightBlock:
        existing = self.store.get(target.height)
        if existing is not None:
            if existing.hash() == target.hash():
                return existing
            raise LightClientError(
                "conflicting header for already-trusted height"
            )
        hc = self.header_cache
        if hc is not None:
            # peek: the enclosing request already counted its lookup
            cached = hc.peek(target.height)
            if cached is not None:
                if cached.hash() == target.hash():
                    self.store.save(cached)
                    return cached
                # forked-header detection MUST fire on a cache hit:
                # the primary served a header conflicting with a
                # block another session fully verified (and witness
                # cross-checked) at this height
                raise LightClientError(
                    f"primary's header at height {target.height} "
                    "conflicts with the cross-client verified cache "
                    "(forked or lying primary)"
                )
        self._publish_pending = []
        try:
            out = self._verify_header_inner(target, now_ns)
            if hc is not None:
                # EVERY block this call stages — bisection pivots
                # included — is witness-cross-checked before any of
                # them is published: trusting verification lets a
                # >1/3-colluding fork mint a crypto-valid PIVOT just
                # as easily as a target, and an unchecked pivot in
                # the shared cache would poison every session.
                # _verify_header_inner already cross-checked the
                # target itself; check the rest, THEN publish all.
                for lb in self._publish_pending:
                    if lb is not out:
                        self._cross_check(lb)
                for lb in self._publish_pending:
                    hc.publish(lb)
        finally:
            self._publish_pending = []
        return out

    def _verify_header_inner(self, target: LightBlock, now_ns: int) -> LightBlock:
        trusted = self._best_trusted_before(target.height)
        if trusted is None:
            # target below every trusted header: hash-chain walk down
            # from the lowest trusted block (reference light/client.go
            # backwards verification)
            lowest = self.store.lowest()
            if lowest is None:
                raise LightClientError("no trusted state")
            self._verify_backwards(lowest, target)
            self._cross_check(target)
            return target
        if self.mode == SEQUENTIAL:
            self._verify_sequential(trusted, target, now_ns)
        else:
            self._verify_skipping(trusted, target, now_ns)
        self._cross_check(target)
        return target

    def _best_trusted_before(self, height: int) -> Optional[LightBlock]:
        """Bisection anchor: own trusted store, improved by the shared
        cache's frontier when it is closer to the target (a pooled
        serving client with a cold store picks up where ANY session
        left off instead of re-walking from its trust root)."""
        trusted = self.store.latest_before(height)
        if self.header_cache is not None:
            cached = self.header_cache.latest_before(height)
            if cached is not None and (trusted is None or cached.height > trusted.height):
                self.store.save(cached)
                trusted = cached
        return trusted

    def _note_verified(self, lb: LightBlock) -> None:
        """Stage a freshly verified block for shared-cache publication
        (held until the enclosing verify_header's cross-check)."""
        self.store.save(lb)
        if self.header_cache is not None:
            self._publish_pending.append(lb)

    # --- verification strategies ---------------------------------------

    def _verify_sequential(
        self, trusted: LightBlock, target: LightBlock, now_ns: int
    ) -> None:
        for h in range(trusted.height + 1, target.height + 1):
            nxt = (
                target
                if h == target.height
                else self._primary_block(h)
            )
            verifier.verify_adjacent(
                self.chain_id,
                trusted,
                nxt,
                nxt.validator_set,
                self.trust.period_ns,
                now_ns,
                self.drift,
                cache=self.cache,
                engine=self.verify_engine,
                priority=self.priority,
                device=self.device,
            )
            self._note_verified(nxt)
            trusted = nxt
            self.hops += 1

    def _verify_skipping(
        self, trusted: LightBlock, target: LightBlock, now_ns: int
    ) -> None:
        """Bisection: try to jump straight to the target; on
        insufficient trusted overlap, pull an intermediate header at
        9/16 of the gap (reference verifySkipping)."""
        pivots = [target]
        while pivots:
            candidate = pivots[-1]
            if self.header_cache is not None:
                # peek: same request-internal probe as _primary_block
                cached = self.header_cache.peek(candidate.height)
                if cached is not None:
                    if cached.hash() != candidate.hash():
                        # the primary's hop conflicts with a block
                        # another session verified + cross-checked:
                        # fork detection on a cache hit
                        raise LightClientError(
                            f"primary's header at height "
                            f"{candidate.height} conflicts with the "
                            "cross-client verified cache"
                        )
                    self.store.save(cached)
                    trusted = cached
                    pivots.pop()
                    self.hops += 1
                    continue
            try:
                if candidate.height == trusted.height + 1:
                    verifier.verify_adjacent(
                        self.chain_id,
                        trusted,
                        candidate,
                        candidate.validator_set,
                        self.trust.period_ns,
                        now_ns,
                        self.drift,
                        cache=self.cache,
                        engine=self.verify_engine,
                        priority=self.priority,
                        device=self.device,
                    )
                else:
                    trusted_next_vals = self._next_vals(trusted)
                    verifier.verify_non_adjacent(
                        self.chain_id,
                        trusted,
                        trusted_next_vals,
                        candidate,
                        candidate.validator_set,
                        self.trust.period_ns,
                        now_ns,
                        self.drift,
                        self.trust_level,
                        cache=self.cache,
                        engine=self.verify_engine,
                        priority=self.priority,
                        device=self.device,
                    )
                self._note_verified(candidate)
                trusted = candidate
                pivots.pop()
                self.hops += 1
            except verifier.ErrNewValSetCantBeTrusted:
                gap = candidate.height - trusted.height
                pivot_h = trusted.height + gap * BISECT_NUM // BISECT_DEN
                if pivot_h in (trusted.height, candidate.height):
                    raise LightClientError(
                        "bisection cannot make progress"
                    )
                pivots.append(self._primary_block(pivot_h))

    def _verify_backwards(
        self, trusted: LightBlock, target: LightBlock
    ) -> None:
        """Verify a header BELOW the trust root by walking the header
        hash chain down one height at a time: header(h).last_block_id
        must equal hash(header(h-1)) (reference light/client.go
        backwards: no signature checks needed — the chain of hashes is
        anchored at the already-trusted block).

        Each hop additionally enforces what the reference's
        VerifyBackwards (light/verifier.go) does beyond the hash link:
        chain-id match, exact height adjacency, and time monotonicity
        (untrusted.Time strictly before trusted.Time) — a primary must
        not be able to serve hash-chained headers with out-of-order
        times or a foreign chain id.
        """
        cur = trusted
        while cur.height > target.height:
            want = cur.header.last_block_id
            if want is None or not want.hash:
                raise LightClientError(
                    f"header {cur.height} has no last_block_id"
                )
            lower_h = cur.height - 1
            lower = (
                target
                if lower_h == target.height
                else self._primary_block(lower_h)
            )
            if lower.height != lower_h:
                # also exact adjacency: lower_h == cur.height - 1 and
                # LightBlock.height IS header.height
                raise LightClientError("provider returned wrong height")
            if lower.header.chain_id != self.chain_id:
                raise LightClientError(
                    f"header at {lower_h} from wrong chain "
                    f"{lower.header.chain_id!r}"
                )
            if lower.header.time_ns >= cur.header.time_ns:
                raise LightClientError(
                    f"non-monotonic header time at {lower_h}: "
                    f"{lower.header.time_ns} >= {cur.header.time_ns}"
                )
            if lower.hash() != want.hash:
                raise LightClientError(
                    f"header hash chain broken at {lower_h}"
                )
            lower.validate_basic(self.chain_id)
            self.hops += 1
            cur = lower
        self._note_verified(target)

    def _next_vals(self, lb: LightBlock) -> ValidatorSet:
        """The valset signing height h+1 (trusted next-vals). For
        non-adjacent trusting verification the trusted block's own
        valset is the standard choice (reference uses trusted
        NextValidators; same set when unchanged, and trusting mode
        tolerates drift up to the trust level)."""
        return lb.validator_set

    # --- witnesses ------------------------------------------------------
    #
    # Lifecycle (reference light/client.go:1019-1185): witnesses that
    # are persistently unresponsive or serve INVALID conflicting
    # blocks are removed from rotation; a configured-with-witnesses
    # client whose witness set empties errors out rather than
    # silently continuing unwitnessed; fresh witnesses can be
    # installed at runtime (add_witness).

    MAX_WITNESS_STRIKES = 3

    def note_witness_failure(self, w) -> bool:
        """Count a consecutive failure; True when the witness has
        struck out and should be removed."""
        n = self._witness_strikes.get(id(w), 0) + 1
        self._witness_strikes[id(w)] = n
        return n >= self.MAX_WITNESS_STRIKES

    def clear_witness_failures(self, w) -> None:
        self._witness_strikes.pop(id(w), None)

    def remove_witnesses(self, indexes) -> None:
        """Drop witnesses by index (descending removal, reference
        removeWitnesses). Raises once the set empties on a client
        that was configured WITH witnesses — an unwitnessed client
        must be an explicit operator choice, never a silent decay."""
        if not indexes:
            return
        for i in sorted(set(indexes), reverse=True):
            w = self.witnesses.pop(i)
            self._witness_strikes.pop(id(w), None)
            _log.error(
                "removing witness from rotation",
                witness=getattr(w, "name", repr(w)),
                remaining=len(self.witnesses),
            )
        if self._had_witnesses and not self.witnesses:
            raise LightClientError(
                "no witnesses remain: every configured witness was "
                "removed (unresponsive or misbehaving); install a "
                "fresh one with add_witness or restart with a new "
                "witness set"
            )

    def add_witness(self, provider) -> None:
        """Install a fresh witness at runtime (reference operators do
        this after witness attrition)."""
        with self._lock:
            self.witnesses.append(provider)
            self._had_witnesses = True

    def _cross_check(self, verified: LightBlock) -> None:
        from .detector import check_against_witnesses

        if self.witnesses:
            check_against_witnesses(self, verified, device=self.device)
        elif self._had_witnesses:
            # the configured witness set has fully decayed (divergence
            # or strikes): continuing to verify UNWITNESSED against a
            # possibly-suspect primary would be exactly the silent
            # decay the lifecycle exists to prevent
            raise LightClientError(
                "no witnesses remain: refusing unwitnessed "
                "verification (install one with add_witness)"
            )

    def prune(self, keep: int = 1000) -> None:
        self.store.prune(keep)
