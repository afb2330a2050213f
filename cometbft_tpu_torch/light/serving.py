"""Light-client serving plane: one full node, thousands of light
clients ("Practical Light Clients for Committee-Based Blockchains").

Before this plane, `light/proxy.py` verified per-request, per-client:
every bisection hop paid its own commit signature verification even
when a thousand sessions asked about the same heights. Three shared
seams fix that:

- **VerifiedHeaderCache** — a TTL'd LRU of per-height VERIFIED
  artifacts shared by every session: light blocks that passed full
  verification (and witness cross-check), plus whole-commit
  verification verdicts keyed by (chain, height, commit key, valset
  hash). Single-flight dedup: N concurrent requests for an unverified
  height trigger exactly ONE verification; the rest wait on the
  flight. Poisoned entries are impossible by construction: the only
  write paths are `get_or_verify` (stores what the verify fn
  returned) and `publish` (called by light.Client strictly AFTER
  verification + witness cross-check, and re-validated here), and
  commit verdicts are recorded only by the coalescing engine after a
  successful batch.

- **CoalescedCommitVerifier** — the cross-client batcher: concurrent
  sessions' skipping-verification hops (verify_non_adjacent's
  trusting + light checks) funnel into ONE lane batch through
  types/validation.verify_commit_jobs_coalesced — one ticket of the
  verify scheduler's light class (``PRIORITY_LIGHT``) on the plane's
  ``device``, so on the card one launch of each of K1-K3 — with
  serial-equivalent verdicts (same error types, same early-break
  collection; asserted in tests). Window-batched with leader
  election: the first submitting thread collects followers for
  ``window_s`` then dispatches for everyone.

- **LightServingPlane** — the session layer: bounded concurrent
  sessions + an obs/queues.py InstrumentedGate on in-flight verify
  work, shed-and-count overload behavior (never queue unbounded work
  behind a slow verify), a small pool of verifier Clients all wired
  to the shared cache/engine, and per-request spans
  (``light.serve.request``, ``light.verify.coalesced``,
  ``light.cache.{hit,miss}``) on the plane's tracer.

Sharing contract: a cache/plane may only be shared among clients that
share the same chain AND an equivalent trust policy (same witnesses /
trust root lineage).

A copy of the JAX package's ``light/serving.py``, with the port's
``device`` (None is the GPU, which raises without one; ``"cpu"`` the
host plane or the kernels' plain versions) and one departure (ROADMAP
C3, "on the serving path"): a failed verify route is not a verdict.
The JAX engine hands any exception of the batch to every job as that
job's error; here the batch's ``DeviceRouteError`` (a ticket that did
not resolve within ``FLIGHT_TIMEOUT_S`` becomes one too) reaches every
job of the batch unchanged, and every single-flight follower gets its
leader's error unchanged. Nothing is then published to the header
cache and no commit verdict is recorded, and the clients' trusted
stores stay as they were (the client re-raises the error ahead of its
refusal handling). Every wait of a plane thread is bounded by
``FLIGHT_TIMEOUT_S``.
"""

from __future__ import annotations

import hashlib
import itertools
import threading
import time
from typing import Callable, List, Optional

from ..crypto.scheduler import PRIORITY_LIGHT, DeviceRouteError
from ..device import resolve
from ..obs.queues import InstrumentedGate
from ..trace.tracer import NOOP
from ..types.signature_cache import SignatureCache
from ..types.validation import verify_commit_jobs_coalesced
from .types import LightBlock

_monotonic = time.monotonic
_monotonic_ns = time.monotonic_ns

DEFAULT_CACHE_ENTRIES = 4096
DEFAULT_CACHE_TTL_S = 600.0
DEFAULT_WINDOW_S = 0.002
DEFAULT_MAX_BATCH = 128
# how long a single-flight follower (or a coalesce submitter) waits
# for its leader before giving up — bounds a wedged leader's blast
# radius to one errored request instead of a thread pile-up
FLIGHT_TIMEOUT_S = 120.0


class ServingOverloadError(Exception):
    """Admission shed: the plane is at its session or in-flight bound.
    Callers surface this as a retryable overload (the proxy maps it to
    a JSON-RPC overload error), never as a verification failure."""


class CachePoisonError(Exception):
    """A publish attempt carried an internally inconsistent block —
    refused (and loudly: this means a caller tried to publish
    something that cannot have passed verification)."""


def commit_key(commit) -> bytes:
    """Stable content key of a commit (memoized on the object — codec
    decode conventions make commits immutable). Two fetches of the
    same commit from different sessions must land on one verdict
    cache entry, so identity is content, not id()."""
    k = getattr(commit, "_serving_key", None)
    if k is None:
        h = hashlib.sha256()
        h.update(commit.height.to_bytes(8, "big", signed=False))
        h.update(commit.round.to_bytes(4, "big", signed=True))
        h.update(bytes(commit.block_id.hash))
        for cs in commit.signatures:
            h.update(bytes([cs.block_id_flag]))
            h.update(bytes(cs.validator_address or b""))
            h.update(
                (cs.timestamp_ns or 0).to_bytes(8, "big", signed=True)
            )
            h.update(bytes(cs.signature or b""))
        k = h.digest()
        try:
            commit._serving_key = k
        except Exception:
            pass  # slots/frozen commit: key just recomputes
    return k


def _valset_key(vals) -> bytes:
    k = getattr(vals, "_serving_key", None)
    if k is None:
        k = bytes(vals.hash())
        try:
            vals._serving_key = k
        except Exception:
            pass
    return k


class _Flight:
    """One in-flight verification: the leader resolves it, followers
    wait on the event."""

    __slots__ = ("event", "block", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.block: Optional[LightBlock] = None
        self.error: Optional[BaseException] = None


class VerifiedHeaderCache:
    """Cross-client TTL'd LRU of verified light blocks + commit
    verdicts for ONE chain. Thread-safe; every lookup counts a hit or
    miss (and, when a tracer is attached, records a zero-duration
    ``light.cache.hit``/``light.cache.miss`` span so the span→metrics
    bridge can export the counters)."""

    def __init__(
        self,
        chain_id: str,
        max_entries: int = DEFAULT_CACHE_ENTRIES,
        ttl_s: float = DEFAULT_CACHE_TTL_S,
        tracer=NOOP,
    ) -> None:
        self.chain_id = chain_id
        self.max_entries = max_entries
        self.ttl_s = ttl_s
        self.tracer = tracer
        self._lock = threading.Lock()
        # height -> (block, verified_at_monotonic); insertion order is
        # maintained fresh-last for LRU eviction
        self._blocks: dict = {}
        # (kind, height, commit_key, valset_key, extra) -> stamp
        self._verdicts: dict = {}
        self._flights: dict = {}
        self.hits = 0
        self.misses = 0
        self.verdict_hits = 0
        self.flight_waits = 0
        self.published = 0
        self.expired = 0

    # --- verified block cache ------------------------------------------

    def _get_locked(self, height: int) -> Optional[LightBlock]:
        ent = self._blocks.get(height)
        if ent is None:
            return None
        lb, stamp = ent
        if self.ttl_s and _monotonic() - stamp > self.ttl_s:
            del self._blocks[height]
            self.expired += 1
            return None
        # LRU touch
        del self._blocks[height]
        self._blocks[height] = (lb, stamp)
        return lb

    def get(self, height: int) -> Optional[LightBlock]:
        """Counting lookup — use at REQUEST entry points only (the
        plane's get_or_verify, a direct client's fast path); internal
        bisection/anchor probes use ``peek`` so one cold plane
        request counts at most two misses (plane probe + client
        entry) and a warm one exactly one hit."""
        with self._lock:
            lb = self._get_locked(height)
            if lb is not None:
                self.hits += 1
            else:
                self.misses += 1
        self.tracer.complete(
            "light.cache.hit" if lb is not None else "light.cache.miss",
            _monotonic_ns(),
            0,
            "light",
            height=height,
        )
        return lb

    def peek(self, height: int) -> Optional[LightBlock]:
        """Lookup WITHOUT counting a hit/miss (internal consumers that
        already counted this request, e.g. the single-flight loop)."""
        with self._lock:
            return self._get_locked(height)

    def latest_before(self, height: int) -> Optional[LightBlock]:
        """Highest verified block strictly below ``height`` — the
        bisection anchor seam: a pooled client starting from a cold
        store picks up the cache's frontier instead of re-walking from
        its trust root."""
        with self._lock:
            best = None
            for h in self._blocks:
                if h < height and (best is None or h > best):
                    best = h
            return self._get_locked(best) if best is not None else None

    def publish(self, lb: LightBlock) -> None:
        """Insert a VERIFIED block. Only light.Client calls this, and
        only after full verification + witness cross-check of the
        enclosing verify_header. Defense in depth: the block must be
        internally consistent (header/commit/valset bind) — an entry
        that fails validate_basic can never enter, whatever the
        caller's bug."""
        try:
            lb.validate_basic(self.chain_id)
        except Exception as e:
            raise CachePoisonError(
                f"refusing to cache inconsistent light block at "
                f"height {lb.height}: {e}"
            )
        with self._lock:
            self._blocks.pop(lb.height, None)
            self._blocks[lb.height] = (lb, _monotonic())
            self.published += 1
            while len(self._blocks) > self.max_entries:
                oldest = next(iter(self._blocks))
                del self._blocks[oldest]

    # --- single flight -------------------------------------------------

    def get_or_verify(
        self, height: int, verify_fn: Callable[[int], LightBlock]
    ) -> LightBlock:
        """Serve ``height`` from the cache, or run ``verify_fn`` ONCE
        no matter how many threads ask concurrently. The leader's
        result is published (verify_fn returning = it verified);
        followers wait on the flight and share verdict AND error."""
        while True:
            got = self.get(height)
            if got is not None:
                return got
            with self._lock:
                # re-check under the lock: a leader may have landed
                # between the get() above and here
                got = self._get_locked(height)
                if got is not None:
                    self.hits += 1
                    return got
                fl = self._flights.get(height)
                if fl is None:
                    fl = _Flight()
                    self._flights[height] = fl
                    leader = True
                else:
                    leader = False
            if leader:
                try:
                    lb = verify_fn(height)
                    if self.peek(height) is None:
                        self.publish(lb)
                    fl.block = lb
                    return lb
                except BaseException as e:
                    fl.error = e
                    raise
                finally:
                    with self._lock:
                        self._flights.pop(height, None)
                    fl.event.set()
            else:
                self.flight_waits += 1
                if not fl.event.wait(FLIGHT_TIMEOUT_S):
                    raise ServingOverloadError(
                        f"verification of height {height} did not "
                        "complete in time (wedged flight)"
                    )
                if fl.error is not None:
                    raise fl.error
                if fl.block is not None:
                    return fl.block
                # leader resolved without a block (cancelled): retry

    # --- commit verdict cache ------------------------------------------

    def check_commit_verdict(self, key: tuple) -> bool:
        with self._lock:
            ent = self._verdicts.get(key)
            if ent is None:
                return False
            if self.ttl_s and _monotonic() - ent > self.ttl_s:
                del self._verdicts[key]
                return False
            self.verdict_hits += 1
            return True

    def record_commit_verdict(self, key: tuple) -> None:
        """Called ONLY by the coalescing engine after the batch
        verified this commit successfully — failures are never
        recorded (a negative verdict must re-verify: the failing lane
        set can differ per caller)."""
        with self._lock:
            self._verdicts.pop(key, None)
            self._verdicts[key] = _monotonic()
            while len(self._verdicts) > self.max_entries:
                del self._verdicts[next(iter(self._verdicts))]

    # --- introspection -------------------------------------------------

    def __len__(self) -> int:
        return len(self._blocks)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._blocks),
                "verdicts": len(self._verdicts),
                "hits": self.hits,
                "misses": self.misses,
                "verdict_hits": self.verdict_hits,
                "flight_waits": self.flight_waits,
                "published": self.published,
                "expired": self.expired,
            }


class _Pending:
    __slots__ = ("job", "key", "error", "event")

    def __init__(self, job, key) -> None:
        self.job = job
        self.key = key
        self.error: Optional[BaseException] = None
        self.event = threading.Event()


class CoalescedCommitVerifier:
    """Thread-facing window batcher over
    types/validation.verify_commit_jobs_coalesced, on ``device``.

    Submitting threads block for their own verdict; all jobs that
    arrive within ``window_s`` of the first (or until ``max_batch``)
    are verified as ONE lane batch through the existing crypto
    dispatch engine. The first submitter is the leader: it sleeps out
    the window on a condition variable (woken early when the batch
    fills), takes the batch, dispatches, and resolves everyone.

    The verdict cache (a VerifiedHeaderCache) short-circuits whole
    commits that any session already verified — the promotion of the
    per-client signature cache into one cross-client verdict per
    (chain, height, commit, valset)."""

    def __init__(
        self,
        chain_id: str,
        signature_cache: Optional[SignatureCache] = None,
        verdict_cache: Optional[VerifiedHeaderCache] = None,
        window_s: float = DEFAULT_WINDOW_S,
        max_batch: int = DEFAULT_MAX_BATCH,
        tracer=NOOP,
        device=None,
    ) -> None:
        self.device = resolve(device)
        self.chain_id = chain_id
        self.signature_cache = signature_cache
        self.verdict_cache = verdict_cache
        self.window_s = window_s
        self.max_batch = max_batch
        self.tracer = tracer
        self._cond = threading.Condition()
        self._pending: List[_Pending] = []
        # stats (exported via plane.stats + the span bridge)
        self.submitted = 0
        self.dispatches = 0
        self.jobs_batched = 0
        self.max_batch_seen = 0
        self.verdict_hits = 0

    # --- the verifier-facing API (light/verifier.py engine seam) -------

    def verify_commit_light(
        self, vals, block_id, height: int, commit
    ) -> None:
        key = (
            "light",
            height,
            commit_key(commit),
            _valset_key(vals),
            bytes(block_id.hash),
        )
        if self._verdict_hit(key):
            return
        err = self._submit(
            ("light", vals, block_id, height, commit), key
        )
        if err is not None:
            raise err

    def verify_commit_light_trusting(
        self, vals, commit, trust_level
    ) -> None:
        key = (
            "trusting",
            commit.height,
            commit_key(commit),
            _valset_key(vals),
            (trust_level.numerator, trust_level.denominator),
        )
        if self._verdict_hit(key):
            return
        err = self._submit(
            ("trusting", vals, commit, trust_level), key
        )
        if err is not None:
            raise err

    def _verdict_hit(self, key: tuple) -> bool:
        vc = self.verdict_cache
        if vc is not None and vc.check_commit_verdict(key):
            self.verdict_hits += 1
            return True
        return False

    # --- batching ------------------------------------------------------

    def _submit(self, job, key) -> Optional[BaseException]:
        ent = _Pending(job, key)
        with self._cond:
            self.submitted += 1
            self._pending.append(ent)
            leader = len(self._pending) == 1
            if len(self._pending) >= self.max_batch:
                self._cond.notify_all()
        if leader:
            with self._cond:
                self._cond.wait_for(
                    lambda: len(self._pending) >= self.max_batch,
                    timeout=self.window_s,
                )
                batch, self._pending = self._pending, []
            self._dispatch(batch)
            return ent.error
        if not ent.event.wait(FLIGHT_TIMEOUT_S):
            return ServingOverloadError(
                "coalesced verification did not complete in time"
            )
        return ent.error

    def _dispatch(self, batch: List[_Pending]) -> None:
        t0 = _monotonic_ns()
        try:
            errors = verify_commit_jobs_coalesced(
                self.chain_id,
                [e.job for e in batch],
                cache=self.signature_cache,
                priority=PRIORITY_LIGHT,
                device=self.device,
                timeout=FLIGHT_TIMEOUT_S,
            )
        except TimeoutError as e:
            # no verdict on any lane: the route did not resolve (C3)
            err = DeviceRouteError(f"verify route did not resolve within {FLIGHT_TIMEOUT_S}s")
            err.__cause__ = e
            errors = [err] * len(batch)
        except BaseException as e:  # engine failure: everyone errors
            errors = [e] * len(batch)
        self.dispatches += 1
        self.jobs_batched += len(batch)
        if len(batch) > self.max_batch_seen:
            self.max_batch_seen = len(batch)
        vc = self.verdict_cache
        for ent, err in zip(batch, errors):
            ent.error = err
            if err is None and vc is not None:
                vc.record_commit_verdict(ent.key)
            ent.event.set()
        self.tracer.complete(
            "light.verify.coalesced",
            t0,
            _monotonic_ns() - t0,
            "light",
            n=len(batch),
        )

    def stats(self) -> dict:
        return {
            "submitted": self.submitted,
            "dispatches": self.dispatches,
            "jobs_batched": self.jobs_batched,
            "max_batch": self.max_batch_seen,
            "verdict_hits": self.verdict_hits,
            "avg_batch": round(
                self.jobs_batched / self.dispatches, 2
            )
            if self.dispatches
            else 0.0,
        }


class Session:
    """One light-client serving session (a connected wallet / SDK).
    Thin: admission happened at open; requests ride the plane."""

    __slots__ = ("plane", "session_id", "requests")

    def __init__(self, plane: "LightServingPlane", session_id: int):
        self.plane = plane
        self.session_id = session_id
        self.requests = 0

    def verified_block(self, height: int) -> LightBlock:
        self.requests += 1
        return self.plane.serve(height, session=self.session_id)

    def close(self) -> None:
        self.plane.close_session(self.session_id)

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class LightServingPlane:
    """Bounded, instrumented serving front over a pool of verifier
    Clients sharing one VerifiedHeaderCache + CoalescedCommitVerifier
    + SignatureCache.

    ``clients``: one or more light.Client instances for the SAME
    chain/trust policy (the pool bounds verification concurrency —
    concurrent misses on different heights verify in parallel and
    their signature batches coalesce). Each client is wired to the
    shared seams here (header_cache / verify_engine / signature
    cache) and must run on the plane's ``device``."""

    def __init__(
        self,
        clients: List,
        *,
        max_sessions: int = 1024,
        max_inflight: int = 32,
        admit_timeout_s: float = 0.25,
        cache: Optional[VerifiedHeaderCache] = None,
        window_s: float = DEFAULT_WINDOW_S,
        cache_ttl_s: float = DEFAULT_CACHE_TTL_S,
        coalesce: bool = True,
        tracer=NOOP,
        device=None,
    ) -> None:
        if not clients:
            raise ValueError("serving plane needs >= 1 client")
        self.device = resolve(device)
        self.chain_id = clients[0].chain_id
        self.tracer = tracer
        self.max_sessions = max_sessions
        # identity check, NOT truthiness: the cache defines __len__,
        # so a shared-but-still-empty cache (a fleet booting cold)
        # would read as falsy and silently get replaced by a private
        # one — breaking cross-replica single-flight exactly when it
        # matters most
        self.cache = (
            cache
            if cache is not None
            else VerifiedHeaderCache(
                self.chain_id, ttl_s=cache_ttl_s, tracer=tracer
            )
        )
        # promote the FIRST client's signature cache to the shared one
        self.signature_cache = clients[0].cache
        self.engine = (
            CoalescedCommitVerifier(
                self.chain_id,
                signature_cache=self.signature_cache,
                verdict_cache=self.cache,
                window_s=window_s,
                tracer=tracer,
                device=self.device,
            )
            if coalesce
            else None
        )
        self._clients = list(clients)
        for c in self._clients:
            self.adopt_client(c)
        self._free: List = list(self._clients)
        self._client_cond = threading.Condition()
        self.gate = InstrumentedGate(max_inflight, name="light.serve")
        self.admit_timeout_s = admit_timeout_s
        self._sessions: dict = {}
        self._session_ids = itertools.count(1)
        self._session_lock = threading.Lock()
        self.sessions_opened = 0
        self.sessions_shed = 0
        self.requests = 0
        self.requests_shed = 0
        self._draining = False

    # --- client pool ---------------------------------------------------

    def adopt_client(self, client) -> None:
        """Wire a Client into the shared seams (idempotent)."""
        if client.device != self.device:
            raise ValueError(
                f"client on {client.device} cannot join a serving plane on {self.device}"
            )
        client.header_cache = self.cache
        client.verify_engine = self.engine
        client.cache = self.signature_cache
        # serving sessions verify under the LIGHT scheduler class:
        # above catch-up storms, below the live round
        client.priority = PRIORITY_LIGHT

    def _checkout(self):
        with self._client_cond:
            if not self._client_cond.wait_for(
                lambda: self._free, timeout=FLIGHT_TIMEOUT_S
            ):
                raise ServingOverloadError(
                    "no verifier client became free in time"
                )
            return self._free.pop()

    def _checkin(self, client) -> None:
        with self._client_cond:
            self._free.append(client)
            self._client_cond.notify()

    # --- sessions ------------------------------------------------------

    def open_session(self) -> Session:
        with self._session_lock:
            if self._draining:
                self.sessions_shed += 1
                self.gate.count_drop()
                raise ServingOverloadError(
                    "serving plane draining; retry another replica"
                )
            if len(self._sessions) >= self.max_sessions:
                self.sessions_shed += 1
                self.gate.count_drop()
                raise ServingOverloadError(
                    f"session bound reached "
                    f"({self.max_sessions}); retry later"
                )
            sid = next(self._session_ids)
            s = Session(self, sid)
            self._sessions[sid] = s
            self.sessions_opened += 1
            return s

    def close_session(self, session_id: int) -> None:
        with self._session_lock:
            self._sessions.pop(session_id, None)

    def active_sessions(self) -> int:
        return len(self._sessions)

    # --- serving -------------------------------------------------------

    def serve(
        self, height: int, session: Optional[int] = None
    ) -> LightBlock:
        """One verified-block request: admission gate -> shared cache
        -> single-flight verification on a pooled client."""
        self.requests += 1
        span = self.tracer.span(
            "light.serve.request", "light", height=height
        )
        with span:
            if self._draining:
                self.requests_shed += 1
                self.gate.count_drop()
                span.set(shed=True)
                raise ServingOverloadError(
                    "serving plane draining; retry another replica"
                )
            if not self.gate.enter(self.admit_timeout_s):
                self.requests_shed += 1
                span.set(shed=True)
                raise ServingOverloadError(
                    "serving plane at its in-flight bound; retry"
                )
            try:
                return self.cache.get_or_verify(height, self._verify)
            finally:
                self.gate.exit()

    def _verify(self, height: int) -> LightBlock:
        client = self._checkout()
        try:
            return client.verify_light_block_at_height(height)
        finally:
            self._checkin(client)

    # --- drain (graceful rotate-out) -----------------------------------

    def drain(self, timeout_s: float = 5.0) -> bool:
        """Stop admitting (new sessions AND new requests shed with the
        standard overload error) and wait — BOUNDED — for every
        in-flight request to resolve. Returns True when the gate went
        idle inside the budget; False means the caller rotates the
        replica out anyway knowing requests are still in flight. Sync
        and thread-safe: the plane is the thread-facing seam, so an
        async caller runs it via ``asyncio.to_thread`` (the wait is
        bounded, never a hang)."""
        self._draining = True
        return self.gate.wait_idle(timeout_s)

    def resume(self) -> None:
        """Re-open admission after a drain (replica rotates back in)."""
        self._draining = False

    # --- introspection -------------------------------------------------

    def register_queues(self, registry) -> None:
        """Expose the admission gate in an obs QueueRegistry."""
        registry.register("light.serve", self.gate.stats)

    def stats(self) -> dict:
        return {
            "draining": self._draining,
            "sessions": self.active_sessions(),
            "sessions_opened": self.sessions_opened,
            "sessions_shed": self.sessions_shed,
            "requests": self.requests,
            "requests_shed": self.requests_shed,
            "admission": self.gate.stats(),
            "cache": self.cache.stats(),
            "coalesce": self.engine.stats()
            if self.engine is not None
            else None,
            "verifier_pool": len(self._clients),
        }
