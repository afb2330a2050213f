"""Blocksync reactor: the catch-up verify/apply loop.

The port of the JAX package's ``blocksync/reactor.py`` (reference
blocksync/reactor.go poolRoutine, :560-700). Instead of verifying one
commit at a time (VerifyCommit at :631), the loop takes a WINDOW of
buffered heights and verifies all their commits in one coalesced
dispatch (``types.validation.verify_commits_coalesced_async``), which
the verify scheduler routes to the GPU kernels or to the host plane.
Block h is verified by block (h+1).LastCommit, so a window of K
applies needs K+1 buffered blocks (PeekTwoBlocks, K wide).

While window K is applied, window K+1's dispatch is already in flight
(``_predispatch_lookahead``); it is reused only when its inputs match
the next window by content (the valset hash and every block hash), and
dropped on any refetch, ban or valset change.

Every verify runs on the reactor's ``device`` (None = the GPU, which
raises without one). Adaptive sync (the fork's feature): given a
``block_ingestor`` (a started ``consensus.state.ConsensusState``), each
verified block goes into the consensus state machine through
``ingest_verified_block``, which persists and applies it, instead of
being applied here; the window pass then runs on the event loop it
shares with consensus, and drops the heights consensus committed
itself. Departure: the pool routine still catches every exception and
retries, but counts each one in ``loop_errors`` (``LoopErrors``: the
count, the first and the last few errors), so a caller can see that it
happened. It logs the traceback of each distinct error once, and while
one error repeats it backs off its retry from 10 ms to 1 s; a window
that applies resets the wait. A failing card is not replaced by the
host plane, and a failed route in the extended-commit check is no
verdict on the peer (ROADMAP C7): it reaches the pool routine as it
is, with no refetch and no ban.

Spans on the reactor's ``tracer``, tid ``blocksync`` (docs/TRACE.md):
a pass is ``prepare``, ``verify_wait``, ``lookahead`` and ``apply``
under ``blocksync.window.``; ``apply`` holds ``stage``, ``persist``
and one ``exec`` a block, in which the executor records its own
``exec.*`` phases on the same tracer. Between passes the routine
records ``fill_wait`` (too few blocks buffered), ``backoff`` (the
retry sleeps) and ``yield`` (the pool's fetch tasks running on the
loop before the next pass).
"""

from __future__ import annotations

import asyncio
import time
import traceback
from typing import Callable, Optional

from ..crypto.scheduler import DeviceRouteError, resolved
from ..device import resolve
from ..trace import NOOP as TRACE_NOOP
from ..types.block import BlockID
from ..types.part_set import PartSet
from ..types.signature_cache import SignatureCache
from ..types.validation import (
    PRIORITY_CATCHUP,
    verify_commits_coalesced_async,
    verify_extended_commit,
)
from ..utils import codec
from ..utils.log import get_logger
from ..utils.loop_errors import LoopErrors
from .pool import BlockPool

_log = get_logger("blocksync")

VERIFY_WINDOW = 32
SWITCH_TO_CONSENSUS_INTERVAL_S = 1.0
# Apply a block without its extended commit after this many fetches of
# the height came back without one (liveness: no reachable peer may
# hold it, see _check_extended_commit).
EC_MISS_TOLERANCE = 2
# the pool routine's retry after a pass that applied nothing; doubled
# while the same error repeats, up to the cap
RETRY_MIN_S = 0.01
RETRY_MAX_S = 1.0


class MissingExtendedCommit(ValueError):
    """A peer served a block without its extended commit at an
    extension-enabled height: maybe an honest gap, never a failed
    verification."""


class _PrefixErrors:
    """The first ``n`` per-job errors of a wider coalesced handle (the
    lookahead covered more heights than this pass applies)."""

    __slots__ = ("_h", "_n")

    def __init__(self, handle, n: int) -> None:
        self._h = handle
        self._n = n

    @property
    def tickets(self):
        return self._h.tickets

    def result(self):
        return self._h.result()[: self._n]


class _SplicedErrors:
    """Lookahead verdicts for the first ``n`` jobs, then a fresh
    dispatch for the rest, in job order (the pool refilled after the
    lookahead was sized)."""

    __slots__ = ("_a", "_b", "_n")

    def __init__(self, pre, rest, n: int) -> None:
        self._a = pre
        self._b = rest
        self._n = n

    @property
    def tickets(self):
        return self._a.tickets + self._b.tickets

    def result(self):
        return self._a.result()[: self._n] + self._b.result()


class BlockSyncReactor:
    def __init__(
        self,
        state,
        block_exec,
        block_store,
        pool: Optional[BlockPool] = None,
        signature_cache: Optional[SignatureCache] = None,
        on_caught_up: Optional[Callable] = None,
        block_ingestor=None,
        verify_window: int = VERIFY_WINDOW,
        local_blocks_chain=None,  # fn(state) -> bool, reactor.go:448
        device=None,
    ):
        self.device = resolve(device)
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.pool = pool or BlockPool(state.last_block_height + 1)
        # the pipelined verify needs ~2x the window buffered (this
        # window, the lookahead and the +1 commit block); a shallower
        # pool silently disables the overlap
        self.pool.max_pending = max(self.pool.max_pending, 2 * verify_window + 2)
        self.sig_cache = signature_cache or SignatureCache()
        self.on_caught_up = on_caught_up
        self.ingestor = block_ingestor
        self.window = verify_window
        self.local_blocks_chain = local_blocks_chain
        self.blocks_applied = 0
        # height -> peer ids that served the height without its EC
        self._ec_misses: dict = {}
        # (key, handle) of the next window's dispatch, already in flight
        self._inflight = None
        self.pipeline_stats = {
            "reused": 0,  # pre-dispatched handles consumed
            "dispatched": 0,  # fresh dispatches
            "predispatched": 0,  # lookahead dispatches issued
            "discarded": 0,  # handles dropped (redo, valset, reshuffle)
        }
        # what the pool routine caught (it retries after each)
        self.loop_errors = LoopErrors()
        self.retry_s = RETRY_MIN_S
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        # blocks a second of the last window that applied any, from its
        # prepare to its last apply (the Prometheus window gauge)
        self.last_window_bps = 0.0
        self._tracer = TRACE_NOOP

    @property
    def tracer(self):
        """The window spans' tracer (``blocksync.window.*``)."""
        return self._tracer

    @tracer.setter
    def tracer(self, tracer) -> None:
        # the executor this reactor drives records its phase spans
        # (exec.*) on the same ring, nested in blocksync.window.exec
        self._tracer = tracer
        self.block_exec.tracer = tracer

    # --- lifecycle ----------------------------------------------------

    async def start(self) -> None:
        self.pool.start_requesters()
        self._task = asyncio.create_task(self._pool_routine())

    async def stop(self) -> None:
        self._stopped = True
        self.pool.stop()
        if self._task:
            self._task.cancel()
            try:
                # bounded: the routine may be waiting on a verify in an
                # executor; abandon it past the budget
                await asyncio.wait_for(self._task, 10.0)
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                if not self._task.cancelled():
                    raise  # stop() itself was cancelled: propagate
            except Exception:
                traceback.print_exc()

    # --- the verify/apply loop ----------------------------------------

    async def _pool_routine(self) -> None:
        last_switch_check = time.monotonic()
        last_kind = None
        while not self._stopped:
            if time.monotonic() - last_switch_check > SWITCH_TO_CONSENSUS_INTERVAL_S:
                last_switch_check = time.monotonic()
                # switch when caught up, or when blocksync cannot go on
                # without our own votes (reference reactor.go:543)
                if self.pool.is_caught_up() or (
                    self.local_blocks_chain is not None and self.local_blocks_chain(self.state)
                ):
                    _log.info(
                        "caught up, leaving blocksync",
                        height=self.state.last_block_height,
                        applied=self.blocks_applied,
                    )
                    if self.on_caught_up:
                        self.on_caught_up(self.state)
                    return
            # one extra window of lookahead: _process_window_overlapped
            # pre-dispatches the next window before applying this one
            window = self.pool.peek_window(self.window * 2)
            if len(window) < 2:
                with self.tracer.span("blocksync.window.fill_wait", tid="blocksync", blocks=len(window)):
                    await self.pool.wait_for_block()
                continue
            t0 = time.monotonic()
            try:
                if self.ingestor is None:
                    applied = await self._process_window_overlapped(window)
                else:
                    # adaptive mode: consensus shares this loop, and
                    # the blocking pass serializes against it — an
                    # await inside the pass would let consensus commit
                    # mid-window against the pass's state view
                    applied = self._process_window(window)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                if self.loop_errors.add(e):
                    traceback.print_exc()
                LoopErrors.drop_frames(e)
                kind = LoopErrors.kind(e)
                # back off while the same error repeats
                self.retry_s = min(2 * self.retry_s, RETRY_MAX_S) if kind == last_kind else RETRY_MIN_S
                last_kind = kind
                with self.tracer.span("blocksync.window.backoff", tid="blocksync", reason="error"):
                    await asyncio.sleep(self.retry_s)
                continue
            if applied:
                self.retry_s, last_kind = RETRY_MIN_S, None
                self.last_window_bps = applied / (time.monotonic() - t0)
            else:
                with self.tracer.span("blocksync.window.backoff", tid="blocksync", reason="none_applied"):
                    await asyncio.sleep(RETRY_MIN_S)
            # the fetch tasks the pass left pending run here
            with self.tracer.span("blocksync.window.yield", tid="blocksync"):
                await asyncio.sleep(0)

    def _process_window(self, window) -> int:
        """Verify every verifiable height of the window in ONE dispatch,
        then apply them in order; returns the number applied. The
        blocking form (tests); the pool routine waits in an executor
        instead (_process_window_overlapped)."""
        with self.tracer.span("blocksync.window.prepare", tid="blocksync"):
            prep = self._prepare_window(window)
        if prep is None:
            return 0
        window, jobs, handle = prep
        with self.tracer.span("blocksync.window.verify_wait", tid="blocksync", jobs=len(jobs)):
            errors = handle.result()
        pre = self._predispatch_lookahead(len(jobs))
        with self.tracer.span("blocksync.window.apply", tid="blocksync", jobs=len(jobs)):
            return self._apply_window(window, jobs, errors, pre)

    async def _process_window_overlapped(self, window) -> int:
        """_process_window with the verify wait in the default executor:
        the event loop keeps serving fetches while the window verifies,
        and the lookahead verifies while this window is applied."""
        with self.tracer.span("blocksync.window.prepare", tid="blocksync"):
            prep = self._prepare_window(window)
        if prep is None:
            return 0
        window, jobs, handle = prep
        with self.tracer.span("blocksync.window.verify_wait", tid="blocksync", jobs=len(jobs)):
            # the tickets are awaited on the loop, so the executor
            # thread only folds verdicts and never waits on the card
            for ticket in handle.tickets:
                await resolved(ticket)
            errors = await asyncio.get_running_loop().run_in_executor(None, handle.result)
        pre = self._predispatch_lookahead(len(jobs))
        with self.tracer.span("blocksync.window.apply", tid="blocksync", jobs=len(jobs)):
            return self._apply_window(window, jobs, errors, pre)

    def _dispatch(self, jobs):
        return verify_commits_coalesced_async(
            self.state.chain_id,
            jobs,
            cache=self.sig_cache,
            priority=PRIORITY_CATCHUP,
            device=self.device,
        )

    def _prepare_window(self, window):
        """Dispatch (or reuse) the window's coalesced batch. None when
        nothing is verifiable this pass, else (window, jobs, handle).

        The batch uses the current state's validator set, so it stops
        at the first height whose header names another validators_hash
        (a valset change mid-window): those heights verify on a later
        pass. The hash only LIMITS the batch; each block is still
        validated against the locally derived valset when applied."""
        if self.ingestor is not None:
            # adaptive mode: consensus may also be committing heights
            # (its own rounds, commit_block catch-up). Track its state
            # and drop the heights it already owns, else the window
            # would verify against a stale valset and ban honest peers.
            self.state = self.ingestor.state
            while window and window[0][0] < self.ingestor.rs.height:
                self.pool.pop_request()
                self.blocks_applied += 1
                window = window[1:]
            if len(window) < 2:
                return None
        # take (and clear) the pre-dispatched handle first: every exit
        # from this pass either consumes it or drops it
        inflight, self._inflight = self._inflight, None
        vals_hash = self.state.validators.hash()
        jobs, key = self._build_jobs(window, vals_hash, self.window - 1)
        if not jobs:
            if inflight is not None:
                self.pipeline_stats["discarded"] += 1
            if len(window) >= 1:
                # the head block names a valset our state does not
                # derive: it cannot validate, refetch it elsewhere
                h, _, peer = window[0]
                self.pool.redo_request(h, peer)
            return None
        handle = self._reuse_inflight(inflight, jobs, key) if inflight is not None else None
        if handle is None:
            if inflight is not None:
                self.pipeline_stats["discarded"] += 1
            handle = self._dispatch(jobs)
            self.pipeline_stats["dispatched"] += 1
        return window, jobs, handle

    def _reuse_inflight(self, inflight, jobs, key):
        """Match the pre-dispatched handle against this pass's jobs by
        content, allowing length drift either way (each job is
        independent, so verdict prefixes compose):

        - lookahead covers the window: consume its verdicts' prefix;
        - lookahead shorter (the pool refilled after its peek): consume
          all of it and dispatch just the rest, spliced in order.

        Any content mismatch (a refetched block, a valset change)
        returns None and the caller drops the handle."""
        pre_key, pre_handle = inflight
        if pre_key[0] != key[0]:
            return None
        pre_hs, hs = pre_key[1], key[1]
        if len(hs) <= len(pre_hs):
            if pre_hs[: len(hs)] != hs:
                return None
            self.pipeline_stats["reused"] += 1
            if len(hs) == len(pre_hs):
                return pre_handle
            return _PrefixErrors(pre_handle, len(hs) - 1)
        if hs[: len(pre_hs)] != pre_hs:
            return None
        n_pre = len(pre_hs) - 1
        rest_handle = self._dispatch(jobs[n_pre:])
        self.pipeline_stats["reused"] += 1
        self.pipeline_stats["dispatched"] += 1
        return _SplicedErrors(pre_handle, rest_handle, n_pre)

    def _predispatch_lookahead(self, n_skip: int):
        """Dispatch the NEXT window before applying this one, peeked
        after this window's verdicts resolved so that it covers what
        the requesters fetched meanwhile. Built on the pre-apply
        valset: only heights whose headers name the same
        validators_hash enter it, and the reuse key is checked against
        the post-apply state before any verdict is consumed. Its span
        (``blocksync.window.lookahead``) lies between the window's
        verify_wait and its apply: the peek, the jobs, their sign
        bytes and the dispatch."""
        with self.tracer.span("blocksync.window.lookahead", tid="blocksync", jobs=0) as sp:
            tail = self.pool.peek_window(self.window * 2)[n_skip:]
            if len(tail) < 2:
                return None
            pre_jobs, pre_key = self._build_jobs(tail, self.state.validators.hash(), self.window - 1)
            if not pre_jobs:
                return None
            sp.set(jobs=len(pre_jobs))
            self.pipeline_stats["predispatched"] += 1
            return pre_key, self._dispatch(pre_jobs)

    def _canonical_parts(self, blk, nxt):
        """The block's part set: from the peer's wire bytes when they
        give the part-set header the validators signed (saving a
        re-encode), else from our canonical encoding. On a mismatch the
        wire-byte memos are dropped, so nothing downstream persists a
        peer's non-canonical encoding."""
        signed_psh = nxt.last_commit.block_id.part_set_header
        raw = getattr(blk, "_raw_bytes", None)
        if raw is not None:
            parts = PartSet.from_data(raw)
            if parts.header.hash == signed_psh.hash:
                return parts
            for o in (blk, blk.last_commit):
                if hasattr(o, "_raw_bytes"):
                    del o._raw_bytes
        return PartSet.from_data(codec.encode_block(blk))

    def _apply_window(self, window, jobs, errors, pre) -> int:
        """Apply the window's verified blocks in order; returns the
        number applied. ``errors`` are the per-job verdicts."""
        # Stage the window's store writes and flush them in ONE batch
        # before any apply: the commit batch vouched for every staged
        # header, and a store ahead of the state is the direction the
        # handshake replays back (consensus/replay.py). Departure
        # (ROADMAP C4): staging also stops at the first block whose
        # body does not match its header (validate_basic: data and
        # last-commit hashes), which the JAX package stores and then
        # refuses to apply, leaving the peer's txs in the store.
        # The ingestor path owns its own persistence (consensus saves
        # each block it ingests).
        parts_by_idx = {}
        ec_by_idx = {}
        entries = []
        with self.tracer.span("blocksync.window.stage", tid="blocksync"):
            for i in range(len(jobs) if self.ingestor is None else 0):
                if errors[i] is not None:
                    break
                h, blk, peer_i = window[i]
                _, nxt, _ = window[i + 1]
                try:
                    blk.validate_basic()
                except ValueError:
                    break  # the apply loop refuses it and refetches
                parts = self._canonical_parts(blk, nxt)
                parts_by_idx[i] = parts
                # a block whose extended commit is missing or invalid never
                # enters the store bare
                enabled = self.state.consensus_params.vote_extensions_enabled(h)
                try:
                    ec_bytes = self._check_extended_commit(h, blk, peer_i)
                except DeviceRouteError:
                    raise  # no verdict on the peer (C7): nothing staged
                except Exception:
                    # the apply loop below re-runs the check at this height
                    # and owns the tolerance and redo logic
                    break
                ec_by_idx[i] = (enabled, ec_bytes)
                if self.block_store.height() < h:
                    entries.append((blk, parts, nxt.last_commit))
        if entries:
            with self.tracer.span("blocksync.window.persist", tid="blocksync", blocks=len(entries)):
                self.block_store.save_block_batch(entries)
        applied = 0
        for i, _job in enumerate(jobs):
            h, blk, peer = window[i]
            _, nxt, _ = window[i + 1]
            if errors[i] is not None:
                # a bad commit: block h (its hash is the expected
                # BlockID) or h+1's LastCommit may be at fault, so both
                # senders are banned and refetched (reference
                # handleValidationFailure, blocksync/reactor.go:749)
                _log.error(
                    "commit verification failed, refetching",
                    height=h,
                    peer=str(peer)[:12],
                    err=repr(errors[i]),
                )
                self.pool.redo_request(h, peer)
                if window[i + 1][2] != peer:
                    self.pool.redo_request(h + 1, window[i + 1][2])
                break
            bid = jobs[i][1]
            try:
                self.block_exec.validate_block(self.state, blk, skip_commit_check=True)
            except Exception:
                self.pool.redo_request(h, peer)
                break
            try:
                cached = ec_by_idx.get(i)
                if cached is not None and cached[0] == (
                    self.state.consensus_params.vote_extensions_enabled(h)
                ):
                    ec_bytes = cached[1]
                else:
                    if cached is not None:
                        # consensus params moved mid-window: roll the
                        # unapplied store tip back to h-1 before
                        # deciding again, so a block whose EC became
                        # required never stays stored bare
                        while self.block_store.height() >= h:
                            self.block_store.delete_latest_block()
                    ec_bytes = self._check_extended_commit(h, blk, peer)
            except MissingExtendedCommit:
                served = self._ec_misses.setdefault(h, set())
                served.add(peer)
                # bare apply only below the tip (the switch-to-consensus
                # block needs its EC), and only after EC_MISS_TOLERANCE
                # distinct peers, or every peer able to serve h, came
                # back without one
                at_tip = h >= self.pool.max_peer_height() - 1
                can_serve = {pid for pid, p in self.pool.peers.items() if p.base <= h <= p.height}
                exhausted = bool(can_serve) and served >= can_serve
                if at_tip or (len(served) < EC_MISS_TOLERANCE and not exhausted):
                    # refetch without a ban, steered to another peer
                    _log.info(
                        "peer lacks extended commit, refetching",
                        height=h,
                        distinct_peers=len(served),
                        at_tip=at_tip,
                    )
                    self.pool.exclude_peer_for_height(h, peer)
                    self.pool.redo_request(h, None)
                    break
                _log.info(
                    "applying historical block without extended commit",
                    height=h,
                    distinct_peers=len(served),
                )
                ec_bytes = None
            except DeviceRouteError:
                # the card failed, not the peer (C7): no refetch, no
                # ban; the pool routine counts it and retries
                raise
            except Exception as e:
                _log.error("extended commit check failed, refetching", height=h, err=repr(e))
                self.pool.redo_request(h, peer)
                break
            # persist the verified EC at once, so this node can serve it
            if ec_bytes and not self.block_store.load_extended_commit(h):
                self.block_store.save_extended_commit(h, ec_bytes)
            parts = parts_by_idx.get(i)
            if parts is None:
                parts = self._canonical_parts(blk, nxt)
            if self.ingestor is not None:
                # adaptive sync: the verified block goes straight into
                # the consensus state machine, which applies it and
                # returns the post-apply state (so the rest of the
                # window validates against it)
                if blk.height < self.ingestor.rs.height:
                    # consensus ingested it concurrently (catch-up)
                    self.state = self.ingestor.state
                    self.pool.pop_request()
                    self.blocks_applied += 1
                    applied += 1
                    continue
                try:
                    self.state = self.ingestor.ingest_verified_block(blk, parts, nxt.last_commit)
                except ValueError:
                    # consensus is mid-commit at this height; let it
                    # finish and resume on the next pass
                    break
            else:
                # usually saved by the window flush above; a block
                # behind an EC decision made in this loop was not staged
                if self.block_store.height() < h:
                    self.block_store.save_block(blk, parts, nxt.last_commit)
                with self.tracer.span("blocksync.window.exec", tid="blocksync", height=h):
                    self.state = self.block_exec.apply_verified_block(self.state, bid, blk)
            if h in self._ec_misses:
                del self._ec_misses[h]
                self.pool.clear_exclusions(h)
            self.pool.pop_request()
            self.blocks_applied += 1
            applied += 1
        else:
            # every job applied without a break: the next window's
            # handle stays for the next pass (subject to the key check)
            self._inflight = pre
        if pre is not None and self._inflight is not pre:
            self.pipeline_stats["discarded"] += 1
        return applied

    def _build_jobs(self, window, vals_hash, max_jobs: int):
        """Verify jobs for the leading valset-constant prefix of
        ``window`` (block i verified by block i+1's last_commit), and
        a reuse key naming the inputs by content: the valset hash and
        every involved block's hash (the hash covers the header, whose
        last_commit_hash binds the commit the job verifies)."""
        jobs = []
        for i in range(min(len(window) - 1, max_jobs)):
            h, blk, peer = window[i]
            _, nxt, _ = window[i + 1]
            if blk.header.validators_hash != vals_hash:
                break
            bid = BlockID(blk.hash(), nxt.last_commit.block_id.part_set_header)
            jobs.append((self.state.validators, bid, h, nxt.last_commit))
        key = (
            vals_hash,
            tuple(bytes(window[i][1].hash()) for i in range(len(jobs) + 1)) if jobs else (),
        )
        return jobs, key

    def _check_extended_commit(self, h, blk, peer):
        """With vote extensions enabled at height h the peer should send
        a valid extended commit with the block (reference
        blocksync/reactor.go:648). Returns the bytes to persist, or
        None when extensions are off. A missing payload raises
        MissingExtendedCommit (retried without a ban); an invalid one
        raises the verification error."""
        enabled = self.state.consensus_params.vote_extensions_enabled(h)
        ec_bytes = getattr(blk, "_ec_bytes", None)
        if not enabled:
            return None  # unsolicited payloads are ignored
        if not ec_bytes:
            raise MissingExtendedCommit(
                f"peer omitted extended commit at extension-enabled height {h}"
            )
        verify_extended_commit(
            self.state.chain_id,
            self.state.validators,
            blk.hash(),
            h,
            codec.decode_extended_commit(ec_bytes),
            cache=self.sig_cache,
            priority=PRIORITY_CATCHUP,
            device=self.device,
        )
        return ec_bytes
