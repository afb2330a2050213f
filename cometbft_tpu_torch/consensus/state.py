"""The BFT consensus state machine (reference consensus/state.go).

Tendermint rounds: propose -> prevote -> precommit -> commit, with
locking/unlocking, POL (proof-of-lock) tracking, WAL-before-act
persistence and crash replay.

Architecture (TPU-host-native, not a goroutine port): one asyncio task
(`_receive_routine`) is the single writer over RoundState — peers,
internal messages and timeouts all arrive on one queue, mirroring the
reference's single-threaded receiveRoutine (consensus/state.go:789)
without its mutex web. Timeouts are asyncio timers that enqueue; the
block executor + TPU signature verification run inline (they are the
actual work); gossip runs in reactor tasks reading RoundState snapshots.

A copy of the JAX package's ``consensus/state.py``, with its runtime
sanitizer hook: the state is tagged as affine to the loop thread that
starts it (``consensus.state``) and every handled message touches it
(``analysis/runtime.py``; one attribute check when it is off). Every
signature check that goes to the batch path runs on the state
machine's ``device`` (None is the GPU, and raises without one;
``device="cpu"`` the host plane or the plain kernels): the in-round
vote coalescer's waves, the ``commit_block`` catch-up commit and its
extended commit, and the proposal's LastCommit in ``validate_block``,
all at ``PRIORITY_LIVE``. A peer's vote that conflicts with one held
becomes duplicate-vote evidence in the evidence pool, which checks it
on the host.

Departure (ROADMAP C3): where the JAX module turns any exception into
a verdict — the coalescer's callback drops the vote as forged,
``_handle_commit_block`` drops the block, ``_enter_prevote`` and
``_enter_precommit`` vote nil — a ``crypto.scheduler.DeviceRouteError``
(a verify route that failed, with no verdict on any lane) is raised
instead, with the round step put back as it was; the receive routine
counts it in ``loop_errors`` (``utils.loop_errors.LoopErrors``)
and goes on, as does the coalescer's callback when the vote it adds
leads to a failed check. It never falls back to the host. A propose
timeout or a re-sent part retries the prevote's check, the
prevote-wait timeout or the round's next vote a polka's block check,
the sender's next ``commit_block`` the catch-up; a vote lost to a
failed wave is not retried. Every other error keeps the JAX handling.
"""

from __future__ import annotations

import asyncio
import time
import traceback
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.runtime import get_sanitizer
from ..config import ConsensusConfig
from ..crypto.scheduler import DeviceRouteError
from ..device import resolve
from ..obs.queues import InstrumentedQueue
from ..state.state_types import State
from ..store.block_store import _decode_part, _encode_part
from ..trace import NOOP as TRACE_NOOP
from ..types import events as ev
from ..types.block import NIL_BLOCK_ID, BlockID, PartSetHeader
from ..types.part_set import Part, PartSet
from ..types.signature_cache import SignatureCache
from ..types.validation import PRIORITY_LIVE, verify_commit, verify_extended_commit
from ..types.vote import PRECOMMIT, PREVOTE, Proposal, Vote
from ..types.vote_set import ErrVoteConflictingVotes
from ..utils import codec
from ..utils.fail import fail_point
from ..utils.log import Lazy, get_logger
from ..utils.loop_errors import LoopErrors
from ..utils.tasks import spawn
from . import wal as walmod
from .types import HeightVoteSet, RoundState, Step

_log = get_logger("consensus")


@dataclass
class ProposalMessage:
    proposal: Proposal


@dataclass
class BlockPartMessage:
    height: int
    round: int
    part: Part


@dataclass
class VoteMessage:
    vote: Vote


@dataclass
class TimeoutInfo:
    duration_s: float
    height: int
    round: int
    step: Step


class ConsensusState:
    def __init__(
        self,
        config: ConsensusConfig,
        state: State,
        block_exec,
        block_store,
        mempool,
        priv_validator=None,
        event_bus: Optional[ev.EventBus] = None,
        wal_path: Optional[str] = None,
        evidence_pool=None,
        on_decided: Optional[Callable] = None,
        device=None,
    ):
        self.config = config
        self.device = resolve(device)
        # loop-affinity guard (analysis/runtime.py): consensus state is
        # mutated only on its event loop
        self._sanitizer = get_sanitizer()
        self.block_exec = block_exec
        self.block_store = block_store
        self.mempool = mempool
        self.privval = priv_validator
        self.event_bus = event_bus or ev.EventBus()
        self.evpool = evidence_pool
        self.on_decided = on_decided  # hook: (height, block_id, block)

        # shared with the reactor's async coalescing verifier: votes
        # pre-verified in batches resolve as cache hits in add_vote
        self.sig_cache = SignatureCache()
        self.rs = RoundState()
        self.state: Optional[State] = None
        self.queue: "asyncio.Queue" = None  # created in start()
        self._timeout_task: Optional[asyncio.Task] = None
        self._routine_task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event() if False else None
        self._halting = False  # set by stop() / crash(): staged votes are dropped
        self.wal: Optional[walmod.WAL] = None
        self._wal_path = wal_path
        self._broadcast_hooks: List[Callable] = []
        self.decided_heights = 0
        # failed verify routes the receive routine met (C3)
        self.loop_errors = LoopErrors()
        # tracing plane (trace/, docs/TRACE.md): the node build swaps
        # in the real per-node tracer; NOOP keeps call sites
        # unconditional. Step spans are opened/closed across
        # callsites, so the open handles live here (LIFO:
        # height ⊇ round ⊇ step — Perfetto nests them by time range).
        self.tracer = TRACE_NOOP
        self._sp_height = None
        self._sp_round = None
        self._sp_step = None
        # commit-latency attribution (docs/TRACE.md
        # "Cross-node timelines"): per-height monotonic marks the
        # quorum spans and the last-commit breakdown are computed
        # from. All reset by update_to_state.
        self._round_t0_ns = 0
        self._proposal_complete_ns = 0
        self._verify_ns = 0
        self._quorum_at: Dict = {}  # (round, "prevote"|"precommit") -> ns
        self._vote_first: Dict = {}  # (round, vote type) -> first-arrival ns
        # {"height", "phases": {...}, "dominant"} for the last height
        # this node committed — served by RPC health so a degraded
        # verdict can cite the dominant phase
        self.last_commit_breakdown: Optional[Dict] = None
        # --- live-consensus fast path (docs/PERF.md) -----------------
        # in-round vote micro-batcher (built in start(): needs a loop);
        # peer votes pre-verify in coalesced batches and resolve as
        # sig_cache hits in add_vote
        self._vote_coalescer = None
        # pipelined finalize: height currently persisting/applying
        # off-loop (None = none; at most ONE in flight by design) and
        # the next-height messages parked until that height opens
        self._finalize_inflight: Optional[int] = None
        self._finalize_task: Optional[asyncio.Task] = None
        self._parked: List[Tuple] = []
        # deferred externalizations awaiting their WAL barrier, in
        # submission order (see _after_durable)
        self._durable_fifo: List[Tuple] = []

        self.update_to_state(state)

    # --- wiring -------------------------------------------------------

    def add_broadcast_hook(self, fn: Callable) -> None:
        """fn(kind, payload): called for every message this node emits
        (proposal / block part / vote) — the reactor's gossip feed."""
        self._broadcast_hooks.append(fn)

    def _broadcast(self, kind: str, payload) -> None:
        for fn in self._broadcast_hooks:
            try:
                fn(kind, payload)
            except Exception:
                traceback.print_exc()

    # --- lifecycle ----------------------------------------------------

    async def start(self) -> None:
        self._sanitizer.tag("consensus.state")
        self._halting = False
        self.queue = InstrumentedQueue(10000, name="consensus.inbox")
        self.event_bus.set_loop(asyncio.get_running_loop())
        if self._wal_path:
            # a power cut may have left a torn partial record at the
            # head's end; repair BEFORE reopening for append, or every
            # record written this incarnation lands after the garbage
            # and is lost on the next restart (wal.repair_torn_tail)
            walmod.WAL.repair_torn_tail(self._wal_path)
            self.wal = walmod.WAL(
                self._wal_path,
                tracer=self.tracer,
                group_commit_ms=self.config.wal_group_commit_ms,
            )
            self._catchup_replay()
            self._reconcile_privval_state()
        if self.config.vote_batch_window_ms > 0:
            # in-round vote-verify micro-batching (the blocksync
            # pre-verify pattern applied to live rounds): one batch
            # dispatch per arrival window, results land in sig_cache
            from ..crypto.coalesce import CoalescingVerifier

            self._vote_coalescer = CoalescingVerifier(
                cache=self.sig_cache,
                window_s=self.config.vote_batch_window_ms / 1000.0,
                device=self.device,
            )
        self._routine_task = asyncio.create_task(self._receive_routine())
        # kick off the first height
        self._schedule_timeout(
            0.0, self.rs.height, 0, Step.NEW_HEIGHT
        )

    async def stop(self) -> None:
        await self._halt(graceful=True)

    async def crash(self) -> None:
        """Abrupt in-process stop (chaos harness): cancel the routines
        and abandon the WAL without flushing buffered records — the
        power-cut analog of stop(). Recovery must come exclusively
        from fsync'd WAL prefixes + persisted stores."""
        await self._halt(graceful=False)

    async def _halt(self, graceful: bool) -> None:
        self._halting = True
        if self._routine_task:
            self._routine_task.cancel()
            try:
                # bounded: a receive routine wedged in a
                # swallowed cancel must not hang the halt — the WAL
                # close below seals the durable state either way
                await asyncio.wait_for(self._routine_task, 10.0)
            except asyncio.TimeoutError:
                _log.error(
                    "receive routine ignored cancel past budget, "
                    "abandoning", height=self.rs.height,
                )
            except asyncio.CancelledError:
                if not self._routine_task.cancelled():
                    raise  # outer cancel of stop()/crash(): propagate
            except Exception:
                traceback.print_exc()
        if self._timeout_task:
            self._timeout_task.cancel()
        if self._finalize_task and not self._finalize_task.done():
            if graceful:
                try:
                    # bounded: let an in-flight finalize land
                    # before sealing the WAL; a wedged apply is
                    # abandoned (recovery replays from the stores)
                    await asyncio.wait_for(self._finalize_task, 10.0)
                except asyncio.TimeoutError:
                    pass
                except asyncio.CancelledError:
                    if not self._finalize_task.cancelled():
                        raise  # outer cancel of stop(): propagate
                except Exception:
                    traceback.print_exc()
            else:
                self._finalize_task.cancel()
        if self._vote_coalescer is not None and graceful:
            try:
                # flush the last vote window so no future leaks into a
                # dead loop (drops are fine — the machine is stopping)
                await asyncio.wait_for(self._vote_coalescer.drain(), 5.0)
            except asyncio.TimeoutError:
                pass
            except asyncio.CancelledError:
                raise
            except Exception:
                traceback.print_exc()
        if self.wal:
            if graceful:
                self.wal.close()
            else:
                self.wal.crash_close()
        # record the in-progress height's open spans: the ring must
        # show what this node was doing when it stopped/crashed —
        # that partial timeline is exactly what the chaos dump
        # exists for
        self._close_trace_spans()

    # --- state transitions --------------------------------------------

    def update_to_state(self, state: State) -> None:
        """Reset RoundState for the next height (reference updateToState)."""
        if (
            self.rs.commit_round > -1
            and 0 < self.rs.height <= state.last_block_height
        ):
            pass  # committed by us; moving on
        self.state = state
        height = state.last_block_height + 1
        if height == state.initial_height:
            last_precommits = None
        else:
            last_precommits = self.rs.votes.precommits(
                self.rs.commit_round
            ) if self.rs.votes and self.rs.commit_round >= 0 else None
        # fresh height: reset the commit-latency attribution marks
        self._round_t0_ns = time.monotonic_ns()
        self._proposal_complete_ns = 0
        self._verify_ns = 0
        self._quorum_at = {}
        self._vote_first = {}
        self.rs = RoundState(
            height=height,
            round=0,
            step=Step.NEW_HEIGHT,
            validators=state.validators.copy(),
            votes=HeightVoteSet(
                state.chain_id, height, state.validators,
                sig_cache=self.sig_cache,
            ),
            last_commit=last_precommits,
            last_validators=state.last_validators.copy()
            if state.last_validators and getattr(state.last_validators, "validators", None)
            else None,
            start_time_ns=time.time_ns(),
        )

    # --- receive routine (single writer) ------------------------------

    async def _receive_routine(self) -> None:
        while True:
            item = await self.queue.get()
            try:
                kind, payload, peer_id = item
                if kind == "timeout":
                    self._wal_write(
                        walmod.WALMessage(
                            kind=walmod.MSG_TIMEOUT,
                            height=payload.height,
                            round=payload.round,
                            step=str(int(payload.step)),
                        ),
                        sync=True,
                    )
                    self._handle_timeout(payload)
                else:
                    if self._park_next_height(kind, payload, peer_id):
                        continue
                    if (
                        kind == "vote"
                        and peer_id != ""
                        and self._maybe_prestage_vote(payload, peer_id)
                    ):
                        continue  # re-enqueues once batch-verified
                    self._wal_write_msg(kind, payload, peer_id)
                    self._handle_msg(kind, payload, peer_id)
            except asyncio.CancelledError:
                raise
            except DeviceRouteError as e:
                # no verdict (C3): counted, the round state as it was
                self._count_route_error(e)
            except Exception as e:
                _log.error(
                    "receive routine error",
                    height=self.rs.height,
                    kind=item[0] if item else "?",
                    err=repr(e),
                )
                traceback.print_exc()
            if (
                self._vote_coalescer is not None
                and self.queue.qsize() == 0
            ):
                # inbox drained = the natural micro-batch boundary:
                # dispatch the staged vote wave NOW instead of letting
                # the window timer starve behind a busy loop
                self._vote_coalescer.flush()

    def _count_route_error(self, e: DeviceRouteError) -> None:
        if self.loop_errors.add(e):
            _log.error("verify route failed, no verdict", height=self.rs.height, err=repr(e))
        LoopErrors.drop_frames(e)

    def _handle_msg(self, kind: str, payload, peer_id: str) -> None:
        if self._sanitizer.enabled:
            self._sanitizer.touch("consensus.state")
        if self.tracer.enabled:
            self._trace_handle(kind, payload, peer_id)
        if kind == "proposal":
            if self._set_proposal(payload.proposal) and peer_id != "":
                self._broadcast("proposal", payload)
        elif kind == "block_part":
            added = self._add_proposal_block_part(
                payload.height, payload.round, payload.part
            )
            if added and peer_id != "":
                self._broadcast("block_part", payload)
        elif kind == "vote":
            self._try_add_vote(payload.vote, peer_id)
        elif kind == "commit_block":
            self._handle_commit_block(payload, peer_id)
        elif kind == "retry_sign":
            self._handle_sign_retry(payload)
        elif kind == "signed_vote":
            # our own vote, signed off-loop by a remote signer
            self._commit_own_vote(payload.vote)
        elif kind == "signed_proposal":
            prop, parts = payload
            self._publish_own_proposal(prop, parts)

    def _trace_handle(self, kind: str, payload, peer_id: str) -> None:
        """Correlated handling instant: the state-machine
        side of the p2p.msg.recv instants — the gap between the two is
        the consensus-inbox queue wait."""
        h = r = None
        if kind == "proposal":
            h, r = payload.proposal.height, payload.proposal.round
        elif kind == "block_part":
            h, r = payload.height, payload.round
        elif kind in ("vote", "signed_vote"):
            h, r = payload.vote.height, payload.vote.round
        elif kind == "commit_block":
            h = payload.block.height
        else:
            return
        self.tracer.instant(
            "consensus.msg.handle", tid="consensus", kind=kind,
            h=h, r=r, peer=peer_id[:12] if peer_id else "self",
        )

    def _handle_commit_block(self, payload, peer_id: str) -> None:
        """Catch-up: a peer sent us a committed block + its commit
        (the reactor-level analog of the reference's part-by-part
        catch-up gossip, consensus/reactor.go gossipDataForCatchup).
        Verify the commit against OUR validator set, then ingest."""
        rs = self.rs
        block, commit = payload.block, payload.commit
        if block.height != rs.height:
            return
        # reuse peer wire bytes only when they produce the PSH the
        # commit binds to — a non-canonical encoding of a valid block
        # must fall back to canonical re-encode, not get dropped
        # (same guard as blocksync/reactor.py's apply loop)
        raw = getattr(block, "_raw_bytes", None)
        parts = None
        if raw is not None:
            parts = PartSet.from_data(raw)
            if parts.header.hash != commit.block_id.part_set_header.hash:
                parts = None
        if parts is None:
            parts = PartSet.from_data(codec.encode_block(block))
        bid = BlockID(block.hash(), parts.header)
        if commit.block_id.hash != bid.hash:
            return
        if rs.step >= Step.COMMIT:
            # already committing from our own precommits, but we may be
            # MISSING the block itself (enter_commit's "reset parts"
            # branch). Adopt the received block if it matches the
            # committed BlockID, then finalize.
            maj = (
                rs.votes.precommits(rs.commit_round).two_thirds_majority()
                if rs.commit_round >= 0
                else None
            )
            if (
                rs.proposal_block is None
                and maj is not None
                and not maj.is_nil()
                and maj.hash == bid.hash
                and maj.part_set_header.hash == parts.header.hash
            ):
                rs.proposal_block = block
                rs.proposal_block_parts = parts
                self._try_finalize_commit(block.height)
            return
        try:
            verify_commit(
                self.state.chain_id,
                rs.validators,
                bid,
                block.height,
                commit,
                cache=self.sig_cache,
                priority=PRIORITY_LIVE,
                device=self.device,
            )
        except DeviceRouteError:
            raise  # no verdict on the block (C3)
        except Exception:
            return
        self.ingest_verified_block(block, parts, commit)
        # persist the EC the sender shipped alongside (reference
        # SaveBlockWithExtendedCommit on every commit path): without
        # this, a node that caught up here can never serve the EC to a
        # future blocksync joiner. Invalid/missing EC never rejects the
        # block — the plain commit already verified.
        ec_bytes = getattr(payload, "ec_bytes", None)
        if ec_bytes and self.state.consensus_params.vote_extensions_enabled(
            block.height
        ):
            if not self.block_store.load_extended_commit(block.height):
                try:
                    # the EC's embedded commit carries the same
                    # precommit sigs just verified above: with the
                    # shared cache the re-check is near-free and only
                    # the extension lanes cost real verifies
                    verify_extended_commit(
                        self.state.chain_id,
                        rs.validators,
                        bid.hash,
                        block.height,
                        codec.decode_extended_commit(ec_bytes),
                        cache=self.sig_cache,
                        priority=PRIORITY_LIVE,
                        device=self.device,
                    )
                    self.block_store.save_extended_commit(
                        block.height, ec_bytes
                    )
                except DeviceRouteError:
                    raise  # no verdict on the extended commit (C3)
                except Exception:
                    traceback.print_exc()

    def ingest_verified_block(self, block, parts, commit):
        """Adaptive-sync ingest (reference consensus/state_ingest.go:231
        + reactor IngestVerifiedBlock): commit a block WITHOUT running
        rounds. Caller must have verified `commit` against this
        height's validator set. Returns the post-apply State."""
        rs = self.rs
        if block.height != rs.height:
            raise ValueError(
                f"ingest at height {block.height}, consensus at {rs.height}"
            )
        if rs.step >= Step.COMMIT:
            raise ValueError("consensus already committing this height")
        bid = BlockID(block.hash(), parts.header)
        return self._apply_committed_block(
            block, parts, commit, bid, immediate=True
        )

    def _apply_committed_block(
        self, block, parts, commit, bid, immediate: bool
    ):
        """Shared tail of _finalize_commit and ingest_verified_block:
        persist, WAL-barrier, apply, advance to the next height."""
        timings = self._finalize_tail(block, parts, commit, bid)
        return self._complete_finalize(
            block, bid, timings, immediate=immediate
        )

    def _finalize_tail(self, block, parts, commit, bid) -> Tuple:
        """The blocking legs: persist -> WAL end-height barrier ->
        ABCI apply (strictly this order; reference state.go:1769-1837)."""
        t_fin, t_persist, t_wal = self._finalize_persist(
            block, parts, commit
        )
        return self._finalize_apply(
            block, bid, t_fin, t_persist, t_wal
        )

    def _finalize_persist(self, block, parts, commit) -> Tuple:
        """Persist + WAL end-height barrier — the GIL-releasing disk
        legs (sqlite writes, fsync). Thread-safe against the receive
        loop (stores and the WAL take their own locks), so the
        pipelined path overlaps them with live gossip relay via
        asyncio.to_thread. The pure-Python ABCI apply deliberately
        does NOT ride along: offloading it to a thread just fights
        the loop for the GIL and loses outright on a 2-vCPU host."""
        height = block.height
        t_fin = time.monotonic_ns()
        fail_point("cs-before-save-block")  # reference state.go:1769
        if self.block_store.height() < height:
            self.block_store.save_block(block, parts, commit)
        else:
            self.block_store.save_seen_commit(height, commit)
        t_persist = time.monotonic_ns()
        fail_point("cs-after-save-block")  # :1786
        if self.wal:
            self.wal.write_end_height(height)
        t_wal = time.monotonic_ns()
        fail_point("cs-after-wal-end-height")  # :1809
        return t_fin, t_persist, t_wal

    def _finalize_apply(
        self, block, bid, t_fin, t_persist, t_wal
    ) -> Tuple:
        new_state = self.block_exec.apply_verified_block(
            self.state, bid, block
        )
        t_apply = time.monotonic_ns()
        fail_point("cs-after-apply")  # :1837
        return new_state, t_fin, t_persist, t_wal, t_apply

    def _complete_finalize(
        self, block, bid, timings, immediate: bool,
        pipelined: bool = False,
    ):
        """Loop-side completion: record the waterfall, advance to the
        next height, release parked next-height messages."""
        new_state, t_fin, t_persist, t_wal, t_apply = timings
        height = block.height
        _log.info(
            "finalized block",
            height=height,
            hash=Lazy(lambda: block.hash()[:8].hex()),
            txs=len(block.data.txs),
            app_hash=Lazy(lambda: new_state.app_hash[:8].hex()),
        )
        self.decided_heights += 1
        # finalize leg of the commit waterfall (recorded before the
        # height span closes below, so it nests in Perfetto)
        self.tracer.complete(
            "consensus.finalize", t_fin, t_apply - t_fin,
            tid="consensus", height=height,
            persist_ms=round((t_persist - t_fin) / 1e6, 3),
            wal_ms=round((t_wal - t_persist) / 1e6, 3),
            apply_ms=round((t_apply - t_wal) / 1e6, 3),
            pipelined=pipelined,
        )
        if pipelined:
            # end-to-end pipelined finalize including the loop handoff
            # (its own budget entry; the loop itself never stalled)
            self.tracer.complete(
                "consensus.finalize.pipelined", t_fin,
                time.monotonic_ns() - t_fin,
                tid="consensus", height=height,
            )
        self._note_commit_breakdown(height, t_fin, t_persist, t_wal, t_apply)
        # close the height's span stack and stamp the commit;
        # ingest-path commits may have no open round/step spans
        self._close_trace_spans()
        self.tracer.instant(
            "consensus.commit", tid="consensus",
            height=height, txs=len(block.data.txs),
        )
        if self.on_decided:
            try:
                self.on_decided(height, bid, block)
            except Exception:
                traceback.print_exc()
        self.update_to_state(new_state)
        if pipelined:
            self._finalize_inflight = None
            self._finalize_task = None
        if self._parked and self.queue is not None:
            # the new height just opened: replay everything that
            # arrived for it early, ahead of whatever else is queued
            parked, self._parked = self._parked, []
            for item in parked:
                try:
                    self.queue.put_nowait(item)
                except asyncio.QueueFull:
                    # inbox drowning (10k deep): shed THIS item and
                    # keep trying the rest — the standard overload
                    # policy; dropping the whole tail would lose a
                    # proposal the flood never resends
                    self.queue.count_drop()
        if self.queue is not None:  # only once started
            self._schedule_timeout(
                0.0
                if immediate or self.config.skip_timeout_commit
                else self.config.timeout_commit_s,
                self.rs.height,
                0,
                Step.NEW_HEIGHT,
            )
        return new_state

    def _handle_timeout(self, ti: TimeoutInfo) -> None:
        rs = self.rs
        if ti.height != rs.height or (
            ti.round < rs.round
            or (ti.round == rs.round and ti.step < rs.step and ti.step != Step.NEW_HEIGHT)
        ):
            return
        if ti.step == Step.NEW_HEIGHT:
            self._enter_new_round(ti.height, 0)
        elif ti.step == Step.NEW_ROUND:
            self._enter_propose(ti.height, 0)
        elif ti.step == Step.PROPOSE:
            self.event_bus.publish_type(ev.EVENT_TIMEOUT_PROPOSE, rs.height)
            self._enter_prevote(ti.height, ti.round)
        elif ti.step == Step.PREVOTE_WAIT:
            self.event_bus.publish_type(ev.EVENT_TIMEOUT_WAIT, rs.height)
            self._enter_precommit(ti.height, ti.round)
        elif ti.step == Step.PRECOMMIT_WAIT:
            self.event_bus.publish_type(ev.EVENT_TIMEOUT_WAIT, rs.height)
            self._enter_precommit(ti.height, ti.round)
            self._enter_new_round(ti.height, ti.round + 1)

    # --- WAL ----------------------------------------------------------

    def _wal_write_msg(
        self, kind: str, payload, peer_id: str
    ) -> Optional[walmod.SyncTicket]:
        if self.wal is None:
            return None
        if kind == "proposal":
            m = walmod.WALMessage(
                kind=walmod.MSG_PROPOSAL,
                height=payload.proposal.height,
                round=payload.proposal.round,
                data=codec.encode_proposal(payload.proposal),
                peer_id=peer_id,
            )
        elif kind == "block_part":
            m = walmod.WALMessage(
                kind=walmod.MSG_BLOCK_PART,
                height=payload.height,
                round=payload.round,
                data=_encode_part(payload.part),
                peer_id=peer_id,
            )
        elif kind == "vote":
            m = walmod.WALMessage(
                kind=walmod.MSG_VOTE,
                height=payload.vote.height,
                round=payload.vote.round,
                data=codec.encode_vote(payload.vote),
                peer_id=peer_id,
            )
        else:
            return None
        # own messages (peer_id == "") are fsync barriers (state.go:881)
        return self._wal_write(m, sync=(peer_id == ""))

    def _wal_write(
        self, m: walmod.WALMessage, sync: bool
    ) -> Optional[walmod.SyncTicket]:
        """Returns the barrier's SyncTicket for sync writes (done
        immediately on the strict path, after the covering group
        fsync otherwise); None for async writes / no WAL."""
        if self.wal is None:
            return None
        if sync:
            # group seam: with wal_group_commit_ms == 0 this IS the
            # strict write_sync and the ticket comes back done
            return self.wal.write_group(m)
        self.wal.write(m)
        return None

    def _after_durable(self, ticket, fn: Callable) -> None:
        """WAL-before-act: run ``fn`` (an externalization — broadcast
        of our own vote/proposal) only once its barrier record is
        durable. Strict-path / absent tickets run inline.

        Deferred actions drain through a FIFO, NOT straight off each
        ticket: a later barrier whose ticket happens to be done at
        registration time (its group fsync landed while the current
        handler was still running) must not jump ahead of an earlier
        barrier whose callback is still queued on the loop — peers
        receiving a proposer's first block part before its proposal
        drop the part on the floor, and flood delivery never resends
        (observed as systematic round-0 failure)."""
        if ticket is None or (ticket.done() and not self._durable_fifo):
            fn()
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            # no loop (sync test harness): the barrier cannot be
            # awaited — block for it, bounded, then act
            ticket.wait(1.0)
            fn()
            return
        self._durable_fifo.append((ticket, fn))
        ticket.add_done_callback(
            lambda: loop.call_soon_threadsafe(self._drain_durable)
        )

    def _drain_durable(self) -> None:
        """Run every queued externalization whose barrier has landed,
        strictly in submission order (head-of-line blocks the rest)."""
        fifo = self._durable_fifo
        while fifo and fifo[0][0].done():
            _, fn = fifo.pop(0)
            try:
                fn()
            except Exception:
                traceback.print_exc()

    # --- in-round vote pre-verification (fast path) -------------------

    def _maybe_prestage_vote(self, payload, peer_id: str) -> bool:
        """Route a current-height peer vote through the coalescing
        batch verifier; returns True when staged (the vote re-enqueues
        once its batch resolves, then lands in add_vote as a
        sig_cache hit). Anything the batcher cannot judge — other
        heights, unknown indexes, already-cached signatures — handles
        inline, where add_vote produces the canonical verdicts."""
        vc = self._vote_coalescer
        if vc is None:
            return False
        vote = payload.vote
        rs = self.rs
        if (
            vote.height != rs.height
            or rs.validators is None
            or not vote.signature
            or not 0 <= vote.validator_index < rs.validators.size()
        ):
            return False
        val = rs.validators.get_by_index(vote.validator_index)
        if val is None or val.address != vote.validator_address:
            return False
        sb = vote.sign_bytes(self.state.chain_id)
        if self.sig_cache.contains(
            sb, vote.signature, val.pub_key.key_bytes
        ):
            # pre-verified (reactor batch, a re-delivery, or our own
            # earlier window): inline handling cache-hits — also the
            # cycle-breaker for the re-enqueued staged vote itself
            return False
        fut = vc.submit(val.pub_key, sb, vote.signature)

        def _done(f: "asyncio.Future") -> None:
            if self._halting:
                # the stop's last window resolved after the receive
                # routine ended: the vote is dropped, not handled on a
                # machine whose WAL is closing
                return
            ok = False
            try:
                ok = bool(f.result())
            except DeviceRouteError as e:
                # the wave's route failed: no verdict on this vote
                # (C3), so it is neither dropped as forged nor added
                self._count_route_error(e)
                return
            except Exception:
                pass
            if not ok:
                _log.error(
                    "dropping vote with invalid signature",
                    height=vote.height,
                    round=vote.round,
                    peer=peer_id[:12],
                )
                return
            # same-loop continuation: the callback runs on the event
            # loop, i.e. inside the single-writer context — handle
            # directly instead of paying another queue round trip and
            # a second prestage/cache pass. The height may have moved
            # while the batch was in flight: the normal park/height
            # guards apply.
            try:
                if self._park_next_height("vote", payload, peer_id):
                    return
                self._wal_write_msg("vote", payload, peer_id)
                self._handle_msg("vote", payload, peer_id)
            except DeviceRouteError as e:
                # the vote's own route succeeded; a check it led to
                # (the polka's block in _enter_precommit) failed (C3)
                self._count_route_error(e)
            except Exception:
                traceback.print_exc()

        fut.add_done_callback(_done)
        return True

    # --- pipelined-finalize parking -----------------------------------

    _PARK_LIMIT = 2048

    def _park_next_height(self, kind: str, payload, peer_id: str) -> bool:
        """Messages for the NEXT height would be dropped by the height
        guards and cost a gossip-retransmit round trip (or, on a
        flood-only harness, the whole round). They arrive whenever
        delivery is not globally ordered — a peer that committed
        first proposes h+1 while our own commit of h is a few ms from
        landing (batched vote windows, group-commit broadcast
        deferral, pipelined finalize). Park them (bounded) and replay
        at height entry."""
        h = None
        if kind == "proposal":
            h = payload.proposal.height
        elif kind == "block_part":
            h = payload.height
        elif kind in ("vote", "signed_vote"):
            h = payload.vote.height
        elif kind == "commit_block":
            h = payload.block.height
        if h is None or h != self.rs.height + 1:
            return False
        if len(self._parked) < self._PARK_LIMIT:
            self._parked.append((kind, payload, peer_id))
        return True

    def _catchup_replay(self) -> None:
        """Replay WAL messages for the current height after a crash
        (reference consensus/replay.go:94)."""
        path = self._wal_path
        end_prev = walmod.WAL.search_for_end_height(
            path, self.rs.height - 1
        )
        if end_prev is None and self.rs.height > self.state.initial_height:
            return
        replaying = []
        if end_prev is not None:
            msgs = list(walmod.WAL.iter_messages(path))[end_prev:]
            replaying = msgs
        else:
            replaying = list(
                walmod.WAL.iter_messages(path)
            )
        if replaying:
            _log.info(
                "replaying WAL messages for current height",
                height=self.rs.height,
                count=len(replaying),
            )
        for m in replaying:
            try:
                self._replay_one(m)
            except Exception:
                traceback.print_exc()

    def _replay_one(self, m: walmod.WALMessage) -> None:
        if m.kind == walmod.MSG_PROPOSAL:
            self._set_proposal(codec.decode_proposal(m.data))
        elif m.kind == walmod.MSG_BLOCK_PART:
            self._add_proposal_block_part(
                m.height, m.round, _decode_part(m.data)
            )
        elif m.kind == walmod.MSG_VOTE:
            self._try_add_vote(codec.decode_vote(m.data), m.peer_id)

    def _reconcile_privval_state(self) -> None:
        """Group-commit recovery: a crash between an own-vote append
        and its group fsync loses the WAL record, but the privval
        state file — fsync-persisted BEFORE the signature is ever
        released (privval/file_pv.py) — still holds the signed vote.
        Rebuild it from that authoritative record and feed it back
        through the normal own-vote path; without this, replay asks
        the signer for an already-passed step and every retry dies on
        DoubleSignError while the height wedges. No-op whenever the
        WAL already carried the vote (the strict serial path)."""
        pv = self.privval
        last = getattr(pv, "last", None)  # remote signers: no state
        if (
            last is None
            or not last.sign_bytes
            or not last.signature
            or last.height != self.rs.height
        ):
            return
        try:
            vote = self._vote_from_privval_state(last)
        except Exception:
            traceback.print_exc()
            return
        if vote is None:
            return
        vs = (
            self.rs.votes.prevotes(vote.round)
            if vote.type_ == PREVOTE
            else self.rs.votes.precommits(vote.round)
        )
        if (
            vs is None
            or not 0 <= vote.validator_index < len(vs.votes)
            or vs.votes[vote.validator_index] is not None
        ):
            return  # replayed from the WAL — nothing was lost
        if vote.type_ == PRECOMMIT and not vote.block_id.is_nil():
            rs = self.rs
            have_block = (
                rs.proposal_block is not None
                and rs.proposal_block.hash() == vote.block_id.hash
            ) or (
                rs.proposal_block_parts is not None
                and rs.proposal_block_parts.header.hash
                == vote.block_id.part_set_header.hash
            )
            val = rs.validators.get_by_index(vote.validator_index)
            alone_quorum = (
                val is not None
                and val.voting_power * 3
                > rs.validators.total_voting_power() * 2
            )
            if not have_block and alone_quorum:
                # the WAL lost the block this precommit binds to
                # (crash inside the same group window) and our own
                # power forms a quorum: injecting the vote would
                # drive _enter_commit into waiting forever for parts
                # that exist nowhere. Roll the signer back instead —
                # see _rollback_privval_to_wal for why that is safe.
                self._rollback_privval_to_wal(vote)
                return
        _log.info(
            "reconciling own vote lost from WAL tail (privval state "
            "is authoritative)",
            height=vote.height,
            round=vote.round,
            type=vote.type_,
        )
        self._commit_own_vote(vote)

    def _rollback_privval_to_wal(self, vote: Vote) -> None:
        """Reset the signer's last-sign state to the newest own record
        the fsync'd WAL holds.

        Safe because externalization is gated on durability: a
        broadcast fires only after its record's covering fsync
        (_after_durable), on the strict path and the group path
        alike — so a vote present in the privval state but ABSENT
        from the WAL was provably never sent to anyone, and
        re-signing at that HRS cannot put conflicting signatures on
        the wire. (Prefix-ordered durability extends the proof
        backward: if this precommit never fsync'd, neither did
        anything we wrote after the last WAL-backed record.) The one
        unprovable case — an operator deleting the WAL while keeping
        the privval state — is exactly the setup the reference's
        double-sign protection cannot distinguish either."""
        from ..privval.file_pv import (
            _LastSign,
            STEP_PRECOMMIT,
            STEP_PREVOTE,
        )

        rs = self.rs
        idx = vote.validator_index
        newest = None  # (vote, privval step) from the replayed WAL
        for r in range(vote.round, -1, -1):
            for vset, step in (
                (rs.votes.precommits(r), STEP_PRECOMMIT),
                (rs.votes.prevotes(r), STEP_PREVOTE),
            ):
                v = (
                    vset.votes[idx]
                    if vset is not None and idx < len(vset.votes)
                    else None
                )
                if v is not None and v.signature:
                    newest = (v, step)
                    break
            if newest is not None:
                break
        if newest is None:
            new_last = _LastSign(height=vote.height, round=0, step=0)
        else:
            v, step = newest
            new_last = _LastSign(
                height=v.height,
                round=v.round,
                step=step,
                signature=v.signature.hex(),
                sign_bytes=v.sign_bytes(self.state.chain_id).hex(),
            )
        _log.info(
            "rolling back privval state to the newest WAL-proven "
            "record (lost vote was never externalized)",
            height=vote.height,
            round=vote.round,
            lost_type=vote.type_,
            restored_step=new_last.step,
        )
        self.privval.last = new_last
        try:
            self.privval.save_state()
        except Exception:
            traceback.print_exc()

    def _vote_from_privval_state(self, last) -> Optional[Vote]:
        """Decode FilePV's canonical sign bytes back into our Vote;
        None when it isn't a vote of ours for this height (proposals,
        other chains, valsets we left)."""
        from ..utils import proto

        sb = bytes.fromhex(last.sign_bytes)
        payload, _ = proto.read_delimited(sb)
        m = proto.parse(payload)
        type_c = proto.get1(m, 1, 0)
        if type_c not in (PREVOTE, PRECOMMIT):
            return None
        chain = proto.get1(m, 6, b"").decode()
        if chain != self.state.chain_id:
            return None
        bid_raw = proto.get1(m, 4, None)
        if bid_raw is None:
            bid = NIL_BLOCK_ID
        else:
            bm = proto.parse(bid_raw)
            pm = proto.parse(proto.get1(bm, 2, b""))
            bid = BlockID(
                proto.get1(bm, 1, b""),
                PartSetHeader(
                    proto.get1(pm, 1, 0), proto.get1(pm, 2, b"")
                ),
            )
        if (
            self.state.consensus_params.vote_extensions_enabled(
                last.height
            )
            and type_c == PRECOMMIT
            and not bid.is_nil()
        ):
            # the extension payload/signature are not in the privval
            # state; a rebuilt extensionless precommit would be
            # rejected by every peer's VerifyVoteExtension gate
            return None
        addr = self.privval.pub_key().address()
        idx, val = self.rs.validators.get_by_address(addr)
        if idx < 0 or val is None:
            return None
        vote = Vote(
            type_=type_c,
            height=last.height,
            round=last.round,
            block_id=bid,
            timestamp_ns=proto.parse_timestamp(
                proto.get1(m, 5, b"")
            ),
            validator_address=addr,
            validator_index=idx,
            signature=bytes.fromhex(last.signature),
        )
        # the rebuilt encoding must reproduce the signed bytes exactly
        # or the signature is for something else — refuse to inject
        if vote.sign_bytes(chain) != sb:
            return None
        return vote

    # --- timeout scheduling -------------------------------------------

    def _schedule_timeout(
        self, duration_s: float, height: int, round_: int, step: Step
    ) -> None:
        if self._timeout_task is not None:
            self._timeout_task.cancel()
        ti = TimeoutInfo(duration_s, height, round_, step)

        async def fire():
            try:
                if duration_s > 0:
                    await asyncio.sleep(duration_s)
                await self.queue.put(("timeout", ti, ""))
            except asyncio.CancelledError:
                pass

        self._timeout_task = asyncio.create_task(fire())

    # --- round entry functions ----------------------------------------

    def _enter_new_round(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step != Step.NEW_HEIGHT
        ):
            return
        if round_ > rs.round:
            vals = rs.validators.copy()
            vals.increment_proposer_priority(round_ - rs.round)
            rs.validators = vals
        # close the previous round's open spans (step first — LIFO)
        # so the new round's spans nest cleanly under the height span
        self._close_trace_spans("_sp_step", "_sp_round")
        _log.debug("entering new round", height=height, round=round_)
        self._round_t0_ns = time.monotonic_ns()
        rs.round = round_
        rs.step = Step.NEW_ROUND
        if round_ > 0:
            # new round: reset proposal (keep locked/valid blocks)
            rs.proposal = None
            rs.proposal_block = None
            rs.proposal_block_parts = None
        rs.votes.set_round(round_)
        rs.triggered_timeout_precommit = False
        self.event_bus.publish_type(
            ev.EVENT_NEW_ROUND, {"height": height, "round": round_}
        )
        self._new_step()
        # wait for txs? (create_empty_blocks interval) — proceed directly
        self._enter_propose(height, round_)

    def _enter_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= Step.PROPOSE
        ):
            return
        _log.debug("entering propose step", height=height, round=round_)
        rs.step = Step.PROPOSE
        self._new_step()
        self._schedule_timeout(
            self.config.propose_timeout(round_), height, round_, Step.PROPOSE
        )
        if self.privval is None:
            self._maybe_finish_propose(height, round_)
            return
        try:
            our_addr = self.privval.pub_key().address()
        except Exception:
            # remote signer unavailable; propose timeout cycles round
            self._maybe_finish_propose(height, round_)
            return
        if not rs.validators.has_address(our_addr):
            self._maybe_finish_propose(height, round_)
            return
        proposer = rs.validators.get_proposer()
        if proposer.address == our_addr:
            self._decide_proposal(height, round_)
        self._maybe_finish_propose(height, round_)

    def _maybe_finish_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.proposal_block is not None and rs.proposal is not None:
            self._enter_prevote(height, round_)

    def _decide_proposal(self, height: int, round_: int) -> None:
        """We are the proposer (reference defaultDecideProposal :1246)."""
        rs = self.rs
        if rs.valid_block is not None:
            block, parts = rs.valid_block, rs.valid_block_parts
        else:
            last_commit = None
            if height > self.state.initial_height:
                seen = self.block_store.load_seen_commit(height - 1)
                last_commit = seen
                if last_commit is None and rs.last_commit is not None:
                    last_commit = rs.last_commit.make_commit()
                if last_commit is None:
                    return  # cannot propose without last commit
            extended_commit = None
            if (
                height > self.state.initial_height
                and self.state.consensus_params.vote_extensions_enabled(
                    height - 1
                )
            ):
                raw = self.block_store.load_extended_commit(height - 1)
                try:
                    extended_commit = (
                        codec.decode_extended_commit(raw) if raw else None
                    )
                except Exception:
                    traceback.print_exc()
                    extended_commit = None
                if extended_commit is None:
                    # extensions were promised to the app; proposing a
                    # plain CommitInfo instead would silently violate
                    # the ABCI contract (reference panics here). Skip
                    # this proposal — another proposer that holds the
                    # extended commit takes the next round.
                    _log.error(
                        "no extended commit for previous height; "
                        "refusing to propose",
                        height=height,
                    )
                    return
            try:
                block, parts = self.block_exec.create_proposal_block(
                    height,
                    self.state,
                    last_commit,
                    self.privval.pub_key().address(),
                    extended_commit=extended_commit,
                )
            except Exception:
                traceback.print_exc()
                return
        bid = BlockID(block.hash(), parts.header)
        _log.info(
            "proposing block",
            height=height,
            round=round_,
            hash=Lazy(lambda: block.hash()[:8].hex()),
            txs=len(block.data.txs),
        )
        prop = Proposal(
            height=height,
            round=round_,
            pol_round=rs.valid_round,
            block_id=bid,
            timestamp_ns=time.time_ns(),
        )
        if getattr(self.privval, "REMOTE_BLOCKING", False) and self.queue:
            chain_id = self.state.chain_id

            async def sign_off_loop():
                try:
                    await asyncio.to_thread(
                        self.privval.sign_proposal, chain_id, prop
                    )
                except asyncio.CancelledError:
                    raise  # consensus stop cancels in-flight signs
                except Exception:
                    traceback.print_exc()
                    return  # propose timeout moves the round along
                self.enqueue_nowait("signed_proposal", (prop, parts), "")

            spawn(sign_off_loop(), name="privval-sign-off")
            return
        try:
            self.privval.sign_proposal(self.state.chain_id, prop)
        except Exception:
            traceback.print_exc()
            return
        self._publish_own_proposal(prop, parts)

    def _publish_own_proposal(self, prop: Proposal, parts) -> None:
        """Feed our signed proposal + parts to ourselves and the
        gossip hooks (we ARE the single writer here)."""
        rs = self.rs
        if prop.height != rs.height or prop.round != rs.round:
            return  # round moved on while signing remotely
        tprop = self._wal_write_msg("proposal", ProposalMessage(prop), "")
        self._set_proposal(prop)
        self._after_durable(
            tprop,
            lambda: self._broadcast("proposal", ProposalMessage(prop)),
        )
        for i in range(parts.header.total):
            part = parts.get_part(i)
            msg = BlockPartMessage(prop.height, prop.round, part)
            # one fsync typically covers the proposal + every part
            # (the group window): the proposer's worst per-height
            # fsync storm collapses to one barrier
            tpart = self._wal_write_msg("block_part", msg, "")
            self._add_proposal_block_part(prop.height, prop.round, part)
            self._after_durable(
                tpart, lambda m=msg: self._broadcast("block_part", m)
            )

    def _set_proposal(self, proposal: Proposal) -> bool:
        rs = self.rs
        if rs.proposal is not None:
            return False
        if proposal.height != rs.height or proposal.round != rs.round:
            return False
        proposal.validate_basic()
        proposer = rs.validators.get_proposer()
        if not proposal.verify(self.state.chain_id, proposer.pub_key):
            raise ValueError("invalid proposal signature")
        rs.proposal = proposal
        if rs.proposal_block_parts is None:
            rs.proposal_block_parts = PartSet(proposal.block_id.part_set_header)
        return True

    def _add_proposal_block_part(
        self, height: int, round_: int, part: Part
    ) -> bool:
        rs = self.rs
        if height != rs.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        added = rs.proposal_block_parts.add_part(part)
        if not added:
            return False
        if rs.proposal_block_parts.is_complete():
            data = rs.proposal_block_parts.assemble()
            block = codec.decode_block(data)
            rs.proposal_block = block
            # attribution mark: proposal fully propagated to this node
            self._proposal_complete_ns = time.monotonic_ns()
            self.tracer.instant(
                "consensus.proposal.complete", tid="consensus",
                height=height, round=rs.round,
            )
            self.event_bus.publish_type(
                ev.EVENT_COMPLETE_PROPOSAL,
                {"height": height, "block_id": rs.proposal.block_id if rs.proposal else None},
            )
            # prevotes may already have a polka for this block
            prevotes = rs.votes.prevotes(rs.round)
            bid = prevotes.two_thirds_majority()
            if bid is not None and not bid.is_nil() and rs.valid_round < rs.round:
                if block.hash() == bid.hash:
                    rs.valid_round = rs.round
                    rs.valid_block = block
                    rs.valid_block_parts = rs.proposal_block_parts
            if rs.step <= Step.PROPOSE and rs.proposal is not None:
                self._enter_prevote(height, rs.round)
            elif rs.step == Step.COMMIT:
                self._try_finalize_commit(height)
        return True

    # --- prevote ------------------------------------------------------

    def _enter_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= Step.PREVOTE
        ):
            return
        _log.debug("entering prevote step", height=height, round=round_)
        prev_step = rs.step
        rs.step = Step.PREVOTE
        self._new_step()
        try:
            self._do_prevote(height, round_)
        except DeviceRouteError:
            # no verdict on the proposal (C3): the step goes back, so
            # the propose timeout or a re-sent part checks it again
            rs.step = prev_step
            raise

    def _do_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        # locked block? vote for it (reference defaultDoPrevote :1387)
        if rs.locked_block is not None:
            self._sign_add_vote(
                PREVOTE,
                rs.locked_block.hash(),
                rs.locked_block_parts.header,
            )
            return
        if rs.proposal_block is None:
            self._sign_add_vote(PREVOTE, None, None)
            return
        # validate (spanned: the "verify" leg of the per-height
        # commit-latency waterfall, docs/TRACE.md)
        t_verify = time.monotonic_ns()
        try:
            self.block_exec.validate_block(
                self.state, rs.proposal_block, priority=PRIORITY_LIVE
            )
            accepted = self.block_exec.process_proposal(
                rs.proposal_block, self.state
            )
        except DeviceRouteError:
            raise
        except Exception:
            accepted = False
        self._verify_ns = time.monotonic_ns() - t_verify
        self.tracer.complete(
            "consensus.verify", t_verify, self._verify_ns,
            tid="consensus", height=height, round=round_,
            accepted=accepted,
        )
        if accepted:
            self._sign_add_vote(
                PREVOTE,
                rs.proposal_block.hash(),
                rs.proposal_block_parts.header,
            )
        else:
            self._sign_add_vote(PREVOTE, None, None)

    # --- precommit ----------------------------------------------------

    def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= Step.PREVOTE_WAIT
        ):
            return
        rs.step = Step.PREVOTE_WAIT
        self._new_step()
        self._schedule_timeout(
            self.config.prevote_timeout(round_),
            height,
            round_,
            Step.PREVOTE_WAIT,
        )

    def _enter_precommit(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.step >= Step.PRECOMMIT
        ):
            return
        _log.debug("entering precommit step", height=height, round=round_)
        prev_step = rs.step
        rs.step = Step.PRECOMMIT
        self._new_step()
        try:
            self._do_precommit(height, round_)
        except DeviceRouteError:
            # no verdict on the polka's block (C3): the step goes back
            rs.step = prev_step
            raise

    def _do_precommit(self, height: int, round_: int) -> None:
        rs = self.rs
        prevotes = rs.votes.prevotes(round_)
        bid = prevotes.two_thirds_majority()
        if bid is None:
            # no polka: precommit nil
            self._sign_add_vote(PRECOMMIT, None, None)
            return
        self.event_bus.publish_type(
            ev.EVENT_POLKA, {"height": height, "round": round_}
        )
        if bid.is_nil():
            # polka for nil: unlock
            rs.locked_round = -1
            rs.locked_block = None
            rs.locked_block_parts = None
            self._sign_add_vote(PRECOMMIT, None, None)
            return
        # polka for a block
        if rs.locked_block is not None and rs.locked_block.hash() == bid.hash:
            rs.locked_round = round_
            self._sign_add_vote(PRECOMMIT, bid.hash, bid.part_set_header)
            return
        if rs.proposal_block is not None and rs.proposal_block.hash() == bid.hash:
            try:
                self.block_exec.validate_block(
                    self.state,
                    rs.proposal_block,
                    priority=PRIORITY_LIVE,
                )
                rs.locked_round = round_
                rs.locked_block = rs.proposal_block
                rs.locked_block_parts = rs.proposal_block_parts
                self.event_bus.publish_type(
                    ev.EVENT_LOCK, {"height": height, "round": round_}
                )
                self._sign_add_vote(
                    PRECOMMIT, bid.hash, bid.part_set_header
                )
                return
            except DeviceRouteError:
                raise
            except Exception:
                traceback.print_exc()
        # polka for a block we don't have: unlock, precommit nil
        rs.locked_round = -1
        rs.locked_block = None
        rs.locked_block_parts = None
        self._sign_add_vote(PRECOMMIT, None, None)

    def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or (
            rs.round == round_ and rs.triggered_timeout_precommit
        ):
            return
        rs.triggered_timeout_precommit = True
        self._new_step()
        self._schedule_timeout(
            self.config.precommit_timeout(round_),
            height,
            round_,
            Step.PRECOMMIT_WAIT,
        )

    # --- commit -------------------------------------------------------

    def _enter_commit(self, height: int, commit_round: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step >= Step.COMMIT:
            return
        _log.debug(
            "entering commit step", height=height, round=commit_round
        )
        rs.step = Step.COMMIT
        rs.commit_round = commit_round
        rs.commit_time_ns = time.time_ns()
        self._new_step()
        bid = rs.votes.precommits(commit_round).two_thirds_majority()
        assert bid is not None and not bid.is_nil()
        # if we have the block already as locked/proposal, stage it
        if rs.locked_block is not None and rs.locked_block.hash() == bid.hash:
            rs.proposal_block = rs.locked_block
            rs.proposal_block_parts = rs.locked_block_parts
        if (
            rs.proposal_block is None
            or rs.proposal_block.hash() != bid.hash
        ):
            # we're missing the block: reset parts to fetch it
            if (
                rs.proposal_block_parts is None
                or rs.proposal_block_parts.header.hash != bid.part_set_header.hash
            ):
                rs.proposal_block = None
                rs.proposal_block_parts = PartSet(bid.part_set_header)
            return
        self._try_finalize_commit(height)

    def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height or rs.step != Step.COMMIT:
            return
        if self._finalize_inflight is not None:
            return  # single in-flight height: the pipeline's barrier
        bid = rs.votes.precommits(rs.commit_round).two_thirds_majority()
        if bid is None or bid.is_nil():
            return
        if rs.proposal_block is None or rs.proposal_block.hash() != bid.hash:
            return
        self._finalize_commit(height)

    def _finalize_commit(self, height: int) -> None:
        rs = self.rs
        block, parts = rs.proposal_block, rs.proposal_block_parts
        bid = BlockID(block.hash(), parts.header)
        seen_commit = rs.votes.precommits(rs.commit_round).make_commit()
        if self.state.consensus_params.vote_extensions_enabled(height):
            # persist the extension payloads alongside the block so
            # the proposer can feed them to the NEXT height's
            # PrepareProposal (reference SaveBlockWithExtendedCommit)
            try:
                ec = rs.votes.precommits(
                    rs.commit_round
                ).make_extended_commit()
                self.block_store.save_extended_commit(
                    height, codec.encode_extended_commit(ec)
                )
            except Exception:
                traceback.print_exc()
        # persist + WAL end-height barrier (reference :1775-1801) +
        # apply + advance (commit already verified by consensus itself)
        if self.config.finalize_pipeline and self.queue is not None:
            self._start_pipelined_finalize(block, parts, seen_commit, bid)
            return
        self._apply_committed_block(
            block, parts, seen_commit, bid, immediate=False
        )

    def _start_pipelined_finalize(self, block, parts, commit, bid) -> None:
        """Run the finalize tail off-loop so the receive routine keeps
        relaying gossip (votes/parts/catch-up) during persist + fsync +
        apply. Bounded to one in-flight height: _try_finalize_commit
        refuses to start another until _complete_finalize lands, and
        the next height only opens there — the barrier before the next
        commit is structural."""
        height = block.height
        self._finalize_inflight = height
        # NOTE: _parked is NOT cleared — messages for height+1 parked
        # before the commit quorum landed are exactly what the replay
        # at _complete_finalize exists to deliver

        async def run():
            try:
                # the disk legs go off-loop: the loop keeps relaying
                # votes/parts while sqlite + the end-height fsync
                # grind
                t_fin, t_persist, t_wal = await asyncio.to_thread(
                    self._finalize_persist, block, parts, commit
                )
                if self.config.finalize_offload_apply:
                    # native finalize lane (state/native_finalize.py):
                    # the ABCI dispatch stays on-loop (app-owned,
                    # GIL-ful), but the hash/encode/persist leg —
                    # which the native pass runs with the GIL
                    # RELEASED — rides a second thread hop, so the
                    # loop relays gossip through it too. Same phase
                    # order and fail points as the serial apply_block.
                    resp = self.block_exec.apply_finalize(
                        self.state, block, verified=True
                    )
                    def hash_persist():
                        # timed THREAD-SIDE: the span is the leg the
                        # native lane owns (tx hashes, result encodes,
                        # LastResultsHash, event encodes, the response
                        # write) without the loop-resume latency of
                        # the to_thread hop, which on a saturated box
                        # dwarfs the work itself
                        t_a = time.monotonic_ns()
                        out = self.block_exec.apply_hash_persist(
                            self.state, bid, block, resp
                        )
                        return out, t_a, time.monotonic_ns()

                    (new_state, artifacts), t_a, t_b = (
                        await asyncio.to_thread(hash_persist)
                    )
                    self.tracer.complete(
                        "consensus.finalize.hash_persist", t_a,
                        t_b - t_a,
                        tid="consensus", height=block.height,
                        native=artifacts.native,
                    )
                    new_state = self.block_exec.apply_complete(
                        new_state, bid, block, resp, artifacts
                    )
                    t_apply = time.monotonic_ns()
                    fail_point("cs-after-apply")  # :1837
                    timings = (
                        new_state, t_fin, t_persist, t_wal, t_apply
                    )
                else:
                    # legacy shape: the whole (pure-Python, GIL-bound)
                    # ABCI apply runs back on the loop exactly like
                    # the serial path
                    timings = self._finalize_apply(
                        block, bid, t_fin, t_persist, t_wal
                    )
            except asyncio.CancelledError:
                raise
            except Exception:
                _log.error(
                    "pipelined finalize failed", height=height
                )
                traceback.print_exc()
                # release the barrier: a later precommit/part retries
                # through _try_finalize_commit (the tail is idempotent
                # — save_block is height-guarded, end-height re-marks;
                # parked next-height messages stay parked for the
                # retry's completion)
                self._finalize_inflight = None
                return
            self._complete_finalize(
                block, bid, timings, immediate=False, pipelined=True
            )

        self._finalize_task = spawn(run(), name="finalize-pipeline")

    # --- votes --------------------------------------------------------

    def _sign_add_vote(
        self,
        type_: int,
        block_hash: Optional[bytes],
        psh: Optional[PartSetHeader],
    ) -> None:
        rs = self.rs
        if self.privval is None:
            return
        try:
            addr = self.privval.pub_key().address()
        except Exception:
            traceback.print_exc()
            self._schedule_sign_retry(
                type_, block_hash, psh, rs.height, rs.round
            )
            return
        if not rs.validators.has_address(addr):
            return
        idx, _ = rs.validators.get_by_address(addr)
        bid = (
            BlockID(block_hash, psh)
            if block_hash is not None
            else NIL_BLOCK_ID
        )
        vote = Vote(
            type_=type_,
            height=rs.height,
            round=rs.round,
            block_id=bid,
            timestamp_ns=time.time_ns(),
            validator_address=addr,
            validator_index=idx,
        )
        want_ext = (
            type_ == PRECOMMIT
            and not bid.is_nil()
            and self.state.consensus_params.vote_extensions_enabled(rs.height)
        )
        if want_ext:
            # the APP authors the extension content (reference
            # consensus/state.go ExtendVote -> ABCI boundary). A
            # failure must NOT degrade to signing an empty extension:
            # peers' VerifyVoteExtension would reject the whole
            # precommit, silently equivalent to not voting — retry
            # instead (the app may be restarting).
            try:
                vote.extension = self.block_exec.extend_vote(
                    bid.hash, rs.height, rs.round, vote.timestamp_ns
                )
            except Exception:
                _log.error(
                    "ExtendVote failed; retrying vote",
                    height=rs.height,
                    round=rs.round,
                )
                traceback.print_exc()
                self._schedule_sign_retry(
                    type_, block_hash, psh, rs.height, rs.round
                )
                return
        if getattr(self.privval, "REMOTE_BLOCKING", False) and self.queue:
            # remote signer: a socket round trip must not block the
            # event loop — sign in a worker thread and feed the signed
            # vote back through the single-writer queue
            chain_id = self.state.chain_id

            def do_sign():
                self.privval.sign_vote(chain_id, vote)
                if want_ext:
                    self.privval.sign_vote_extension(chain_id, vote)

            async def sign_off_loop():
                try:
                    await asyncio.to_thread(do_sign)
                except asyncio.CancelledError:
                    raise  # consensus stop cancels in-flight signs
                except Exception as e:
                    from ..privval import DoubleSignError

                    traceback.print_exc()
                    if not isinstance(e, DoubleSignError):
                        self._schedule_sign_retry(
                            type_, block_hash, psh, vote.height, vote.round
                        )
                    return
                self.enqueue_nowait("signed_vote", VoteMessage(vote), "")

            spawn(sign_off_loop(), name="privval-sign-off")
            return
        try:
            self.privval.sign_vote(self.state.chain_id, vote)
            if want_ext:
                self.privval.sign_vote_extension(self.state.chain_id, vote)
        except Exception as e:
            from ..privval import DoubleSignError

            traceback.print_exc()
            if isinstance(e, DoubleSignError):
                # permanent: the signer's state is AHEAD of this ask
                # (e.g. group-commit recovery rebuilt an earlier step)
                # — retrying the same HRS can never succeed, and the
                # privval-state reconciliation / round progression is
                # what recovers liveness
                return
            # signing can fail transiently (remote signer down):
            # retry while the round is still current, else a lone or
            # pivotal validator stalls forever even after the signer
            # returns. Safe: FilePV re-serves the signature for votes
            # differing only by timestamp, so no double-sign risk.
            self._schedule_sign_retry(
                type_, block_hash, psh, rs.height, rs.round
            )
            return
        self._commit_own_vote(vote)

    def _check_vote_extension(self, vote: Vote) -> None:
        """Peer-vote extension rules (reference consensus/state.go
        addVote -> VerifyVoteExtension boundary):

        - extensions disabled, or a prevote, or a nil precommit: any
          extension data is rejected (byzantine padding would otherwise
          be stored, gossiped, and fed to the app against the ABCI
          contract);
        - extensions enabled + non-nil precommit: the extension
          signature must verify and the app must accept — checked only
          for NEW votes (duplicates short-circuit before the ed25519 +
          ABCI round trip).
        """
        rs = self.rs
        enabled = self.state.consensus_params.vote_extensions_enabled(
            vote.height
        )
        is_ext_precommit = (
            enabled
            and vote.type_ == PRECOMMIT
            and not vote.block_id.is_nil()
        )
        if not is_ext_precommit:
            if vote.extension or vote.extension_signature:
                raise ValueError(
                    "unexpected vote extension data (disabled height, "
                    "prevote, or nil precommit)"
                )
            return
        # duplicate? the vote set dedups cheaply; don't pay the
        # signature + app round trip again for re-gossiped votes
        existing = rs.votes.precommits(vote.round).get_vote(
            vote.validator_index
        ) if 0 <= vote.validator_index < rs.validators.size() else None
        if (
            existing is not None
            and existing.block_id.key() == vote.block_id.key()
        ):
            return
        val = rs.validators.get_by_index(vote.validator_index)
        if val is None or not vote.extension_signature:
            raise ValueError("missing vote extension signature")
        if not val.pub_key.verify(
            vote.extension_sign_bytes(self.state.chain_id),
            vote.extension_signature,
        ):
            raise ValueError("invalid vote extension signature")
        if not self.block_exec.verify_vote_extension(vote):
            raise ValueError("app rejected vote extension")

    def _commit_own_vote(self, vote: Vote) -> None:
        ticket = self._wal_write_msg("vote", VoteMessage(vote), "")
        self._try_add_vote(vote, "")
        # WAL-before-act: the group-commit seam defers the BROADCAST
        # (the externalization that must never precede durability)
        # until the vote's barrier fsync lands; adding to our own
        # vote set above is in-memory only and crash-consistent
        self._after_durable(
            ticket, lambda: self._broadcast("vote", VoteMessage(vote))
        )

    def _schedule_sign_retry(
        self, type_, block_hash, psh, height: int, round_: int
    ) -> None:
        if self.queue is None:
            return

        async def retry():
            await asyncio.sleep(1.0)
            try:
                self.queue.put_nowait(
                    ("retry_sign", (type_, block_hash, psh, height, round_), "")
                )
            except asyncio.QueueFull:
                pass

        spawn(retry(), name="sign-retry")

    def _handle_sign_retry(self, payload) -> None:
        type_, block_hash, psh, height, round_ = payload
        rs = self.rs
        if rs.height != height or rs.round != round_:
            return  # round moved on; normal flow takes over
        if rs.votes is not None:
            vs = (
                rs.votes.prevotes(round_)
                if type_ == PREVOTE
                else rs.votes.precommits(round_)
            )
            if vs is not None and self.privval is not None:
                try:
                    addr = self.privval.pub_key().address()
                    idx, _ = rs.validators.get_by_address(addr)
                    if idx >= 0 and vs.votes[idx] is not None:
                        return  # already signed + added
                except Exception:
                    # signer STILL down (the very case retries exist
                    # for): keep the chain of retries alive
                    self._schedule_sign_retry(
                        type_, block_hash, psh, height, round_
                    )
                    return
        self._sign_add_vote(type_, block_hash, psh)

    def _try_add_vote(self, vote: Vote, peer_id: str) -> None:
        rs = self.rs
        try:
            if vote.height + 1 == rs.height and vote.type_ == PRECOMMIT:
                # late precommit for the previous height
                if rs.last_commit is not None:
                    try:
                        rs.last_commit.add_vote(vote)
                    except Exception:
                        pass
                return
            if vote.height != rs.height:
                return
            if peer_id != "":
                self._check_vote_extension(vote)
            added = rs.votes.add_vote(vote)
            if not added:
                return
        except ErrVoteConflictingVotes as e:
            if self.evpool is not None and peer_id != "":
                _, val = rs.validators.get_by_address(vote.validator_address)
                if val is not None:
                    from ..evidence.types import DuplicateVoteEvidence

                    evd = DuplicateVoteEvidence.from_votes(
                        e.existing,
                        e.new,
                        val.voting_power,
                        rs.validators.total_voting_power(),
                        time.time_ns(),
                    )
                    _log.info(
                        "found conflicting vote, adding evidence",
                        height=vote.height,
                        round=vote.round,
                        validator=vote.validator_address.hex()[:12],
                    )
                    try:
                        self.evpool.add_evidence(evd)
                    except Exception:
                        pass
            return
        except Exception as e:
            _log.error(
                "failed to add vote",
                height=vote.height,
                round=vote.round,
                type=vote.type_,
                peer=peer_id,
                err=repr(e),
            )
            return
        self.event_bus.publish_type(ev.EVENT_VOTE, vote)
        if self.tracer.enabled and vote.height == rs.height:
            self._record_vote_arrival(vote, peer_id)
        if peer_id != "":
            self._broadcast("vote", VoteMessage(vote))
        height, round_ = rs.height, rs.round
        if vote.type_ == PREVOTE:
            prevotes = rs.votes.prevotes(vote.round)
            bid = prevotes.two_thirds_majority()
            if bid is not None and not bid.is_nil():
                self._record_quorum(vote.round, "prevote")
                # unlock if POL for something else (reference :2274)
                if (
                    rs.locked_block is not None
                    and rs.locked_round < vote.round <= rs.round
                    and rs.locked_block.hash() != bid.hash
                ):
                    rs.locked_round = -1
                    rs.locked_block = None
                    rs.locked_block_parts = None
                # update valid block
                if (
                    rs.valid_round < vote.round <= rs.round
                    and rs.proposal_block is not None
                    and rs.proposal_block.hash() == bid.hash
                ):
                    rs.valid_round = vote.round
                    rs.valid_block = rs.proposal_block
                    rs.valid_block_parts = rs.proposal_block_parts
            if vote.round == round_:
                if prevotes.has_two_thirds_majority():
                    self._enter_precommit(height, vote.round)
                elif (
                    rs.step == Step.PREVOTE and prevotes.has_two_thirds_any()
                ):
                    self._enter_prevote_wait(height, vote.round)
            elif vote.round > round_ and rs.votes.prevotes(
                vote.round
            ).has_two_thirds_any():
                self._enter_new_round(height, vote.round)
        else:  # PRECOMMIT
            precommits = rs.votes.precommits(vote.round)
            bid = precommits.two_thirds_majority()
            if bid is not None:
                if not bid.is_nil():
                    self._record_quorum(vote.round, "precommit")
                self._enter_new_round(height, vote.round)
                self._enter_precommit(height, vote.round)
                if not bid.is_nil():
                    self._enter_commit(height, vote.round)
                    self._try_finalize_commit(height)
                    if self.config.skip_timeout_commit and precommits.has_all():
                        pass
                else:
                    self._enter_precommit_wait(height, vote.round)
            elif vote.round >= round_ and precommits.has_two_thirds_any():
                self._enter_new_round(height, vote.round)
                self._enter_precommit_wait(height, vote.round)

    # --- commit-latency attribution -----------------------------------

    def _record_quorum(self, round_: int, step: str) -> None:
        """First time ⅔ of voting power lands on a non-nil block for
        (height, round, step): record a pre-measured span from round
        entry to now — the time-to-quorum leg of the commit waterfall
        (rides the span→metrics bridge into
        consensus_quorum_latency_seconds{step})."""
        key = (round_, step)
        if key in self._quorum_at:
            return
        now = time.monotonic_ns()
        self._quorum_at[key] = now
        t0 = self._round_t0_ns or now
        self.tracer.complete(
            f"consensus.quorum.{step}", t0, max(0, now - t0),
            tid="consensus", height=self.rs.height, round=round_,
            step=step,
        )

    def _note_commit_breakdown(
        self, height: int, t_fin: int, t_persist: int, t_wal: int,
        t_apply: int,
    ) -> None:
        """Phase attribution for the height just committed, measured
        from this round's entry (monotonic, this node's clock). Phases
        that never happened on this node (ingest path, nil rounds) are
        simply absent. ``dominant`` names the largest DISJOINT segment
        of the commit timeline — what RPC health cites when latency
        degrades."""
        t0 = self._round_t0_ns or t_fin
        ms = 1e6
        rs = self.rs
        segments: Dict[str, float] = {}
        prop = self._proposal_complete_ns
        if prop >= t0:
            segments["proposal_ms"] = (prop - t0) / ms
        pv = self._quorum_at.get((rs.commit_round, "prevote"))
        pc = self._quorum_at.get((rs.commit_round, "precommit"))
        if pv is not None:
            segments["prevote_wait_ms"] = (
                pv - (prop if prop >= t0 else t0)
            ) / ms
        if pc is not None:
            segments["precommit_wait_ms"] = (pc - (pv or t0)) / ms
        segments["persist_ms"] = (t_persist - t_fin) / ms
        segments["wal_ms"] = (t_wal - t_persist) / ms
        segments["apply_ms"] = (t_apply - t_wal) / ms
        phases = {k: round(max(0.0, v), 3) for k, v in segments.items()}
        if pv is not None:
            phases["prevote_quorum_ms"] = round(max(0.0, (pv - t0) / ms), 3)
        if pc is not None:
            phases["precommit_quorum_ms"] = round(
                max(0.0, (pc - t0) / ms), 3
            )
        if self._verify_ns:
            # overlaps the prevote segment (it IS part of forming our
            # prevote); reported but excluded from `dominant`
            phases["verify_ms"] = round(self._verify_ns / ms, 3)
        phases["total_ms"] = round(max(0.0, (t_apply - t0) / ms), 3)
        dominant = max(segments, key=lambda k: segments[k])
        self.last_commit_breakdown = {
            "height": height,
            "round": rs.commit_round,
            "phases": phases,
            "dominant": dominant,
        }

    def _record_vote_arrival(self, vote, peer_id: str) -> None:
        """Per-peer vote-arrival skew: a span from the FIRST vote of
        this (round, type) wave to this vote's arrival, labeled by the
        delivering peer (self for our own votes). The bridge surfaces
        the latest value as a per-peer gauge."""
        now = time.monotonic_ns()
        fkey = (vote.round, vote.type_)
        first = self._vote_first.setdefault(fkey, now)
        self.tracer.complete(
            "consensus.vote.skew", first, max(0, now - first),
            tid="consensus",
            peer=peer_id[:12] if peer_id else "self",
            step="prevote" if vote.type_ == PREVOTE else "precommit",
            height=vote.height, round=vote.round,
        )

    # --- misc ---------------------------------------------------------

    def _close_trace_spans(
        self, *attrs: str
    ) -> None:
        """End the named open trace spans (default: the whole stack),
        always innermost-first — step ⊂ round ⊂ height must close
        LIFO or Perfetto's time-range nesting breaks. Every handle is
        None-guarded (replay/ingest paths open lazily)."""
        for attr in attrs or ("_sp_step", "_sp_round", "_sp_height"):
            sp = getattr(self, attr)
            if sp is not None:
                sp.end()
                setattr(self, attr, None)

    def _new_step(self) -> None:
        # step-span lifecycle: each step's span runs until the NEXT
        # step begins (the machine is event-driven, not call-scoped);
        # height/round spans open lazily so replay/ingest paths that
        # skip _enter_new_round still nest correctly
        sp = self._sp_step
        if sp is not None:
            sp.end()
            self._sp_step = None
        if self.tracer.enabled:
            rs = self.rs
            if self._sp_height is None:
                self._sp_height = self.tracer.span(
                    "consensus.height", tid="consensus",
                    height=rs.height,
                )
            if self._sp_round is None:
                self._sp_round = self.tracer.span(
                    "consensus.round", tid="consensus",
                    height=rs.height, round=rs.round,
                )
            self._sp_step = self.tracer.span(
                "consensus.step", tid="consensus",
                height=rs.height, round=rs.round, step=rs.step.name,
            )
        self.event_bus.publish_type(
            ev.EVENT_NEW_ROUND_STEP,
            {
                "height": self.rs.height,
                "round": self.rs.round,
                "step": int(self.rs.step),
            },
        )

    # external API for reactors
    async def enqueue(self, kind: str, payload, peer_id: str) -> None:
        await self.queue.put((kind, payload, peer_id))

    def enqueue_nowait(self, kind: str, payload, peer_id: str) -> None:
        if self.queue is None:
            return  # not started yet (sync phase); drop
        try:
            self.queue.put_nowait((kind, payload, peer_id))
        except asyncio.QueueFull:
            # overload shed: count it, callers keep their existing
            # QueueFull handling
            self.queue.count_drop()
            raise
