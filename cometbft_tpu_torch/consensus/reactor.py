"""Consensus reactor: gossips proposals, block parts and votes over
p2p channels (reference consensus/reactor.go).

Channel layout mirrors the reference (consensus/reactor.go:27-30):
  0x20 state  — NewRoundStep, HasVote, HasPart announcements
  0x21 data   — Proposal, BlockPart, CommitBlock (catch-up)
  0x22 vote   — Vote

Delivery model: fast path is flood-with-dedup (the state machine
re-broadcasts every NEWLY-added artifact via its broadcast hooks;
duplicates die at VoteSet/PartSet level). Reliability comes from the
per-peer GOSSIP routine (reference gossipDataRoutine :611 /
gossipVotesRoutine :657): using each peer's announced round state
(NewRoundStep) and acknowledgements (HasVote/HasPart — sent for every
vote/part received, duplicate or not), the routine retransmits
whatever the peer still lacks until it advances. This heals both
startup races (votes flooded before the peer connected) and any
mid-round message loss. Lagging peers get whole committed blocks +
commits instead (CommitBlock — the reactor-level analog of the
reference's gossipDataForCatchup).

A copy of the JAX package's ``consensus/reactor.py``: the channels,
message type bytes and wire codec are the same, byte for byte. Peer
votes for the current height are verified in waves by the reactor's
own ``CoalescingVerifier`` on the state machine's device (None is the
GPU), at ``PRIORITY_LIVE``; a verified signature lands in the shared
signature cache, so the state machine's inline check is a cache hit.
How a wave closes differs from the JAX reactor, which dispatches
whatever its coalescer holds 2 ms after the first vote and so splits a
wave that arrives frame by frame over TCP. Here a wave is the votes of
one (height, round, type), counted as the reactor sees them (at its
coalescer or added by the state machine, the node's own included). It
dispatches as soon as every validator's vote is in; once +2/3 of the
power is in, it waits at most as long again as it took to get there
(at least ``WAVE_GRACE_MIN_S``), so a missing validator costs a wave
that much, not the window; ``WAVE_WINDOW_S``, the coalescer's window,
bounds a wave that never reaches +2/3. A 150-validator wave that
trickles in is one ticket, and ``wave_log`` keeps how each closed. A
peer's relay of a vote the state machine already holds goes straight
to it (its vote set drops the copy as a duplicate with no check) and
takes no lane; the JAX reactor verifies every relayed copy, the node's
own votes included.

Departure (ROADMAP C3): where the JAX ``_submit_vote`` turns any
exception of the wave into "dropping vote with invalid signature", a
``crypto.scheduler.DeviceRouteError`` (the wave's verify route failed,
no verdict on any lane) is counted in the state machine's
``loop_errors``; the vote is not called forged, not checked on the
host, and not acknowledged. The JAX reactor acknowledges a vote
(``HasVote``) the moment it arrives; this one acknowledges a vote that
goes to the coalescer only once it has a verdict, so a vote lost to a
failed wave stays unacknowledged and the sender's gossip routine
resends it (``RETRANSMIT_AFTER_S``), to be checked again by the next
wave. Every other error keeps the JAX handling.
"""

from __future__ import annotations

import asyncio
import struct
import time
import traceback
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Optional, Set, Tuple

from ..crypto.coalesce import DEFAULT_WINDOW_S, CoalescingVerifier
from ..crypto.scheduler import DeviceRouteError
from ..p2p.node_info import ChannelDescriptor
from ..p2p.reactor import Reactor
from ..store.block_store import _decode_part, _encode_part
from ..types import events as ev
from ..types.block import Block, Commit
from ..types.part_set import Part
from ..types.vote import PREVOTE, Proposal, Vote
from ..utils import codec, proto
from ..utils.log import get_logger
from .state import BlockPartMessage, ProposalMessage, TimeoutInfo, VoteMessage  # noqa: F401

_log = get_logger("consensus.reactor")

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22

MSG_NEW_ROUND_STEP = 0x01
MSG_PROPOSAL = 0x02
MSG_BLOCK_PART = 0x03
MSG_VOTE = 0x04
MSG_COMMIT_BLOCK = 0x05
MSG_HAS_VOTE = 0x06
MSG_HAS_PART = 0x07

RETRANSMIT_AFTER_S = 0.25
CATCHUP_RETRANSMIT_S = 1.0
# periodic NewRoundStep re-announce per peer: step announcements are
# otherwise only broadcast ON step transitions, so a node whose
# announcement was lost (partition blackhole, conn churn) leaves every
# peer's PeerRoundState stale FOREVER if it then wedges in one step —
# peers keep aiming catch-up at the wrong height and the node can
# never advance (the healed-minority consensus wedge the chaos
# compound partition x statesync_join surfaced: peers retransmitted
# height-2 commits at a node parked in height 3 for 150s+)
STEP_REANNOUNCE_S = 1.0
MAX_GOSSIP_VOTES_PER_TICK = 16
MAX_GOSSIP_PARTS_PER_TICK = 8
# a vote wave's close (module docstring): the coalescer's window, which
# bounds a wave short of +2/3, and the least wait after +2/3
WAVE_WINDOW_S = 0.5
WAVE_GRACE_MIN_S = DEFAULT_WINDOW_S
WAVE_LOG = 256


@dataclass
class CommitBlockMessage:
    block: Block
    commit: Commit
    # raw extended commit when the sender holds one for this height —
    # catch-up must propagate ECs like every other commit path
    # (reference SaveBlockWithExtendedCommit), or nodes that caught up
    # through consensus can never serve the EC to blocksync joiners
    ec_bytes: Optional[bytes] = None


@dataclass
class PeerRoundState:
    height: int = 0
    round: int = -1
    step: int = 0
    # (height, round, type, index) votes the peer is known to have
    has_votes: Set[Tuple[int, int, int, int]] = field(default_factory=set)
    # (height, round, part_index) parts the peer is known to have
    has_parts: Set[Tuple[int, int, int]] = field(default_factory=set)
    proposal_seen: bool = False


class _Wave:
    """The votes of one (height, round, type) the reactor has seen."""

    __slots__ = ("key", "first", "seen", "power", "two_thirds_s", "timer")

    def __init__(self, key: Tuple[int, int, int]):
        self.key = key
        self.first: Optional[float] = None  # the first vote to pend
        self.seen: Set[int] = set()
        self.power = 0
        self.two_thirds_s: Optional[float] = None  # first to +2/3
        self.timer: Optional[asyncio.TimerHandle] = None


class PeerVoteCursor:
    """Incremental per-peer vote picker over VoteSet.vote_log.

    The old shape rescanned every vote set the peer could need on
    EVERY gossip tick — O(validators) per peer per tick, O(V^2)
    across the committee even at steady state (flagged by ASY117,
    slope measured by bench.py's scaling leg). The cursor reads each
    source log once (``vote_log[read:]``), stages what the peer has
    not acked into ``pending``, and retransmits only from there:
    a tick costs O(new votes + unacked), which is O(0) at steady
    state.

    Sources are the same sets the reference PickSendVote consults:
    prevotes/precommits for {peer round, our round, our round - 1}
    plus last-height precommits. ``pending`` is bounded by the
    per-height vote count and the whole cursor resets on height
    advance (mirroring the peer's own ``has_votes.clear()``).
    """

    __slots__ = ("height", "_read", "pending")

    def __init__(self):
        self.height = 0
        self._read: Dict[tuple, int] = {}
        # vote key -> [vote, last_sent_monotonic]
        self.pending: Dict[tuple, list] = {}

    def reset(self, height: int) -> None:
        self.height = height
        self._read.clear()
        self.pending.clear()

    def _ingest_log(self, skey: tuple, log, has) -> None:
        start = self._read.get(skey, 0)
        if start >= len(log):
            return
        for v in log[start:]:
            k = _vote_key(v)
            if k not in has and k not in self.pending:
                self.pending[k] = [v, 0.0]
        self._read[skey] = len(log)

    def ingest(self, rs, prs: "PeerRoundState") -> None:
        """Advance every source cursor; stage new unacked votes."""
        has = prs.has_votes
        if rs.votes is not None:
            rounds = {prs.round, rs.round, rs.round - 1}
            for r in sorted(x for x in rounds if x >= 0):
                pv = rs.votes.prevotes(r)
                if pv is not None:
                    self._ingest_log(("pv", r), pv.vote_log, has)
                pc = rs.votes.precommits(r)
                if pc is not None:
                    self._ingest_log(("pc", r), pc.vote_log, has)
        if rs.last_commit is not None:
            self._ingest_log(("lc",), rs.last_commit.vote_log, has)

    def due_votes(
        self,
        prs: "PeerRoundState",
        now: float,
        budget: int,
        after: float = RETRANSMIT_AFTER_S,
    ):
        """Drop acked entries, return up to ``budget`` votes due for
        (re)transmission, stamping their send time."""
        out = []
        has = prs.has_votes
        drop = []
        for k, entry in self.pending.items():
            if k in has:
                drop.append(k)
                continue
            if now - entry[1] > after:
                entry[1] = now
                out.append(entry[0])
                if len(out) >= budget:
                    break
        for k in drop:
            del self.pending[k]
        return out


# --- wire codecs --------------------------------------------------------


def encode_new_round_step(height: int, round_: int, step: int) -> bytes:
    return bytes([MSG_NEW_ROUND_STEP]) + struct.pack(
        ">qiB", height, round_, step
    )


def encode_proposal_msg(p: Proposal) -> bytes:
    return bytes([MSG_PROPOSAL]) + codec.encode_proposal(p)


def encode_block_part_msg(height: int, round_: int, part: Part) -> bytes:
    return (
        bytes([MSG_BLOCK_PART])
        + proto.field_varint(1, height)
        + proto.field_varint(2, round_ + 1)  # +1: round 0 must be present
        + proto.field_bytes(3, _encode_part(part))
    )


def encode_vote_msg(v: Vote) -> bytes:
    return bytes([MSG_VOTE]) + codec.encode_vote(v)


def encode_commit_block(
    block: Block, commit: Commit, ec_bytes: Optional[bytes] = None
) -> bytes:
    out = (
        bytes([MSG_COMMIT_BLOCK])
        + proto.field_bytes(1, codec.encode_block(block))
        + proto.field_bytes(2, codec.encode_commit(commit))
    )
    if ec_bytes:
        out += proto.field_bytes(3, ec_bytes)
    return out


def encode_has_vote(height: int, round_: int, type_: int, index: int) -> bytes:
    return bytes([MSG_HAS_VOTE]) + struct.pack(">qiBi", height, round_, type_, index)


def encode_has_part(height: int, round_: int, index: int) -> bytes:
    return bytes([MSG_HAS_PART]) + struct.pack(">qii", height, round_, index)


def _vote_key(v: Vote) -> Tuple[int, int, int, int]:
    return (v.height, v.round, v.type_, v.validator_index)


class ConsensusReactor(Reactor):
    name = "consensus"

    def __init__(self, cs, block_store, wait_sync: bool = False):
        super().__init__()
        self.cs = cs
        self.block_store = block_store
        # wait_sync: created during blocksync/statesync; gossip starts
        # after switch_to_consensus (reference conR.WaitSync)
        self.wait_sync = wait_sync
        self._gossip_tasks: Dict[str, asyncio.Task] = {}
        # async coalescing queue: a round's vote wave is verified in
        # one batch dispatch on the state machine's device; results
        # land in cs.sig_cache so the state machine's inline verify is
        # a cache hit (crypto/coalesce.py)
        self.vote_verifier = CoalescingVerifier(
            cache=cs.sig_cache, window_s=WAVE_WINDOW_S, device=cs.device,
        )
        self._waves: Dict[Tuple[int, int, int], _Wave] = {}
        # the waves this reactor dispatched, newest last: (height,
        # round, type, "whole" or "grace", votes seen, seconds from the
        # first pended vote to +2/3 and to the dispatch)
        self.wave_log: deque = deque(maxlen=WAVE_LOG)

    def get_channels(self):
        return [
            ChannelDescriptor(STATE_CHANNEL, priority=6, max_msg_size=1 << 20),
            ChannelDescriptor(DATA_CHANNEL, priority=10),
            ChannelDescriptor(VOTE_CHANNEL, priority=7, max_msg_size=1 << 20),
        ]

    # --- lifecycle ----------------------------------------------------

    async def start(self) -> None:
        self.cs.add_broadcast_hook(self._on_cs_broadcast)
        self.cs.event_bus.add_sync_listener(self._on_event)

    async def stop(self) -> None:
        for t in self._gossip_tasks.values():
            t.cancel()
        self._gossip_tasks.clear()
        self._drop_waves()
        try:
            # bounded: dispatch the last window now, so no wave of a
            # stopped node is left to a timer that fires later
            await asyncio.wait_for(self.vote_verifier.drain(), 5.0)
        except asyncio.TimeoutError:
            pass

    def switch_to_consensus(self) -> None:
        """Called when blocksync finishes (reference
        consensus/reactor.go:121 SwitchToConsensus)."""
        self.wait_sync = False
        self._announce_step()

    # --- outbound (flood fast path) -----------------------------------

    def _on_cs_broadcast(self, kind: str, payload) -> None:
        if self.switch is None or self.wait_sync:
            return
        # proposal/part/vote broadcasts name their trace kind (the JAX
        # switch stamps these; the port's sends them unstamped);
        # has_vote/has_part acks and round-step announcements carry
        # none
        if kind == "proposal":
            p = payload.proposal
            self.switch.broadcast(
                DATA_CHANNEL, encode_proposal_msg(p),
                tkind="proposal", height=p.height, round_=p.round,
            )
        elif kind == "block_part":
            self.switch.broadcast(
                DATA_CHANNEL,
                encode_block_part_msg(
                    payload.height, payload.round, payload.part
                ),
                tkind="block_part",
                height=payload.height, round_=payload.round,
            )
            # tell peers we have it so they stop retransmitting to us
            self.switch.broadcast(
                STATE_CHANNEL,
                encode_has_part(
                    payload.height, payload.round, payload.part.index
                ),
            )
        elif kind == "vote":
            v = payload.vote
            val = self._current_validator(v)
            if val is not None:
                self._note_vote(self._wave(v), v, val, pended=False)
            self.switch.broadcast(
                VOTE_CHANNEL, encode_vote_msg(v),
                tkind="vote", height=v.height, round_=v.round,
            )
            self.switch.broadcast(
                STATE_CHANNEL, encode_has_vote(*_vote_key(payload.vote))
            )

    def _submit_vote(self, vote: Vote, peer_id: str, ack=None) -> None:
        """Route an inbound vote through the coalescing verifier when
        it belongs to the current height's validator set; anything else
        (catch-up votes, unknown indexes) goes straight to the state
        machine, whose inline verification handles it (and produces
        the canonical error for genuinely bad input). ``ack()`` sends
        the vote's HasVote: at once on the direct paths, once the wave
        has a verdict on the coalesced one, never after a failed
        route."""
        ack = ack or (lambda: None)
        cs = self.cs
        val = self._current_validator(vote)
        if val is None or self._held(vote):
            ack()
            cs.enqueue_nowait("vote", VoteMessage(vote), peer_id)
            return
        wave = self._wave(vote)
        vc = self.vote_verifier
        before = vc.pending_count()
        try:
            fut = vc.submit(
                val.pub_key, vote.sign_bytes(cs.state.chain_id),
                vote.signature,
            )
        except RuntimeError:  # no running loop (sync test harness)
            ack()
            cs.enqueue_nowait("vote", VoteMessage(vote), peer_id)
            return
        self._note_vote(wave, vote, val, pended=vc.pending_count() > before)

        def _done(f: asyncio.Future) -> None:
            ok = False
            try:
                ok = bool(f.result())
            except DeviceRouteError as e:
                # the wave's route failed: no verdict on this vote
                # (C3). Not forged, not added, not acknowledged: the
                # sender's gossip routine resends it
                cs._count_route_error(e)
                return
            except Exception:
                pass
            ack()
            if ok:
                cs.enqueue_nowait("vote", VoteMessage(vote), peer_id)
            else:
                _log.error(
                    "dropping vote with invalid signature",
                    height=vote.height,
                    round=vote.round,
                    peer=peer_id[:12],
                )

        fut.add_done_callback(_done)

    def _current_validator(self, vote: Vote):
        """The validator that signed ``vote`` when the vote is of the
        current height and its set, else None."""
        rs = self.cs.rs
        if vote.height != rs.height or rs.validators is None:
            return None
        if not 0 <= vote.validator_index < rs.validators.size():
            return None
        val = rs.validators.get_by_index(vote.validator_index)
        if val is None or val.address != vote.validator_address:
            return None
        return val

    def _held(self, vote: Vote) -> bool:
        """Whether the state machine already holds ``vote`` (a peer's
        relay of a vote it added, its own included): the same block ID
        and signature at that validator's index, which its vote set
        drops as a duplicate with no check, so no lane is spent on
        it."""
        votes = self.cs.rs.votes
        if votes is None:
            return False
        if vote.type_ == PREVOTE:
            vs = votes.prevotes(vote.round)
        else:
            vs = votes.precommits(vote.round)
        have = vs.votes[vote.validator_index] if vs is not None else None
        return (
            have is not None
            and have.signature == vote.signature
            and have.block_id.key() == vote.block_id.key()
        )

    def _wave(self, vote: Vote) -> _Wave:
        """The wave of ``vote``; on a new height the past height's
        waves are dropped and what they left pending dispatches."""
        waves = self._waves
        if waves and next(iter(waves))[0] != vote.height:
            self._drop_waves()
        key = (vote.height, vote.round, vote.type_)
        w = waves.get(key)
        if w is None:
            w = waves[key] = _Wave(key)
        return w

    def _note_vote(self, w: _Wave, vote: Vote, val, pended: bool) -> None:
        """Count ``vote`` into its wave: one from a peer that
        ``pended`` (joined the coalescer's next dispatch, neither a
        cache hit nor a copy of one in flight), or one the state
        machine added. When the vote is a new validator's or pended,
        dispatch the coalescer's pending votes if the wave is whole, or
        arm the wave's grace if it holds +2/3 of the power. The grace
        is timed from the wave's first pended vote, so neither the
        node's own vote nor a relay lengthens it."""
        now = time.monotonic()
        if pended and w.first is None:
            w.first = now
        new = vote.validator_index not in w.seen
        if new:
            w.seen.add(vote.validator_index)
            w.power += val.voting_power
        vals = self.cs.rs.validators
        if w.two_thirds_s is None and 3 * w.power > 2 * vals.total_voting_power():
            w.two_thirds_s = now - (now if w.first is None else w.first)
        if not (new or pended) or not self.vote_verifier.pending_count():
            return
        if len(w.seen) == vals.size():
            self._close(w, "whole")
        elif w.two_thirds_s is not None and w.timer is None:
            w.timer = asyncio.get_running_loop().call_later(
                max(WAVE_GRACE_MIN_S, w.two_thirds_s), self._close, w, "grace"
            )

    def _close(self, w: _Wave, how: str) -> None:
        if w.timer is not None:
            w.timer.cancel()
            w.timer = None
        vc = self.vote_verifier
        if vc.pending_count():
            since = 0.0 if w.first is None else time.monotonic() - w.first
            self.wave_log.append(w.key + (how, len(w.seen), w.two_thirds_s, since))
            vc.flush()

    def _drop_waves(self) -> None:
        """Forget the waves of a past height; what they left pending
        dispatches now."""
        for w in self._waves.values():
            if w.timer is not None:
                w.timer.cancel()
        self._waves.clear()
        self.vote_verifier.flush()

    def _on_event(self, e) -> None:
        if e.type_ == ev.EVENT_NEW_ROUND_STEP:
            self._announce_step()

    def _announce_step(self) -> None:
        if self.switch is None or self.wait_sync:
            return
        rs = self.cs.rs
        self.switch.broadcast(
            STATE_CHANNEL,
            encode_new_round_step(rs.height, rs.round, int(rs.step)),
        )

    # --- peers --------------------------------------------------------

    def add_peer(self, peer) -> None:
        peer.set("prs", PeerRoundState())
        rs = self.cs.rs
        if not self.wait_sync:
            peer.try_send(
                STATE_CHANNEL,
                encode_new_round_step(rs.height, rs.round, int(rs.step)),
            )
        self._gossip_tasks[peer.peer_id] = asyncio.create_task(
            self._gossip_routine(peer)
        )

    def remove_peer(self, peer, reason) -> None:
        t = self._gossip_tasks.pop(peer.peer_id, None)
        if t:
            t.cancel()

    # --- the per-peer gossip routine ----------------------------------

    async def _gossip_routine(self, peer) -> None:
        sent_at: Dict[tuple, float] = {}
        cursor = PeerVoteCursor()
        sleep_s = getattr(self.cs.config, "peer_gossip_sleep_s", 0.1)
        try:
            while True:
                await asyncio.sleep(sleep_s)
                if self.wait_sync:
                    continue
                prs: PeerRoundState = peer.get("prs")
                rs = self.cs.rs
                now = time.monotonic()

                def due(key, after=RETRANSMIT_AFTER_S) -> bool:
                    return now - sent_at.get(key, 0.0) > after

                # keep the PEER's view of US fresh (STEP_REANNOUNCE_S
                # above): runs even while we are behind or the peer
                # never announced — a behind node correcting its
                # peers' stale view is exactly what re-aims their
                # catch-up at the right height
                if due(("nrs",), STEP_REANNOUNCE_S):
                    sent_at[("nrs",)] = now
                    peer.try_send(
                        STATE_CHANNEL,
                        encode_new_round_step(
                            rs.height, rs.round, int(rs.step)
                        ),
                    )
                if prs is None or prs.height == 0:
                    continue

                if prs.height < rs.height:
                    # catch-up: ship whole committed blocks, repeating
                    # (paced) until the peer's NewRoundStep advances
                    ckey = ("cb", prs.height)
                    if prs.height <= self.block_store.height() and due(
                        ckey, CATCHUP_RETRANSMIT_S
                    ):
                        block = self.block_store.load_block(prs.height)
                        commit = self.block_store.load_seen_commit(
                            prs.height
                        ) or self.block_store.load_block_commit(prs.height)
                        if block is not None and commit is not None:
                            sent_at[ckey] = now
                            await peer.send(
                                DATA_CHANNEL,
                                self.switch.stamp_msg(
                                    DATA_CHANNEL,
                                    encode_commit_block(
                                        block,
                                        commit,
                                        self.block_store
                                        .load_extended_commit(prs.height),
                                    ),
                                    "commit_block",
                                    height=prs.height,
                                    peer=peer.peer_id,
                                ),
                            )
                    continue
                if prs.height > rs.height:
                    continue  # we're behind; their catch-up feeds us

                # data: proposal + parts for the current round
                if rs.proposal is not None and not prs.proposal_seen:
                    key = ("prop", rs.height, rs.round)
                    if due(key):
                        peer.try_send(
                            DATA_CHANNEL,
                            self.switch.stamp_msg(
                                DATA_CHANNEL,
                                encode_proposal_msg(rs.proposal),
                                "proposal",
                                height=rs.height, round_=rs.round,
                                peer=peer.peer_id,
                            ),
                        )
                        sent_at[key] = now
                if rs.proposal_block_parts is not None:
                    sent_parts = 0
                    for part in rs.proposal_block_parts.parts:
                        if part is None:
                            continue
                        pkey = (rs.height, rs.round, part.index)
                        if pkey in prs.has_parts:
                            continue
                        if not due(("part",) + pkey):
                            continue
                        peer.try_send(
                            DATA_CHANNEL,
                            self.switch.stamp_msg(
                                DATA_CHANNEL,
                                encode_block_part_msg(
                                    rs.height, rs.round, part
                                ),
                                "block_part",
                                height=rs.height, round_=rs.round,
                                peer=peer.peer_id,
                            ),
                        )
                        sent_at[("part",) + pkey] = now
                        sent_parts += 1
                        if sent_parts >= MAX_GOSSIP_PARTS_PER_TICK:
                            break

                # votes: incremental cursor over each source's
                # append-ordered vote_log — O(new + unacked) per
                # tick, not a full O(validators) rescan
                if cursor.height != rs.height:
                    cursor.reset(rs.height)
                cursor.ingest(rs, prs)
                for vote in cursor.due_votes(
                    prs, now, MAX_GOSSIP_VOTES_PER_TICK
                ):
                    peer.try_send(
                        VOTE_CHANNEL,
                        self.switch.stamp_msg(
                            VOTE_CHANNEL, encode_vote_msg(vote), "vote",
                            height=vote.height, round_=vote.round,
                            peer=peer.peer_id,
                        ),
                    )
                if len(sent_at) > 50_000:
                    sent_at.clear()
        except asyncio.CancelledError:
            raise
        except Exception:
            traceback.print_exc()

    # --- inbound ------------------------------------------------------

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        if not msg:
            return
        mtype = msg[0]
        body = msg[1:]
        prs: PeerRoundState = peer.get("prs") or PeerRoundState()
        if mtype == MSG_NEW_ROUND_STEP:
            h, r, s = struct.unpack(">qiB", body)
            if h != prs.height:
                prs.has_votes.clear()
                prs.has_parts.clear()
                prs.proposal_seen = False
            elif r != prs.round:
                prs.proposal_seen = False
            prs.height, prs.round, prs.step = h, r, s
            peer.set("prs", prs)
        elif mtype == MSG_HAS_VOTE:
            h, r, t, i = struct.unpack(">qiBi", body)
            prs.has_votes.add((h, r, t, i))
        elif mtype == MSG_HAS_PART:
            h, r, i = struct.unpack(">qii", body)
            prs.has_parts.add((h, r, i))
        elif self.wait_sync:
            return  # ignore consensus traffic until synced
        elif mtype == MSG_PROPOSAL:
            prop = codec.decode_proposal(body)
            if prop.height == prs.height:
                prs.proposal_seen = True
            self.cs.enqueue_nowait(
                "proposal", ProposalMessage(prop), peer.peer_id
            )
        elif mtype == MSG_BLOCK_PART:
            m = proto.parse(body)
            height = proto.get1(m, 1, 0)
            round_ = proto.get1(m, 2, 1) - 1
            part = _decode_part(proto.get1(m, 3, b""))
            # the sender obviously has it; ack so it stops resending
            prs.has_parts.add((height, round_, part.index))
            peer.try_send(
                STATE_CHANNEL, encode_has_part(height, round_, part.index)
            )
            self.cs.enqueue_nowait(
                "block_part",
                BlockPartMessage(height, round_, part),
                peer.peer_id,
            )
        elif mtype == MSG_VOTE:
            vote = codec.decode_vote(body)
            prs.has_votes.add(_vote_key(vote))
            has_vote = encode_has_vote(*_vote_key(vote))
            self._submit_vote(
                vote, peer.peer_id,
                ack=lambda: peer.try_send(STATE_CHANNEL, has_vote),
            )
        elif mtype == MSG_COMMIT_BLOCK:
            m = proto.parse(body)
            block = codec.decode_block(proto.get1(m, 1, b""))
            commit = codec.decode_commit(proto.get1(m, 2, b""))
            ec_bytes = proto.get1(m, 3, b"") or None
            self.cs.enqueue_nowait(
                "commit_block",
                CommitBlockMessage(block, commit, ec_bytes),
                peer.peer_id,
            )
        else:
            raise ValueError(f"unknown consensus msg type {mtype}")
