"""SessionRouter: the one admission seam in front of N replicas (a
copy of the JAX package's ``fleet/router.py``).

Every serving request — websocket subscription, light session, indexed
read — enters the fleet HERE:

- **admission** via the InstrumentedGate contract (obs/queues.py):
  ``try_enter`` never blocks the loop, overload is a counted shed, and
  the gate rides the obs QueueRegistry as ``fleet.route`` so health
  sees router backpressure like any bounded queue;
- **placement** least-loaded across serviceable replicas;
- **consistency tokens**: a request carrying token H only lands on a
  replica whose served height ≥ H — the indexer's sealed-vs-flushed
  ``idx:last`` barrier generalized cross-replica. If no replica
  satisfies H the router WAITS the most advanced replica's height
  barrier (bounded) or refuses (``StaleReadError``); it never serves
  stale;
- **lag-aware shedding**: a follower stalled past
  ``[fleet] max_lag_heights`` is drained and marked degraded — only
  ITS clients are shed; the rest of the fleet is untouched;
- **failover**: on replica death mid-stream every session is
  re-admitted elsewhere with ZERO lost commits — CommitWaiterMap-style
  lossless height-keyed resume: the session replays
  ``last_delivered+1..`` from the store before going live, and the
  live stream is spliced behind the replay through a bounded buffer
  (membership snapshots in follower.ReplicaFanout are per height, so
  the buffer always starts at a clean height boundary).
"""

from __future__ import annotations

import asyncio
import json
import re
import time
from typing import Dict, List, Optional, Set

from ..obs.queues import InstrumentedGate
from ..trace import NOOP
from ..utils.log import get_logger
from ..utils.tasks import spawn
from .follower import event_payload, height_events
from ..rpc.fanout import _event_attrs

_log = get_logger("fleet.router")

# bounded wait for the watchdog task to unwind on close
WATCH_STOP_WAIT_S = 2.0

# replay-splice safety bounds: a resume that can't converge inside
# these is SHED (honest bound), never silently truncated
REPLAY_MAX_LEGS = 32
REPLAY_BUFFER_MAX = 65536

# first "height" key in a frame is the block/tx height for every frame
# shape rpc/fanout.py emits (block header height for NewBlock, TxResult
# height for Tx) — the hub-path fallback when delivery has no
# on_height signal (fleet.follower.NodeReplica)
_HEIGHT_RE = re.compile(r'"height": ?"(\d+)"')


class FleetOverloadError(Exception):
    """Router at its session bound or no serviceable replica."""


class StaleReadError(Exception):
    """Consistency token unsatisfiable: no replica at or past the
    token height within the barrier wait — the request must be
    retried/redirected, NEVER served below its token."""


class RoutedSession:
    """One routed subscription: the pipe between a replica's delivery
    plane and the client sink. Tracks ``last_delivered`` (the lossless
    height-keyed resume cursor) and buffers live frames during a
    failover replay so the splice is gap-free AND duplicate-free."""

    __slots__ = (
        "sink",
        "query_str",
        "query",
        "sub_id",
        "_prefix",
        "last_delivered",
        "closed",
        "close_reason",
        "parse_heights",
        "resumes",
        "_buffer",
        "_replaying",
        "_pending_height",
        "_router",
    )

    def __init__(self, sink, query_str: str, query, sub_id):
        self.sink = sink
        self.query_str = query_str
        self.query = query
        self.sub_id = sub_id
        # identical envelope to rpc.fanout.FanoutSubscriber so routed
        # frames are byte-compatible with hub frames
        self._prefix = (
            '{"jsonrpc": "2.0", "id": '
            + json.dumps(sub_id)
            + ', "result": '
        )
        self.last_delivered = 0
        self.closed = False
        self.close_reason = ""
        self.parse_heights = False
        self.resumes = 0
        self._buffer: List[str] = []
        self._replaying = False
        self._pending_height = 0
        self._router = None

    # --- delivery-plane surface ---------------------------------------

    async def send_str(self, frame: str) -> None:
        if self.closed:
            raise ConnectionError("session closed")
        if self._replaying:
            if len(self._buffer) >= REPLAY_BUFFER_MAX:
                raise ConnectionError("replay buffer overflow")
            self._buffer.append(frame)
            return
        await self.sink.send_str(frame)
        if self.parse_heights:
            m = _HEIGHT_RE.search(frame)
            if m:
                h = int(m.group(1))
                if h > self.last_delivered:
                    self.last_delivered = h

    def on_height(self, height: int) -> None:
        """Replica-paced delivery completed ``height`` for this
        session (follower.ReplicaFanout)."""
        if self._replaying:
            if height > self._pending_height:
                self._pending_height = height
        elif height > self.last_delivered:
            self.last_delivered = height

    def on_send_failed(self) -> None:
        """The delivery plane saw this session's sink raise: degrade
        THIS session only — the router reaps it off-loop."""
        self.closed = True
        self.close_reason = self.close_reason or "send_failed"
        r = self._router
        if r is not None:
            r._note_failed(self)

    # --- replay splice ------------------------------------------------

    def begin_replay(self) -> None:
        self._replaying = True
        self._pending_height = 0

    async def end_replay(self, replayed_through: int) -> None:
        """Flush the live frames buffered during replay, dropping the
        ones the replay already covered (height ≤ ``replayed_through``
        — per-height membership snapshots guarantee the buffer starts
        at a clean height boundary, so this is exact)."""
        buffered, self._buffer = self._buffer, []
        self._replaying = False
        for frame in buffered:
            m = _HEIGHT_RE.search(frame)
            if m and int(m.group(1)) <= replayed_through:
                continue
            await self.sink.send_str(frame)
        if self._pending_height > self.last_delivered:
            self.last_delivered = self._pending_height
        self._pending_height = 0


class SessionRouter:
    """N replicas behind one admission + placement + failover seam."""

    def __init__(
        self,
        replicas: List,
        *,
        store_source=None,
        max_sessions: int = 4096,
        admit_timeout_s: float = 0.25,
        max_lag_heights: int = 8,
        lag_poll_s: float = 0.1,
        token_wait_s: float = 2.0,
        resume_replay_max: int = 512,
        tracer=NOOP,
    ):
        self.replicas = list(replicas)
        self.store_source = store_source
        self.tracer = tracer
        self.admit_timeout_s = admit_timeout_s
        self.max_lag_heights = max_lag_heights
        self.lag_poll_s = lag_poll_s
        self.token_wait_s = token_wait_s
        self.resume_replay_max = resume_replay_max
        self.gate = InstrumentedGate(max_sessions, name="fleet.route")
        self._sessions: Dict[RoutedSession, object] = {}
        self._degraded: Set[int] = set()  # id(replica)
        self._failed: List[RoutedSession] = []
        self._watch_task: Optional[asyncio.Future] = None
        self._wake: Optional[asyncio.Event] = None
        self._drain_tasks: List[asyncio.Future] = []
        self.failovers = 0
        self.sessions_resumed = 0
        self.sheds_lag = 0
        self.sheds_failover = 0
        self.tokens_issued = 0
        for r in self.replicas:
            r.on_death = self._on_replica_death

    # --- lifecycle ----------------------------------------------------

    async def start(self) -> None:
        if self._watch_task is None:
            self._wake = asyncio.Event()
            self._watch_task = spawn(
                self._watch(), name="fleet-router-watch"
            )

    async def close(self) -> None:
        t, self._watch_task = self._watch_task, None
        if t is not None and not t.done():
            t.cancel()
            try:
                await asyncio.wait_for(
                    asyncio.gather(t, return_exceptions=True),
                    WATCH_STOP_WAIT_S,
                )
            except asyncio.TimeoutError:
                pass
        for dt in self._drain_tasks:
            if not dt.done():
                dt.cancel()
        self._drain_tasks.clear()
        for sess in list(self._sessions):
            await self._close_session(sess, "router_closed")

    # --- admission + placement ----------------------------------------

    def _serviceable(self, *, need_light: bool = False) -> List:
        return [
            r
            for r in self.replicas
            if r.alive
            and not r.draining
            and id(r) not in self._degraded
            and (not need_light or r.light_plane is not None)
        ]

    async def _pick(
        self, token: Optional[int] = None, *, need_light: bool = False
    ):
        elig = self._serviceable(need_light=need_light)
        if not elig:
            raise FleetOverloadError("no serviceable replica")
        if token:
            sat = [r for r in elig if r.served_height() >= token]
            if sat:
                return min(sat, key=lambda r: r.members())
            # nobody is at the token yet: wait the MOST ADVANCED
            # replica's height barrier (bounded) — route-away or
            # wait, never stale
            best = max(elig, key=lambda r: r.served_height())
            ok = await best.wait_height(token, self.token_wait_s)
            if not ok or not best.alive:
                raise StaleReadError(
                    f"no replica reached token height {token} "
                    f"within {self.token_wait_s}s"
                )
            return best
        return min(elig, key=lambda r: r.members())

    async def subscribe(
        self,
        sink,
        query_str: str,
        query=None,
        *,
        sub_id=None,
        token: Optional[int] = None,
    ) -> RoutedSession:
        """Admit + place one event subscription."""
        if query is None:
            from ..utils.pubsub_query import parse as parse_query

            query = parse_query(query_str)
        span = self.tracer.span(
            "fleet.route", "fleet", kind="subscribe"
        )
        with span:
            if not self.gate.try_enter():
                span.set(shed=True)
                raise FleetOverloadError(
                    "router at its session bound; retry"
                )
            try:
                replica = await self._pick(token)
            except BaseException:
                self.gate.exit()
                raise
            sess = RoutedSession(
                sink,
                query_str,
                query,
                sub_id if sub_id is not None else len(self._sessions),
            )
            sess._router = self
            sess.parse_heights = getattr(
                replica, "HUB_DELIVERY", False
            )
            if token:
                sess.last_delivered = 0
            replica.attach(sess)
            self._sessions[sess] = replica
            span.set(replica=getattr(replica, "name", "?"))
            return sess

    async def unsubscribe(self, sess: RoutedSession) -> None:
        await self._close_session(sess, "unsubscribed")

    async def route_read(self, token: Optional[int] = None):
        """Pick a replica for a one-shot read under a consistency
        token: the returned replica's served height is ≥ token (the
        read-your-writes guarantee), or StaleReadError."""
        span = self.tracer.span("fleet.route", "fleet", kind="read")
        with span:
            replica = await self._pick(token)
            span.set(replica=getattr(replica, "name", "?"))
            return replica

    def route_light(
        self, token: Optional[int] = None, timeout_s: Optional[float] = None
    ):
        """Thread-facing placement for light sessions (the serving
        plane is the thread seam — light/serving.py): returns a
        replica whose plane to open a session on, honoring the token
        with a bounded poll-wait. Never returns a replica below the
        token."""
        deadline = time.monotonic() + (
            timeout_s if timeout_s is not None else self.token_wait_s
        )
        while True:
            elig = self._serviceable(need_light=True)
            sat = [
                r
                for r in elig
                if not token or r.served_height() >= token
            ]
            if sat:
                return min(
                    sat, key=lambda r: r.light_plane.active_sessions()
                )
            if time.monotonic() >= deadline:
                if not elig:
                    raise FleetOverloadError(
                        "no serviceable light replica"
                    )
                raise StaleReadError(
                    f"no light replica reached token height {token}"
                )
            time.sleep(0.005)

    def serve_light(
        self, height: int, token: Optional[int] = None
    ):
        """One routed light request (thread-facing): placement here,
        admission + single-flight verify on the replica's own plane."""
        replica = self.route_light(token)
        return replica.light_plane.serve(height)

    def issue_token(self) -> int:
        """Read-your-writes token: the committee head as this router
        sees it — any write committed by now is covered."""
        self.tokens_issued += 1
        return self._head()

    def _head(self) -> int:
        if self.store_source is not None:
            return self.store_source.height()
        alive = [r.served_height() for r in self.replicas if r.alive]
        return max(alive) if alive else 0

    # --- lag watchdog + failover --------------------------------------

    def _on_replica_death(self, replica) -> None:
        if self._wake is not None:
            self._wake.set()

    def _note_failed(self, sess: RoutedSession) -> None:
        self._failed.append(sess)
        if self._wake is not None:
            self._wake.set()

    async def _watch(self) -> None:
        while True:
            try:
                await asyncio.wait_for(
                    self._wake.wait(), self.lag_poll_s
                )
            except asyncio.TimeoutError:
                pass
            self._wake.clear()
            try:
                await self._reap_failed()
                self._check_lag()
                for r in self.replicas:
                    if not r.alive and any(
                        rep is r for rep in self._sessions.values()
                    ):
                        await self._failover(r)
            except asyncio.CancelledError:
                raise
            except Exception:
                import traceback

                traceback.print_exc()

    async def _reap_failed(self) -> None:
        failed, self._failed = self._failed, []
        for sess in failed:
            if sess in self._sessions:
                await self._close_session(sess, "send_failed")

    def _check_lag(self) -> None:
        head = self._head()
        for r in self.replicas:
            if not r.alive:
                continue
            lag = head - r.served_height()
            if id(r) not in self._degraded:
                if lag > self.max_lag_heights:
                    self._degrade(r, lag)
            elif lag <= max(1, self.max_lag_heights // 2):
                # caught back up: rotate back in
                self._degraded.discard(id(r))
                r.resume_serving()
                _log.info(
                    "replica recovered",
                    replica=getattr(r, "name", "?"),
                    lag=lag,
                )

    def _degrade(self, replica, lag: int) -> None:
        """A stalled follower degrades ONLY its own clients: mark it
        out of placement, drain its serving plane, shed its sessions
        (they re-admit through the front door and land elsewhere)."""
        self._degraded.add(id(replica))
        _log.info(
            "replica degraded (lag shed)",
            replica=getattr(replica, "name", "?"),
            lag=lag,
            max_lag=self.max_lag_heights,
        )
        if replica.light_plane is not None:
            self._drain_tasks.append(
                spawn(
                    asyncio.to_thread(replica.light_plane.drain, 5.0),
                    name="fleet-drain",
                )
            )
        mine = [
            s for s, rep in self._sessions.items() if rep is replica
        ]
        for sess in mine:
            self.sheds_lag += 1
            spawn(
                self._close_session(sess, "shed_lag"),
                name="fleet-shed",
            )

    async def _failover(self, replica) -> None:
        """Replica died mid-stream: re-admit every one of its
        sessions elsewhere with zero lost commits (store replay up to
        the live splice)."""
        sessions = [
            s for s, rep in self._sessions.items() if rep is replica
        ]
        if not sessions:
            return
        self.failovers += 1
        span = self.tracer.span(
            "fleet.failover",
            "fleet",
            replica=getattr(replica, "name", "?"),
            sessions=len(sessions),
        )
        with span:
            resumed = 0
            for sess in sessions:
                targets = [
                    r
                    for r in self._serviceable()
                    if r is not replica
                ]
                if not targets or sess.closed:
                    await self._close_session(sess, "failover_shed")
                    self.sheds_failover += 1
                    continue
                target = min(targets, key=lambda r: r.members())
                if await self._resume_on(sess, target):
                    self._sessions[sess] = target
                    sess.resumes += 1
                    self.sessions_resumed += 1
                    resumed += 1
                else:
                    await self._close_session(sess, "failover_shed")
                    self.sheds_failover += 1
            span.set(resumed=resumed)

    async def _resume_on(self, sess: RoutedSession, target) -> bool:
        """Lossless height-keyed resume: attach live (buffering),
        replay ``last_delivered+1..`` from the store, splice."""
        src = self.store_source
        if src is None:
            # no store to replay from: live-only re-admit is LOSSY —
            # refuse (the caller sheds; the client re-subscribes with
            # its own resume logic)
            return False
        gap = max(0, src.height() - sess.last_delivered)
        if gap > self.resume_replay_max:
            return False
        sess.begin_replay()
        target.attach(sess)
        sess.parse_heights = getattr(target, "HUB_DELIVERY", False)
        cur = sess.last_delivered
        end = cur
        try:
            for _ in range(REPLAY_MAX_LEGS):
                end = max(end, target.served_height())
                while cur < end:
                    h = cur + 1
                    block = src.load_block(h)
                    if block is None:
                        # pruned below the resume cursor: lossless
                        # replay is impossible — shed honestly
                        raise LookupError(h)
                    for e in height_events(
                        block, getattr(src, "results_fn", None)
                    ):
                        attrs = _event_attrs(e)
                        if not sess.query.matches(attrs):
                            continue
                        await sess.sink.send_str(
                            sess._prefix
                            + event_payload(e, sess.query_str, attrs)
                            + "}"
                        )
                    cur = h
                    sess.last_delivered = h
                    await asyncio.sleep(0)
                if target.served_height() <= end:
                    break
            else:
                raise LookupError("replay could not converge")
            await sess.end_replay(end)
            return True
        except asyncio.CancelledError:
            raise
        except Exception:
            await target.detach_member(sess)
            sess._replaying = False
            sess._buffer.clear()
            return False

    # --- teardown helpers ---------------------------------------------

    async def _close_session(
        self, sess: RoutedSession, reason: str
    ) -> None:
        replica = self._sessions.pop(sess, None)
        if replica is not None:
            try:
                await replica.detach_member(sess)
            except asyncio.CancelledError:
                raise
            except Exception:
                pass
            self.gate.exit()
        sess.closed = True
        sess.close_reason = sess.close_reason or reason

    # --- obs / introspection ------------------------------------------

    def register_queues(self, registry) -> None:
        """Expose router admission in an obs QueueRegistry (the same
        contract every bounded plane follows)."""
        registry.register("fleet.route", self.gate.stats)

    def fleet_status(self) -> dict:
        head = self._head()
        reps = []
        for r in self.replicas:
            st = r.status()
            st["lag_heights"] = (
                max(0, head - r.served_height()) if r.alive else None
            )
            st["degraded"] = id(r) in self._degraded
            reps.append(st)
        return {
            "head": head,
            "sessions": len(self._sessions),
            "admission": self.gate.stats(),
            "failovers": self.failovers,
            "sessions_resumed": self.sessions_resumed,
            "sheds": {
                "admit": self.gate.stats()["dropped"],
                "lag": self.sheds_lag,
                "failover": self.sheds_failover,
            },
            "tokens_issued": self.tokens_issued,
            "replicas": reps,
        }
