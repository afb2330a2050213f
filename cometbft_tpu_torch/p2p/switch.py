"""Switch: owns transport, peers, and reactors (reference p2p/switch.go).

Responsibilities (mirroring the reference):
- accept loop: upgraded inbound conns -> add_peer
- dial_peers_async with persistent-peer redial handed to the
  self-healing ReconnectPlane (p2p/reconnect.py): budgeted full-jitter
  fast lane + never-give-up slow-lane sweep (the reference's
  reconnectToPeer gave up after a finite budget; ours cannot — a
  healed partition must always converge)
- incarnation-safe dial dedup: duplicate conns are resolved on
  (node id, incarnation) — a restarted remote's fresh dial EVICTS the
  zombie entry (a synchronous abort) instead of being
  dup-discarded against it, and simultaneous cross-dials resolve
  deterministically (the conn whose dialer has the lower node id wins
  on both ends; the loser's conn is closed synchronously)
- channel routing: every complete MConnection message is dispatched to
  the reactor that registered its channel
- stop_peer_for_error: the single choke point reactors use to drop a
  misbehaving peer (and everything re-routes through reconnect logic)
- max peer caps + dedup by node ID.

A copy of the JAX package's ``p2p/switch.py``, with the runtime
sanitizer's loop-affinity guard on the peer map (``p2p.switch.peers``,
tagged at ``start``, touched where a peer is registered or removed;
``analysis/runtime.py``). Trace stamping is the JAX one:
``enable_stamping`` (node wiring, when the node's tracer is on) builds
a ``tracewire.TraceStamper``; ``broadcast(tkind=...)`` and
``stamp_msg`` then stamp outbound consensus, mempool and blocksync
messages and record ``p2p.msg.send``, and every received stamp is
peeled before dispatch and, with a stamper, recorded as
``p2p.msg.recv`` (and ``p2p.msg.propagation`` within one clock
domain). With ``use_autopool`` reactor messages drain through an
``utils.autopool.AutoPool`` (2 to 16 workers, started and stopped with
the switch); a saturated pool dispatches inline. The lp2p switcher
(``lp2p/switch.py``) subclasses this one.

Departure (ROADMAP C3): a reactor whose ``receive`` raises
``crypto.scheduler.DeviceRouteError`` (a verify route that failed,
with no verdict) does not get its peer stopped. The error is counted
in ``loop_errors`` (a node points it at its consensus state's) and the
peer stays connected. Every other error stops the peer, as in the JAX
package.
"""

from __future__ import annotations

import asyncio
import time
import traceback
from typing import Dict, List, Optional

from ..analysis.runtime import get_sanitizer
from ..crypto.scheduler import DeviceRouteError
from ..trace import NOOP as TRACE_NOOP
from ..utils.log import get_logger
from ..utils.loop_errors import LoopErrors
from ..utils.tasks import spawn
from . import tracewire
from .node_info import ChannelDescriptor, NodeInfo
from .peer import Peer
from .reactor import Reactor
from .reconnect import ReconnectPlane

_log = get_logger("p2p")

DEFAULT_MAX_PEERS = 50
# health connectivity verdict default: degraded below this many peers
# (only once the node has evidence it is MEANT to be connected)
DEFAULT_MIN_PEERS = 1
# duplicate-conn resolution: a conn OLDER than this facing a fresh
# opposite-dialer conn is not in a simultaneous dial race — the fresh
# conn is a redial against our (one-sided-dead) entry and wins
CROSS_DIAL_WINDOW_S = 5.0


class Switch:
    def __init__(
        self,
        transport,
        node_info: NodeInfo,
        max_peers: int = DEFAULT_MAX_PEERS,
        mconn_config: Optional[dict] = None,
        use_autopool: bool = False,
        reconnect_config: Optional[dict] = None,
    ):
        # fork feature: reactor messages can be drained by an
        # auto-scaling worker pool (reference lp2p/reactor_set.go +
        # internal/autopool) instead of inline dispatch
        self._autopool = None
        self._use_autopool = use_autopool
        self.transport = transport
        self.node_info = node_info
        self.reactors: Dict[str, Reactor] = {}
        self.chan_to_reactor: Dict[int, Reactor] = {}
        self.channel_descs: List[ChannelDescriptor] = []
        self._chan_caps: Dict[int, int] = {}
        self.peers: Dict[str, Peer] = {}
        # loop-affinity guard (analysis/runtime.py): the peer map is
        # mutated only on the switch's event loop
        self._sanitizer = get_sanitizer()
        self.persistent_addrs: Dict[str, str] = {}  # id -> addr
        self.banned: set = set()
        self.max_peers = max_peers
        self.mconn_config = mconn_config or {}
        self._accept_task: Optional[asyncio.Task] = None
        self._stopped = False
        # self-healing connectivity plane (p2p/reconnect.py): owns all
        # persistent-peer redial; Lp2pSwitch inherits it unchanged
        self.reconnect = ReconnectPlane(self, **(reconnect_config or {}))
        # PEX address book, set by node wiring when PEX is on: the
        # reconnect plane consults it for re-learned addresses and
        # records dial failures into it
        self.addr_book = None
        # health connectivity verdict floor
        self.min_peers = DEFAULT_MIN_PEERS
        # tracing plane (trace/): peer-count changes land as counter
        # events
        self.tracer = TRACE_NOOP
        # cross-node stamping plane (p2p/tracewire.py): None until the
        # node enables it, so the fully-off path is one None check
        self.stamper = None
        # failed verify routes a reactor's receive raised (C3); a node
        # points this at its consensus state's
        self.loop_errors = LoopErrors()

    # --- reactor registry ---------------------------------------------

    def add_reactor(self, name: str, reactor: Reactor) -> Reactor:
        self.reactors[name] = reactor
        for desc in reactor.get_channels():
            if desc.chan_id in self.chan_to_reactor:
                raise ValueError(
                    f"channel {desc.chan_id:#x} claimed twice"
                )
            self.chan_to_reactor[desc.chan_id] = reactor
            self.channel_descs.append(desc)
            self._chan_caps[desc.chan_id] = desc.max_msg_size
            self.node_info.channels.append(desc.chan_id)
        reactor.set_switch(self)
        return reactor

    def reactor(self, name: str) -> Optional[Reactor]:
        return self.reactors.get(name)

    # --- lifecycle ----------------------------------------------------

    async def start(self) -> None:
        self._sanitizer.tag("p2p.switch.peers")
        for r in self.reactors.values():
            await r.start()
        if self._use_autopool:
            from ..utils.autopool import AutoPool

            self._autopool = AutoPool(min_workers=2, max_workers=16)
            self._autopool.start()
        self._accept_task = asyncio.create_task(self._accept_routine())
        self.reconnect.start()

    async def stop(self) -> None:
        # every await is bounded: one wedged reactor/peer/transport
        # must not hang the node's whole stop chain
        self._stopped = True
        if self._accept_task:
            self._accept_task.cancel()
        self.reconnect.stop()
        if self._autopool is not None:
            try:
                await asyncio.wait_for(self._autopool.stop(), 5.0)
            except asyncio.TimeoutError:
                pass
        for r in self.reactors.values():
            try:
                # 12s: strictly ABOVE the largest per-plane bound a
                # reactor stop carries internally (mempool/blocksync
                # budget their sub-planes at 10s) — an inner bound
                # must stay reachable or its post-wait cleanup is
                # silently skipped
                await asyncio.wait_for(r.stop(), 12.0)
            except asyncio.CancelledError:
                raise
            except asyncio.TimeoutError:
                _log.error(
                    "reactor stop exceeded its budget, abandoning",
                    reactor=type(r).__name__,
                )
            except Exception:
                traceback.print_exc()
        for p in list(self.peers.values()):
            try:
                # 9s: strictly above Peer.stop's internal 7s bound
                # (same reachability rule as the reactor bound above)
                await asyncio.wait_for(self._remove_peer(p, None), 9.0)
            except asyncio.TimeoutError:
                # the fd must still die (zombie-conn rejoin wedge)
                try:
                    p.abort()
                except Exception:
                    pass
        try:
            await asyncio.wait_for(self.transport.close(), 5.0)
        except asyncio.TimeoutError:
            pass

    def abort(self) -> None:
        """Synchronous last-resort teardown: when the graceful
        ``stop()`` was cancelled or abandoned past its budget, every
        remaining connection must STILL die — a conn left open past
        shutdown is a zombie its remote keeps treating as a live peer,
        so it dup-discards the restarted node's fresh dials and the
        node can never rejoin. Never awaits; reactors get their sync remove_peer so gossip tasks
        are cancelled, not left erroring against dead fds."""
        self._stopped = True
        if self._accept_task:
            self._accept_task.cancel()
        self.reconnect.stop()
        for p in list(self.peers.values()):
            for r in self.reactors.values():
                try:
                    r.remove_peer(p, None)
                except Exception:
                    pass
            try:
                p.abort()
            except Exception:
                pass
        self.peers.clear()
        self.tracer.counter("p2p.peers", 0, tid="p2p")
        spawn(
            self._close_transport_best_effort(),
            name="switch-abort-transport",
        )

    async def _close_transport_best_effort(self) -> None:
        try:
            await asyncio.wait_for(self.transport.close(), 5.0)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass

    # --- accept / dial ------------------------------------------------

    async def _accept_routine(self) -> None:
        while not self._stopped:
            try:
                sconn, their_info, conn_str = await self.transport.accept()
            except asyncio.CancelledError:
                raise
            except Exception:
                traceback.print_exc()
                await asyncio.sleep(0.1)
                continue
            if (
                their_info.node_id in self.banned
                or their_info.node_id == self.node_info.node_id
            ):
                self._discard_conn(sconn)
                continue
            existing = self.peers.get(their_info.node_id)
            if existing is not None:
                # incarnation-safe dedup: the duplicate may be the
                # LIVE conn (restarted remote, cross-dial winner)
                if self._new_conn_wins(existing, their_info, inbound=True):
                    self._evict_peer_sync(
                        existing,
                        ConnectionError("superseded by newer conn"),
                    )
                else:
                    self._discard_conn(sconn)
                    continue
            elif len(self.peers) >= self.max_peers:
                self._discard_conn(sconn)
                continue
            self._make_peer(sconn, their_info, conn_str, outbound=False)

    async def dial_peer(
        self, addr: str, peer_id: Optional[str] = None, persistent: bool = False
    ) -> Optional[Peer]:
        """addr forms: "id@host:port", "host:port", "mem://id"."""
        if "@" in addr:
            peer_id, _, addr = addr.partition("@")
        if peer_id == self.node_info.node_id:
            raise ValueError("cannot dial self")
        if peer_id and (peer_id in self.peers or peer_id in self.banned):
            return self.peers.get(peer_id)
        if persistent and peer_id:
            self.persistent_addrs[peer_id] = addr
        try:
            sconn, their_info, conn_str = await self.transport.dial(
                addr, peer_id
            )
        except Exception as e:
            if persistent and peer_id:
                # hand the retry to the self-healing plane (counted;
                # never given up on)
                self.reconnect.note_dial_failure(peer_id)
            raise e
        if their_info.node_id == self.node_info.node_id:
            self._discard_conn(sconn)
            raise ValueError("dialed own address (self-connection)")
        existing = self.peers.get(their_info.node_id)
        if existing is not None:
            if self._new_conn_wins(existing, their_info, inbound=False):
                self._evict_peer_sync(
                    existing,
                    ConnectionError("superseded by newer conn"),
                )
            else:
                self._discard_conn(sconn)
                return existing
        return self._make_peer(
            sconn, their_info, conn_str, outbound=True, persistent=persistent
        )

    def dial_peers_async(self, addrs: List[str], persistent: bool = False):
        return [
            asyncio.create_task(self._dial_ignore_err(a, persistent))
            for a in addrs
        ]

    async def _dial_ignore_err(self, addr: str, persistent: bool):
        try:
            await self.dial_peer(addr, persistent=persistent)
        except asyncio.CancelledError:
            raise
        except Exception:
            pass  # dial errors are expected; the reconnect plane owns
            # the retry (dial_peer already routed the failure there)

    # --- duplicate-conn resolution ------------------------------------

    def _new_conn_wins(
        self, existing: Peer, their_info, inbound: bool
    ) -> bool:
        """Deterministic duplicate resolution keyed on
        (node id, incarnation):

        - different incarnation → the registered peer is a previous
          life of the remote (its conn may be a zombie the abort floor
          has not reaped yet): the NEW conn always wins, so a
          restarted node's dials are never dup-discarded against a
          stale entry;
        - same incarnation, same dialer → a REDIAL: the origin only
          dials again because its end of the old conn is already dead
          (our side may not have processed the EOF yet), so the new
          conn wins — dup-discarding it would throw away the redial
          against a conn that is about to die anyway;
        - same incarnation, opposite dialers, EXISTING conn long
          established → also a redial: the remote's end of the old
          conn died one-sided (we have not noticed yet), so its fresh
          dial wins — the tiebreak below must not keep discarding
          legitimate redials in favor of a zombie until the pong
          timeout reaps it;
        - same incarnation, opposite dialers, both young →
          simultaneous cross-dial: the conn whose DIALER has the
          lower node id wins, evaluated identically on both ends
          (each end keeps the same one connection and closes the
          other synchronously)."""
        new_inc = getattr(their_info, "incarnation", "")
        old_inc = getattr(existing.node_info, "incarnation", "")
        if new_inc and old_inc and new_inc != old_inc:
            return True
        me = self.node_info.node_id
        them = their_info.node_id
        new_dialer = them if inbound else me
        old_dialer = me if existing.outbound else them
        if new_dialer == old_dialer:
            return True
        established = getattr(existing, "established_at", 0.0)
        if time.monotonic() - established > CROSS_DIAL_WINDOW_S:
            return True  # not a dial race: the remote REDIALED
        return new_dialer < old_dialer

    def _evict_peer_sync(self, peer: Peer, reason: Exception) -> None:
        """Synchronous removal of a duplicate-resolution loser: the
        conn must be DEAD before the replacement registers (never
        awaits — same floor as abort())."""
        if self._sanitizer.enabled:
            self._sanitizer.touch("p2p.switch.peers")
        if self.peers.get(peer.peer_id) is peer:
            del self.peers[peer.peer_id]
            self.tracer.counter("p2p.peers", len(self.peers), tid="p2p")
        _log.info(
            "evicted duplicate peer conn",
            peer=peer.peer_id[:12],
            reason=str(reason),
            outbound=peer.outbound,
        )
        for r in self.reactors.values():
            try:
                r.remove_peer(peer, reason)
            except Exception:
                traceback.print_exc()
        try:
            peer.abort()
        except Exception:
            pass

    # --- peer management ----------------------------------------------

    def _discard_conn(self, sconn) -> None:
        """Close an upgraded connection rejected before peer
        registration; subclasses release admission resources here."""
        sconn.close()

    def _register_peer(self, peer) -> None:
        """Shared tail of peer construction: register, start, announce
        to reactors, feed the self-healing plane."""
        peer.established_at = time.monotonic()
        if self._sanitizer.enabled:
            self._sanitizer.touch("p2p.switch.peers")
        self.peers[peer.peer_id] = peer
        self.tracer.counter("p2p.peers", len(self.peers), tid="p2p")
        _log.info(
            "added peer",
            peer=peer.peer_id[:12],
            addr=peer.conn_str,
            outbound=peer.outbound,
            total=len(self.peers),
        )
        was_starving = self.reconnect.on_peer_connected(peer)
        if self.addr_book is not None and peer.node_info.listen_addr:
            self.addr_book.mark_good(
                peer.peer_id,
                f"{peer.peer_id}@{peer.node_info.listen_addr}",
            )
        peer.start()
        for r in self.reactors.values():
            try:
                r.add_peer(peer)
            except Exception:
                traceback.print_exc()
        if was_starving:
            # starvation exit: re-learn moved/healed addresses NOW —
            # a rejoining minority must not wait out the PEX crawl
            # interval to find where everyone went
            pex = self.reactors.get("pex")
            if pex is not None and hasattr(pex, "request_now"):
                pex.request_now(peer)

    def _make_peer(
        self, sconn, their_info, conn_str, outbound, persistent=False
    ) -> Peer:
        channels = [
            (d.chan_id, d.priority, d.max_msg_size)
            for d in self.channel_descs
        ]
        peer = Peer(
            sconn,
            their_info,
            conn_str,
            channels,
            on_receive=self._on_peer_msg,
            on_error=self._on_peer_error,
            outbound=outbound,
            persistent=persistent
            or their_info.node_id in self.persistent_addrs,
            mconn_config=self.mconn_config,
        )
        self._register_peer(peer)
        return peer

    def _on_peer_msg(self, chan_id: int, msg: bytes, peer: Peer) -> None:
        # cross-node tracing: peel an optional trace-context stamp
        # (tracewire) before channel dispatch, recording the
        # correlated receive instant. Decoding is ALWAYS on — stamped
        # traffic from tracing peers must interop with nodes whose own
        # stamping (or whole tracer) is off.
        if msg[:2] == tracewire.MAGIC:
            ctx, msg = tracewire.unstamp(msg)
            if ctx is not None and self.stamper is not None:
                self.stamper.on_receive(ctx, peer.peer_id)
        reactor = self.chan_to_reactor.get(chan_id)
        if reactor is None:
            self.stop_peer_for_error(
                peer, ValueError(f"msg on unclaimed channel {chan_id:#x}")
            )
            return
        if self._autopool is not None:
            if not self._autopool.submit(self._dispatch, reactor, chan_id, peer, msg):
                # saturated pool: dispatch inline rather than dropping
                # (a lost vote/part can stall a consensus round)
                self._dispatch(reactor, chan_id, peer, msg)
            return
        self._dispatch(reactor, chan_id, peer, msg)

    @property
    def autopool(self):
        """The reactor worker pool while the switch runs with
        ``use_autopool``, else None."""
        return self._autopool

    def _dispatch(self, reactor, chan_id: int, peer: Peer, msg: bytes):
        try:
            reactor.receive(chan_id, peer, msg)
        except DeviceRouteError as e:
            # no verdict on the peer's message (C3): counted, the peer
            # kept
            if self.loop_errors.add(e):
                _log.error(
                    "verify route failed, no verdict; peer kept",
                    channel=f"{chan_id:#x}",
                    peer=peer.peer_id[:12],
                    err=repr(e),
                )
            LoopErrors.drop_frames(e)
        except Exception as e:
            _log.error(
                "reactor receive failed, stopping peer",
                channel=f"{chan_id:#x}",
                peer=peer.peer_id[:12],
                err=repr(e),
            )
            traceback.print_exc()
            self.stop_peer_for_error(peer, e)

    def _on_peer_error(self, peer: Peer, exc: Exception) -> None:
        self.stop_peer_for_error(peer, exc)

    def stop_peer_for_error(self, peer: Peer, exc: Optional[Exception]):
        spawn(self._remove_peer(peer, exc, reconnect=True))

    async def stop_peer_gracefully(self, peer: Peer):
        await self._remove_peer(peer, None, reconnect=False)

    async def _remove_peer(self, peer, exc, reconnect=False) -> None:
        if self.peers.get(peer.peer_id) is not peer:
            return
        if self._sanitizer.enabled:
            self._sanitizer.touch("p2p.switch.peers")
        del self.peers[peer.peer_id]
        self.tracer.counter("p2p.peers", len(self.peers), tid="p2p")
        _log.info(
            "removed peer",
            peer=peer.peer_id[:12],
            err=repr(exc) if exc else "",
            total=len(self.peers),
        )
        for r in self.reactors.values():
            try:
                r.remove_peer(peer, exc)
            except Exception:
                traceback.print_exc()
        await peer.stop()
        if not self._stopped:
            self.reconnect.on_peer_removed(peer, had_error=reconnect)

    def ban_peer(self, peer_id: str) -> None:
        _log.info("banned peer", peer=peer_id[:12])
        self.banned.add(peer_id)
        self.reconnect.abandon(peer_id)  # the one sanctioned give-up
        p = self.peers.get(peer_id)
        if p:
            spawn(self._remove_peer(p, None))

    # --- broadcast / trace stamping -----------------------------------

    def enable_stamping(self, tracer, origin: str, outbound: bool = True) -> None:
        """Turn on the cross-node tracing plane (node wiring).
        ``outbound=False`` ([instrumentation] trace_msg_stamp off)
        keeps receive-side correlation recording while this node's
        own sends go out unstamped."""
        self.stamper = tracewire.TraceStamper(tracer, origin, outbound)

    def stamp_msg(
        self,
        chan_id: int,
        msg: bytes,
        kind: str,
        height: int = 0,
        round_: int = -1,
        peer: str = "",
    ) -> bytes:
        """Wire form for a single traced send (the per-peer gossip
        routines): stamped when the stamping plane is on; otherwise
        the message unchanged — except a payload that happens to
        begin with the stamp magic, which is escaped either way
        (receive-side peel is ALWAYS on, so a raw magic-prefixed
        payload — e.g. an adversarial tx — would otherwise be
        mutated by the receiver)."""
        st = self.stamper
        if st is None or not st.outbound:
            return tracewire.encode_plain(msg, self._chan_caps.get(chan_id, 0))
        return st.wrap(
            msg, kind, height=height, round_=round_,
            cap=self._chan_caps.get(chan_id, 0), peer=peer[:12],
        )

    def broadcast(
        self,
        chan_id: int,
        msg: bytes,
        tkind: Optional[str] = None,
        height: int = 0,
        round_: int = -1,
    ) -> None:
        """Send to every peer; with ``tkind`` set and stamping on, the
        message is stamped ONCE with a trace context (one encode per
        broadcast, one send instant carrying the fan-out). Unstamped
        broadcasts still escape a magic-prefixed payload (see
        ``stamp_msg``) — raw txs are attacker-shaped bytes."""
        st = self.stamper
        cap = self._chan_caps.get(chan_id, 0)
        if st is not None and st.outbound and tkind is not None:
            msg = st.wrap(msg, tkind, height=height, round_=round_, cap=cap, npeers=len(self.peers))
        else:
            msg = tracewire.encode_plain(msg, cap)
        for p in list(self.peers.values()):  # bftlint: disable=ASY117 — flood fanout IS the protocol floor: one encode per broadcast, O(peers) enqueues of one shared bytes object; vote-aggregation relay is the committee-scale answer
            p.try_send(chan_id, msg)

    def num_peers(self) -> int:
        return len(self.peers)
