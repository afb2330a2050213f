"""Peer exchange (PEX) + address book (reference p2p/pex/pex_reactor.go,
p2p/pex/addrbook.go).

AddrBook: known peer addresses split into NEW (heard about) and OLD
(connected successfully) buckets, persisted as JSON, with attempt/
success bookkeeping. PexReactor (channel 0x00): answers address
requests from the book, learns addresses from responses, and crawls —
dialing book addresses whenever the switch is below its outbound
target. Seed mode answers one request then disconnects the peer
(reference pex_reactor.go seed crawling).

A copy of the JAX package's ``p2p/pex.py``: the same messages on
channel 0x00 (a request byte; a response byte then a JSON list of
``id@host:port``), the same book file and the same forgiveness of aged
attempt counters, so a port node and a JAX node exchange addresses.
"""

from __future__ import annotations

import asyncio
import json
import os
import random
import time
import traceback
from dataclasses import dataclass
from typing import Dict, List, Optional

from ..utils.tasks import spawn
from .node_info import ChannelDescriptor
from .reactor import Reactor

PEX_CHANNEL = 0x00

MSG_PEX_REQUEST = 0x01
MSG_PEX_RESPONSE = 0x02

MAX_ADDRS_PER_RESPONSE = 250
CRAWL_INTERVAL_S = 5.0
REQUEST_INTERVAL_S = 30.0
MAX_ATTEMPTS = 10
MAX_BOOK_SIZE = 5000  # reference addrbook bucket caps analog
# persisted attempt counters age out: an address whose LAST attempt
# is older than this reloads with a clean counter — without
# forgiveness, a never-connected entry that crossed MAX_ATTEMPTS
# would be is_bad FOREVER across restarts (excluded from crawl and
# selection, re-learnable only by an inbound conn). The pre-persist
# behavior got this for free by losing the counters entirely.
FORGIVE_AFTER_S = 3600.0


@dataclass
class KnownAddress:
    addr: str  # "id@host:port"
    src: str = ""  # peer id we heard it from
    attempts: int = 0
    last_attempt: float = 0.0
    last_success: float = 0.0
    is_old: bool = False  # promoted after a successful connection
    # conn-death bookkeeping (the self-healing plane records a
    # failure on every dial failure AND every conn death)
    failures: int = 0
    last_failure: float = 0.0

    @property
    def peer_id(self) -> str:
        return self.addr.partition("@")[0]

    @property
    def is_bad(self) -> bool:
        return self.attempts >= MAX_ATTEMPTS and not self.last_success


class AddrBook:
    """JSON-persisted address book (reference p2p/pex/addrbook.go)."""

    def __init__(self, path: Optional[str] = None, our_id: str = ""):
        self.path = path
        self.our_id = our_id
        self.addrs: Dict[str, KnownAddress] = {}  # peer_id -> ka
        if path and os.path.exists(path):
            self._load()

    # --- mutation -----------------------------------------------------

    def add_address(self, addr: str, src: str = "") -> bool:
        pid = addr.partition("@")[0]
        if not pid or pid == self.our_id:
            return False
        ka = self.addrs.get(pid)
        if ka is None:
            if len(self.addrs) >= MAX_BOOK_SIZE:
                self._evict_one()
                if len(self.addrs) >= MAX_BOOK_SIZE:
                    return False  # full of good addresses; drop new
            self.addrs[pid] = KnownAddress(addr=addr, src=src)
            return True
        if not ka.is_old and addr != ka.addr:
            ka.addr = addr  # newer routing info for a NEW address
            ka.attempts = 0  # a fresh address deserves fresh dials
        elif (
            ka.is_old
            and addr != ka.addr
            and ka.last_failure > ka.last_success
        ):
            # the PROVEN address is now failing (conn died / dials
            # miss): re-learned routing info wins, or a moved peer's
            # stale entry would shadow its new address forever and
            # the reconnect plane would redial the dead one
            ka.addr = addr
            ka.attempts = 0
        return False

    def _evict_one(self) -> None:
        """Drop the least valuable entry: bad first, then the oldest
        never-connected NEW address."""
        worst = None
        for pid, a in self.addrs.items():
            if a.is_bad:
                worst = pid
                break
            if not a.is_old and (
                worst is None or a.last_attempt < self.addrs[worst].last_attempt
            ):
                worst = pid
        if worst is not None:
            del self.addrs[worst]

    def mark_attempt(self, peer_id: str) -> None:
        ka = self.addrs.get(peer_id)
        if ka:
            ka.attempts += 1
            ka.last_attempt = time.time()

    def mark_good(self, peer_id: str, addr: str = "") -> None:
        ka = self.addrs.get(peer_id)
        if ka is None and addr:
            ka = self.addrs[peer_id] = KnownAddress(addr=addr)
        if ka:
            if addr and ka.addr != addr:
                # a LIVE connection at this address is the strongest
                # routing evidence there is — it beats any older entry
                ka.addr = addr
            ka.attempts = 0
            ka.last_success = time.time()
            ka.is_old = True

    def mark_failed(self, peer_id: str, addr: str = "") -> None:
        """A dial failed or a live conn died (the reconnect plane's
        conn-death hook). Creates the entry when ``addr`` is given so
        a persistent peer that was never PEX-learned still accumulates
        health history."""
        ka = self.addrs.get(peer_id)
        if ka is None and addr:
            ka = self.addrs[peer_id] = KnownAddress(addr=addr)
        if ka:
            ka.failures += 1
            ka.last_failure = time.time()

    def remove(self, peer_id: str) -> None:
        self.addrs.pop(peer_id, None)

    # --- selection ----------------------------------------------------

    def selection(self, limit: int = MAX_ADDRS_PER_RESPONSE) -> List[str]:
        """Biased random sample for PEX responses (reference
        GetSelection: mix of old + new)."""
        pool = [a for a in self.addrs.values() if not a.is_bad]
        random.shuffle(pool)
        pool.sort(key=lambda a: not a.is_old)  # old first, then new
        take = pool[: limit // 2] + [
            a for a in pool[limit // 2:] if not a.is_old
        ][: limit // 2]
        return [a.addr for a in take[:limit]]

    def pick_to_dial(self, exclude: set, n: int) -> List[str]:
        cands = [
            a
            for pid, a in self.addrs.items()
            if pid not in exclude and not a.is_bad
            and time.time() - a.last_attempt > 10.0 * (a.attempts + 1)
        ]
        # new-bucket bias like the reference's crawl
        random.shuffle(cands)
        return [a.addr for a in cands[:n]]

    def size(self) -> int:
        return len(self.addrs)

    # --- persistence --------------------------------------------------

    def save(self) -> None:
        if not self.path:
            return
        # the FULL bookkeeping persists: a restarted node's reconnect
        # plane and crawl biasing resume from real dial history, not a
        # wiped slate (attempts/last_attempt previously evaporated
        # across restarts, resetting pick_to_dial's backoff gating)
        data = [
            {
                "addr": a.addr,
                "src": a.src,
                "attempts": a.attempts,
                "last_attempt": a.last_attempt,
                "last_success": a.last_success,
                "is_old": a.is_old,
                "failures": a.failures,
                "last_failure": a.last_failure,
            }
            for a in self.addrs.values()
        ]
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"addrs": data}, f)
        os.replace(tmp, self.path)

    def _load(self) -> None:
        try:
            with open(self.path) as f:
                data = json.load(f)
            now = time.time()
            for d in data.get("addrs", []):
                ka = KnownAddress(
                    addr=d["addr"],
                    src=d.get("src", ""),
                    attempts=d.get("attempts", 0),
                    last_attempt=d.get("last_attempt", 0.0),
                    last_success=d.get("last_success", 0.0),
                    is_old=d.get("is_old", False),
                    failures=d.get("failures", 0),
                    last_failure=d.get("last_failure", 0.0),
                )
                if now - ka.last_attempt > FORGIVE_AFTER_S:
                    # aged-out failure history (FORGIVE_AFTER_S):
                    # the entry gets a fresh chance; failures/
                    # last_failure stay for diagnostics
                    ka.attempts = 0
                self.addrs[ka.peer_id] = ka
        except Exception:
            traceback.print_exc()


class PexReactor(Reactor):
    name = "pex"

    def __init__(
        self,
        book: AddrBook,
        seed_mode: bool = False,
        target_outbound: int = 10,
    ):
        super().__init__()
        self.book = book
        self.seed_mode = seed_mode
        self.target_outbound = target_outbound
        self._crawl_task: Optional[asyncio.Task] = None
        self._last_request: Dict[str, float] = {}
        self._requested: set = set()  # peers we asked (expect response)

    def get_channels(self):
        return [
            ChannelDescriptor(PEX_CHANNEL, priority=1, max_msg_size=1 << 16)
        ]

    async def start(self) -> None:
        self._crawl_task = asyncio.create_task(self._crawl_routine())

    async def stop(self) -> None:
        if self._crawl_task:
            self._crawl_task.cancel()
        self.book.save()

    # --- peers --------------------------------------------------------

    def add_peer(self, peer) -> None:
        # every live peer is a GOOD address
        if peer.node_info.listen_addr:
            self.book.mark_good(
                peer.peer_id,
                f"{peer.peer_id}@{peer.node_info.listen_addr}",
            )
        if peer.outbound and not self.seed_mode:
            self._request_addrs(peer)

    def remove_peer(self, peer, reason) -> None:
        self._requested.discard(peer.peer_id)
        self._last_request.pop(peer.peer_id, None)

    def _request_addrs(self, peer) -> None:
        now = time.monotonic()
        if now - self._last_request.get(peer.peer_id, 0) < REQUEST_INTERVAL_S:
            return
        self.request_now(peer)

    def request_now(self, peer) -> None:
        """Rate-limit-bypassing address request: the switch calls this
        on every dial success while the node is STARVING (zero peers
        past the starvation threshold) so a rejoining minority
        re-learns moved/healed addresses immediately instead of
        waiting out REQUEST_INTERVAL_S."""
        self._last_request[peer.peer_id] = time.monotonic()
        self._requested.add(peer.peer_id)
        peer.try_send(PEX_CHANNEL, bytes([MSG_PEX_REQUEST]))

    # --- wire ---------------------------------------------------------

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        mtype = msg[0]
        if mtype == MSG_PEX_REQUEST:
            addrs = self.book.selection()
            # advertise ourselves too? peers already know us. Send book.
            peer.try_send(
                PEX_CHANNEL,
                bytes([MSG_PEX_RESPONSE])
                + json.dumps(addrs).encode(),
            )
            if self.seed_mode:
                # seeds serve addresses then hang up (reference
                # pex_reactor.go:~seed mode)
                spawn(self.switch.stop_peer_gracefully(peer))
        elif mtype == MSG_PEX_RESPONSE:
            if peer.peer_id not in self._requested:
                # unsolicited response is a protocol violation
                # (reference ErrUnsolicitedList)
                self.switch.stop_peer_for_error(
                    peer, ValueError("unsolicited PEX response")
                )
                return
            self._requested.discard(peer.peer_id)
            try:
                addrs = json.loads(msg[1:].decode())
            except Exception:
                self.switch.stop_peer_for_error(
                    peer, ValueError("bad PEX response")
                )
                return
            for a in addrs[:MAX_ADDRS_PER_RESPONSE]:
                if isinstance(a, str) and "@" in a:
                    self.book.add_address(a, src=peer.peer_id)
        else:
            raise ValueError(f"unknown pex msg type {mtype}")

    # --- crawling -----------------------------------------------------

    async def _crawl_routine(self) -> None:
        try:
            while True:
                await asyncio.sleep(CRAWL_INTERVAL_S)
                sw = self.switch
                if sw is None:
                    continue
                have = sw.num_peers()
                if have >= self.target_outbound:
                    # refresh the book occasionally from a random peer
                    peers = list(sw.peers.values())
                    if peers and not self.seed_mode:
                        self._request_addrs(random.choice(peers))
                    continue
                exclude = set(sw.peers) | sw.banned | {self.book.our_id}
                for addr in self.book.pick_to_dial(
                    exclude, self.target_outbound - have
                ):
                    pid = addr.partition("@")[0]
                    self.book.mark_attempt(pid)
                    try:
                        await sw.dial_peer(addr)
                        self.book.mark_good(pid, addr)
                    except asyncio.CancelledError:
                        raise
                    except Exception:
                        pass  # crawl dials fail routinely
                self.book.save()
        except asyncio.CancelledError:
            raise
        except Exception:
            traceback.print_exc()
