"""Evidence reactor: gossip evidence on channel 0x38 (reference
evidence/reactor.go:17, broadcastEvidenceRoutine :107).

A copy of the JAX package's ``evidence/reactor.py``: every pending
piece of evidence is offered to every peer by a per-peer routine every
``BROADCAST_INTERVAL_S`` (the pool dedups), newly added evidence is
flooded at once through the pool's broadcast hook, an undecodable
message stops its peer and evidence the pool refuses is dropped.
Received evidence is checked in a task of its own, with the commit
checks' tickets awaited on the loop (``add_evidence_awaited``), so a
light-client attack's two tickets stop no other reactor.

One departure (ROADMAP C3): a failed verify route is no verdict. The
JAX ``receive`` swallows every error of ``add_evidence``, and the
sender never offers the same evidence again (its ``sent`` set is per
peer), so a failed card would drop valid evidence of an attack. Here a
``DeviceRouteError`` keeps the evidence on a retry list (bounded by
``MAX_RETRY_BYTES`` of encoded evidence, deduplicated by hash), the
error is counted in the switch's ``loop_errors`` and the peer kept,
and a routine offers the list to the pool again every
``RETRY_INTERVAL_S`` until each piece has a verdict. Evidence handed
to a node directly (``add_evidence``) takes the same path, and so does
received evidence while ``MAX_CHECKS`` checks are already running.
"""

from __future__ import annotations

import asyncio
import traceback
from typing import Dict, Optional

from ..crypto.scheduler import DeviceRouteError
from ..p2p.node_info import ChannelDescriptor
from ..p2p.reactor import Reactor
from ..utils.log import get_logger
from ..utils.loop_errors import LoopErrors
from .types import decode_evidence

_log = get_logger("evidence")

EVIDENCE_CHANNEL = 0x38
BROADCAST_INTERVAL_S = 0.5
MAX_PENDING_BYTES = 1 << 20
RETRY_INTERVAL_S = BROADCAST_INTERVAL_S
MAX_RETRY_BYTES = MAX_PENDING_BYTES
# received evidence checked at once; more waits on the retry list
MAX_CHECKS = 8


class EvidenceReactor(Reactor):
    name = "evidence"

    def __init__(self, evpool):
        super().__init__()
        self.evpool = evpool
        self._tasks: Dict[str, asyncio.Task] = {}
        # received evidence being checked, by hash
        self._checking: Dict[bytes, asyncio.Task] = {}
        # evidence whose check met a failed verify route, by hash
        self._retry: Dict[bytes, object] = {}
        self._retry_bytes = 0
        self._retry_task: Optional[asyncio.Task] = None
        # evidence not kept for a retry because the list was full
        self.retry_overflow = 0

    def get_channels(self):
        return [ChannelDescriptor(EVIDENCE_CHANNEL, priority=6, max_msg_size=1 << 20)]

    async def start(self) -> None:
        self.evpool.add_broadcast_hook(self._on_new_evidence)
        self._retry_task = asyncio.create_task(self._retry_routine())

    def _on_new_evidence(self, evd) -> None:
        if self.switch is not None:
            self.switch.broadcast(EVIDENCE_CHANNEL, evd.encode())

    def add_peer(self, peer) -> None:
        self._tasks[peer.peer_id] = asyncio.create_task(self._broadcast_routine(peer))

    def remove_peer(self, peer, reason) -> None:
        t = self._tasks.pop(peer.peer_id, None)
        if t:
            t.cancel()

    async def stop(self) -> None:
        for t in (*self._tasks.values(), *self._checking.values()):
            t.cancel()
        self._tasks.clear()
        self._checking.clear()
        if self._retry_task is not None:
            self._retry_task.cancel()
            self._retry_task = None

    async def _broadcast_routine(self, peer) -> None:
        sent = set()
        try:
            while True:
                for evd in self.evpool.pending_evidence(MAX_PENDING_BYTES):
                    k = evd.hash()
                    if k in sent:
                        continue
                    await peer.send(EVIDENCE_CHANNEL, evd.encode())
                    sent.add(k)
                await asyncio.sleep(BROADCAST_INTERVAL_S)
        except asyncio.CancelledError:
            raise
        except Exception:
            traceback.print_exc()

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        try:
            evd = decode_evidence(msg)
        except Exception:
            self.switch.stop_peer_for_error(peer, ValueError("undecodable evidence"))
            return
        key = evd.hash()
        if key in self._checking:
            return  # the same evidence is being checked already
        if len(self._checking) >= MAX_CHECKS:
            self._keep(evd)
            return
        self._checking[key] = asyncio.create_task(self._check_received(key, evd))

    async def _check_received(self, key: bytes, evd) -> None:
        # checked in a task of its own: the commit checks' tickets are
        # awaited, so the loop serves every other reactor meanwhile
        try:
            await self.add_evidence(evd)
        except DeviceRouteError as e:
            # kept for a retry; counted, the peer kept
            self._count_route_error(e)
        except Exception:  # bftlint: disable=ASY104 — any refusal drops the evidence, as the reference's Receive does; route errors are caught above and cancellation is no Exception
            # refused: dropped, as the reference does (evidence/reactor.go
            # Receive)
            pass
        finally:
            self._checking.pop(key, None)

    def _count_route_error(self, e: DeviceRouteError) -> None:
        if self.switch.loop_errors.add(e):
            _log.error("verify route failed, no verdict on evidence", err=repr(e))
        LoopErrors.drop_frames(e)

    # --- evidence offered to the pool, and its retry (C3) -------------

    async def add_evidence(self, evd) -> None:
        """Offer ``evd`` to the pool: it is pending (or already known)
        when this returns, a refusal raises the pool's error, and a
        failed verify route raises ``DeviceRouteError`` after keeping
        ``evd`` for a retry."""
        try:
            await self.evpool.add_evidence_awaited(evd)
        except DeviceRouteError:
            self._keep(evd)
            raise

    def retry_pending(self) -> int:
        """Evidence waiting for a working verify route."""
        return len(self._retry)

    def _keep(self, evd) -> None:
        key, size = evd.hash(), len(evd.encode())
        if key in self._retry:
            return
        if self._retry_bytes + size > MAX_RETRY_BYTES:
            self.retry_overflow += 1
            _log.error("evidence retry list full; evidence not kept", bytes=size)
            return
        self._retry[key] = evd
        self._retry_bytes += size

    def _forget(self, key: bytes) -> None:
        evd = self._retry.pop(key, None)
        if evd is not None:
            self._retry_bytes -= len(evd.encode())

    async def _retry_routine(self) -> None:
        while True:
            await asyncio.sleep(RETRY_INTERVAL_S)
            for key, evd in list(self._retry.items()):
                try:
                    await self.evpool.add_evidence_awaited(evd)
                except DeviceRouteError as e:
                    # the card still fails: the rest waits for the next
                    # round
                    self._count_route_error(e)
                    break
                except Exception:  # bftlint: disable=ASY104 — a refusal now drops the evidence like a peer's refusal; route errors are caught above and cancellation is no Exception
                    pass
                self._forget(key)
