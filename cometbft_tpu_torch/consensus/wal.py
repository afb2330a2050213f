"""Consensus WAL: fsync'd, size-capped rotating log of consensus inputs.

Parity with reference consensus/wal.go + libs/autofile/group.go: CRC32
+ length framing (wal.go:295), EndHeightMessage markers (:41),
WriteSync fsync barrier (:202), SearchForEndHeight (:232, cross-file),
corruption-tolerant replay, and **file rotation** — the head file
rotates once it exceeds ``head_size_limit`` (group.go:65 headSizeLimit,
RotateFile :265) and the oldest rotated files are deleted when the
group exceeds ``total_size_limit`` (group.go checkTotalSizeLimit), so a
node at height 10k does not carry an unbounded WAL.

Layout: the head is ``<path>``; rotated files are ``<path>.000``,
``<path>.001``, ... (monotonically increasing). Readers iterate the
group in index order then the head; records never span files (rotation
happens between records).

Record: [crc32(payload) u32 BE][len u32 BE][payload]; payload is a
proto-encoded TimedWALMessage.

Group commit (docs/PERF.md "Live consensus fast path"): with
``group_commit_ms > 0``, ``write_group`` appends the record
immediately but defers the fsync to a flusher thread that coalesces
every barrier enqueued within the window into ONE fsync — the
autofile file-group design's batching seam, made explicit. Callers
get a :class:`SyncTicket` that completes only after the covering
fsync; durability stays prefix-ordered (an fsync covers every record
appended before it), so "ticket done" is exactly as strong as the
serial ``write_sync`` barrier. ``group_commit_ms == 0`` keeps the
strict serial path (write_group degenerates to write_sync).

Routing is measurement-driven (the crypto dispatch calibration's
philosophy applied to disk): coalescing only pays when the fsync is
genuinely expensive — on an NVMe with a volatile write cache a
barrier costs ~0.1 ms and the cross-thread ticket handoff costs
more, while on a sync-through datacenter disk the barrier costs
milliseconds and coalescing collapses 3-4 of them per height into
one. ``write_group`` therefore tracks an EWMA of observed fsync
walls and routes strict-inline below ``fsync_slow_s`` (never a
regression on fast disks), engaging the group seam above it. Tests
force the seam with ``fsync_slow_s=0``; ``set_fsync_model`` injects
a synthetic barrier cost so the bench/chaos can model slow disks on
fast hardware.

A copy of the JAX package's ``consensus/wal.py``; the file lock is
the runtime sanitizer's ``wal.append`` (the raw RLock when the
sanitizer is off).
The record format is byte-identical, so each package reads the other's
WAL.
"""

from __future__ import annotations

import os
import re
import struct
import threading
import time
import zlib
from dataclasses import dataclass
from typing import Callable, Iterator, List, Optional, Tuple

from ..analysis.runtime import sanitized_lock
from ..trace import NOOP as TRACE_NOOP
from ..utils import proto
from ..utils.fail import fail_point
from ..utils.log import get_logger

_log = get_logger("wal")

MAX_MSG_SIZE = 2 * 1024 * 1024

# reference autofile defaults: 10 MB head, 1 GB group total
DEFAULT_HEAD_SIZE_LIMIT = 10 * 1024 * 1024
DEFAULT_TOTAL_SIZE_LIMIT = 1024 * 1024 * 1024

# message kinds
MSG_EVENT = 1        # internal state-machine event (round step string)
MSG_PROPOSAL = 2
MSG_BLOCK_PART = 3
MSG_VOTE = 4
MSG_TIMEOUT = 5
MSG_END_HEIGHT = 6


@dataclass
class WALMessage:
    kind: int
    height: int = 0
    round: int = 0
    step: str = ""
    data: bytes = b""
    peer_id: str = ""
    time_ns: int = 0

    def encode(self) -> bytes:
        return (
            proto.field_varint(1, self.kind)
            + proto.field_varint(2, self.height)
            + proto.field_varint(3, self.round)
            + proto.field_string(4, self.step)
            + proto.field_bytes(5, self.data)
            + proto.field_string(6, self.peer_id)
            + proto.field_varint(7, self.time_ns)
        )

    @classmethod
    def decode(cls, b: bytes) -> "WALMessage":
        m = proto.parse(b)
        return cls(
            kind=proto.get1(m, 1, 0),
            height=proto.get1(m, 2, 0),
            round=proto.get1(m, 3, 0),
            step=proto.get1(m, 4, b"").decode(),
            data=proto.get1(m, 5, b""),
            peer_id=proto.get1(m, 6, b"").decode(),
            time_ns=proto.get1(m, 7, 0),
        )


class SyncTicket:
    """Completion handle for one group-committed sync barrier.

    Done exactly when an fsync covering the ticket's record has
    returned. A crash (``crash_close``) leaves undone tickets undone
    forever — the record was never acked, so the caller's deferred
    externalization (vote/proposal broadcast) never fires, which is
    precisely the no-acked-then-lost crash contract."""

    __slots__ = ("_ev", "_cbs", "_lock")

    def __init__(self, done: bool = False):
        self._ev = threading.Event()
        self._cbs: List[Callable] = []
        self._lock = threading.Lock()
        if done:
            self._ev.set()

    def done(self) -> bool:
        return self._ev.is_set()

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._ev.wait(timeout)

    def add_done_callback(self, fn: Callable) -> None:
        """fn() after the covering fsync; runs on the flusher thread
        (or inline when already done) — marshal to your loop yourself."""
        with self._lock:
            if not self._ev.is_set():
                self._cbs.append(fn)
                return
        fn()

    def _complete(self) -> None:
        with self._lock:
            self._ev.set()
            cbs, self._cbs = self._cbs, []
        for fn in cbs:
            try:
                fn()
            except Exception:
                import traceback

                traceback.print_exc()


# shared pre-completed ticket for the strict (window = 0) path
_DONE_TICKET = SyncTicket(done=True)

# synthetic per-fsync barrier cost (seconds) for slow-disk modeling:
# bench ablations and chaos nemeses set this to measure the group
# seam's effect on hardware whose own fsync is too fast to show it
# (NVMe + volatile write cache ~0.1 ms vs the 1-10 ms of sync-through
# production disks). 0.0 = real disk only.
_FSYNC_MODEL_S = 0.0

# below this measured fsync wall, coalescing cannot win: the ticket
# handoff (flusher wakeup + loop marshal) costs more than the barrier
# it batches. ~0.5 ms sits between cached-NVMe and sync-through media.
DEFAULT_FSYNC_SLOW_S = 0.0005


def set_fsync_model(delay_s: float) -> None:
    """Install a synthetic slow-disk barrier cost (bench/chaos only)."""
    global _FSYNC_MODEL_S
    _FSYNC_MODEL_S = max(0.0, delay_s)

_ROT_RE = re.compile(r"\.(\d{3,})$")


def _group_files(path: str) -> List[str]:
    """All files of the group in read order: rotated (by index) + head."""
    d = os.path.dirname(path) or "."
    base = os.path.basename(path)
    rotated = []
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        names = []
    for name in names:
        if not name.startswith(base + "."):
            continue
        m = _ROT_RE.search(name[len(base):])
        if m:
            rotated.append((int(m.group(1)), os.path.join(d, name)))
    out = [p for _, p in sorted(rotated)]
    if os.path.exists(path):
        out.append(path)
    return out


def prune_group_below(path: str, height: int) -> Tuple[int, int]:
    """Delete sealed (rotated) WAL files whose every record is below
    ``height``; returns (files_deleted, bytes_freed).

    The retention plane's WAL leg (store/retention.py): replay after
    a restart never needs records below the retained end-height, so a
    rotated file whose max recorded height is < height is dead
    weight. The HEAD file is never deleted (it is open for append),
    and an unreadable/empty rotated file is left alone — pruning must
    never turn a corrupt-but-diagnosable group into a gap. Deletion
    goes oldest-first and stops at the first file that must stay, so
    the group never ends up with a hole in its rotation order."""
    freed_files = freed_bytes = 0
    for p in _group_files(path):
        if p == path:
            break  # never the head
        max_h = None
        for msg in WAL._iter_file(p):
            if msg.height > (max_h or 0):
                max_h = msg.height
        if max_h is None or max_h >= height:
            break  # unreadable or still-needed: stop, keep the rest
        try:
            sz = os.path.getsize(p)
            os.remove(p)
        except OSError:
            break
        freed_files += 1
        freed_bytes += sz
    return freed_files, freed_bytes


class WAL:
    def __init__(
        self,
        path: str,
        head_size_limit: int = DEFAULT_HEAD_SIZE_LIMIT,
        total_size_limit: int = DEFAULT_TOTAL_SIZE_LIMIT,
        tracer=None,
        group_commit_ms: float = 0.0,
        fsync_slow_s: float = DEFAULT_FSYNC_SLOW_S,
    ):
        self.path = path
        self.head_size_limit = head_size_limit
        self.total_size_limit = total_size_limit
        self.tracer = tracer or TRACE_NOOP
        # group-commit window: barriers enqueued within it share one
        # fsync (0 = strict serial write_sync path)
        self.group_commit_ms = group_commit_ms
        # calibrated engage threshold: strict-inline while the fsync
        # EWMA sits below this (fast disk — deferral would only add
        # latency); 0 forces the group seam unconditionally (tests)
        self.fsync_slow_s = fsync_slow_s
        self._fsync_ewma_s: Optional[float] = None
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "ab")
        self._head_size = self._f.tell()
        # one RLock over every file mutation: the consensus loop
        # appends, the group flusher fsyncs, and a pipelined-finalize
        # worker may write_end_height concurrently
        self._lock = sanitized_lock(threading.RLock(), "wal.append")
        self._pending: List[SyncTicket] = []
        self._flush_wakeup = threading.Condition(self._lock)
        self._flusher: Optional[threading.Thread] = None
        self._closed = False
        # observability: coalescing ratio = group_coalesced/group_fsyncs
        self.group_fsyncs = 0
        self.group_coalesced = 0

    def write(self, msg: WALMessage) -> None:
        if not msg.time_ns:
            msg.time_ns = time.time_ns()
        payload = msg.encode()
        if len(payload) > MAX_MSG_SIZE:
            raise ValueError("WAL message too big")
        rec = struct.pack(
            ">II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload)
        )
        with self._lock:
            self._f.write(rec + payload)
            self._head_size += 8 + len(payload)
            if self._head_size >= self.head_size_limit:
                self._rotate()

    def write_sync(self, msg: WALMessage) -> None:
        """The fsync barrier (own votes/proposals + end-height markers
        MUST hit disk before acting; reference consensus/wal.go:202).
        The append takes the lock; the fsync (inside flush_sync) runs
        WITHOUT it, so concurrent appends — the consensus loop, while
        a pipelined finalize writes its end-height marker on a worker
        — never park behind the disk."""
        self.write(msg)
        self.flush_sync()

    def write_group(self, msg: WALMessage) -> SyncTicket:
        """Group-committed sync barrier: append now, fsync within
        ``group_commit_ms``. The returned ticket completes once a
        covering fsync lands (possibly a strict flush_sync issued by
        another caller — durability is prefix-ordered). Degenerates
        to write_sync (done ticket) when the window is 0 OR the
        calibrated router says the disk is fast (fsync EWMA below
        ``fsync_slow_s`` — coalescing would only add handoff
        latency there)."""
        if self.group_commit_ms <= 0 or (
            self.fsync_slow_s > 0
            and (
                self._fsync_ewma_s is None
                or self._fsync_ewma_s < self.fsync_slow_s
            )
        ):
            # fast disk (or still measuring): the strict barrier IS
            # the cheaper path — do it inline and keep the EWMA warm
            self.write_sync(msg)
            return _DONE_TICKET
        with self._lock:
            if self._closed:
                raise ValueError("WAL is closed")
            self.write(msg)
            ticket = SyncTicket()
            self._pending.append(ticket)
            if self._flusher is None:
                self._flusher = threading.Thread(
                    target=self._flusher_loop,
                    name="wal-group-commit",
                    daemon=True,
                )
                self._flusher.start()
            self._flush_wakeup.notify()
        return ticket

    def _flusher_loop(self) -> None:
        """One fsync per window for however many barriers queued up —
        the bounded-barrier guarantee: a ticket waits at most
        ~group_commit_ms + one fsync."""
        window_s = self.group_commit_ms / 1000.0
        while True:
            with self._lock:
                while not self._pending and not self._closed:
                    self._flush_wakeup.wait()
                if self._closed:
                    # graceful close fsyncs + completes leftovers
                    # itself; crash_close abandons them (power cut)
                    return
            # coalesce OUTSIDE the lock so barriers keep enqueueing
            time.sleep(window_s)
            with self._lock:
                if self._closed:
                    return
                do_flush = bool(self._pending)
            if do_flush:
                # flush_sync takes the lock only for the buffer
                # flush + fd dup; the fsync itself runs lock-free
                try:
                    self.flush_sync()
                except (OSError, ValueError):
                    with self._lock:
                        if self._closed:
                            # fd yanked mid-crash_close: tickets stay
                            # undone, exactly like the power cut this
                            # models
                            return
                    # transient disk error: flush_sync re-queued the
                    # tickets; keep the flusher alive and retry next
                    # window (a dead flusher would silently stop
                    # every future broadcast behind the FIFO)
                    _log.error(
                        "WAL group fsync failed; retrying next window",
                        path=self.path,
                    )

    def flush_sync(self) -> None:
        # the fsync barrier is the consensus hot path's only disk
        # stall — span it so step latencies attribute to it. ANY
        # fsync completes every pending group ticket: their records
        # were appended+flushed before this fsync started (same
        # lock), and fsync durability covers the whole file prefix.
        #
        # The fsync itself runs OUTSIDE the append lock, on a dup'd
        # fd: holding the lock across the disk stall would park the
        # consensus loop behind the flusher thread on every WAL
        # append (measured 10x liveness loss at small windows), and
        # the dup keeps the fd valid across a concurrent rotation.
        with self._lock:
            tickets, self._pending = self._pending, []
            try:
                self._f.flush()
                fd = os.dup(self._f.fileno())
            except (OSError, ValueError):
                # nothing durable happened: the tickets go back to
                # the FRONT of the queue, still unacked
                self._pending = tickets + self._pending
                raise
        name = "wal.fsync.group" if tickets else "wal.fsync"
        t0 = time.perf_counter()
        try:
            with self.tracer.span(name, tid="wal", n=len(tickets) or 1):
                # the WAL seam is the one sanctioned blocking sink:
                # strict-inline routing is calibrated (EWMA, sub-ms
                # fsyncs only), the group path runs on the off-loop
                # flusher, and rotation's in-lock barrier is required
                # by the rename-atomicity + ticket-prefix-durability
                # contract
                os.fsync(fd)  # bftlint: disable=ASY114 — the one sanctioned WAL blocking seam (strict-inline calibrated, group path off-loop)
                if _FSYNC_MODEL_S > 0:
                    # synthetic slow-disk model for bench/chaos legs
                    time.sleep(_FSYNC_MODEL_S)  # bftlint: disable=ASY114 — synthetic slow-disk model, bench/chaos legs only
        except OSError:
            with self._lock:
                self._pending = tickets + self._pending
            raise
        finally:
            os.close(fd)
        wall = time.perf_counter() - t0
        # EWMA of the barrier cost drives the strict-vs-group routing
        prev = self._fsync_ewma_s
        self._fsync_ewma_s = (
            wall if prev is None else prev + 0.3 * (wall - prev)
        )
        if tickets:
            self.group_fsyncs += 1
            self.group_coalesced += len(tickets)
        for t in tickets:
            t._complete()

    def write_end_height(self, height: int) -> None:
        self.write_sync(WALMessage(kind=MSG_END_HEIGHT, height=height))

    def close(self) -> None:
        flusher = self._stop_flusher()
        if flusher is not None:
            flusher.join(timeout=5.0)
        try:
            self.flush_sync()
        except Exception:
            pass
        with self._lock:
            self._f.close()

    def _stop_flusher(self) -> Optional[threading.Thread]:
        with self._lock:
            self._closed = True
            self._flush_wakeup.notify_all()
            return self._flusher

    def crash_close(self) -> None:
        """Power-cut close (chaos harness): release the file WITHOUT
        flushing Python's userspace buffer — records written since the
        last fsync barrier are lost, exactly like a real crash. The fd
        is redirected to /dev/null first so the buffered tail drains
        harmlessly instead of reaching the WAL on GC. Pending group
        tickets are NEVER completed: an unacked barrier must stay
        unacked across the cut."""
        self._stop_flusher()  # no join: a crash doesn't wait for anyone
        with self._lock:
            try:
                devnull = os.open(os.devnull, os.O_WRONLY)
                try:
                    os.dup2(devnull, self._f.fileno())
                finally:
                    os.close(devnull)
            except OSError:
                pass
            self._f.close()

    # --- rotation -----------------------------------------------------

    def _next_index(self) -> int:
        top = -1
        for p in _group_files(self.path):
            m = _ROT_RE.search(p)
            if m:
                top = max(top, int(m.group(1)))
        return top + 1

    def _rotate(self) -> None:
        """Head -> <path>.<index>; fresh head. Records never span files.

        Crash-safety: the head is flushed+fsync'd before the rename, the
        rename is atomic, and a crash at any point leaves a readable
        group (a missing head is recreated on reopen). Matches
        libs/autofile/group.go:265 RotateFile.
        """
        self.flush_sync()
        self._f.close()
        idx = self._next_index()
        fail_point("wal-rotate-before-rename")
        os.replace(self.path, f"{self.path}.{idx:03d}")
        fail_point("wal-rotate-after-rename")
        self._f = open(self.path, "ab")
        self._head_size = 0
        _log.debug("rotated WAL head", path=self.path, index=idx)
        self._enforce_total_limit()

    def _enforce_total_limit(self) -> None:
        """Delete oldest rotated files while the group exceeds the total
        cap (group.go checkTotalSizeLimit — the head never deletes)."""
        files = _group_files(self.path)
        sizes = {p: os.path.getsize(p) for p in files if os.path.exists(p)}
        total = sum(sizes.values())
        for p in files:
            if total <= self.total_size_limit or p == self.path:
                break
            try:
                os.remove(p)
                total -= sizes.get(p, 0)
                _log.info(
                    "WAL group over size cap, removed oldest file",
                    file=p,
                )
            except OSError:
                break

    # --- reading ------------------------------------------------------

    @staticmethod
    def _iter_file(path: str, stats: Optional[dict] = None):
        """Yield valid records; on stop, ``stats`` (if given) gets
        ``valid_bytes`` (length of the valid record prefix) and
        ``size`` (file size) — a single pass answers both "what are the
        records" and "is there trailing garbage"."""
        if not os.path.exists(path):
            if stats is not None:
                stats["valid_bytes"] = stats["size"] = 0
            return
        pos = 0
        with open(path, "rb") as f:
            try:
                while True:
                    hdr = f.read(8)
                    if len(hdr) < 8:
                        return
                    crc, ln = struct.unpack(">II", hdr)
                    if ln > MAX_MSG_SIZE:
                        return
                    payload = f.read(ln)
                    if len(payload) < ln:
                        return
                    if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                        return
                    try:
                        msg = WALMessage.decode(payload)
                    except Exception:
                        return
                    yield msg
                    pos += 8 + ln
            finally:
                if stats is not None:
                    stats["valid_bytes"] = pos
                    try:
                        stats["size"] = os.path.getsize(path)
                    except OSError:
                        stats["size"] = pos

    @classmethod
    def iter_messages(cls, path: str) -> Iterator[WALMessage]:
        """Yields messages across the whole group (rotated files in
        index order, then the head). A corrupt record inside any file
        stops iteration entirely — everything after it is suspect, the
        same stop-at-first-bad-record semantic as the reference."""
        for p in _group_files(path):
            stats: dict = {}
            yield from cls._iter_file(p, stats)
            if p != path and stats.get("size", 0) > stats.get(
                "valid_bytes", 0
            ):
                # a rotated (sealed) file that ends mid-record was cut
                # by corruption, not by an in-progress write: stop
                return

    @classmethod
    def search_for_end_height(
        cls, path: str, height: int
    ) -> Optional[int]:
        """Global message index right after ENDHEIGHT(height), or None."""
        for i, msg in enumerate(cls.iter_messages(path)):
            if msg.kind == MSG_END_HEIGHT and msg.height == height:
                return i + 1
        return None

    @classmethod
    def messages_after_end_height(cls, path: str, height: int):
        found = False
        for msg in cls.iter_messages(path):
            if found:
                yield msg
            elif msg.kind == MSG_END_HEIGHT and msg.height == height:
                found = True

    @classmethod
    def repair_torn_tail(cls, path: str) -> int:
        """Truncate a torn tail off the HEAD file in place; returns
        the bytes removed (0 when the head is clean or absent).

        A power cut can leave a partial record at the head's end (a
        real torn write, or the chaos harness's ``wal_torn_tail``
        injection). Replay tolerates it — iteration stops at the
        first bad record — but the WAL reopens in append mode, so
        WITHOUT this repair every record written after the garbage
        would be unreadable on the NEXT restart: silent amnesia one
        crash later. The valid prefix is already in place, so this
        is one ``truncate`` + fsync, not a rewrite (rotated files
        are sealed behind an fsync barrier and cannot tear; cross-
        file corruption repair stays with truncate_corrupt_tail)."""
        if not os.path.exists(path):
            return 0
        stats: dict = {}
        for _ in cls._iter_file(path, stats):
            pass
        torn = stats.get("size", 0) - stats.get("valid_bytes", 0)
        if torn <= 0:
            return 0
        with open(path, "r+b") as f:
            f.truncate(stats["valid_bytes"])
            f.flush()
            os.fsync(f.fileno())
        _log.info(
            "repaired torn WAL tail",
            path=path,
            removed_bytes=torn,
            kept_bytes=stats["valid_bytes"],
        )
        return torn

    @classmethod
    def truncate_corrupt_tail(cls, path: str) -> int:
        """Repair: keep only the valid record prefix of the group.

        The file containing the first corrupt record is rewritten to its
        valid prefix and every later file is deleted; earlier files are
        untouched (no multi-GB rewrite). Returns the total number of
        valid messages in the group (reference WAL repair,
        consensus/state.go:2677).
        """
        files = _group_files(path)
        total = 0
        for fi, p in enumerate(files):
            stats: dict = {}
            msgs = list(cls._iter_file(p, stats))
            total += len(msgs)
            if stats.get("size", 0) > stats.get("valid_bytes", 0):
                tmp = p + ".repair"
                if os.path.exists(tmp):
                    # stale temp from a crashed earlier repair: a fresh
                    # repair must not append after its partial contents
                    os.remove(tmp)
                w = WAL(tmp, head_size_limit=1 << 62)
                for m in msgs:
                    w.write(m)
                w.close()
                os.replace(tmp, p)
                for later in files[fi + 1 :]:
                    if later != p:
                        try:
                            os.remove(later)
                        except OSError:
                            pass
                # a deleted head must be recreated so the group stays
                # writable / iterable from <path>
                if p != path:
                    open(path, "ab").close()
                break
        return total
