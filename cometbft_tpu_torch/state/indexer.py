"""Tx + block event indexing (reference state/txindex/kv/kv.go,
state/indexer/block/kv, and the event-driven IndexerService at
state/txindex/indexer_service.go:29).

KV layout (order-preserving big-endian heights for prefix scans):
  tx:h:<hash>                  -> record(height, index, tx, result)
  tx:a:<key>=<value>:<height8>:<index4> -> tx hash   (attribute index)
  blk:e:<key>=<value>:<height8>         -> b""       (block events)
  idx:last                     -> height8 (last FULLY indexed height)
Search evaluates the pubsub query against the attribute index;
height conditions constrain the scan range.

``IndexerService`` does not write the DB inside the bus publish: the
sync listener only ACCUMULATES a height's tx + block events in memory
and, once the height is complete, hands the bundle to a bounded async
drain that flushes everything (rows + the ``idx:last`` marker) in ONE
``db.write_batch`` per height off the consensus hot path. The marker
rides the same atomic batch, so a crash leaves it pointing at the
last fully indexed height and ``replay()`` re-indexes forward
idempotently (keys are deterministic — a re-run overwrites identical
rows, never duplicates them).

A copy of the JAX package's ``state/indexer.py``: the same rows, the
same search results. Both indexers share one kv db (the node wiring);
the JAX service's per-item path for the write-only Postgres sink
(``psql_sink``) is not ported."""

from __future__ import annotations

import asyncio
import hashlib
import struct
import threading
import traceback
from typing import Dict, List, Optional, Tuple

from ..abci import types as abci
from ..obs.queues import InstrumentedQueue
from ..trace import NOOP as TRACE_NOOP
from ..types import events as ev
from ..utils import kv, proto
from ..utils.pubsub_query import Query
from ..utils.tasks import spawn
from .execution import decode_finalize_response

# last fully indexed height, written ATOMICALLY with that height's
# rows (crash consistency: the marker can never run ahead of rows,
# and rows without the marker are re-written identically on replay)
LAST_INDEXED_KEY = b"idx:last"
# first retained indexed height (exclusive floor: every row BELOW it
# is pruned), mirroring idx:last's contiguity discipline from the
# other end — the marker advances ATOMICALLY with the delete batch
# that clears everything below it (``prune_index``), so a crash
# mid-prune leaves base <= the true first retained row and a re-prune
# resumes idempotently: no gap, no orphan rows above the marker
INDEX_BASE_KEY = b"idx:base"


def _enc_height(h: int) -> bytes:
    return struct.pack(">Q", h)


def _dec_height(b: Optional[bytes]) -> int:
    return struct.unpack(">Q", b)[0] if b else 0


def _enc_record(
    height: int, index: int, tx: bytes, result, events_enc=None
) -> bytes:
    res_b = _enc_tx_result(result, events_enc)
    return (
        proto.field_varint(1, height)
        + proto.field_varint(2, index + 1)
        + proto.field_bytes(3, tx)
        + proto.field_bytes(4, res_b)
    )


def _enc_tx_result(r, events_enc=None) -> bytes:
    out = (
        proto.field_varint(1, r.code)
        + proto.field_bytes(2, r.data)
        + proto.field_string(3, r.log)
        + proto.field_varint(4, r.gas_wanted)
        + proto.field_varint(5, r.gas_used)
    )
    if events_enc is not None:
        # the field-6 payload is byte-identical to the finalize pass's
        # encoded-event bytes (state/native_finalize.py) — reuse them
        # instead of re-walking the attributes
        for eb in events_enc:
            out += proto.field_bytes(6, eb)
        return out
    for e in r.events:
        attrs = b""
        for a in e.attributes:
            k, v, idx = abci.attr_kvi(a)
            attrs += proto.field_bytes(
                2,
                proto.field_string(1, k)
                + proto.field_string(2, v)
                + proto.field_varint(3, 1 if idx else 0),
            )
        out += proto.field_bytes(6, proto.field_string(1, e.type_) + attrs)
    return out


def _dec_tx_result(b: bytes) -> abci.ExecTxResult:
    m = proto.parse(b)
    events = []
    for eb in m.get(6, []):
        em = proto.parse(eb)
        attrs = []
        for ab in em.get(2, []):
            am = proto.parse(ab)
            attrs.append(
                abci.EventAttribute(
                    key=proto.get1(am, 1, b"").decode(),
                    value=proto.get1(am, 2, b"").decode(),
                    index=bool(proto.get1(am, 3, 0)),
                )
            )
        events.append(
            abci.Event(
                type_=proto.get1(em, 1, b"").decode(), attributes=attrs
            )
        )
    return abci.ExecTxResult(
        code=proto.get1(m, 1, 0),
        data=proto.get1(m, 2, b""),
        log=proto.get1(m, 3, b"").decode(),
        gas_wanted=proto.get1(m, 4, 0),
        gas_used=proto.get1(m, 5, 0),
        events=events,
    )


def _attr_key(key: str, value: str, height: int, index: int) -> bytes:
    return (
        b"tx:a:"
        + key.encode()
        + b"="
        + value.encode()
        + b":"
        + struct.pack(">Q", height)
        + struct.pack(">I", index)
    )


class TxIndexer:
    """Indexes txs by hash + event attributes."""

    def __init__(self, db: kv.KV):
        self.db = db
        self._lock = threading.Lock()

    def tx_sets(
        self,
        height: int,
        index: int,
        tx: bytes,
        result: abci.ExecTxResult,
        tx_hash: Optional[bytes] = None,
        events_flat=None,
        events_enc=None,
    ) -> List[Tuple[bytes, bytes]]:
        """The (key, value) rows for one tx — pure, deterministic:
        re-running on the same inputs produces byte-identical rows,
        which is what makes crash replay idempotent.

        ``tx_hash``/``events_flat``/``events_enc`` are the finalize
        pass's precomputed forms (state/native_finalize.py) — byte-
        identical to deriving them here, just not re-derived."""
        h = tx_hash if tx_hash is not None else hashlib.sha256(tx).digest()
        sets = [
            (b"tx:h:" + h, _enc_record(height, index, tx, result, events_enc))
        ]
        # implicit attributes (reference: tx.height is always indexed)
        sets.append((_attr_key("tx.height", str(height), height, index), h))
        if events_flat is not None:
            for type_, kvis in events_flat:
                for k, v, idx in kvis:
                    if not idx:
                        continue
                    sets.append(
                        (_attr_key(f"{type_}.{k}", v, height, index), h)
                    )
            return sets
        for e in result.events:
            for a in e.attributes:
                k, v, idx = abci.attr_kvi(a)
                if not idx:
                    continue
                sets.append(
                    (_attr_key(f"{e.type_}.{k}", v, height, index), h)
                )
        return sets

    def index_tx(
        self, height: int, index: int, tx: bytes, result: abci.ExecTxResult
    ) -> None:
        with self._lock:
            self.db.write_batch(self.tx_sets(height, index, tx, result))

    def last_indexed_height(self) -> int:
        """The crash-consistency marker (``idx:last``): every height
        <= this is FULLY indexed (rows + marker land in one atomic
        batch per height)."""
        return _dec_height(self.db.get(LAST_INDEXED_KEY))

    def base_height(self) -> int:
        """The prune floor (``idx:base``): every row below this
        height is pruned; 0 = nothing ever pruned."""
        return _dec_height(self.db.get(INDEX_BASE_KEY))

    def prune_deletes(self, retain_height: int) -> List[bytes]:
        """Keys of every tx row below ``retain_height`` — pure scan,
        no writes. The ``tx:h:<hash>`` rows are reached through the
        implicit ``tx.height`` attribute rows (every indexed tx has
        one — tx_sets appends it unconditionally), so this never
        parses record values."""
        deletes: List[bytes] = []
        hash_prefix = b"tx:a:tx.height="
        for k, v in self.db.iter_prefix(b"tx:a:"):
            # key tail = <value> ':' height(8) index(4)
            h = struct.unpack(">Q", k[-12:-4])[0]
            if h >= retain_height:
                continue
            deletes.append(k)
            if k.startswith(hash_prefix):
                deletes.append(b"tx:h:" + bytes(v))
        return deletes

    def prune(self, retain_height: int) -> int:
        """Delete tx rows below ``retain_height`` and advance
        ``idx:base`` in the SAME atomic batch; returns keys deleted.
        Prefer ``prune_index`` (module level) when a BlockIndexer
        shares this db — it covers both row families under one
        marker advance."""
        if retain_height <= self.base_height():
            return 0
        deletes = self.prune_deletes(retain_height)
        with self._lock:
            self.db.write_batch(
                [(INDEX_BASE_KEY, _enc_height(retain_height))], deletes
            )
        return len(deletes)

    def get(self, tx_hash: bytes):
        raw = self.db.get(b"tx:h:" + tx_hash)
        if raw is None:
            return None
        m = proto.parse(raw)
        return (
            proto.get1(m, 1, 0),
            proto.get1(m, 2, 1) - 1,
            proto.get1(m, 3, b""),
            _dec_tx_result(proto.get1(m, 4, b"")),
        )

    def search(self, q: Query) -> List[Tuple]:
        """Returns [(height, index, tx, result, hash)] matching ALL
        conditions, height/index ordered."""
        # special case: tx.hash = '...' is a point lookup
        for c in q.conditions:
            if c.key == "tx.hash" and c.op == "=":
                h = bytes.fromhex(str(c.value))
                rec = self.get(h)
                return [rec + (h,)] if rec else []
        candidate_hashes: Optional[set] = None
        scans = 0
        for c in q.conditions:
            matches = set()
            if c.op == "=":
                prefix = (
                    b"tx:a:"
                    + c.key.encode()
                    + b"="
                    + self._valstr(c.value).encode()
                    + b":"
                )
                for k, v in self.db.iter_prefix(prefix):
                    matches.add(bytes(v))
            elif c.op == "CONTAINS":
                prefix = b"tx:a:" + c.key.encode() + b"="
                for k, v in self.db.iter_prefix(prefix):
                    # substring-match only the VALUE portion of the
                    # key (tail = value ':' height(8) index(4))
                    if str(c.value).encode() in k[len(prefix):-13]:
                        matches.add(bytes(v))
            else:  # range ops incl. EXISTS: scan the key's entries
                prefix = b"tx:a:" + c.key.encode() + b"="
                for k, v in self.db.iter_prefix(prefix):
                    if c.op == "EXISTS":
                        matches.add(bytes(v))
                        continue
                    try:
                        # key tail = <value> ':' height(8) index(4)
                        val = float(k[len(prefix):-13])
                    except ValueError:
                        continue
                    if (
                        (c.op == "<" and val < c.value)
                        or (c.op == ">" and val > c.value)
                        or (c.op == "<=" and val <= c.value)
                        or (c.op == ">=" and val >= c.value)
                    ):
                        matches.add(bytes(v))
            scans += 1
            candidate_hashes = (
                matches
                if candidate_hashes is None
                else candidate_hashes & matches
            )
            if not candidate_hashes:
                return []
        out = []
        for h in candidate_hashes or ():
            rec = self.get(h)
            if rec:
                out.append(rec + (h,))
        out.sort(key=lambda r: (r[0], r[1]))
        return out

    @staticmethod
    def _valstr(v) -> str:
        if isinstance(v, float) and v == int(v):
            return str(int(v))
        return str(v)


class BlockIndexer:
    """Indexes block-level events by height (reference
    state/indexer/block/kv)."""

    def __init__(self, db: kv.KV):
        self.db = db

    def block_sets(
        self, height: int, events: List[abci.Event], events_flat=None
    ) -> List[Tuple[bytes, bytes]]:
        """Pure (key, value) rows for one block's events (same
        idempotency contract as TxIndexer.tx_sets). ``events_flat``
        is the finalize pass's once-flattened form when available."""
        sets = [
            (
                b"blk:e:block.height="
                + str(height).encode()
                + b":"
                + struct.pack(">Q", height),
                b"",
            )
        ]
        if events_flat is not None:
            for type_, kvis in events_flat:
                for k, v, idx in kvis:
                    if not idx:
                        continue
                    sets.append(
                        (
                            b"blk:e:"
                            + f"{type_}.{k}={v}".encode()
                            + b":"
                            + struct.pack(">Q", height),
                            b"",
                        )
                    )
            return sets
        for e in events:
            for a in e.attributes:
                k, v, idx = abci.attr_kvi(a)
                if not idx:
                    continue
                sets.append(
                    (
                        b"blk:e:"
                        + f"{e.type_}.{k}={v}".encode()
                        + b":"
                        + struct.pack(">Q", height),
                        b"",
                    )
                )
        return sets

    def index_block(self, height: int, events: List[abci.Event]) -> None:
        self.db.write_batch(self.block_sets(height, events))

    def prune_deletes(self, retain_height: int) -> List[bytes]:
        """Keys of every block-event row below ``retain_height`` —
        pure scan, no writes (height is the key's last 8 bytes)."""
        return [
            k
            for k, _ in self.db.iter_prefix(b"blk:e:")
            if struct.unpack(">Q", k[-8:])[0] < retain_height
        ]

    def prune(self, retain_height: int) -> int:
        """Delete block-event rows below ``retain_height`` and
        advance ``idx:base`` atomically with them; returns keys
        deleted. Prefer ``prune_index`` when a TxIndexer shares this
        db (one marker advance covering both row families)."""
        if retain_height <= _dec_height(self.db.get(INDEX_BASE_KEY)):
            return 0
        deletes = self.prune_deletes(retain_height)
        self.db.write_batch(
            [(INDEX_BASE_KEY, _enc_height(retain_height))], deletes
        )
        return len(deletes)

    def search(self, q: Query) -> List[int]:
        heights: Optional[set] = None
        for c in q.conditions:
            matches = set()
            if c.op == "=":
                prefix = (
                    b"blk:e:"
                    + c.key.encode()
                    + b"="
                    + TxIndexer._valstr(c.value).encode()
                    + b":"
                )
                for k, _ in self.db.iter_prefix(prefix):
                    matches.add(struct.unpack(">Q", k[-8:])[0])
            else:
                prefix = b"blk:e:" + c.key.encode() + b"="
                for k, _ in self.db.iter_prefix(prefix):
                    h = struct.unpack(">Q", k[-8:])[0]
                    if c.op == "EXISTS":
                        matches.add(h)
                        continue
                    try:
                        val = float(k[len(prefix):-9])
                    except ValueError:
                        continue
                    if (
                        (c.op == "<" and val < c.value)
                        or (c.op == ">" and val > c.value)
                        or (c.op == "<=" and val <= c.value)
                        or (c.op == ">=" and val >= c.value)
                    ):
                        matches.add(h)
            heights = matches if heights is None else heights & matches
            if not heights:
                return []
        return sorted(heights or ())


def prune_index(
    tx_indexer: TxIndexer,
    block_indexer: BlockIndexer,
    retain_height: int,
) -> int:
    """Prune BOTH indexers' rows below ``retain_height`` in ONE
    atomic batch carrying the ``idx:base`` advance — the retention
    plane's index leg (store/retention.py). Crash-safe by construction:
    the marker lands with (never before) the deletes it covers, so a
    crash mid-prune leaves either the old base (deletes retried
    idempotently) or the new base with every covered row gone — no
    gap, no orphan rows. Requires both indexers on the same kv db
    (the node wiring guarantees it; IndexerService checks the same).
    Returns keys deleted."""
    db = tx_indexer.db
    assert getattr(block_indexer, "db", None) is db
    if retain_height <= tx_indexer.base_height():
        return 0
    deletes = tx_indexer.prune_deletes(retain_height)
    deletes += block_indexer.prune_deletes(retain_height)
    with tx_indexer._lock:
        db.write_batch(
            [(INDEX_BASE_KEY, _enc_height(retain_height))], deletes
        )
    return len(deletes)


class HeightBundle:
    """Everything one height needs indexed, sealed once complete.

    ``extras`` maps tx index -> (tx_hash, events_flat, events_enc)
    from the finalize pass's one pass (state/native_finalize.py);
    ``block_events_flat`` is the once-flattened block-event form.
    Both are optional — bundles built by replay or tests lack them
    and the flush derives everything itself, byte-identically."""

    __slots__ = ("height", "txs", "block_events", "extras",
                 "block_events_flat")

    def __init__(
        self,
        height: int,
        txs: list,
        block_events: list,
        extras: Optional[dict] = None,
        block_events_flat=None,
    ):
        self.height = height
        self.txs = txs  # [(index, tx_bytes, ExecTxResult)]
        self.block_events = block_events
        self.extras = extras
        self.block_events_flat = block_events_flat


class IndexerService:
    """Event-bus-driven indexing (reference
    state/txindex/indexer_service.go:29,43) with per-height batched,
    off-hot-path flushing.

    The sync listener is now PURE ACCUMULATION: ``EVENT_NEW_BLOCK``
    opens a height bundle (block events + expected tx count from the
    block itself), each ``EVENT_TX`` appends, and the bundle seals
    when the last tx of the height lands — all in-memory, no DB work
    inside ``bus.publish``. Sealed bundles flush from a bounded async drain
    (``start_async``), ONE ``db.write_batch`` per height carrying the
    rows AND the ``idx:last`` marker; without a running loop (CLI
    reindex, sync tests) sealing flushes inline — still one batch per
    height.

    ``barrier()`` gives RPC index queries read-your-writes over the
    async drain; ``replay()`` closes the crash hole: on restart every
    height past the marker is re-indexed from the stored blocks +
    finalize responses, idempotently."""

    # a drain this deep means indexing itself is the bottleneck; the
    # overflow path flushes off-loop without queueing (never drops)
    QUEUE_SIZE = 256

    def __init__(
        self, tx_indexer: TxIndexer, block_indexer: BlockIndexer, event_bus
    ):
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.bus = event_bus
        self.tracer = TRACE_NOOP
        # one atomic batch per height requires both indexers on the
        # SAME kv db (the node wiring)
        if block_indexer.db is not tx_indexer.db:
            raise ValueError("the tx and block indexers must share one kv db")
        self._kv_db = tx_indexer.db
        self._pending: Dict[int, dict] = {}
        self._plock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._queue: InstrumentedQueue = InstrumentedQueue(
            self.QUEUE_SIZE, name="state.index"
        )
        self._task = None
        self._inflight = 0
        self.sealed_heights = 0
        self.flushed_heights = 0
        self.flush_failures = 0
        self.replayed_heights = 0
        # flushed-but-not-yet-marker-covered heights (out-of-order
        # flushes via the overflow path): the idx:last marker only
        # advances CONTIGUOUSLY, so a crash can never skip a height
        # that was still queued in memory
        self._done_heights: set = set()
        # in-flight overflow-path flushes: stop() must await them or
        # a graceful stop races Node._shutdown's store close and
        # loses the height's rows until the next restart's replay
        self._overflow_tasks: set = set()
        # first height ever sealed live in this process: heights
        # below it can only land via replay()'s anchored walk, so it
        # floors the contiguity check — without it a statesync-
        # restored joiner (marker 0, live heights starting at
        # snapshot+1, the gap pruned) would park every height in
        # _done_heights forever and never advance the marker
        self._first_sealed: Optional[int] = None

    # --- lifecycle ----------------------------------------------------

    def start(self) -> None:
        """Attach the accumulator (build time, loop not required).

        The accumulator's only blocking reach is the no-running-loop
        inline flush in _seal (no loop exists to stall in that mode);
        with a loop, sealing hands the bundle to the bounded async
        drain."""
        self.bus.add_sync_listener(self._on_event)  # bftlint: disable=ASY116 — listener only degrades inline when NO loop is running (CLI embedders)

    async def start_async(self, block_store=None, state_store=None) -> None:
        """Upgrade to the async drain (Node.start): replay any
        crash gap first, then flush sealed bundles off-loop."""
        if block_store is not None and state_store is not None:
            await asyncio.to_thread(self.replay, block_store, state_store)
        self._loop = asyncio.get_running_loop()
        if self._task is None:
            self._task = spawn(self._drain(), name="indexer-flush")

    async def stop(self) -> None:
        """Bounded stop: reap the drain, then flush whatever
        was still queued synchronously — a graceful stop loses no
        index rows (a crash is what replay() is for)."""
        t, self._task = self._task, None
        self._loop = None
        if t is not None:
            t.cancel()
            try:
                await asyncio.wait_for(
                    asyncio.gather(t, return_exceptions=True), 2.0
                )
            except asyncio.TimeoutError:
                pass
        while not self._queue.empty():
            await asyncio.to_thread(self._flush, self._queue.get_nowait())
        # overflow-path flushes still in flight write to the same db
        # Node._shutdown is about to close — await them (bounded)
        pending = [t for t in self._overflow_tasks if not t.done()]
        if pending:
            try:
                await asyncio.wait_for(
                    asyncio.gather(*pending, return_exceptions=True), 5.0
                )
            except asyncio.TimeoutError:
                pass

    # --- accumulation (sync listener: in-memory only) ------------------

    def _on_event(self, e: ev.Event) -> None:
        bundle = None
        if e.type_ == ev.EVENT_NEW_BLOCK and isinstance(e.data, dict):
            blk = e.data["block"]
            with self._plock:
                p = self._pending.setdefault(
                    blk.height,
                    {"txs": [], "events": [], "expected": None,
                     "extras": {}, "events_flat": None},
                )
                p["events"] = list(e.data.get("result_events") or [])
                p["events_flat"] = e.data.get("events_flat")
                p["expected"] = len(blk.data.txs)
                bundle = self._maybe_seal_locked(blk.height)
        elif e.type_ == ev.EVENT_TX and isinstance(e.data, dict):
            d = e.data
            with self._plock:
                p = self._pending.setdefault(
                    d["height"],
                    {"txs": [], "events": [], "expected": None,
                     "extras": {}, "events_flat": None},
                )
                p["txs"].append((d["index"], d["tx"], d["result"]))
                if "tx_hash" in d:
                    # the finalize pass's precomputed forms ride the
                    # event data as optional keys (state/execution.py
                    # _fire_events); keyed by index so the sort at
                    # seal time can't misalign them
                    p["extras"][d["index"]] = (
                        d["tx_hash"],
                        d.get("events_flat"),
                        d.get("events_enc"),
                    )
                bundle = self._maybe_seal_locked(d["height"])
        if bundle is not None:
            self._seal(bundle)

    def _maybe_seal_locked(self, height: int) -> Optional[HeightBundle]:
        p = self._pending.get(height)
        if p is None or p["expected"] is None:
            return None
        if len(p["txs"]) < p["expected"]:
            return None
        self._pending.pop(height, None)
        # bound the accumulator: anything older than the sealed
        # height can never complete (its NEW_BLOCK already passed)
        for h in [h for h in self._pending if h < height]:
            self._pending.pop(h, None)
        return HeightBundle(
            height,
            sorted(p["txs"], key=lambda t: t[0]),
            p["events"],
            extras=p.get("extras") or None,
            block_events_flat=p.get("events_flat"),
        )

    def _seal(self, bundle: HeightBundle) -> None:
        self.sealed_heights += 1
        if self._first_sealed is None:
            self._first_sealed = bundle.height
        loop = self._loop
        if loop is not None and not loop.is_closed():
            loop.call_soon_threadsafe(self._offer, bundle)
            return
        # no drain running (build-time commits, sync tests): flush
        # inline — one batch per height, and there is no event loop
        # in this mode to stall
        self._flush(bundle)

    def _offer(self, bundle: HeightBundle) -> None:
        try:
            self._queue.put_nowait(bundle)
        except asyncio.QueueFull:
            # overflow of last resort: never drop index rows — flush
            # off-loop immediately (ordering is safe: flushes
            # serialize on _flush_lock and the marker is monotonic)
            self._queue.count_drop()
            t = spawn(
                self._overflow_flush(bundle),
                name="indexer-overflow-flush",
            )
            self._overflow_tasks.add(t)
            t.add_done_callback(self._overflow_tasks.discard)

    async def _overflow_flush(self, bundle: "HeightBundle") -> None:
        try:
            await asyncio.to_thread(self._flush, bundle)
        except asyncio.CancelledError:
            raise
        except Exception:
            # same accounting as _drain: a failed flush must land in
            # the ledger or barrier() burns its full timeout on every
            # index query for the rest of the process
            self.flush_failures += 1
            traceback.print_exc()

    # --- flushing -----------------------------------------------------

    async def _drain(self) -> None:
        while True:
            bundle = await self._queue.get()
            self._inflight += 1
            try:
                await asyncio.to_thread(self._flush, bundle)
            except asyncio.CancelledError:
                raise
            except Exception:
                # one transient DB failure (locked sqlite, disk
                # hiccup) must not kill the drain for the rest of the
                # process — the height stays unmarked, so a restart's
                # replay() re-indexes it; counted so barrier() does
                # not burn its timeout on a height that will not land
                self.flush_failures += 1
                traceback.print_exc()
            finally:
                self._inflight -= 1

    def _flush(self, bundle: HeightBundle, anchored: bool = False) -> None:
        """ONE write_batch per height: every tx row, every block
        event row and the idx:last marker, atomically."""
        with self._flush_lock:
            span = self.tracer.span(
                "fanout.index.flush",
                height=bundle.height,
                n_txs=len(bundle.txs),
            )
            with span:
                sets: List[Tuple[bytes, bytes]] = []
                extras = bundle.extras or {}
                for i, tx, res in bundle.txs:
                    th, efl, een = extras.get(i) or (None, None, None)
                    sets.extend(
                        self.tx_indexer.tx_sets(
                            bundle.height, i, tx, res,
                            tx_hash=th,
                            events_flat=efl,
                            events_enc=een,
                        )
                    )
                sets.extend(
                    self.block_indexer.block_sets(
                        bundle.height,
                        bundle.block_events,
                        events_flat=bundle.block_events_flat,
                    )
                )
                # marker advances CONTIGUOUSLY only: an
                # out-of-order flush (overflow path) parks its
                # height in _done_heights until the gap below it
                # lands — "every height <= marker is FULLY
                # indexed" must survive a crash with older
                # bundles still queued in memory. ``anchored``
                # (replay: ascending from a floor below which
                # nothing exists/is unindexed) may jump directly.
                prev = self.tx_indexer.last_indexed_height()
                if anchored:
                    marker = max(prev, bundle.height)
                else:
                    self._done_heights.add(bundle.height)
                    marker = prev
                    # anchor at the first live-sealed height:
                    # anything below it can only arrive via
                    # replay()'s anchored walk, never through
                    # this path — a joiner whose history is
                    # pruned must not wait on it (same rule as
                    # reindex-event's below-base jump)
                    first = self._first_sealed
                    if first is not None and first - 1 > marker:
                        marker = first - 1
                    while marker + 1 in self._done_heights:
                        marker += 1
                        self._done_heights.discard(marker)
                if marker > prev:
                    sets.append(
                        (LAST_INDEXED_KEY, _enc_height(marker))
                    )
                self._done_heights -= {
                    h for h in self._done_heights if h <= marker
                }
                self._kv_db.write_batch(sets)
            self.flushed_heights += 1

    async def barrier(self, timeout_s: float = 5.0) -> None:
        """Wait (bounded) until every height sealed so far has
        flushed: read-your-writes for index queries racing a commit.
        Counter-based (sealed vs flushed), so the window between a
        seal and its bundle landing on the queue can't slip through."""
        if self._loop is None:
            return  # inline mode is always consistent
        target = self.sealed_heights
        deadline = asyncio.get_running_loop().time() + timeout_s
        while (
            self.flushed_heights + self.flush_failures < target
            and asyncio.get_running_loop().time() < deadline
        ):
            await asyncio.sleep(0.005)

    # --- crash replay -------------------------------------------------

    def replay(self, block_store, state_store) -> int:
        """Re-index every height past the idx:last marker from the
        stored blocks + finalize responses (which persist tx AND
        block events, state/execution.py). Idempotent:
        deterministic keys mean a partially-written height (crash
        between rows... impossible — batch is atomic — but also a
        marker behind a re-run) just overwrites identical rows."""
        last = self.tx_indexer.last_indexed_height()
        top = block_store.height()
        n = 0
        for h in range(max(last + 1, block_store.base()), top + 1):
            blk = block_store.load_block(h)
            raw = state_store.load_finalize_block_response(h)
            if blk is None or raw is None:
                continue
            resp = decode_finalize_response(raw)
            txs = [
                (i, tx, resp.tx_results[i])
                for i, tx in enumerate(blk.data.txs)
                if i < len(resp.tx_results)
            ]
            self.sealed_heights += 1  # keep the barrier's
            # sealed-vs-flushed ledger balanced across replay.
            # anchored: replay walks ascending from a floor below
            # which every height is indexed or absent from the store,
            # so the marker may jump straight to h (a pruned store's
            # base > marker+1 would otherwise park it forever)
            self._flush(HeightBundle(h, txs, resp.events), anchored=True)
            n += 1
        self.replayed_heights += n
        return n

    def queue_stats(self) -> dict:
        """obs registry entry (state.index): the bounded drain's
        backlog; ``dropped`` counts overflow-path flushes (work moved
        off the queue, never lost)."""
        s = self._queue.stats()
        s["flushed_heights"] = self.flushed_heights
        return s
