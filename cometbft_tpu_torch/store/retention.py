"""Storage lifecycle plane: retention-windowed pruning and node-side
snapshot persistence.

A copy of the JAX package's ``store/retention.py``. The
``RetentionPlane`` is a node-owned background service that reconciles
the node-side retention window (``[storage] retain_blocks /
retain_states / retain_index``) with the app's ``retain_height`` from
ABCI Commit — **min wins**: the node only ever keeps MORE than the app
allows pruning, never less — and prunes blocks, states, index rows
(``state.indexer.prune_index``), sealed WAL files and committed
evidence markers (``evpool.prune_below``) in bounded batches OFF the
consensus loop.

Crash-safety direction (one rule, every leg): the delete batch and
the base-marker advance it covers land in ONE atomic ``write_batch``
— ``BlockStore.prune_blocks`` for blocks (``base`` key),
``prune_index`` for index rows (``idx:base``). A crash between batches
resumes idempotently: the next reconcile re-computes the same target
and continues from the committed base. Batches are ``prune_batch``
heights each, and each is preceded by
``fail_point("retention-prune-batch")``.

Two floors cap every prune target:
  - the newest locally-held snapshot (``statesync/snapshots.py``):
    with snapshotting on, a pruned node must still hold one complete
    snapshot to bootstrap a fresh joiner — no snapshot yet means NO
    pruning yet;
  - in-flight statesync serves (``serving()``): a chunk being
    streamed to a joiner must not be pruned out from under it.

Snapshot generation rides the ABCI snapshot seam: at
``snapshot_interval`` cadence the plane mirrors the app's newest
advertised snapshot (``list_snapshots`` + ``load_snapshot_chunk``)
into the on-disk ``SnapshotStore``. An app wired directly to the same
store (models/kvstore.py) makes the mirror a no-op.

Observability: ``storage.prune`` / ``storage.snapshot`` spans on the
node's tracer and the node's ``store.retention`` queue-registry entry
(``stats()``), which the RPC ``health`` route reports; with
``instrumentation.prometheus`` the metrics' span bridge reads the spans
and the ``cometbft_storage_*`` gauges the plane's counters
(``utils/metrics.py``).
"""

from __future__ import annotations

import asyncio
import hashlib
import os
import threading
from collections import Counter
from contextlib import contextmanager
from typing import Optional

from ..trace import NOOP as TRACE_NOOP
from ..utils.fail import fail_point
from ..utils.log import get_logger

_log = get_logger("retention")


def _du(path: str) -> int:
    total = 0
    for dirpath, _, files in os.walk(path):
        for name in files:
            try:
                total += os.path.getsize(os.path.join(dirpath, name))
            except OSError:
                pass
    return total


class RetentionPlane:
    """Background retention reconciler + snapshot persister."""

    def __init__(
        self,
        storage_config,
        block_store,
        state_store,
        tx_indexer=None,
        block_indexer=None,
        evpool=None,
        snapshot_store=None,
        proxy=None,
        wal_path: Optional[str] = None,
        home: Optional[str] = None,
        tracer=TRACE_NOOP,
    ):
        self.cfg = storage_config
        self.block_store = block_store
        self.state_store = state_store
        self.tx_indexer = tx_indexer
        self.block_indexer = block_indexer
        self.evpool = evpool
        self.snapshot_store = snapshot_store
        self.proxy = proxy
        self.wal_path = wal_path
        self.home = home
        self.tracer = tracer
        # the app's retain_height from the last ABCI Commit (0 = the
        # app allows no pruning); written from the consensus thread
        # via the BlockExecutor hook, read here — a bare int store is
        # atomic under the GIL
        self._app_retain = 0
        # in-flight statesync serve floor: height -> active serves
        self._serves: Counter = Counter()
        self._serve_lock = threading.Lock()
        # one reconcile at a time (timer tick racing an explicit call)
        self._reconcile_lock = threading.Lock()
        # in-process crash seam: called before every bounded batch,
        # right after the fail_point. A hook that raises aborts the
        # pass mid-batch (the crash window) and one that parks holds
        # it there — the stand-in for FAIL_TEST_INDEX's os._exit,
        # which would kill the whole test process
        self.batch_hook = None
        self._task = None
        # counters (stats() / metrics bridge)
        self.pruned_blocks_total = 0
        self.pruned_index_total = 0
        self.pruned_states_passes = 0
        self.pruned_wal_files = 0
        self.pruned_evidence_total = 0
        self.snapshots_taken = 0
        self.reconciles = 0
        self.last_prune_s = 0.0
        # OS thread ident of the last reconcile pass (prune work must
        # never run on the event loop's thread)
        self.last_thread_ident = None

    # --- enablement ---------------------------------------------------

    @property
    def enabled(self) -> bool:
        """Any lifecycle work configured at all. Off (every knob 0)
        keeps exact reference semantics: immortal storage, app
        retain_height handled by the legacy inline path."""
        c = self.cfg
        return bool(
            c.retain_blocks
            or c.retain_states
            or c.retain_index
            or c.snapshot_interval
        )

    # --- inputs -------------------------------------------------------

    def notify_retain_height(self, retain_height: int) -> None:
        """BlockExecutor hook (consensus thread): the app's latest
        ABCI Commit retain_height. Recorded only — pruning happens on
        the plane's own cadence, off the consensus loop."""
        self._app_retain = int(retain_height)

    @contextmanager
    def serving(self, height: int):
        """Pin ``height`` against pruning while a statesync chunk or
        snapshot listing for it is being served to a joiner."""
        with self._serve_lock:
            self._serves[height] += 1
        try:
            yield
        finally:
            with self._serve_lock:
                self._serves[height] -= 1
                if self._serves[height] <= 0:
                    del self._serves[height]

    def _serve_floor(self) -> Optional[int]:
        with self._serve_lock:
            return min(self._serves) if self._serves else None

    # --- target reconciliation (min wins) -----------------------------

    def _target(self, height: int, window: int) -> int:
        """Prune target for one leg: min-reconcile the node window
        against the app's retain_height, then cap under the snapshot
        and in-flight-serve floors. 0 = nothing prunable."""
        cands = []
        if window > 0:
            cands.append(height - window)
        rh = self._app_retain
        if rh > 0:
            cands.append(rh)
        if not cands:
            return 0
        t = min(cands)
        if self.cfg.snapshot_interval > 0 and self.snapshot_store:
            # never prune above (or into) the newest held snapshot;
            # none held yet -> no pruning yet
            t = min(t, self.snapshot_store.latest_height())
        floor = self._serve_floor()
        if floor is not None:
            t = min(t, floor)
        return max(0, min(t, height))

    def _batch_point(self) -> None:
        """One bounded batch is about to commit. The fail_point is the
        subprocess crash seam (FAIL_TEST_INDEX -> os._exit, the power
        cut); ``batch_hook`` is the in-process chaos seam (abort or
        park the pass mid-batch without killing the harness)."""
        fail_point("retention-prune-batch")
        hook = self.batch_hook
        if hook is not None:
            hook()

    # --- the reconcile pass (worker thread / sync drivers) ------------

    def reconcile_once(self) -> dict:
        """One full lifecycle pass: snapshot first (it RAISES the
        prune floor), then prune every leg in bounded batches.
        Synchronous — the async loop runs it via to_thread; tests and
        the compressed-time soak call it directly."""
        with self._reconcile_lock:
            import time as _time

            self.last_thread_ident = threading.get_ident()
            t0 = _time.monotonic()
            out = {
                "snapshot": 0,
                "blocks": 0,
                "index": 0,
                "states": 0,
                "wal_files": 0,
                "evidence": 0,
            }
            try:
                if self.cfg.snapshot_interval > 0:
                    out["snapshot"] = self._maybe_snapshot()
                self._prune_pass(out)
            finally:
                self.reconciles += 1
                self.last_prune_s = _time.monotonic() - t0
            return out

    def _maybe_snapshot(self) -> int:
        """Mirror the app's newest advertised snapshot to disk once
        it is ``snapshot_interval`` past the newest one held."""
        if self.proxy is None or self.snapshot_store is None:
            return 0
        snaps = self.proxy.snapshot.list_snapshots() or []
        if not snaps:
            return 0
        newest = max(snaps, key=lambda s: s.height)
        held = self.snapshot_store.latest_height()
        if newest.height <= held or (
            held and newest.height < held + self.cfg.snapshot_interval
        ):
            return 0
        with self.tracer.span(
            "storage.snapshot",
            tid="retention",
            height=newest.height,
            chunks=newest.chunks,
        ):
            parts = []
            for i in range(newest.chunks):
                parts.append(
                    self.proxy.snapshot.load_snapshot_chunk(
                        newest.height, newest.format, i
                    )
                    or b""
                )
            blob = b"".join(parts)
            if hashlib.sha256(blob).digest() != newest.hash:
                _log.error(
                    "app snapshot chunks do not hash to the "
                    "advertised hash; not persisting",
                    height=newest.height,
                )
                return 0
            self.snapshot_store.save(
                newest.height,
                blob,
                format_=newest.format,
                metadata=newest.metadata,
            )
        self.snapshots_taken += 1
        return 1

    def _prune_pass(self, out: dict) -> None:
        height = self.block_store.height()
        batch = max(1, int(self.cfg.prune_batch))
        # blocks: slice prune_blocks so each call is ONE bounded
        # atomic batch (deletes + base advance together)
        bt = self._target(height, self.cfg.retain_blocks)
        base = self.block_store.base()
        if bt > base:
            with self.tracer.span(
                "storage.prune",
                tid="retention",
                kind="blocks",
                target=bt,
                base=base,
            ):
                while base < bt:
                    step = min(base + batch, bt)
                    self._batch_point()
                    out["blocks"] += self.block_store.prune_blocks(step)
                    base = step
            self.pruned_blocks_total += out["blocks"]
        # index rows: same slicing, idx:base advances with each batch
        it = self._target(height, self.cfg.retain_index)
        if (
            it > 0
            and self.tx_indexer is not None
            and self.block_indexer is not None
            and getattr(self.tx_indexer, "db", None) is not None
            and getattr(self.tx_indexer, "db", None)
            is getattr(self.block_indexer, "db", None)
        ):
            from ..state.indexer import prune_index

            ibase = self.tx_indexer.base_height()
            if it > ibase:
                with self.tracer.span(
                    "storage.prune",
                    tid="retention",
                    kind="index",
                    target=it,
                    base=ibase,
                ):
                    while ibase < it:
                        step = min(ibase + batch, it)
                        self._batch_point()
                        out["index"] += prune_index(
                            self.tx_indexer, self.block_indexer, step
                        )
                        ibase = step
                self.pruned_index_total += out["index"]
        # states: prune_states keeps its own validator-info anchor
        # discipline; one pass per reconcile (row counts there are
        # per-height small)
        st = self._target(height, self.cfg.retain_states)
        if st > 0:
            with self.tracer.span(
                "storage.prune", tid="retention", kind="states", target=st
            ):
                self._batch_point()
                self.state_store.prune_states(st)
                out["states"] = 1
            self.pruned_states_passes += 1
        # WAL: sealed rotated files entirely below the retained end-
        # height (file granularity; the head is never touched)
        if self.wal_path and bt > 0:
            from ..consensus.wal import prune_group_below

            n, _ = prune_group_below(self.wal_path, bt)
            out["wal_files"] = n
            self.pruned_wal_files += n
        # evidence: committed markers aged past the max-age window
        if self.evpool is not None and bt > 0:
            try:
                n = self.evpool.prune_below(bt)
            except Exception:
                n = 0
            out["evidence"] = n
            self.pruned_evidence_total += n

    # --- async lifecycle (Node.start / Node._shutdown) ----------------

    async def start(self) -> None:
        """Spawn the background reconcile loop (no-op when no knob is
        set). Every pass runs in a worker thread: the event loop —
        and through it the consensus task — never carries prune
        work."""
        if not self.enabled or self._task is not None:
            return
        from ..utils.tasks import spawn

        self._task = spawn(self._loop(), name="retention-reconcile")

    async def _loop(self) -> None:
        interval = max(0.05, float(self.cfg.prune_interval_s))
        while True:
            await asyncio.sleep(interval)
            try:
                await asyncio.to_thread(self.reconcile_once)
            except asyncio.CancelledError:
                raise
            except Exception:
                # one failed pass (transient sqlite lock, disk
                # hiccup) must not kill the plane for the rest of
                # the process — the next tick retries the same
                # idempotent targets
                import traceback

                traceback.print_exc()

    async def stop(self) -> None:
        """Bounded stop (ASY110): cancel the loop, reap it, then
        drain any reconcile pass still running in its worker thread —
        cancelling an `await to_thread` abandons the await, not the
        thread, and Node._shutdown closes the stores right after."""
        t, self._task = self._task, None
        if t is not None:
            t.cancel()
            try:
                await asyncio.wait_for(
                    asyncio.gather(t, return_exceptions=True), 5.0
                )
            except asyncio.TimeoutError:
                pass

        def _drain() -> None:
            if self._reconcile_lock.acquire(timeout=5.0):
                self._reconcile_lock.release()

        await asyncio.to_thread(_drain)

    # --- observability ------------------------------------------------

    def disk_bytes(self) -> Optional[int]:
        return _du(self.home) if self.home else None

    def stats(self) -> dict:
        s = {
            "enabled": self.enabled,
            "base_height": self.block_store.base(),
            "index_base_height": (
                self.tx_indexer.base_height()
                if self.tx_indexer is not None
                and hasattr(self.tx_indexer, "base_height")
                else 0
            ),
            "app_retain_height": self._app_retain,
            "pruned_blocks_total": self.pruned_blocks_total,
            "pruned_index_total": self.pruned_index_total,
            "pruned_wal_files": self.pruned_wal_files,
            "pruned_evidence_total": self.pruned_evidence_total,
            "snapshots_taken": self.snapshots_taken,
            "reconciles": self.reconciles,
            "last_prune_s": round(self.last_prune_s, 6),
        }
        if self.snapshot_store is not None:
            s["snapshots"] = self.snapshot_store.stats()
        db = self.disk_bytes()
        if db is not None:
            s["disk_bytes"] = db
        return s
