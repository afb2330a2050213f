"""Multi-core host verification plane.

The port's counterpart of the JAX package's ``crypto/parallel_verify.py``.
Verification lanes fan out in chunks over a persistent worker pool and
the per-lane verdicts merge back in input order. It serves the lanes
that the calibrated routing (``crypto/batch.py``) keeps on the host,
and the ``"cpu-parallel"`` backend.

Tier selection follows the crypto tiers of ``crypto/keys.py``:

- **thread tier** — ed25519 verification reaches libcrypto (through
  ctypes in the port), which releases the GIL in each EVP call, so
  threads scale with cores and items are never pickled.
- **process tier** — only the pure-Python check is available, which
  holds the GIL: chunks go to a process pool. Its workers are started
  with ``spawn``: the parent may have initialised CUDA, after which a
  forked child is unsafe. Items are plain picklable tuples of frozen
  key dataclasses and bytes.
- **serial tier** — one worker, or the pool could not be created:
  verify on the calling thread, bit-identically.

Chunk size is calibrated: a small benchmark when the pool starts
measures the serial cost of one verify, chunk walls from real batches
keep an EWMA of it, and chunks are sized to ~target_ms of work each
while every worker still gets a share of a mid-size batch.

Env knobs, as in the JAX package (all optional):
  GRAFT_VERIFY_WORKERS         worker count (default: os.cpu_count(), capped)
  GRAFT_VERIFY_TIER            thread | process | serial (force a tier)
  GRAFT_VERIFY_CHUNK_TARGET_MS per-chunk wall target (default 4.0)
  GRAFT_VERIFY_MIN_PARALLEL    batch size below which verify is serial
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional, Sequence, Tuple

from ..trace import global_tracer

_MAX_WORKERS_CAP = 16
_MIN_CHUNK = 8
_DEFAULT_MIN_PARALLEL = 24
_EWMA_ALPHA = 0.3
# prior of the serial per-item cost (the JAX package's), replaced by the
# start-up benchmark before any chunk is sized
_PER_ITEM_PRIOR_S = 80e-6


def _ed25519_releases_gil() -> bool:
    """True when ed25519 verification reaches libcrypto, which releases
    the GIL in the EVP call; the pure-Python check holds it."""
    from . import keys

    return bool(keys._HAVE_OSSL or keys._HAVE_CTYPES_OSSL)


def _verify_chunk(items, tier: str = "?") -> Tuple[List[bool], float]:
    """Worker body (top level, so the process tier can pickle it):
    verify one chunk, returning (verdicts, serial wall); the wall feeds
    the per-item EWMA that sizes later chunks.

    The native extension (``crypto/native_verify``) verifies the whole
    chunk in one GIL-releasing call; without it, the bit-identical
    per-lane loop runs. A ``crypto.verify_chunk`` span lands on the
    process-wide tracer when it is enabled (a spawned worker's stays
    disabled: no observer could read it)."""
    from . import native_verify

    with global_tracer().span(
        "crypto.verify_chunk", tid=threading.current_thread().name, lanes=len(items), tier=tier
    ):
        t0 = time.perf_counter()
        oks = native_verify.verify_chunk(items)
        if oks is None:
            oks = [pk.verify(msg, sig) for pk, msg, sig in items]
        wall = time.perf_counter() - t0
    return oks, wall


class PendingLanes:
    """In-flight parallel verify: per-lane verdicts behind a blocking
    ``result()``, merged in input order. ``wall()`` is the dispatch →
    last-chunk-completion wall, stamped by the last chunk's done
    callback, so a caller that resolves late cannot inflate it."""

    __slots__ = (
        "_futures", "_engine", "_n", "_t0", "_done_t", "_left", "_lock",
    )

    def __init__(self, futures, engine, n: int) -> None:
        self._futures = futures  # [(start, future)]
        self._engine = engine
        self._n = n
        self._t0 = time.perf_counter()
        self._done_t: Optional[float] = None
        self._left = len(futures)
        self._lock = threading.Lock()
        for _, fut in futures:
            fut.add_done_callback(self._one_done)

    def _one_done(self, _fut) -> None:
        self._engine._chunk_done()
        with self._lock:
            self._left -= 1
            if self._left == 0:
                self._done_t = time.perf_counter()

    def wall(self) -> Optional[float]:
        """Dispatch → last-chunk-completion wall, or None while pending."""
        with self._lock:
            done = self._done_t
        return None if done is None else done - self._t0

    def result(self) -> List[bool]:
        oks: List[bool] = [False] * self._n
        for start, fut in self._futures:
            chunk_oks, chunk_wall = fut.result()
            oks[start : start + len(chunk_oks)] = chunk_oks
            self._engine._observe_chunk(len(chunk_oks), chunk_wall)
        with self._lock:
            if self._done_t is None:
                # a future wakes its waiters before it runs its done
                # callbacks: all work is done here, so stamp now and
                # keep the sample for the host-cost EWMA
                self._done_t = time.perf_counter()
        return oks


class _ResolvedLanes:
    """Already-computed verdicts behind the PendingLanes interface
    (serial path / empty batch)."""

    __slots__ = ("_oks", "_wall")

    def __init__(self, oks: List[bool], wall: float) -> None:
        self._oks = oks
        self._wall = wall

    def wall(self) -> float:
        return self._wall

    def result(self) -> List[bool]:
        return self._oks


class ParallelVerifyEngine:
    """Persistent worker pool for (pubkey, msg, sig) verification.

    ``verify()`` is bit-identical to the serial per-item loop: every
    lane runs the same ``pk.verify(msg, sig)`` (or the native chunk
    call with the same verdicts), and verdict order matches input
    order whatever the chunk size or worker count."""

    def __init__(
        self,
        workers: Optional[int] = None,
        tier: Optional[str] = None,
        chunk_target_s: Optional[float] = None,
        min_parallel: Optional[int] = None,
    ) -> None:
        env = os.environ
        if workers is None:
            w = env.get("GRAFT_VERIFY_WORKERS")
            workers = int(w) if w else min(os.cpu_count() or 1, _MAX_WORKERS_CAP)
        self.workers = max(1, workers)
        if tier is None:
            tier = env.get("GRAFT_VERIFY_TIER")
        if tier is None:
            tier = "thread" if _ed25519_releases_gil() else "process"
        if self.workers <= 1:
            tier = "serial"
        if tier not in ("thread", "process", "serial"):
            raise ValueError(f"unknown verify tier {tier!r}")
        self.tier = tier
        if chunk_target_s is None:
            chunk_target_s = float(env.get("GRAFT_VERIFY_CHUNK_TARGET_MS", "4.0")) / 1e3
        self._chunk_target_s = chunk_target_s
        if min_parallel is None:
            mp = env.get("GRAFT_VERIFY_MIN_PARALLEL")
            min_parallel = int(mp) if mp else _DEFAULT_MIN_PARALLEL
        self.min_parallel = min_parallel
        self._per_item_s = _PER_ITEM_PRIOR_S
        self._calibrated = False
        self._pool = None
        self._lock = threading.Lock()
        # dispatch backpressure telemetry: chunks submitted and not yet
        # completed, the worst case since start, and all chunks
        self.inflight_chunks = 0
        self.inflight_hwm = 0
        self.chunks_dispatched = 0

    # --- pool / calibration ------------------------------------------

    def _calibrate(self) -> None:
        """Measure the serial per-item verify cost on a synthetic
        keypair, so the first real batch already gets a sensible chunk
        size; the EWMA refines it from real chunk walls."""
        from .keys import Ed25519PrivKey

        priv = Ed25519PrivKey.from_seed(b"\x5a" * 32)
        pk = priv.pub_key()
        msg = b"parallel-verify-calibration"
        sig = priv.sign(msg)
        reps = 6 if _ed25519_releases_gil() else 2
        best = None
        for _ in range(reps):
            t0 = time.perf_counter()
            ok = pk.verify(msg, sig)
            dt = time.perf_counter() - t0
            if not ok:  # pragma: no cover - a broken host tier
                break
            best = dt if best is None else min(best, dt)
        if best:
            self._per_item_s = best
        self._calibrated = True

    def _ensure_pool(self):
        with self._lock:
            if self.tier == "serial":
                return None
            if self._pool is None:
                if not self._calibrated:
                    self._calibrate()
                try:
                    if self.tier == "thread":
                        from concurrent.futures import ThreadPoolExecutor

                        self._pool = ThreadPoolExecutor(
                            max_workers=self.workers,
                            thread_name_prefix="pverify",
                        )
                    else:
                        import multiprocessing
                        from concurrent.futures import ProcessPoolExecutor

                        self._pool = ProcessPoolExecutor(
                            max_workers=self.workers,
                            mp_context=multiprocessing.get_context("spawn"),
                        )
                except (OSError, ImportError, RuntimeError):
                    # restricted container (no processes, thread
                    # limit): bit-identical serial verification
                    self.tier = "serial"
                    self._pool = None
            return self._pool

    def _chunk_submitted(self, n: int = 1) -> None:
        with self._lock:
            self.chunks_dispatched += n
            self.inflight_chunks += n
            if self.inflight_chunks > self.inflight_hwm:
                self.inflight_hwm = self.inflight_chunks

    def _chunk_done(self) -> None:
        with self._lock:
            if self.inflight_chunks > 0:
                self.inflight_chunks -= 1

    def queue_stats(self) -> dict:
        """Dispatch-queue backpressure: chunks in flight (more than the
        workers just means chunks wait on the pool), the high-water
        mark, the total dispatched, and the worker count."""
        with self._lock:
            return {
                "depth": self.inflight_chunks,
                "high_watermark": self.inflight_hwm,
                "enqueued": self.chunks_dispatched,
                "dropped": 0,
                "workers": self.workers,
            }

    def _observe_chunk(self, n: int, wall: float) -> None:
        if n <= 0 or wall <= 0:
            return
        with self._lock:
            self._per_item_s += _EWMA_ALPHA * (wall / n - self._per_item_s)

    def chunk_size(self, n: int) -> int:
        """Lanes per chunk: ~chunk_target_s of serial work each, but
        never so many that a mid-size batch leaves workers idle."""
        if not self._calibrated:
            self._calibrate()
        with self._lock:
            per = max(self._per_item_s, 1e-7)
        c = max(_MIN_CHUNK, int(self._chunk_target_s / per))
        return min(c, max(_MIN_CHUNK, -(-n // self.workers)))

    def stats(self) -> dict:
        with self._lock:
            per = self._per_item_s
        return {
            "tier": self.tier,
            "workers": self.workers,
            "per_item_us": round(per * 1e6, 1),
            "min_parallel": self.min_parallel,
        }

    def close(self) -> None:
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)

    # --- verification -------------------------------------------------

    def _serial(self, items) -> _ResolvedLanes:
        oks, wall = _verify_chunk(items, self.tier)
        self._observe_chunk(len(items), wall)
        return _ResolvedLanes(oks, wall)

    def verify_async(self, items: Sequence):
        """Enqueue the batch on the pool without blocking; the handle's
        ``result()`` blocks and merges. Small batches resolve at once
        (nothing to amortize)."""
        n = len(items)
        pool = self._ensure_pool() if n >= self.min_parallel else None
        if pool is None:
            return self._serial(items)
        if self.tier == "process":
            # chunks cross a pickle boundary: plain tuples only
            items = [(pk, bytes(m), bytes(s)) for pk, m, s in items]
        chunk = self.chunk_size(n)
        futures = []
        try:
            for start in range(0, n, chunk):
                fut = pool.submit(_verify_chunk, items[start : start + chunk], self.tier)
                self._chunk_submitted()
                futures.append((start, fut))
        except RuntimeError:
            # pool shut down underneath us (interpreter teardown):
            # verify the lanes not yet submitted serially — verdicts
            # are never lost
            done = futures[-1][0] + chunk if futures else 0
            tail = self._serial(items[done:])
            pending = PendingLanes(futures, self, done)
            return _ResolvedLanes(pending.result() + tail.result(), tail.wall() or 0.0)
        return PendingLanes(futures, self, n)

    def verify(self, items: Sequence) -> List[bool]:
        """Order-stable parallel verify; blocking."""
        return self.verify_async(items).result()


# --- process-wide default engine ----------------------------------------

_ENGINE: Optional[ParallelVerifyEngine] = None
_ENGINE_LOCK = threading.Lock()


def engine() -> ParallelVerifyEngine:
    """The shared engine every host verification seam rides (the
    cpu-parallel backend, the cuda backend's host-routed lanes, the
    scheduler's host chunks). Created lazily on first use."""
    global _ENGINE
    with _ENGINE_LOCK:
        if _ENGINE is None:
            _ENGINE = ParallelVerifyEngine()
        return _ENGINE


def set_engine(e: Optional[ParallelVerifyEngine]) -> None:
    """Swap the process-wide engine (tests, operator reconfiguration);
    the old pool keeps draining the chunks already submitted."""
    global _ENGINE
    with _ENGINE_LOCK:
        _ENGINE = e
