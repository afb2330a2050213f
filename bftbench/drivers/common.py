"""What both drivers share: the pinned device route, the recorder of
device dispatches, the scheduler's counters, and the process pool the
reference verifies signatures on."""

from __future__ import annotations

import concurrent.futures
import gc
import multiprocessing
import os

from .. import roofline

# rows a reference worker process takes at once
REF_CHUNK = 64


class PinnedRoute:
    """Every verify ticket to the card (the route the cells measure), on
    a scheduler of the run's own; restored on exit. On a CPU device (the
    tests) every ticket goes to the host plane instead."""

    def __init__(self, device):
        self.device = device

    def __enter__(self):
        from cometbft_tpu_torch.crypto import batch
        from cometbft_tpu_torch.crypto import scheduler as S

        self._floor = batch._MIN_DEVICE_BATCH
        batch.set_min_device_batch(1 if self.device.type == "cuda" else 1 << 30)
        self.sched = S.VerifyScheduler()
        S.set_scheduler(self.sched)
        return self

    def stats(self) -> dict:
        return self.sched.stats()

    def __exit__(self, *exc):
        from cometbft_tpu_torch.crypto import batch
        from cometbft_tpu_torch.crypto import scheduler as S

        try:
            self.sched.drain(60)
        finally:
            S.set_scheduler(None)
            self.sched.close()
            batch.set_min_device_batch(self._floor)
        return False


def stats_delta(before: dict, after: dict) -> dict:
    out = {k: after[k] - before[k] for k in ("tickets", "lanes", "device_dispatches", "host_chunks", "degraded")}
    out["by_class"] = {k: after["by_class"][k] - before["by_class"][k] for k in after["by_class"]}
    return out


class DispatchRecorder:
    """While active, every device dispatch: (lanes, row bytes, SHA-512
    blocks, host packing ms)."""

    def __enter__(self):
        from cometbft_tpu_torch.ops import ed25519 as ed

        self._real = real = ed.verify_batch_async
        self.rows = []

        def recording(items, device=None, precomp=None):
            h = real(items, device=device, precomp=precomp)
            d = h.dispatch
            blocks = sum(roofline.sha_blocks(len(m)) for m, _, _ in items)
            self.rows.append((len(items), d.get("cap", 0), blocks, d.get("pack_ms", 0.0)))
            return h

        ed.verify_batch_async = recording
        return self

    def __exit__(self, *exc):
        from cometbft_tpu_torch.ops import ed25519 as ed

        ed.verify_batch_async = self._real
        return False


def dispatch_metrics(rows, kernel_s: dict, device) -> dict:
    """Lanes, packing and the K1-K3 roofline share over the window's dispatches."""
    out = {}
    lanes = sum(r[0] for r in rows)
    if rows:
        out["dispatches"] = len(rows)
        out["lanes"] = lanes
        out["pack_us_per_lane"] = sum(r[3] for r in rows) * 1e3 / lanes
    rate = roofline.int_rate(device) if device.type == "cuda" else None
    ktime = sum(v for k, v in kernel_s.items() if roofline.is_verify_kernel(k))
    if rows and rate and ktime > 0:
        bound = sum(roofline.bound_s(n, cap, blocks, rate) for n, cap, blocks, _ in rows)
        out["verify_roofline_pct"] = 100.0 * bound / ktime
        out["bound_s"], out["kernel_s"] = bound, ktime
    return out


class FrozenHeap:
    """Around the window: collect, then keep everything set-up made (the
    minted chain, the keys) out of the collector's reach, so that its
    passes during the window scan what the program makes there, not the
    harness's inputs; released on exit."""

    def __enter__(self):
        gc.collect()
        gc.freeze()
        return self

    def __exit__(self, *exc):
        gc.unfreeze()
        return False


class RefPool:
    """The reference's worker processes (spawned; none when ``workers`` is 0)."""

    def __init__(self, workers: int | None = None):
        if workers is None:
            workers = min(8, os.cpu_count() or 1)
        self.workers = workers
        self._ex = (concurrent.futures.ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"))
                    if workers else None)

    def map_chunks(self, fn, rows, chunk: int = REF_CHUNK) -> list:
        """``fn`` over ``rows`` in chunks, results in row order."""
        chunks = [rows[i: i + chunk] for i in range(0, len(rows), chunk)]
        if self._ex is None:
            parts = [fn(c) for c in chunks]
        else:
            parts = list(self._ex.map(fn, chunks))
        return [x for p in parts for x in p]

    def close(self) -> None:
        if self._ex is not None:
            self._ex.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class NoRecorder:
    """The untraced run's stand-in for ``DispatchRecorder``."""

    rows: list = []

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
