"""Event-loop watchdog + loop-stall flight recorder (a copy of the
JAX package's ``obs/watchdog.py``).

On a GIL-bound host the dominant tail-latency cause is the asyncio
loop stalling behind one long callback (or a starved thread), and a
stall is invisible in span data: the span that *contains* the
blocking call looks slow, every other span merely queues behind it.
In the port a synchronous CUDA call made on the loop thread (a
``.item()``, a ``.cpu()``, a ``torch.cuda.synchronize``, a first
kernel build) is such a callback: the device route waits on its CUDA
event in the verify scheduler's threads, never on the loop.

Two cooperating parts per node:

- a **heartbeat task** on the loop wakes every ``interval_s`` and
  measures its own scheduling lag (actual wakeup minus requested —
  the canonical loop-responsiveness metric). Each beat lands on the
  trace ring as a completed ``obs.loop.lag`` span whose duration IS
  the lag, so the span→metrics bridge exports a loop-lag histogram
  for free, and a bounded in-memory window serves p50/p95/p99 to the
  RPC ``health`` route.
- a **monitor thread** (daemon, off-loop) watches the heartbeat's
  last-beat stamp. While a callback blocks the loop the heartbeat
  cannot run, so the stamp goes stale; once it is stale past
  ``stall_s`` the thread fires the **flight recorder** MID-STALL:
  ``sys._current_frames()`` for every thread (the loop thread's frame
  is the offending callback, caught red-handed) plus
  ``asyncio.all_tasks`` stacks, appended to the trace ring as
  ``obs.stall`` / ``obs.stall.tasks`` instants and kept on
  ``self.stalls`` for the health route and the node's reports.

Reading task stacks from another thread is a read-only race the same
way py-spy's sampling is: ``asyncio.all_tasks(loop)`` retries on
concurrent mutation by design, and a torn frame read degrades one
diagnostic line, never the node. The monitor must never *touch* loop
state — it only formats frames.
"""

from __future__ import annotations

import io
import sys
import threading
import time
import traceback
from collections import deque
from typing import Dict, List, Optional

from ..analysis.runtime import attribute_frames, attribute_stall
from ..trace import NOOP as TRACE_NOOP
from ..trace.summary import percentile

_monotonic = time.monotonic
_monotonic_ns = time.monotonic_ns

# frames kept per stack in a flight record (deep enough for the p2p /
# abci call chains, bounded so a record stays a few KB)
_STACK_DEPTH = 25
_MAX_RECORDS = 32
_ARG_TRUNC = 1800  # chars of stack embedded in a trace instant


def attribute_frame(frame) -> str:
    """Owning subsystem of a live stalled frame: its formatted stack's
    bucket (``analysis/runtime.attribute_frames``: "torch" for a frame
    of the torch library, a synchronous CUDA call on the loop, else
    the innermost frame's plane, ``ops`` and ``kernels`` included)."""
    return attribute_frames(_format_frame_stack(frame))


def _format_frame_stack(frame, depth: int = _STACK_DEPTH) -> List[str]:
    """Innermost-first "pkg/file.py:lineno func" lines for one frame.

    The parent directory is kept so stall attribution
    (analysis/runtime.attribute_frames) can bucket the frame by owning
    subsystem — "wal.py" alone cannot name its plane; a frame of the
    torch library keeps its path from the library's root
    ("torch/cuda/__init__.py"), so it is bucketed as ``torch``."""
    out: List[str] = []
    f = frame
    while f is not None and len(out) < depth:
        code = f.f_code
        fname = code.co_filename.replace("\\", "/")
        parts = fname.split("/")
        if "torch" in parts[:-1]:
            short = "/".join(parts[parts.index("torch"):])
        else:
            short = "/".join(parts[-2:])
        out.append(f"{short}:{f.f_lineno} {code.co_name}")
        f = f.f_back
    return out


class LoopWatchdog:
    """Per-node loop-lag gauge + stall flight recorder (module doc)."""

    def __init__(
        self,
        tracer=TRACE_NOOP,
        interval_s: float = 0.1,
        stall_s: float = 0.5,
        name: str = "node",
        lag_window: int = 512,
    ) -> None:
        self.tracer = tracer
        self.interval_s = max(0.01, interval_s)
        self.stall_s = max(self.interval_s, stall_s)
        self.name = name
        self._lags: "deque[float]" = deque(maxlen=lag_window)
        self.stalls: "deque[dict]" = deque(maxlen=_MAX_RECORDS)
        self.stall_count = 0
        self._last_stall_t: Optional[float] = None
        self._beat = _monotonic()
        self._loop = None
        self._loop_thread_ident: Optional[int] = None
        self._task = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()

    # --- lifecycle ----------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> None:
        """Must run on the watched loop (captures loop + thread id)."""
        import asyncio

        from ..utils.tasks import spawn

        if self._task is not None:
            return
        self._loop = asyncio.get_running_loop()
        self._loop_thread_ident = threading.get_ident()
        self._beat = _monotonic()
        self._stop.clear()
        self._task = spawn(self._heartbeat(), name=f"loop-watchdog-{self.name}")
        self._thread = threading.Thread(
            target=self._monitor,
            name=f"loopwd-{self.name}",
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t, self._task = self._task, None
        if t is not None:
            t.cancel()
        th, self._thread = self._thread, None
        if th is not None and th is not threading.current_thread():
            th.join(timeout=2.0)

    # --- heartbeat (on-loop) ------------------------------------------

    def _record_beat(self, lag_s: float, now_ns: int) -> None:
        """Per-beat bookkeeping, split out so the overhead guard test
        can bound it: one deque append + one ring append."""
        self._lags.append(lag_s)
        tr = self.tracer
        if tr.enabled:
            lag_ns = int(lag_s * 1e9)
            # a completed span whose duration IS the scheduling lag:
            # rides the span→metrics bridge into the loop-lag histogram
            tr.complete(
                "obs.loop.lag", now_ns - lag_ns, lag_ns, tid="watchdog"
            )

    async def _heartbeat(self) -> None:
        import asyncio

        interval = self.interval_s
        while True:
            t0 = _monotonic()
            await asyncio.sleep(interval)
            now = _monotonic()
            self._beat = now
            self._record_beat(max(0.0, now - t0 - interval), _monotonic_ns())

    # --- monitor (off-loop daemon thread) -----------------------------

    def _monitor(self) -> None:
        reported = False
        check_s = self.interval_s / 2
        while not self._stop.wait(check_s):
            stale = _monotonic() - self._beat
            if stale > self.interval_s + self.stall_s:
                if not reported:
                    reported = True
                    try:
                        self._flight_record(stale)
                    except Exception:
                        # diagnostics must never take the node down
                        pass
            else:
                reported = False

    def _flight_record(self, stalled_s: float) -> None:
        """MID-STALL snapshot: every thread's frame + every task's
        stack, onto the ring and ``self.stalls``."""
        now_ns = _monotonic_ns()
        names = {t.ident: t.name for t in threading.enumerate()}
        own = threading.get_ident()
        threads: Dict[str, List[str]] = {}
        loop_stack: List[str] = []
        for ident, frame in sys._current_frames().items():
            if ident == own:
                continue
            stack = _format_frame_stack(frame)
            label = names.get(ident, f"tid-{ident}")
            threads[label] = stack
            if ident == self._loop_thread_ident:
                loop_stack = stack
        tasks: List[dict] = []
        try:
            import asyncio

            for task in asyncio.all_tasks(self._loop):
                try:
                    buf = io.StringIO()
                    task.print_stack(limit=8, file=buf)
                    tasks.append(
                        {"name": task.get_name(), "stack": buf.getvalue()}
                    )
                except Exception:
                    continue
        except Exception:
            pass
        record = {
            "node": self.name,
            "stalled_s": round(stalled_s, 3),
            "ts_ns": now_ns,
            "loop_stack": loop_stack,
            "threads": threads,
            "tasks": [t["name"] for t in tasks],
        }
        # stall attribution (analysis/runtime.py): name the guilty
        # subsystem, not just the raw stack
        record["subsystem"] = attribute_stall(record)
        self.stalls.append(record)
        self.stall_count += 1
        self._last_stall_t = _monotonic()
        tr = self.tracer
        if tr.enabled:
            # instants land NEXT TO the stalled spans in Perfetto
            tr.instant(
                "obs.stall",
                tid="watchdog",
                stalled_ms=round(stalled_s * 1e3, 1),
                subsystem=record["subsystem"],
                loop_stack=" <- ".join(loop_stack)[:_ARG_TRUNC],
            )
            tr.instant(
                "obs.stall.tasks",
                tid="watchdog",
                tasks="; ".join(
                    t["stack"].strip().replace("\n", " | ")[:200]
                    for t in tasks[:8]
                )[:_ARG_TRUNC],
            )
        from ..utils.log import get_logger

        get_logger("obs.watchdog").error(
            "event loop stalled (flight record captured)",
            node=self.name,
            stalled_s=round(stalled_s, 2),
            subsystem=record["subsystem"],
            loop_stack=" <- ".join(loop_stack[:6]),
        )

    # --- introspection ------------------------------------------------

    def lag_stats(self) -> dict:
        """p50/p95/p99/max scheduling lag (ms) over the sample window
        — the RPC ``health`` payload."""
        lags = sorted(self._lags)
        ms = 1e3

        def p(q: float) -> float:
            return round(percentile(lags, q) * ms, 3)

        return {
            "samples": len(lags),
            "p50_ms": p(0.50),
            "p95_ms": p(0.95),
            "p99_ms": p(0.99),
            "max_ms": round((lags[-1] if lags else 0.0) * ms, 3),
        }

    def last_stall_ago_s(self) -> Optional[float]:
        if self._last_stall_t is None:
            return None
        return _monotonic() - self._last_stall_t


def all_task_stacks(loop=None) -> List[dict]:
    """Every asyncio task's name + formatted stack (the RPC
    ``dump_tasks`` debug payload); safe to call on the loop itself."""
    import asyncio

    out: List[dict] = []
    try:
        tasks = asyncio.all_tasks(loop)
    except RuntimeError:
        return out
    for task in tasks:
        try:
            frames = task.get_stack(limit=_STACK_DEPTH)
            lines: List[str] = []
            for fr in frames:
                lines.extend(
                    traceback.format_stack(fr, limit=1)[0].rstrip()
                    .splitlines()
                )
            out.append({"name": task.get_name(), "stack": lines})
        except Exception:
            continue
    return out
