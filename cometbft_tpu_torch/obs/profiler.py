"""Stdlib sampling profiler with folded-stack (flamegraph) output (a
copy of the JAX package's ``obs/profiler.py``).

A background daemon thread captures ``sys._current_frames()`` at a
configurable Hz and aggregates whole stacks into a
``{folded_stack: count}`` dict, where a folded stack is the
semicolon-joined ``module:func`` chain outermost-first — exactly the
"collapsed" format flamegraph.pl / speedscope / inferno consume.

Why not cProfile: its tracing hook attaches per-thread (the calling
thread here would just be sleeping) and its overhead on a GIL-bound
host distorts the very tails we are attributing. Sampling at the
default ~50 Hz walks every thread's frames once a sample, bounded
depth, no allocation beyond the counter dict.
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Dict, List, Optional

_DEFAULT_HZ = 47.0  # off the round 50 so it never beats with timers
_MAX_DEPTH = 40


def _fold(frame, depth: int = _MAX_DEPTH) -> str:
    """Outermost-first module:func;module:func;... for one frame."""
    parts: List[str] = []
    f = frame
    while f is not None and len(parts) < depth:
        code = f.f_code
        mod = code.co_filename.rsplit("/", 1)[-1]
        if mod.endswith(".py"):
            mod = mod[:-3]
        parts.append(f"{mod}:{code.co_name}")
        f = f.f_back
    parts.reverse()
    return ";".join(parts)


class SamplingProfiler:
    """start()/stop() or use as a context manager; thread-safe reads.

    ``counts`` maps folded stack -> samples; ``folded()`` renders the
    flamegraph-collapsed text ("stack count" per line, descending)."""

    def __init__(
        self,
        hz: float = _DEFAULT_HZ,
        include_idle: bool = False,
        max_stacks: int = 20_000,
    ) -> None:
        self.hz = max(1.0, hz)
        self.include_idle = include_idle
        self.max_stacks = max_stacks
        self.counts: Dict[str, int] = {}
        self.samples = 0
        self.started_ns = 0
        self.wall_s = 0.0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._lock = threading.Lock()

    # --- lifecycle ----------------------------------------------------

    @property
    def running(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def start(self) -> "SamplingProfiler":
        if self.running:
            return self
        self._stop.clear()
        self.started_ns = time.monotonic_ns()
        self._thread = threading.Thread(
            target=self._run, name="obs-profiler", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> "SamplingProfiler":
        self._stop.set()
        th, self._thread = self._thread, None
        if th is not None and th is not threading.current_thread():
            th.join(timeout=2.0)
        if self.started_ns:
            self.wall_s = (time.monotonic_ns() - self.started_ns) / 1e9
        return self

    def __enter__(self) -> "SamplingProfiler":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    # --- sampling -----------------------------------------------------

    def sample_once(self) -> None:
        """One capture of every thread's stack (public so the overhead
        guard test can bound its cost directly)."""
        own = threading.get_ident()
        counts = self.counts
        for tid, frame in sys._current_frames().items():
            if tid == own:
                continue
            key = _fold(frame)
            if not key:
                continue
            if not self.include_idle:
                # parked threads (the selector idle-wait, Event.wait
                # loops, pool workers waiting for work) are noise at
                # every sample; the RUNNING callbacks are what
                # attribution needs. Judge by the INNERMOST frame.
                leaf = key.rsplit(";", 1)[-1]
                if leaf in (
                    "threading:wait",
                    "selectors:select",
                    "threading:_wait_for_tstate_lock",
                ):
                    continue
            if key in counts:
                counts[key] += 1
            elif len(counts) < self.max_stacks:
                counts[key] = 1
        self.samples += 1

    def _run(self) -> None:
        interval = 1.0 / self.hz
        while not self._stop.wait(interval):
            with self._lock:
                try:
                    self.sample_once()
                except Exception:
                    # a torn frame read degrades one sample, never
                    # the profiled process
                    continue

    # --- output -------------------------------------------------------

    def folded(self, top: Optional[int] = None) -> str:
        """Flamegraph-collapsed text: one "stack count" per line,
        heaviest first."""
        with self._lock:
            items = sorted(self.counts.items(), key=lambda kv: -kv[1])
        if top is not None:
            items = items[:top]
        return "\n".join(f"{stack} {n}" for stack, n in items)

    def top_lines(self, n: int = 20) -> List[dict]:
        """Heaviest folded stacks as JSON-able rows.
        ``pct`` is the share of recorded THREAD-samples: one capture
        contributes one count per running thread, and several threads
        can share a folded stack, so the capture count is the wrong
        denominator."""
        with self._lock:
            items = sorted(self.counts.items(), key=lambda kv: -kv[1])
            total = max(1, sum(self.counts.values()))
        return [
            {
                "stack": stack,
                "samples": cnt,
                "pct": round(100.0 * cnt / total, 1),
            }
            for stack, cnt in items[:n]
        ]

    def write_folded(self, path: str) -> str:
        import os

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            header = (
                f"# {self.samples} samples at {self.hz:g} Hz over "
                f"{self.wall_s:.1f}s\n"
            )
            f.write(header)
            f.write(self.folded())
            f.write("\n")
        return path
