"""Per-node fixed-size ring-buffer event tracer (a copy of the JAX
package's ``trace/tracer.py``).

Design constraints:

- **Preallocated slots** — the ring is a list of fixed-shape slot
  lists created once at construction; appends overwrite slot fields
  in place, so the ring itself never grows or churns slot objects
  after warmup.
- **Lock-free append** — the write cursor is an ``itertools.count``,
  whose ``next()`` is atomic under the GIL, so the per-loop writer
  needs no lock and the off-loop writers (the verify scheduler's
  dispatcher and watcher threads, the host plane's workers, the loop
  watchdog's monitor, all appending to a tracer) cannot corrupt the
  cursor; concurrent writers can only ever contend for *different*
  slots unless the ring has already lapped, in which case the older
  event was due to be overwritten anyway.
- **Strict no-op fast path when disabled** — ``span()`` /
  ``instant()`` / ``counter()`` check one attribute and return a
  shared singleton; the hottest call sites may additionally guard on
  ``tracer.enabled`` themselves.
- **Monotonic timestamps only** — ``time.monotonic_ns``; nothing in
  ``trace/`` reads the wall clock (a span whose endpoints straddle an
  NTP step would report negative or garbage durations). The
  monotonic-to-wall anchor that cross-node timelines need is set in
  ``meta`` by node assembly (``node/inprocess.record_clock_anchor``).

Observers (``add_observer``) receive every completed span as
``fn(name, dur_ns, args)``: the span-to-metrics bridge and the smoke's
span sums ride this.

Event slot layout (index into the slot list):
    [seq, name, ph, ts_ns, dur_ns, tid, args]
``ph`` follows the Chrome trace-event phase letters: "X" complete
span, "i" instant, "C" counter.
"""

from __future__ import annotations

import itertools
import time
from typing import Callable, Dict, List, Optional

_monotonic_ns = time.monotonic_ns

# slot field indices
_SEQ, _NAME, _PH, _TS, _DUR, _TID, _ARGS = range(7)

_DEFAULT_TID = "main"


class _NoopSpan:
    """Shared do-nothing span: the disabled-tracer fast path and the
    NOOP tracer both hand this out, so call sites never branch."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **args) -> None:
        pass

    def end(self) -> None:
        pass


NOOP_SPAN = _NoopSpan()


class _Span:
    """In-flight span; records ONE complete ("X") event on end().
    Usable as a context manager or via manual ``end()`` (the
    consensus step machine closes spans from a different callsite
    than it opens them)."""

    __slots__ = ("_tracer", "_name", "_tid", "_args", "_t0")

    def __init__(self, tracer, name, tid, args, t0) -> None:
        self._tracer = tracer
        self._name = name
        self._tid = tid
        self._args = args
        self._t0 = t0

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        self.end()
        return False

    def set(self, **args) -> None:
        """Attach/overwrite args after the span opened (e.g. a reap
        span learns its tx count at the end)."""
        self._args.update(args)

    def end(self) -> None:
        tr = self._tracer
        if tr is None:
            return  # idempotent: __exit__ after an explicit end()
        self._tracer = None
        t0 = self._t0
        tr._append(
            self._name, "X", t0, _monotonic_ns() - t0, self._tid,
            self._args,
        )


class Tracer:
    """Fixed-size ring of trace events (see module docstring).

    ``observers`` receive every completed span as
    ``fn(name, dur_ns, args)`` — the span→metrics bridge
    (trace/bridge.py) rides this; the list is empty by default so the
    hot path pays one truthiness check.
    """

    __slots__ = (
        "enabled", "name", "_n", "_ring", "_count", "_observers",
        "meta",
    )

    def __init__(
        self, name: str = "node", size: int = 16384,
        enabled: bool = True,
    ) -> None:
        if size < 1:
            raise ValueError("ring size must be >= 1")
        self.name = name
        self.enabled = enabled
        self._n = size
        self._ring: List[list] = [
            [None, None, None, 0, 0, None, None] for _ in range(size)
        ]
        self._count = itertools.count()
        self._observers: List[Callable] = []
        # ring-level metadata set by node assembly (node code), never by
        # this plane: the monotonic→wall clock anchor lives here so
        # cross-node timelines can rebase rings from different
        # processes (nothing in trace/ reads the wall clock)
        self.meta: Dict = {}

    # --- append paths -------------------------------------------------

    def _append(self, name, ph, ts, dur, tid, args) -> None:
        i = next(self._count)
        s = self._ring[i % self._n]
        s[_SEQ] = i
        s[_NAME] = name
        s[_PH] = ph
        s[_TS] = ts
        s[_DUR] = dur
        s[_TID] = tid or _DEFAULT_TID
        s[_ARGS] = args
        obs = self._observers
        if obs and ph == "X":
            dead = None
            for fn in obs:
                try:
                    fn(name, dur, args)
                except Exception:
                    # a broken observer must never take down the hot
                    # path it observes: drop it after the first failure
                    dead = fn if dead is None else dead
            if dead is not None:
                try:
                    self._observers.remove(dead)
                except ValueError:
                    pass

    def span(self, name: str, tid: Optional[str] = None, **args):
        """Open a span; record happens at ``end()`` / ``__exit__``."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, tid, args, _monotonic_ns())

    def complete(
        self, name: str, ts_ns: int, dur_ns: int,
        tid: Optional[str] = None, **args,
    ) -> None:
        """Record an already-measured complete span (callers that
        timed the work themselves, e.g. the loop watchdog's lag
        beats); observers fire exactly as for span().end()."""
        if not self.enabled:
            return
        self._append(name, "X", ts_ns, dur_ns, tid, args)

    def instant(self, name: str, tid: Optional[str] = None, **args) -> None:
        if not self.enabled:
            return
        self._append(name, "i", _monotonic_ns(), 0, tid, args)

    def instant_at(
        self, name: str, ts_ns: int, tid: Optional[str] = None, **args
    ) -> None:
        """Instant with a caller-supplied monotonic timestamp (the
        p2p stamping plane records send instants at the exact instant
        baked into the wire stamp)."""
        if not self.enabled:
            return
        self._append(name, "i", ts_ns, 0, tid, args)

    def counter(self, name: str, value, tid: Optional[str] = None) -> None:
        if not self.enabled:
            return
        self._append(
            name, "C", _monotonic_ns(), 0, tid, {"value": value}
        )

    # --- observers (span→metrics bridge) ------------------------------

    def add_observer(self, fn: Callable) -> None:
        """fn(name, dur_ns, args) on every completed span."""
        self._observers.append(fn)

    def remove_observer(self, fn: Callable) -> None:
        try:
            self._observers.remove(fn)
        except ValueError:
            pass

    # --- reading ------------------------------------------------------

    def snapshot(self) -> List[Dict]:
        """Events currently in the ring, oldest first. Safe to call
        while writers append (a concurrently-overwritten slot may
        surface a torn event; post-run dumps never race)."""
        out = []
        for s in self._ring:
            if s[_SEQ] is None:
                continue
            args = s[_ARGS]
            out.append(
                {
                    "seq": s[_SEQ],
                    "name": s[_NAME],
                    "ph": s[_PH],
                    "ts_ns": s[_TS],
                    "dur_ns": s[_DUR],
                    "tid": s[_TID],
                    "args": dict(args) if args else {},
                }
            )
        out.sort(key=lambda e: e["seq"])
        return out

    def stats(self) -> Dict:
        events = self.snapshot()
        written = (events[-1]["seq"] + 1) if events else 0
        return {
            "name": self.name,
            "ring": self._n,
            "written": written,
            "dropped": max(0, written - self._n),
        }

    def clear(self) -> None:
        for s in self._ring:
            s[_SEQ] = None
            s[_NAME] = None
            s[_ARGS] = None


# The shared disabled tracer: instrumented classes default to this so
# every call site can do `self.tracer.span(...)` unconditionally.
NOOP = Tracer(name="noop", size=1, enabled=False)
