"""Span tracer: the part of the JAX package's ``trace/tracer.py`` that
the verify dispatch layer records onto.

A ``Tracer`` hands each completed span, as ``fn(name, dur_ns, args)``,
to the observers added with ``add_observer``. Disabled, ``span()``
returns a shared do-nothing span and ``complete()`` returns at once, so
call sites never branch. Timestamps are ``time.monotonic_ns``. The JAX
package's ring buffer, snapshot and export are not ported yet.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional


class _NoopSpan:
    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False


NOOP_SPAN = _NoopSpan()


class _Span:
    """In-flight span; records one complete span when the ``with``
    block exits."""

    __slots__ = ("_tracer", "_name", "_tid", "_args", "_t0")

    def __init__(self, tracer, name, tid, args) -> None:
        self._tracer = tracer
        self._name = name
        self._tid = tid
        self._args = args
        self._t0 = time.monotonic_ns()

    def __enter__(self) -> "_Span":
        return self

    def __exit__(self, *exc) -> bool:
        t0 = self._t0
        self._tracer.complete(self._name, t0, time.monotonic_ns() - t0, self._tid, **self._args)
        return False


class Tracer:
    __slots__ = ("enabled", "name", "_observers")

    def __init__(self, name: str = "node", enabled: bool = True) -> None:
        self.name = name
        self.enabled = enabled
        self._observers: List[Callable] = []

    def span(self, name: str, tid: Optional[str] = None, **args):
        """Open a span; it is recorded when its ``with`` block exits."""
        if not self.enabled:
            return NOOP_SPAN
        return _Span(self, name, tid, args)

    def complete(
        self, name: str, ts_ns: int, dur_ns: int, tid: Optional[str] = None, **args
    ) -> None:
        """Record a span the caller timed itself."""
        if not self.enabled:
            return
        for fn in list(self._observers):
            try:
                fn(name, dur_ns, args)
            except Exception:
                # a broken observer must never take down the path it
                # observes: drop it
                self.remove_observer(fn)

    def add_observer(self, fn: Callable) -> None:
        """fn(name, dur_ns, args) on every completed span."""
        self._observers.append(fn)

    def remove_observer(self, fn: Callable) -> None:
        try:
            self._observers.remove(fn)
        except ValueError:
            pass


# The shared disabled tracer.
NOOP = Tracer(name="noop", enabled=False)
