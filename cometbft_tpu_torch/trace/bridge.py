"""Span→metrics bridge: routes completed span durations into
observer callables (utils/metrics.py NodeMetrics histograms).

Kept deliberately dumb and dependency-free: NodeMetrics registers
`route(span_name, fn)` entries pointing at its own
``Histogram.observe`` closures, then installs the bridge as a tracer
observer (Tracer.add_observer). The tracer side stays metrics-agnostic
and pays one dict lookup per completed span. A copy of the JAX
package's ``trace/bridge.py``.
"""

from __future__ import annotations

from typing import Callable, Dict


class SpanMetricsBridge:
    """Routes ``(name, dur_ns, args)`` span completions to per-kind
    callables ``fn(dur_s, args)``."""

    __slots__ = ("_routes",)

    def __init__(self) -> None:
        self._routes: Dict[str, Callable] = {}

    def route(self, span_name: str, fn: Callable) -> "SpanMetricsBridge":
        self._routes[span_name] = fn
        return self

    def __call__(self, name: str, dur_ns: int, args: dict) -> None:
        fn = self._routes.get(name)
        if fn is not None:
            fn(dur_ns / 1e9, args)
