"""Tracing-plane hygiene rules (ASY107).

The trace subsystem's whole value is trustworthy latency math: span
durations are differences of ``time.monotonic_ns`` readings. A
wall-clock read (``time.time`` / ``time.time_ns`` / ``datetime.now``)
anywhere in the plane silently breaks that — an NTP step or DST jump
mid-span yields negative or wildly wrong durations that poison the
p99s *and* the span→metrics bridge. The rule hard-forbids wall-clock
call spellings in the package's ``trace/``; code that genuinely needs
a wall anchor must take it from the caller, outside the plane.
"""
from __future__ import annotations

import ast
from typing import List

from ..astutil import dotted, in_planes
from ..findings import Finding
from ..registry import FileContext, rule

_WALLCLOCK = {
    "time.time",
    "time.time_ns",
    "datetime.now",
    "datetime.utcnow",
    "datetime.datetime.now",
    "datetime.datetime.utcnow",
}

_TRACE_PKG = "trace/"  # relative to the scanned package


@rule(
    "ASY107",
    "wallclock-in-trace",
    "wall-clock reads inside the tracing plane break span math "
    "(NTP steps make durations negative); use time.monotonic_ns",
)
def wallclock_in_trace(ctx: FileContext) -> List[Finding]:
    path = ctx.path.replace("\\", "/")
    if not in_planes(path, (_TRACE_PKG,)) and not path.startswith(_TRACE_PKG):
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name in _WALLCLOCK:
            out.append(
                Finding(
                    ctx.path, node.lineno, node.col_offset,
                    "ASY107", "wallclock-in-trace",
                    f"`{name}` inside the tracing plane: span "
                    "timestamps must be monotonic "
                    "(time.monotonic_ns) — wall clock steps corrupt "
                    "durations and the span→metrics bridge",
                )
            )
    return out
