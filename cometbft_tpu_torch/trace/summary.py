"""Span-duration summaries: p50/p95/p99 per span kind per node.

The attribution layer over the raw rings: `summarize` reduces
{node: [events]} to per-span-kind latency stats, `format_summary`
renders the text table the CLI prints. A copy of the JAX package's
``trace/summary.py``.
"""

from __future__ import annotations

from typing import Dict, List


def percentile(sorted_ns: List[int], q: float) -> float:
    """Nearest-rank-with-interpolation percentile over a pre-sorted
    list (numpy-free: the linter/CI lane imports this)."""
    if not sorted_ns:
        return 0.0
    if len(sorted_ns) == 1:
        return float(sorted_ns[0])
    pos = (len(sorted_ns) - 1) * q
    lo = int(pos)
    hi = min(lo + 1, len(sorted_ns) - 1)
    frac = pos - lo
    return sorted_ns[lo] * (1.0 - frac) + sorted_ns[hi] * frac


def summarize(events_by_node: Dict[str, List[dict]]) -> Dict:
    """{node: {span_name: {count, p50_ms, p95_ms, p99_ms, max_ms,
    total_ms}}} over complete ("X") events; counter kinds surface
    under "_counters" with their last seen value."""
    out: Dict = {}
    for node in sorted(events_by_node):
        spans: Dict[str, List[int]] = {}
        counters: Dict[str, object] = {}
        for e in events_by_node[node]:
            ph = e.get("ph", "X")
            if ph == "X":
                spans.setdefault(e["name"], []).append(
                    e.get("dur_ns", 0)
                )
            elif ph == "C":
                counters[e["name"]] = (e.get("args") or {}).get("value")
        node_sum: Dict = {}
        for name in sorted(spans):
            ds = sorted(spans[name])
            ms = 1e6
            node_sum[name] = {
                "count": len(ds),
                "p50_ms": round(percentile(ds, 0.50) / ms, 3),
                "p95_ms": round(percentile(ds, 0.95) / ms, 3),
                "p99_ms": round(percentile(ds, 0.99) / ms, 3),
                "max_ms": round(ds[-1] / ms, 3),
                "total_ms": round(sum(ds) / ms, 3),
            }
        if counters:
            node_sum["_counters"] = counters
        out[node] = node_sum
    return out


def summarize_by_height(events_by_node: Dict[str, List[dict]]) -> Dict:
    """{height: {span_name: {count, p50_ms, max_ms, total_ms}}} over
    the complete spans that carry a height arg (``height`` on the
    consensus spans, ``h`` on the compact p2p events), aggregated
    ACROSS nodes — the per-height grouping behind
    ``summarize --by-height`` (docs/TRACE.md)."""
    per_h: Dict[int, Dict[str, List[int]]] = {}
    for events in events_by_node.values():
        for e in events:
            if e.get("ph", "X") != "X":
                continue
            a = e.get("args") or {}
            h = a.get("height", a.get("h"))
            if h in (None, 0):
                continue
            per_h.setdefault(int(h), {}).setdefault(
                e["name"], []
            ).append(e.get("dur_ns", 0))
    ms = 1e6
    out: Dict = {}
    for h in sorted(per_h):
        spans: Dict = {}
        for name in sorted(per_h[h]):
            ds = sorted(per_h[h][name])
            spans[name] = {
                "count": len(ds),
                "p50_ms": round(percentile(ds, 0.50) / ms, 3),
                "max_ms": round(ds[-1] / ms, 3),
                "total_ms": round(sum(ds) / ms, 3),
            }
        out[h] = spans
    return out


def format_by_height(by_height: Dict) -> str:
    """One block per height, aggregated across nodes."""
    if not by_height:
        return "no height-tagged spans found"
    lines: List[str] = []
    hdr = (
        f"{'span':<34} {'count':>7} {'p50ms':>9} {'max ms':>9} "
        f"{'total ms':>10}"
    )
    for h, spans in by_height.items():
        lines.append(f"== height {h} ==")
        lines.append(hdr)
        for name, s in spans.items():
            lines.append(
                f"{name:<34} {s['count']:>7} {s['p50_ms']:>9} "
                f"{s['max_ms']:>9} {s['total_ms']:>10}"
            )
        lines.append("")
    return "\n".join(lines).rstrip()


def format_summary(summary: Dict) -> str:
    """Aligned text table, one block per node."""
    lines: List[str] = []
    hdr = (
        f"{'span':<34} {'count':>7} {'p50ms':>9} {'p95ms':>9} "
        f"{'p99ms':>9} {'max ms':>9} {'total ms':>10}"
    )
    for node, kinds in summary.items():
        lines.append(f"== {node} ==")
        lines.append(hdr)
        for name, s in kinds.items():
            if name == "_counters":
                continue
            lines.append(
                f"{name:<34} {s['count']:>7} {s['p50_ms']:>9} "
                f"{s['p95_ms']:>9} {s['p99_ms']:>9} {s['max_ms']:>9} "
                f"{s['total_ms']:>10}"
            )
        counters = kinds.get("_counters")
        if counters:
            for cname, v in sorted(counters.items()):
                lines.append(f"{cname:<34} last={v}")
        lines.append("")
    return "\n".join(lines).rstrip()
