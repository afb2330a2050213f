"""Span-budget engine: declarative p95/p99 latency budgets per span
kind, evaluated against trace summaries (a copy of the JAX package's
``obs/budget.py``).

Budgets live in a checked-in TOML (tools/span_budgets.toml):

    [budget."consensus.step"]
    p95_ms = 2000.0
    p99_ms = 15000.0
    min_count = 10       # skip kinds with too few samples to judge

    [budget."wal.fsync"]
    p99_ms = 400.0

Evaluation runs over the exact summary shape trace/summary.summarize
produces ({node: {span: {count, p50_ms, p95_ms, p99_ms, ...}}}), one
verdict row per (node, span, metric). Consumers:

- ``python -m cometbft_tpu_torch.trace summarize --budget [FILE]`` —
  prints the verdict table, exits 2 on any violation;
- ``chip_smoke.py`` phase 18b — reports the verdicts of a live node's
  ring (reported, not gating).

The checked-in file is the JAX package's, calibrated on its hosts;
the port reads it and does not write it.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import tomllib

# metrics a budget entry may bound, in report order
_METRICS = ("p50_ms", "p95_ms", "p99_ms", "max_ms")

DEFAULT_BUDGET_PATH = os.path.join("tools", "span_budgets.toml")


def default_budget_file(repo_root: Optional[str] = None) -> str:
    """Anchored on the PACKAGE location, not the cwd: the --budget
    default must resolve no matter where the CLI is invoked from (a
    cwd-relative miss would surface as a bogus 'budget evaluation
    failed' violation)."""
    root = repo_root or os.path.dirname(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    )
    return os.path.join(root, DEFAULT_BUDGET_PATH)


def load_budgets(path: str) -> Dict[str, dict]:
    """{span_kind: {p95_ms: float, ..., min_count: int}} from TOML."""
    with open(path, "rb") as f:
        raw = tomllib.load(f)
    out: Dict[str, dict] = {}
    for span, entry in (raw.get("budget") or {}).items():
        if not isinstance(entry, dict):
            raise ValueError(f"budget.{span!r}: expected a table")
        known = set(_METRICS) | {"min_count"}
        bad = set(entry) - known
        if bad:
            raise ValueError(
                f"budget.{span!r}: unknown keys {sorted(bad)} "
                f"(allowed: {sorted(known)})"
            )
        out[span] = dict(entry)
    return out


def evaluate_budgets(
    summary: Dict[str, dict], budgets: Dict[str, dict]
) -> List[dict]:
    """One verdict row per (node, span, metric) that a budget bounds.

    Rows: {node, span, metric, actual_ms, budget_ms, count, ok}.
    Span kinds below their ``min_count`` (default 1) are skipped —
    a 2-sample p99 is an anecdote, not a tail."""
    rows: List[dict] = []
    for node in sorted(summary):
        kinds = summary[node]
        for span, budget in sorted(budgets.items()):
            stats = kinds.get(span)
            if stats is None or span == "_counters":
                continue
            count = int(stats.get("count", 0))
            if count < int(budget.get("min_count", 1)):
                continue
            for metric in _METRICS:
                limit = budget.get(metric)
                if limit is None:
                    continue
                actual = float(stats.get(metric, 0.0))
                rows.append(
                    {
                        "node": node,
                        "span": span,
                        "metric": metric,
                        "actual_ms": actual,
                        "budget_ms": float(limit),
                        "count": count,
                        "ok": actual <= float(limit),
                    }
                )
    return rows


def budgets_ok(verdicts: List[dict]) -> bool:
    return all(v["ok"] for v in verdicts)


def format_verdicts(verdicts: List[dict]) -> str:
    """Aligned verdict table; violations first so they can't scroll
    away in CI logs."""
    if not verdicts:
        return "no span kinds matched a budget (nothing evaluated)"
    hdr = (
        f"{'verdict':<8} {'node':<10} {'span':<30} {'metric':<8} "
        f"{'actual ms':>10} {'budget ms':>10} {'count':>7}"
    )
    lines = [hdr]
    for v in sorted(verdicts, key=lambda v: (v["ok"], v["node"], v["span"])):
        lines.append(
            f"{'OK' if v['ok'] else 'OVER':<8} {v['node']:<10} "
            f"{v['span']:<30} {v['metric']:<8} "
            f"{v['actual_ms']:>10.3f} {v['budget_ms']:>10.3f} "
            f"{v['count']:>7}"
        )
    n_over = sum(1 for v in verdicts if not v["ok"])
    lines.append(
        f"budget verdict: "
        + (
            "PASS" if n_over == 0
            else f"FAIL ({n_over}/{len(verdicts)} over budget)"
        )
    )
    return "\n".join(lines)
