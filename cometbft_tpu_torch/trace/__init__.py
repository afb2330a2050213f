"""Tracing plane (a copy of the JAX package's ``trace/``).

Per-node fixed-size ring-buffer tracers with a span API over the hot
planes (consensus step lifecycle, blocksync windows, the verify
scheduler, mempool, WAL fsync, p2p stamps), Chrome trace-event / JSONL
export (Perfetto-loadable), p50/p95/p99 summaries and cross-node
timelines (``python -m cometbft_tpu_torch.trace``).

Two tracer scopes:

- **per-node** — built by ``node/inprocess.build_node`` when
  ``[instrumentation] trace_enabled`` (default on); carried on
  ``NodeParts.tracer`` and attached to the node's consensus state,
  mempool, WAL, indexer, retention plane, blocksync reactor and
  switch.
- **process-wide** — ``global_tracer()``: the landing zone for planes
  shared by every node of the process (the verify scheduler's
  ``crypto.sched.dispatch`` spans, the host plane's
  ``crypto.verify_chunk`` spans). Disabled until the first
  tracing-enabled node calls ``enable_global()``.

Instrumented classes default ``self.tracer`` to the shared ``NOOP``
tracer, so call sites are unconditional and the disabled path is one
attribute check.
"""

from .bridge import SpanMetricsBridge
from .export import chrome_trace, read_jsonl, write_chrome, write_jsonl
from .summary import (
    format_summary,
    percentile,
    summarize,
    summarize_by_height,
)
from .timeline import (
    attribute_heights,
    attribution_key,
    format_waterfall,
    merge_events,
    rebase,
)
from .tracer import NOOP, NOOP_SPAN, Tracer

__all__ = [
    "NOOP",
    "NOOP_SPAN",
    "SpanMetricsBridge",
    "Tracer",
    "attribute_heights",
    "attribution_key",
    "chrome_trace",
    "enable_global",
    "format_summary",
    "format_waterfall",
    "global_tracer",
    "merge_events",
    "percentile",
    "read_jsonl",
    "rebase",
    "summarize",
    "summarize_by_height",
    "write_chrome",
    "write_jsonl",
]

# process-wide tracer for planes shared by every node (the verify
# scheduler, the host plane's workers)
_GLOBAL = Tracer(name="process", size=8192, enabled=False)


def global_tracer() -> Tracer:
    return _GLOBAL


def enable_global(enabled: bool = True) -> Tracer:
    """Flip the process-wide tracer; idempotent (called by every
    tracing-enabled node build)."""
    _GLOBAL.enabled = enabled
    return _GLOBAL
