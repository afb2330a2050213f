"""Runtime health plane (a copy of the JAX package's ``obs/``).

- **LoopWatchdog** (obs/watchdog.py) — per-node event-loop scheduling
  lag measured by a monotonic heartbeat task, plus a **flight
  recorder**: when the loop stalls past a threshold, a monitor thread
  snapshots every thread's frame and every asyncio task's stack INTO
  THE TRACE RING as instant events.
- **SamplingProfiler** (obs/profiler.py) — stdlib sampling profiler
  (sys._current_frames at a configurable Hz) with folded-stack output.
- **InstrumentedQueue / QueueRegistry** (obs/queues.py) —
  backpressure telemetry for every bounded queue in the hot planes:
  depth, high watermark, unified shed/drop counters.
- **ShutdownGuard** (obs/shutdown.py) — per-stage shutdown budgets with
  stop→cancel→abandon escalation and a flight record on each breach.
- **span budgets** (obs/budget.py) — declarative per-span-kind
  p95/p99 budgets in tools/span_budgets.toml, evaluated by
  ``trace summarize --budget``.
"""

from .budget import evaluate_budgets, format_verdicts, load_budgets
from .profiler import SamplingProfiler
from .queues import InstrumentedGate, InstrumentedQueue, QueueRegistry
from .shutdown import ShutdownGuard
from .watchdog import LoopWatchdog

__all__ = [
    "InstrumentedGate",
    "InstrumentedQueue",
    "LoopWatchdog",
    "QueueRegistry",
    "SamplingProfiler",
    "ShutdownGuard",
    "evaluate_budgets",
    "format_verdicts",
    "load_budgets",
]
