"""The runtime health plane's queue telemetry (a copy of the JAX
package's ``obs/queues.py``): ``InstrumentedQueue``,
``InstrumentedGate`` and ``QueueRegistry``. The loop watchdog, the
sampling profiler, span budgets and the shutdown guard are not ported
(ROADMAP A10)."""

from .queues import InstrumentedGate, InstrumentedQueue, QueueRegistry

__all__ = ["InstrumentedGate", "InstrumentedQueue", "QueueRegistry"]
