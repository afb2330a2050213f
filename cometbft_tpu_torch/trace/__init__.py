"""Tracing: the span ``Tracer`` and the process-wide tracer.

The part of the JAX package's ``trace/`` that the verify dispatch
layer records onto: ``Tracer``, the shared disabled ``NOOP`` tracer,
``global_tracer()`` and ``enable_global()``. The verify scheduler
records a ``crypto.sched.dispatch`` span per ticket and the host plane
a ``crypto.verify_chunk`` span per chunk, both onto the process-wide
tracer, which stays disabled until ``enable_global()`` is called; its
observers read them. Export, summaries and timelines are not ported
yet.
"""

from .tracer import NOOP, Tracer

__all__ = ["NOOP", "Tracer", "enable_global", "global_tracer"]

# process-wide tracer for planes shared by every caller (the crypto
# worker pool, the verify scheduler)
_GLOBAL = Tracer(name="process", enabled=False)


def global_tracer() -> Tracer:
    return _GLOBAL


def enable_global(enabled: bool = True) -> Tracer:
    """Flip the process-wide tracer; idempotent."""
    _GLOBAL.enabled = enabled
    return _GLOBAL
