"""Strong-referenced fire-and-forget tasks.

The event loop holds only a *weak* reference to tasks: a bare
``asyncio.create_task(...)`` / ``ensure_future(...)`` whose result is
dropped can be garbage-collected mid-flight, silently killing the
coroutine and losing its exception (CPython docs, asyncio.create_task
"Save a reference to the result"). For genuinely fire-and-forget
work the registry keeps each task alive until done, then a
done-callback drops it (and surfaces a swallowed exception to the
logger instead of the void). A copy of the JAX package's
``utils/tasks.py``.
"""
from __future__ import annotations

import asyncio
from typing import Coroutine, Optional, Set

from .log import get_logger

_log = get_logger("tasks")

_BACKGROUND: Set["asyncio.Future"] = set()


def spawn(
    coro: Coroutine, *, name: Optional[str] = None
) -> "asyncio.Future":
    """Schedule ``coro`` fire-and-forget, retaining a strong ref."""
    task = asyncio.ensure_future(coro)
    if name and hasattr(task, "set_name"):
        task.set_name(name)
    _BACKGROUND.add(task)
    task.add_done_callback(_finish)
    return task


def _finish(task: "asyncio.Future") -> None:
    _BACKGROUND.discard(task)
    if task.cancelled():
        return
    exc = task.exception()
    if exc is not None:
        _log.error(
            "background task died",
            task=getattr(task, "get_name", lambda: "?")(),
            err=repr(exc),
        )


def pending_count() -> int:
    """Live background tasks (introspection / tests)."""
    return len(_BACKGROUND)
