"""Bounded shutdown: per-stage budgets with stop→cancel→abandon
escalation and a flight-recorder dump on every breach (a copy of the
JAX package's ``obs/shutdown.py``).

The known wedge class this exists for: a
graceful ``stop()`` chain awaits some sub-plane's stop that never
returns — a reactor routine swallowing its cancel, a peer drain
waiting on a dead transport, an executor hop that lost its thread —
and the whole process hangs with the loop alive and store fds open.
Nothing times out, nothing reports, the only evidence is a stuck CI
job.

``ShutdownGuard.stage`` turns that into a *diagnosed, bounded*
failure:

1. **stop** — run the stage coroutine under ``asyncio.wait_for`` with
   a per-stage budget;
2. **cancel** — on budget breach, capture a flight record FIRST (the
   hung stage's task stack is still intact mid-hang — exactly like
   the loop watchdog's mid-stall snapshot), then cancel the stage
   task and give it a short grace period to unwind;
3. **abandon** — if the stage ignores its cancel too, leave the task
   behind and move on: later stages (store-handle release, fd close)
   must still run, because a half-stopped node that frees its
   stores can at least be restarted.

Every breach lands on the trace ring as ``obs.shutdown.stall`` (the
hung stage + the offending task/thread stacks) and
``obs.shutdown.tasks`` instants — the same surface the loop
watchdog's stall records use, so ring dumps and Perfetto show the
wedge next to whatever the node was doing — and is kept on
``guard.stalls`` for reports and tests.
"""

from __future__ import annotations

import asyncio
import io
import sys
import threading
from typing import Awaitable, Dict, List, Optional

from ..trace import NOOP as TRACE_NOOP
from .watchdog import _ARG_TRUNC, _format_frame_stack

# escalation grace after the cancel: a well-behaved stage unwinds in
# microseconds; a stage that needs longer than this to HANDLE its
# cancel is itself part of the wedge class
CANCEL_GRACE_S = 1.0


def shutdown_flight_record(
    stage: str, waited_s: float, task: Optional[asyncio.Task] = None
) -> dict:
    """Mid-hang snapshot of the stage task's stack plus every thread's
    frame (the hang may live off-loop: an executor hop, a locked
    native call). Read-only like the watchdog's recorder — formatting
    frames never touches loop state."""
    record: Dict[str, object] = {
        "stage": stage,
        "waited_s": round(waited_s, 3),
    }
    if task is not None:
        try:
            buf = io.StringIO()
            task.print_stack(limit=12, file=buf)
            record["stage_stack"] = buf.getvalue()
        except Exception:
            record["stage_stack"] = ""
    names = {t.ident: t.name for t in threading.enumerate()}
    own = threading.get_ident()
    threads: Dict[str, List[str]] = {}
    try:
        for ident, frame in sys._current_frames().items():
            if ident == own:
                continue
            threads[names.get(ident, f"tid-{ident}")] = (
                _format_frame_stack(frame)
            )
    except Exception:
        pass
    record["threads"] = threads
    return record


class ShutdownGuard:
    """Runs shutdown stages under bounded budgets (module doc).

    One guard per shutdown; ``stalls`` collects every breached
    stage's flight record, ``clean`` is True iff no stage breached.
    """

    def __init__(
        self,
        tracer=TRACE_NOOP,
        name: str = "node",
        budget_s: float = 5.0,
    ) -> None:
        self.tracer = tracer or TRACE_NOOP
        self.name = name
        self.budget_s = budget_s
        self.stalls: List[dict] = []
        self.abandoned: List[str] = []

    @property
    def clean(self) -> bool:
        return not self.stalls

    async def stage(
        self,
        stage_name: str,
        coro: Awaitable,
        budget_s: Optional[float] = None,
    ) -> bool:
        """Run one shutdown stage bounded. Returns True iff the stage
        completed (or failed fast) within budget; a stage exception
        other than the timeout is swallowed after logging — shutdown
        must always reach its last stage."""
        budget = self.budget_s if budget_s is None else budget_s
        task = asyncio.ensure_future(coro)
        try:
            await asyncio.wait_for(asyncio.shield(task), budget)
            return True
        except asyncio.TimeoutError:
            self._on_breach(stage_name, budget, task)
        except asyncio.CancelledError:
            # our own caller is being cancelled: don't leave the stage
            # task dangling silently
            task.cancel()
            raise
        except Exception as e:
            from ..utils.log import get_logger

            get_logger("obs.shutdown").error(
                "shutdown stage failed", node=self.name,
                stage=stage_name, err=repr(e),
            )
            return True  # failed fast — the stage is over, move on
        # escalation: cancel, short grace, then abandon
        task.cancel()
        try:
            await asyncio.wait_for(
                asyncio.shield(task), CANCEL_GRACE_S
            )
        except asyncio.TimeoutError:
            if not task.done():
                self.abandoned.append(stage_name)
        except asyncio.CancelledError:
            if not task.done():
                # the CALLER was cancelled mid-grace (the stage task
                # would be done if this were our own cancel landing):
                # record the abandonment and propagate — swallowing
                # an outer cancel here would keep running a shutdown
                # its owner just revoked
                self.abandoned.append(stage_name)
                raise
            # else: the stage unwound with our cancel — escalation
            # complete, not an abandonment
        except Exception:
            pass  # unwound with an error: still over
        return False

    def _on_breach(
        self, stage_name: str, budget: float, task: asyncio.Task
    ) -> None:
        record = shutdown_flight_record(stage_name, budget, task)
        record["node"] = self.name
        self.stalls.append(record)
        tr = self.tracer
        if getattr(tr, "enabled", False):
            tr.instant(
                "obs.shutdown.stall",
                tid="shutdown",
                stage=stage_name,
                budget_s=budget,
                stage_stack=str(record.get("stage_stack", ""))[
                    :_ARG_TRUNC
                ],
            )
            tr.instant(
                "obs.shutdown.tasks",
                tid="shutdown",
                threads="; ".join(
                    f"{n}: " + " <- ".join(s[:4])
                    for n, s in list(record["threads"].items())[:8]
                )[:_ARG_TRUNC],
            )
        from ..utils.log import get_logger

        get_logger("obs.shutdown").error(
            "shutdown stage exceeded its budget "
            "(flight record captured; escalating stop→cancel)",
            node=self.name,
            stage=stage_name,
            budget_s=budget,
        )
