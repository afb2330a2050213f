"""Unified-verify-scheduler storm (nemesis action ``verify_storm``).

Drives a light-session storm AND a blocksync-style catch-up storm
concurrently with the net's own live consensus — all three through
the ONE process-wide VerifyScheduler (crypto/scheduler.py, chaos
nodes are in-process so they share the singleton). The assertions
are the scheduler's contract under contention:

- **verdict parity**: every ticket's merged verdicts must equal the
  per-key host math, bad signatures included — a parity miss under
  concurrency is a merge/ordering bug the quiet tests can't see;
- **priority-class latency**: the synthetic LIVE tickets' p95
  submit→resolve wall must hold the ``crypto.sched.dispatch`` class
  budget while the storms saturate the engine — chunk-granularity
  preemption is what bounds it;
- **no starvation**: the catch-up feeder must keep completing
  tickets for the storm's whole duration (aging promotion), not
  stall behind the live/light load.

Runs in a worker thread (``asyncio.to_thread`` from the nemesis —
pure CPU + blocking waits would trip the loop-stall detector the
matrix itself polices). Timing values in the record are measured,
not seeded; the verdict assertions are deterministic.

A copy of the JAX package's ``chaos/verify_storm.py``, with the same
pool widths (8 live, 16 light, 64 catch-up lanes), bad lanes, budget
and starvation check. Every ticket is submitted for ``device`` (None
is the GPU, and raises without one). A failed verify route is a
``DeviceRouteError``: the storm stops and raises it, never counting it
as a verdict or a parity miss.
"""

from __future__ import annotations

import threading
import time
from typing import List

from ..crypto import scheduler as sched_mod
from ..crypto.keys import Ed25519PrivKey
from ..device import resolve
from ..utils.log import get_logger
from .invariants import InvariantViolation

_log = get_logger("chaos.verify_storm")


def _percentile(vals: List[float], q: float) -> float:
    if not vals:
        return 0.0
    vs = sorted(vals)
    return vs[min(len(vs) - 1, int(q * (len(vs) - 1) + 0.5))]


def _make_pool(n: int, bad: frozenset, keys) -> tuple:
    items = []
    for i in range(n):
        sk = keys[i % len(keys)]
        msg = b"verify-storm-%d" % i
        sig = sk.sign(msg)
        if i in bad:
            sig = b"\x00" * 64
        items.append((sk.pub_key(), msg, sig))
    expected = [i not in bad for i in range(n)]
    return items, expected


def storm_for_chaos(
    storm_s: float = 1.5, live_budget_ms: float = 2500.0, device=None
) -> dict:
    """Run the three-class storm on ``device``; returns the nemesis
    trace record. Raises InvariantViolation on parity loss, a
    live-class budget breach, or a starved catch-up lane, and the
    first ``DeviceRouteError`` of any ticket."""
    device = resolve(device)
    s = sched_mod.scheduler()
    keys = [Ed25519PrivKey.generate() for _ in range(4)]
    live_items, live_want = _make_pool(8, frozenset(), keys)
    light_items, light_want = _make_pool(16, frozenset({3}), keys)
    catchup_items, catchup_want = _make_pool(64, frozenset({11, 40}), keys)
    promoted_before = s.promoted
    deadline = time.perf_counter() + storm_s
    walls = {0: [], 1: [], 2: []}
    parity_misses: List[str] = []
    route_errors: List[BaseException] = []
    lock = threading.Lock()

    def run_class(priority, items, want, label, pause_s):
        while time.perf_counter() < deadline and not route_errors:
            t = s.submit(items, priority=priority, label=label, device=device)
            try:
                _, oks = t.result(timeout=30.0)
            except TimeoutError:
                with lock:
                    parity_misses.append(f"{label}: ticket timed out")
                return
            except sched_mod.DeviceRouteError as e:
                # no verdict: the storm ends and the caller sees it
                with lock:
                    route_errors.append(e)
                return
            with lock:
                if oks != want:
                    parity_misses.append(
                        f"{label}: verdicts diverged under storm"
                    )
                walls[priority].append(t.wall() or 0.0)
            if pause_s:
                time.sleep(pause_s)

    feeders = [
        threading.Thread(
            target=run_class,
            args=(sched_mod.PRIORITY_LIGHT, light_items, light_want,
                  "storm-light", 0.005),
            daemon=True,
        ),
        threading.Thread(
            target=run_class,
            args=(sched_mod.PRIORITY_CATCHUP, catchup_items,
                  catchup_want, "storm-catchup", 0.0),
            daemon=True,
        ),
    ]
    for f in feeders:
        f.start()
    # the LIVE lane runs on the calling worker thread: small frequent
    # waves, the shape of a precommit burst
    run_class(
        sched_mod.PRIORITY_LIVE, live_items, live_want,
        "storm-live", 0.02,
    )
    for f in feeders:
        f.join(timeout=60.0)
    s.drain(timeout=60.0)
    if route_errors:
        raise route_errors[0]

    record = {"storm_s": storm_s, "live_budget_ms": live_budget_ms}
    for cls, name in enumerate(sched_mod.CLASS_NAMES):
        w = walls[cls]
        record[name] = {
            "tickets": len(w),
            "p50_ms": round(_percentile(w, 0.50) * 1000.0, 3),
            "p95_ms": round(_percentile(w, 0.95) * 1000.0, 3),
        }
    record["promoted"] = s.promoted - promoted_before
    record["parity_ok"] = not parity_misses

    if parity_misses:
        raise InvariantViolation(
            "verify_parity",
            f"scheduler verdicts diverged under storm: "
            f"{parity_misses[:3]}",
        )
    live_p95_ms = record["live"]["p95_ms"]
    if record["live"]["tickets"] and live_p95_ms > live_budget_ms:
        raise InvariantViolation(
            "verify_priority",
            f"live-class verify p95 {live_p95_ms:.0f}ms breached the "
            f"{live_budget_ms:.0f}ms budget while sharing the "
            "scheduler with light+catch-up storms",
        )
    if not record["catchup"]["tickets"]:
        raise InvariantViolation(
            "verify_starvation",
            "catch-up lane completed ZERO tickets during the storm: "
            "aging promotion failed to hold its dispatch share",
        )
    _log.info("verify storm complete", **{
        k: v for k, v in record.items() if not isinstance(v, dict)
    })
    return record
