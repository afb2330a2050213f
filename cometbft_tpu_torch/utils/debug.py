"""Runtime profiling + crash-dump tooling (a copy of the JAX package's
``utils/debug.py``).

Reference analogs:
- pprof HTTP server gated by config (node/node.go:624-627,934-947) —
  here a small aiohttp app serving the Python equivalents: thread/task
  stacks, a sampling CPU profile window, and heap usage (tracemalloc).
- `cometbft debug dump/kill` (cmd/cometbft/commands/debug/) — collect
  status, net_info, consensus state, and profiles from a live node
  into a timestamped archive, optionally then killing the process.

Departure: ``heap_stats`` starts ``tracemalloc`` on its first call, as
in the JAX package, which taxes every later allocation of the process;
a ``DebugServer`` whose ``/debug/pprof/heap`` started it stops it again
in ``stop()``. ``DebugServer.listen_addr`` is the bound address (a
port of 0 binds a free one), and a server that cannot bind raises
from ``start()``.
"""

from __future__ import annotations

import asyncio
import io
import json
import os
import sys
import threading
import time
import traceback
import zipfile
from typing import Optional


class StuckTaskWatchdog:
    """Deadlock-detection analog for the asyncio single-writer design
    (the reference swaps in go-deadlock mutexes under the `deadlock`
    build tag, libs/sync/deadlock.go; a coroutine runtime's equivalent
    hazard is an await that never resumes).

    Samples all asyncio tasks every ``interval_s``; a task observed
    suspended at the SAME await point (same frame, same instruction)
    for more than ``stall_s`` is reported once with its stack via the
    structured logger. Also watches event-loop responsiveness: if the
    sampling task itself fires late by more than ``stall_s`` the loop
    was blocked (sync work on the loop thread) and that is reported.
    """

    def __init__(self, interval_s: float = 5.0, stall_s: float = 30.0):
        self.interval_s = interval_s
        self.stall_s = stall_s
        self._seen = {}  # id(task) -> (marker, first_seen, reported)
        self._task: Optional[asyncio.Task] = None
        self.stalled: list = []  # (name, stack) tuples, for tests

    def start(self) -> None:
        self._task = asyncio.get_running_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    @staticmethod
    def _marker(task: "asyncio.Task"):
        """Identity of the task's current suspension point.

        The frame position alone cannot distinguish "stuck forever"
        from "re-suspends at the same line each iteration" (a polling
        loop), so the marker includes the identity of the innermost
        awaited object: a live loop creates a fresh Future per await,
        a stuck task keeps waiting on the same one.
        """
        import weakref

        coro = task.get_coro()
        fr = getattr(coro, "cr_frame", None)
        if fr is None:
            return None
        obj = coro
        wr = None
        for _ in range(16):
            try:
                # a weakref (not a bare id), so a recycled allocation
                # at the same address cannot masquerade as the same
                # await; keep the DEEPEST weakrefable object (e.g. the
                # inner sleep coroutine — FutureIter isn't weakrefable)
                wr = weakref.ref(obj)
            except TypeError:
                pass
            nxt = getattr(obj, "cr_await", None)
            if nxt is None:
                nxt = getattr(obj, "gi_yieldfrom", None)
            if nxt is None:
                break
            obj = nxt
        if wr is None:
            return None
        return (id(fr), fr.f_lasti, wr)

    def _sample(self) -> None:
        from .log import get_logger

        log = get_logger("watchdog")
        now = time.monotonic()
        alive = set()
        me = asyncio.current_task()
        for task in asyncio.all_tasks():
            if task is me or task.done():
                continue
            key = id(task)
            alive.add(key)
            marker = self._marker(task)
            if marker is None:  # unknown suspension point: never report
                self._seen.pop(key, None)
                continue
            prev = self._seen.get(key)
            if prev is None or prev[0] != marker:
                self._seen[key] = (marker, now, False)
                continue
            marker0, first, reported = prev
            if not reported and now - first > self.stall_s:
                stack = io.StringIO()
                task.print_stack(file=stack)
                name = task.get_name()
                self.stalled.append((name, stack.getvalue()))
                log.error(
                    "task stuck at the same await point",
                    task=name,
                    stalled_s=round(now - first, 1),
                    stack=stack.getvalue()[:2000],
                )
                self._seen[key] = (marker0, first, True)
        for key in list(self._seen):
            if key not in alive:
                del self._seen[key]

    async def _run(self) -> None:
        from .log import get_logger

        log = get_logger("watchdog")
        while True:
            t0 = time.monotonic()
            await asyncio.sleep(self.interval_s)
            late = time.monotonic() - t0 - self.interval_s
            if late > self.stall_s:
                log.error(
                    "event loop blocked (sync work on loop thread)",
                    blocked_s=round(late, 1),
                )
            try:
                self._sample()
            except Exception:  # the watchdog must never kill the node
                pass


def all_stacks() -> str:
    """Every thread's stack + every asyncio task (the goroutine-dump
    equivalent)."""
    out = io.StringIO()
    frames = sys._current_frames()
    for t in threading.enumerate():
        out.write(
            f"--- thread {t.name} (daemon={t.daemon}, id={t.ident})\n"
        )
        fr = frames.get(t.ident)
        if fr is not None:
            traceback.print_stack(fr, file=out)
    try:
        loop = asyncio.get_running_loop()
    except RuntimeError:
        loop = None
    if loop is not None:
        for task in asyncio.all_tasks(loop):
            out.write(f"--- task {task.get_name()} {task!r}\n")
            for line in task.get_stack(limit=16):
                out.write(f"    {line}\n")
    return out.getvalue()


_profile_lock = threading.Lock()


def cpu_profile(seconds: float = 5.0, hz: float = 100.0) -> str:
    """Sampling profiler over ALL threads (py-spy style): captures
    sys._current_frames() at `hz` for the window and aggregates frame
    occurrence counts. cProfile can't do this — its hook only attaches
    to the calling thread, which here would just be sleeping."""
    if not _profile_lock.acquire(blocking=False):
        return "profile already running\n"
    try:
        counts: dict = {}
        own = threading.get_ident()
        deadline = time.monotonic() + seconds
        samples = 0
        interval = 1.0 / hz
        while time.monotonic() < deadline:
            for tid, frame in sys._current_frames().items():
                if tid == own:
                    continue
                stack = []
                f = frame
                depth = 0
                while f is not None and depth < 30:
                    stack.append(
                        f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:"
                        f"{f.f_lineno} {f.f_code.co_name}"
                    )
                    f = f.f_back
                    depth += 1
                key = " <- ".join(stack[:6])
                counts[key] = counts.get(key, 0) + 1
            samples += 1
            time.sleep(interval)
        out = io.StringIO()
        out.write(f"{samples} samples over {seconds}s at {hz}Hz\n\n")
        for key, n in sorted(
            counts.items(), key=lambda kv: -kv[1]
        )[:60]:
            out.write(f"{n:6d}  {key}\n")
        return out.getvalue()
    finally:
        _profile_lock.release()


def heap_stats(top: int = 40) -> str:
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return "tracemalloc started; call again for a snapshot\n"
    snap = tracemalloc.take_snapshot()
    out = io.StringIO()
    for stat in snap.statistics("lineno")[:top]:
        out.write(f"{stat}\n")
    cur, peak = tracemalloc.get_traced_memory()
    out.write(f"current={cur} peak={peak}\n")
    return out.getvalue()


class DebugServer:
    """The pprof-style HTTP listener (config
    instrumentation.pprof_laddr, reference node/node.go:624)."""

    def __init__(self, addr: str):
        self.addr = addr
        self._runner = None
        self.listen_addr = ""
        # True once /heap started tracemalloc: stop() stops it again
        self._started_tracemalloc = False

    async def start(self) -> None:
        from aiohttp import web

        async def index(_req):
            return web.Response(
                text=(
                    "/debug/pprof/stacks   thread+task dump\n"
                    "/debug/pprof/profile?seconds=N  CPU profile\n"
                    "/debug/pprof/heap     tracemalloc top\n"
                )
            )

        async def stacks(_req):
            return web.Response(text=all_stacks())

        async def profile(req):
            secs = float(req.query.get("seconds", "5"))
            text = await asyncio.to_thread(cpu_profile, min(secs, 60.0))
            return web.Response(text=text)

        async def heap(_req):
            import tracemalloc

            if not tracemalloc.is_tracing():
                self._started_tracemalloc = True
            return web.Response(text=heap_stats())

        app = web.Application()
        app.router.add_get("/debug/pprof", index)
        app.router.add_get("/debug/pprof/", index)
        app.router.add_get("/debug/pprof/stacks", stacks)
        app.router.add_get("/debug/pprof/profile", profile)
        app.router.add_get("/debug/pprof/heap", heap)
        self._runner = web.AppRunner(app)
        await self._runner.setup()
        host, _, port = self.addr.replace("tcp://", "").rpartition(":")
        site = web.TCPSite(self._runner, host or "127.0.0.1", int(port))
        try:
            await site.start()
        except BaseException:
            await self._runner.cleanup()
            self._runner = None
            raise
        h, p = site._server.sockets[0].getsockname()[:2]  # noqa: SLF001
        self.listen_addr = f"{h}:{p}"

    async def stop(self) -> None:
        if self._runner is not None:
            await self._runner.cleanup()
            self._runner = None
        if self._started_tracemalloc:
            import tracemalloc

            tracemalloc.stop()
            self._started_tracemalloc = False


def collect_debug_dump(
    rpc_addr: str,
    out_dir: str,
    pprof_addr: str = "",
    label: str = "dump",
) -> str:
    """`cometbft debug dump`: snapshot a live node's observable state
    into <out_dir>/<label>-<ts>.zip. Uses plain HTTP so it works
    against any running node."""
    import urllib.request

    os.makedirs(out_dir, exist_ok=True)
    ts = time.strftime("%Y%m%d-%H%M%S")
    path = os.path.join(out_dir, f"{label}-{ts}.zip")

    def fetch(base, p):
        with urllib.request.urlopen(base + p, timeout=10) as f:
            return f.read()

    rpc = rpc_addr if rpc_addr.startswith("http") else f"http://{rpc_addr}"
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        for name, p in (
            ("status.json", "/status"),
            ("net_info.json", "/net_info"),
            ("consensus_state.json", "/dump_consensus_state"),
            ("abci_info.json", "/abci_info"),
        ):
            try:
                z.writestr(name, fetch(rpc, p))
            except Exception as e:
                z.writestr(name + ".err", str(e))
        if pprof_addr:
            pp = (
                pprof_addr
                if pprof_addr.startswith("http")
                else f"http://{pprof_addr}"
            )
            for name, p in (
                ("stacks.txt", "/debug/pprof/stacks"),
                ("heap.txt", "/debug/pprof/heap"),
            ):
                try:
                    z.writestr(name, fetch(pp, p))
                except Exception as e:
                    z.writestr(name + ".err", str(e))
        z.writestr(
            "meta.json",
            json.dumps({"ts": ts, "rpc": rpc, "pprof": pprof_addr}),
        )
    return path
