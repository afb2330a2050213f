"""Async-safety rules (ASY1xx).

These target the reactor/p2p/rpc layers: a single blocked event loop
stalls every peer connection at once, and a swallowed CancelledError
turns clean shutdown into a hang.  They are the Python analogue of
the `go vet` + race-detector discipline upstream CometBFT relies on.
"""
from __future__ import annotations

import ast
from typing import Iterator, List

from ..astutil import body_awaits, dotted, in_planes, package_path, walk_in_function
from ..findings import Finding
from ..registry import FileContext, rule

# Call targets that block the calling thread.  Name-based: we cannot
# type-infer, but these dotted spellings are unambiguous in practice.
_BLOCKING_CALLS = {
    "time.sleep": "time.sleep blocks the event loop; use "
    "`await asyncio.sleep` or `asyncio.to_thread`",
    "os.system": "os.system blocks; use asyncio.create_subprocess_*",
    "os.wait": "os.wait blocks the loop",
    "os.waitpid": "os.waitpid blocks the loop",
    "subprocess.run": "subprocess.run blocks; use "
    "asyncio.create_subprocess_exec",
    "subprocess.call": "subprocess.call blocks the loop",
    "subprocess.check_call": "subprocess.check_call blocks the loop",
    "subprocess.check_output": "subprocess.check_output blocks the loop",
    "urllib.request.urlopen": "sync HTTP inside async code; use an "
    "async client or asyncio.to_thread",
    "requests.get": "sync HTTP inside async code",
    "requests.post": "sync HTTP inside async code",
    "requests.put": "sync HTTP inside async code",
    "requests.delete": "sync HTTP inside async code",
    "requests.request": "sync HTTP inside async code",
    "socket.create_connection": "sync connect inside async code; use "
    "asyncio.open_connection",
    "socket.getaddrinfo": "sync DNS resolution inside async code; use "
    "loop.getaddrinfo",
    "select.select": "select.select blocks the loop",
}

# asyncio coroutine functions whose bare call is always a lost await
_ASYNCIO_COROS = {
    "asyncio.sleep",
    "asyncio.gather",
    "asyncio.wait",
    "asyncio.wait_for",
    "asyncio.to_thread",
    "asyncio.open_connection",
    "asyncio.start_server",
}

_TASK_SPAWNERS = ("asyncio.create_task", "asyncio.ensure_future")


def _async_defs(tree: ast.Module) -> Iterator[ast.AsyncFunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, ast.AsyncFunctionDef):
            yield node


@rule(
    "ASY101",
    "blocking-call-in-async",
    "blocking call (time.sleep, sync I/O, subprocess) directly inside "
    "an async def starves the event loop",
)
def blocking_call_in_async(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for fn in _async_defs(ctx.tree):
        for node in walk_in_function(fn):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name in _BLOCKING_CALLS:
                out.append(
                    Finding(
                        ctx.path, node.lineno, node.col_offset,
                        "ASY101", "blocking-call-in-async",
                        f"`{name}` inside `async def {fn.name}`: "
                        + _BLOCKING_CALLS[name],
                    )
                )
    return out


@rule(
    "ASY102",
    "unawaited-coroutine",
    "calling a coroutine function as a bare statement never runs it",
)
def unawaited_coroutine(ctx: FileContext) -> List[Finding]:
    async_names = {fn.name for fn in _async_defs(ctx.tree)}
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Call)
        ):
            continue
        call = node.value
        name = dotted(call.func)
        if name is None:
            continue
        hit = None
        if name in _ASYNCIO_COROS:
            hit = name
        elif name in async_names:
            hit = name
        elif name.count(".") == 1 and name.split(".")[0] in (
            "self", "cls"
        ):
            # exactly `self.x()` — a deeper chain (`self.pool.stop()`)
            # targets another object whose `stop` we cannot see
            attr = name.split(".")[1]
            if attr in async_names:
                hit = name
        if hit is not None:
            out.append(
                Finding(
                    ctx.path, node.lineno, node.col_offset,
                    "ASY102", "unawaited-coroutine",
                    f"`{hit}(...)` is a coroutine call whose result is "
                    "discarded — it never runs; await it or wrap it in "
                    "asyncio.create_task",
                )
            )
    return out


@rule(
    "ASY103",
    "dropped-task",
    "asyncio.create_task result discarded: the task can be "
    "garbage-collected mid-flight and its exceptions are lost",
)
def dropped_task(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not (
            isinstance(node, ast.Expr)
            and isinstance(node.value, ast.Call)
        ):
            continue
        name = dotted(node.value.func)
        if name is None:
            continue
        if name in _TASK_SPAWNERS or name.endswith(".create_task"):
            out.append(
                Finding(
                    ctx.path, node.lineno, node.col_offset,
                    "ASY103", "dropped-task",
                    f"result of `{name}` dropped: the event loop keeps "
                    "only a weak reference — retain the task (registry "
                    "or add_done_callback) so it cannot be GC'd "
                    "mid-flight",
                )
            )
    return out


def _is_broad(handler_type: ast.AST | None) -> str | None:
    """Return the offending spelling if the except clause is broad."""
    if handler_type is None:
        return "bare except"
    name = dotted(handler_type)
    if name in ("Exception", "BaseException", "builtins.Exception",
                "builtins.BaseException"):
        return f"except {name}"
    if isinstance(handler_type, ast.Tuple):
        for el in handler_type.elts:
            broad = _is_broad(el)
            if broad is not None:
                return broad
    return None


def _mentions_cancelled(handler_type: ast.AST | None) -> bool:
    if handler_type is None:
        return False
    if isinstance(handler_type, ast.Tuple):
        return any(_mentions_cancelled(e) for e in handler_type.elts)
    name = dotted(handler_type) or ""
    return name.endswith("CancelledError")


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(
        isinstance(n, ast.Raise) for n in walk_in_function(handler)
    )


@rule(
    "ASY104",
    "broad-except-in-async",
    "broad except around awaited code can swallow cancellation and "
    "shutdown errors; catch narrowly or re-raise CancelledError first",
)
def broad_except_in_async(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for fn in _async_defs(ctx.tree):
        for node in walk_in_function(fn):
            if not isinstance(node, ast.Try):
                continue
            if not any(body_awaits(stmt) for stmt in node.body):
                continue
            cancelled_handled = False
            for handler in node.handlers:
                # A NARROW CancelledError handler means cancellation
                # was explicitly considered (re-raise, or the
                # sanctioned `except CancelledError: pass` after a
                # self-cancel); a broad handler whose tuple merely
                # names CancelledError still swallows it and stays
                # flagged.
                broad = _is_broad(handler.type)
                if _mentions_cancelled(handler.type) and broad is None:
                    cancelled_handled = True
                if (
                    broad is None
                    or cancelled_handled
                    or _reraises(handler)
                ):
                    continue
                # bare / BaseException / a tuple naming CancelledError
                # literally swallow cancellation; `except Exception`
                # does NOT on py3.8+ (CancelledError is BaseException)
                # but still hides every shutdown-adjacent error
                swallows_cancel = broad != "except Exception" or (
                    _mentions_cancelled(handler.type)
                )
                if swallows_cancel:
                    why = (
                        "swallows asyncio.CancelledError — shutdown "
                        "hangs while this handler eats the cancel"
                    )
                else:
                    why = (
                        "hides every error indiscriminately (the task "
                        "keeps running on state the failed await left "
                        "behind); catch narrowly, or add `except "
                        "asyncio.CancelledError: raise` above it to "
                        "record cancellation intent"
                    )
                out.append(
                    Finding(
                        ctx.path, handler.lineno, handler.col_offset,
                        "ASY104", "broad-except-in-async",
                        f"{broad} around awaited code in `async def "
                        f"{fn.name}` {why}",
                    )
                )
    return out


def _lockish(expr: ast.AST) -> str | None:
    name = dotted(expr)
    if name is None and isinstance(expr, ast.Call):
        name = dotted(expr.func)
    if name is None:
        return None
    low = name.lower()
    # segment match, not substring: `block_store`/`unblock` must not
    # read as locks in a blockchain codebase
    segments = [s for part in low.split(".") for s in part.split("_")]
    if (
        "lock" in segments
        or "rlock" in segments
        or "mutex" in segments
        or low.endswith(".acquire")
    ):
        return name
    return None


@rule(
    "ASY105",
    "sync-lock-across-await",
    "a threading lock held across an await point deadlocks the loop "
    "the moment a second task contends for it",
)
def sync_lock_across_await(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for fn in _async_defs(ctx.tree):
        for node in walk_in_function(fn):
            if not isinstance(node, ast.With):
                continue
            held = [
                n
                for item in node.items
                if (n := _lockish(item.context_expr)) is not None
            ]
            if not held:
                continue
            if any(body_awaits(stmt) for stmt in node.body):
                out.append(
                    Finding(
                        ctx.path, node.lineno, node.col_offset,
                        "ASY105", "sync-lock-across-await",
                        f"`with {held[0]}` spans an await in `async def "
                        f"{fn.name}`: the loop thread parks inside the "
                        "critical section — use asyncio.Lock with "
                        "`async with`",
                    )
                )
    return out


# ABCI application-surface methods (abci/types.py Application + the
# fork's app-mempool/batch extensions): a synchronous call to any of
# these inside a reactor's receive() runs an app round-trip on the
# event loop — every peer connection stalls behind one tx.
_ABCI_SYNC_METHODS = {
    "check_tx",
    "check_tx_batch",
    "insert_tx",
    "reap_txs",
    "query",
    "info",
    "echo",
    "init_chain",
    "prepare_proposal",
    "process_proposal",
    "extend_vote",
    "verify_vote_extension",
    "finalize_block",
    "commit",
    "list_snapshots",
    "offer_snapshot",
    "load_snapshot_chunk",
    "apply_snapshot_chunk",
}

# receiver spellings that mark the call as an ABCI/mempool path
# (name-based like the other rules: `self.mempool.check_tx`,
# `self.proxy.query`, `env.proxy.mempool.check_tx`, ...)
_ABCI_RECEIVER_SEGMENTS = {"proxy", "mempool", "app", "abci", "client"}


def _reactor_classes(tree: ast.Module) -> Iterator[ast.ClassDef]:
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        names = [node.name] + [
            b for base in node.bases if (b := dotted(base)) is not None
        ]
        if any(n.endswith("Reactor") for n in names):
            yield node


@rule(
    "ASY108",
    "sync-abci-in-receive",
    "a synchronous ABCI proxy/mempool call inside a reactor receive() "
    "blocks the p2p event loop on an app round-trip; enqueue to the "
    "mempool ingest plane or offload via asyncio.to_thread",
)
def sync_abci_in_receive(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for cls in _reactor_classes(ctx.tree):
        for fn in cls.body:
            # receive() is a SYNC callback by contract; an async
            # variant would be a different bug (the switch never
            # awaits it) caught by ASY102 at the call site
            if not (
                isinstance(fn, ast.FunctionDef) and fn.name == "receive"
            ):
                continue
            for node in walk_in_function(fn):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                if name is None or "." not in name:
                    continue
                parts = name.split(".")
                if parts[-1] not in _ABCI_SYNC_METHODS:
                    continue
                recv_segments = {
                    s
                    for part in parts[:-1]
                    for s in part.lower().split("_")
                }
                if not recv_segments & _ABCI_RECEIVER_SEGMENTS:
                    continue
                out.append(
                    Finding(
                        ctx.path, node.lineno, node.col_offset,
                        "ASY108", "sync-abci-in-receive",
                        f"`{name}` inside `{cls.name}.receive`: a "
                        "synchronous ABCI call on the p2p dispatch "
                        "path stalls every peer behind one app "
                        "round-trip — enqueue (mempool/ingest.py) or "
                        "offload to a thread",
                    )
                )
    return out


# hot-plane packages where an UNBOUNDED asyncio queue is a latent
# OOM + latency bomb: producers outrun a stalled consumer silently
# until the process dies. Bounded queues shed-and-count instead
# (obs/queues.py). Path prefixes, posix-style, relative to the scanned
# package (astutil.package_path), so they hold in both trees.
_HOT_PLANE_PREFIXES = (
    "mempool/",
    "p2p/",
    "lp2p/",
    "blocksync/",
    "consensus/",
    "rpc/",
    "statesync/",
    "types/",
    "obs/",
)

# constructor spellings that create an asyncio-queue-like object
_QUEUE_CTORS = ("Queue", "LifoQueue", "PriorityQueue", "InstrumentedQueue")


def _unbounded_queue_call(node: ast.Call) -> str | None:
    """Return the offending ctor spelling if this call builds an
    unbounded asyncio queue (no maxsize, or a literal 0)."""
    name = dotted(node.func)
    if name is None:
        return None
    last = name.rsplit(".", 1)[-1]
    if last not in _QUEUE_CTORS:
        return None
    if last != "InstrumentedQueue" and not name.startswith("asyncio."):
        # only the unambiguous asyncio spelling and our own wrapper:
        # bare Queue()/LifoQueue()/PriorityQueue() could be the sync
        # queue module's (thread-safe, a different concern), and
        # queue.Queue/multiprocessing.Queue are definitely not ours
        return None
    size = None
    if node.args:
        size = node.args[0]
    for kw in node.keywords:
        if kw.arg == "maxsize":
            size = kw.value
    if size is None:
        return name
    if isinstance(size, ast.Constant) and size.value in (0, None):
        return name
    return None


@rule(
    "ASY109",
    "unbounded-queue-in-hot-plane",
    "an asyncio.Queue() with no maxsize in a hot-plane module grows "
    "without bound when its consumer stalls; bound it and shed-and-"
    "count (obs/queues.InstrumentedQueue)",
)
def unbounded_queue_in_hot_plane(ctx: FileContext) -> List[Finding]:
    if not in_planes(ctx.path, _HOT_PLANE_PREFIXES):
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = _unbounded_queue_call(node)
        if name is not None:
            out.append(
                Finding(
                    ctx.path, node.lineno, node.col_offset,
                    "ASY109", "unbounded-queue-in-hot-plane",
                    f"`{name}(...)` without a maxsize in a hot-plane "
                    "module: a stalled consumer grows it until OOM "
                    "and every queued item adds tail latency — pass "
                    "a bound (shed-and-count under overload, "
                    "obs/queues.py)",
                )
            )
    return out


# shutdown-path function names covered by ASY110: these are the
# teardown entry points whose hang IS the wedge class (a stop chain
# awaiting a sub-plane that never returns — see obs/shutdown.py)
_STOP_NAMES = {
    "stop", "_stop", "close", "_close", "aclose", "shutdown",
    "_shutdown", "_halt", "kill", "crash",
}

# awaited spellings that are bounded by construction
_BOUNDED_AWAITS = {"asyncio.wait_for", "asyncio.sleep"}


def _stop_await_allowed(node: ast.Await) -> bool:
    """True when the awaited expression is bounded: asyncio.wait_for /
    sleep, asyncio.wait WITH a timeout, a ShutdownGuard ``.stage``
    hop, or delegation to another covered shutdown method on self/cls
    (which this rule lints on its own)."""
    value = node.value
    if not isinstance(value, ast.Call):
        return False  # bare `await task` / `await fut`: unbounded
    name = dotted(value.func)
    if name is None:
        return False
    if name in _BOUNDED_AWAITS:
        return True
    if name == "asyncio.wait":
        return any(kw.arg == "timeout" for kw in value.keywords)
    if name.endswith(".stage"):
        return True  # obs/shutdown.ShutdownGuard budgeted stage
    parts = name.split(".")
    if (
        len(parts) == 2
        and parts[0] in ("self", "cls")
        and parts[1] in _STOP_NAMES
    ):
        return True  # stop() -> self._halt(): the inner one is linted
    return False


@rule(
    "ASY110",
    "unbounded-await-in-stop",
    "an unbounded await inside a stop()/_shutdown()/close() path of a "
    "hot-plane module can wedge the whole teardown when the awaited "
    "plane hangs; bound it (asyncio.wait_for / ShutdownGuard.stage) "
    "or document the suppression",
)
def unbounded_await_in_stop(ctx: FileContext) -> List[Finding]:
    prefixes = _HOT_PLANE_PREFIXES + (
        "node/",
        "chaos/",
    )
    if not in_planes(ctx.path, prefixes):
        return []
    out: List[Finding] = []
    for fn in _async_defs(ctx.tree):
        if fn.name not in _STOP_NAMES:
            continue
        for node in walk_in_function(fn):
            if not isinstance(node, ast.Await):
                continue
            if _stop_await_allowed(node):
                continue
            what = (
                dotted(node.value.func)
                if isinstance(node.value, ast.Call)
                else None
            )
            out.append(
                Finding(
                    ctx.path, node.lineno, node.col_offset,
                    "ASY110", "unbounded-await-in-stop",
                    f"unbounded `await {what or '<expr>'}` in shutdown "
                    f"path `async def {fn.name}`: if the awaited plane "
                    "hangs, teardown wedges with the loop alive and "
                    "store fds open — wrap in asyncio.wait_for (or a "
                    "ShutdownGuard.stage with a budget), or suppress "
                    "with a comment documenting why it cannot hang",
                )
            )
    return out


# The ONLY sanctioned direct-fsync site in the hot planes: the WAL's
# group-commit seam (consensus/wal.py flush_sync + repair paths),
# where barriers coalesce and the disk stall runs off-loop. A direct
# os.fsync anywhere else in a hot plane is a serial disk stall the
# seam exists to absorb — and on the consensus loop it parks every
# peer at once.
_FSYNC_SEAM_FILES = ("consensus/wal.py",)


@rule(
    "ASY111",
    "direct-fsync-in-hot-plane",
    "a direct os.fsync in a hot-plane module outside the WAL "
    "group-commit seam is a serial disk stall on a latency-critical "
    "path; route the barrier through consensus/wal.py (write_sync / "
    "write_group) or move it off-plane",
)
def direct_fsync_in_hot_plane(ctx: FileContext) -> List[Finding]:
    if not in_planes(ctx.path, _HOT_PLANE_PREFIXES):
        return []
    if package_path(ctx.path) in _FSYNC_SEAM_FILES:
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        if dotted(node.func) != "os.fsync":
            continue
        out.append(
            Finding(
                ctx.path, node.lineno, node.col_offset,
                "ASY111", "direct-fsync-in-hot-plane",
                "`os.fsync` in a hot-plane module outside the WAL "
                "group-commit seam: each call is a serial disk "
                "barrier on a latency-critical path (and a loop "
                "stall when called from the consensus/p2p loop) — "
                "write through consensus/wal.py's write_sync/"
                "write_group seam, or move the fsync off-plane",
            )
        )
    return out


# Reconnect paths live in the p2p planes (both switch flavors).
_RECONNECT_PREFIXES = ("p2p/", "lp2p/")


def _awaits_dial(loop_node: ast.AST) -> bool:
    """True when the loop body awaits a dial-ish call (last dotted
    segment contains "dial": dial, dial_peer, _try_dial, redial)."""
    for n in walk_in_function(loop_node):
        if not (
            isinstance(n, ast.Await) and isinstance(n.value, ast.Call)
        ):
            continue
        name = dotted(n.value.func)
        if name is not None and "dial" in name.rsplit(".", 1)[-1]:
            return True
    return False


def _finite_loop(node: ast.AST) -> str | None:
    """The offending spelling if this loop runs a FINITE attempt
    schedule: ``for ... in range(...)`` or ``while <counter compare>``
    (``while True`` is unbounded and fine)."""
    if isinstance(node, (ast.For, ast.AsyncFor)):
        it = node.iter
        if isinstance(it, ast.Call) and dotted(it.func) == "range":
            return "for ... in range(...)"
        return None
    if isinstance(node, ast.While) and isinstance(node.test, ast.Compare):
        return "while <attempt bound>"
    return None


@rule(
    "ASY112",
    "finite-reconnect-give-up",
    "a bounded attempt loop around a p2p dial that abandons a "
    "persistent peer when the budget runs out: a healed partition can "
    "then never re-converge — hand the peer to the reconnect plane's "
    "slow lane instead (p2p/reconnect.py)",
)
def finite_reconnect_give_up(ctx: FileContext) -> List[Finding]:
    if not in_planes(ctx.path, _RECONNECT_PREFIXES):
        return []
    out: List[Finding] = []
    for fn in _async_defs(ctx.tree):
        # a slow-lane handoff anywhere in the function means the
        # budget is a LANE TRANSITION, not a give-up — the exact
        # pattern the reconnect plane's fast lane uses
        hands_off = any(
            isinstance(n, ast.Call)
            and "slow_lane" in (dotted(n.func) or "")
            for n in walk_in_function(fn)
        )
        if hands_off:
            continue
        for node in walk_in_function(fn):
            spelling = _finite_loop(node)
            if spelling is None or not _awaits_dial(node):
                continue
            out.append(
                Finding(
                    ctx.path, node.lineno, node.col_offset,
                    "ASY112", "finite-reconnect-give-up",
                    f"`{spelling}` dial loop in `async def {fn.name}` "
                    "gives up on the peer when the budget runs out — "
                    "a healed partition minority then stays isolated "
                    "FOREVER (the liveness hole the chaos matrix "
                    "found); park the peer in the reconnect plane's "
                    "slow lane (never-give-up sweep) when the fast "
                    "budget is spent",
                )
            )
    return out


@rule(
    "ASY106",
    "nested-event-loop",
    "asyncio.run / run_until_complete inside an async def always "
    "raises or deadlocks: a loop is already running on this thread",
)
def nested_event_loop(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    for fn in _async_defs(ctx.tree):
        for node in walk_in_function(fn):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name is None:
                continue
            if name == "asyncio.run" or name.endswith(
                ".run_until_complete"
            ):
                out.append(
                    Finding(
                        ctx.path, node.lineno, node.col_offset,
                        "ASY106", "nested-event-loop",
                        f"`{name}` inside `async def {fn.name}`: a "
                        "loop is already running — await the coroutine "
                        "directly",
                    )
                )
    return out


# the commit-verify entry points that must ride the shared serving
# seam when called from light/ (ASY113): signature work here fans out
# per SESSION, so a bare call re-pays crypto a thousand times over
_LIGHT_VERIFY_NAMES = {
    "verify_commit",
    "verify_commit_light",
    "verify_commit_light_trusting",
    "verify_commits_coalesced",
    "verify_commit_jobs_coalesced",
}

_LIGHT_PKG = "light/"


@rule(
    "ASY113",
    "uncoalesced-verify-in-light",
    "a commit signature verification in light/ that bypasses the "
    "shared cache / coalesce seam: per-request crypto multiplies by "
    "the session count on the serving plane (light/serving.py)",
)
def uncoalesced_verify_in_light(ctx: FileContext) -> List[Finding]:
    path = ctx.path.replace("\\", "/")
    if not in_planes(path, (_LIGHT_PKG,)) and not path.startswith(_LIGHT_PKG):
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func) or ""
        parts = name.split(".")
        if parts[-1] not in _LIGHT_VERIFY_NAMES:
            continue
        # calls ON the coalescing engine ARE the seam (the engine
        # owns the shared cache + batch window)
        if any("engine" in p for p in parts[:-1]):
            continue
        if any(
            kw.arg in ("cache", "engine") and not (
                isinstance(kw.value, ast.Constant)
                and kw.value.value is None
            )
            for kw in node.keywords
        ):
            continue
        out.append(
            Finding(
                ctx.path, node.lineno, node.col_offset,
                "ASY113", "uncoalesced-verify-in-light",
                f"`{name}` in light/ verifies per-request, bypassing "
                "the shared cache/coalesce seam — pass the shared "
                "SignatureCache (cache=...) or route through the "
                "serving plane's CoalescedCommitVerifier "
                "(light/serving.py): on the serving plane this "
                "crypto multiplies by the session count",
            )
        )
    return out


# Storage-plane packages where a scan-driven delete loop is the
# crash-consistency + latency hazard ASY120 targets (the hot planes
# plus the stores the retention plane prunes).
_ASY120_PREFIXES = _HOT_PLANE_PREFIXES + (
    "store/",
    "state/",
    "evidence/",
    "light/",
)

# iterator spellings that walk a DB keyspace: a loop over one of
# these has data-dependent (unbounded) trip count by construction
_DB_SCAN_NAMES = {"iter_prefix", "iter_range", "iter_all"}


def _scan_driven(iter_expr: ast.expr) -> str | None:
    """The scan spelling when ``for ... in <iter_expr>`` walks a DB
    keyspace (directly, or through list()/sorted()/enumerate())."""
    for node in ast.walk(iter_expr):
        if isinstance(node, ast.Call):
            name = dotted(node.func) or ""
            last = name.rsplit(".", 1)[-1]
            if last in _DB_SCAN_NAMES:
                return name
    return None


@rule(
    "ASY120",
    "unbounded-delete-in-hot-plane",
    "a DB-scan loop issuing one-at-a-time .delete() calls in a "
    "storage/hot-plane module: unbounded trip count, and a crash "
    "mid-loop leaves partial deletes with no base marker — "
    "accumulate and commit ONE atomic write_batch (deletes + marker "
    "advance together), sliced in bounded steps (store/retention.py)",
)
def unbounded_delete_in_hot_plane(ctx: FileContext) -> List[Finding]:
    if not in_planes(ctx.path, _ASY120_PREFIXES):
        return []
    out: List[Finding] = []
    for loop in ast.walk(ctx.tree):
        if not isinstance(loop, ast.For):
            continue
        scan = _scan_driven(loop.iter)
        if scan is None:
            continue
        for node in ast.walk(loop):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func) or ""
            if not name.endswith(".delete"):
                continue
            out.append(
                Finding(
                    ctx.path, node.lineno, node.col_offset,
                    "ASY120", "unbounded-delete-in-hot-plane",
                    f"`{name}(...)` inside a loop over `{scan}`: the "
                    "scan's trip count is data-dependent (every row "
                    "under the prefix) and each delete is an "
                    "independent write — a crash mid-loop strands "
                    "partial deletes with no marker recording how far "
                    "it got, and the store lock is held for the whole "
                    "scan. Collect doomed keys, then commit deletes + "
                    "base-marker advance in ONE bounded write_batch "
                    "(the store/retention.py slicing discipline)",
                )
            )
    return out


# Verify-consumer planes that must dispatch signature batches through
# the unified scheduler (crypto/scheduler.py) rather than building
# their own BatchVerifier / reaching the parallel-verify pool
# directly: a bypass verifies OUTSIDE the priority classes, so a
# catch-up storm it spawns can starve the live round the scheduler
# exists to protect (ASY121). The sanctioned seams are crypto/ itself
# and types/validation (the choke point every plane submits through).
_ASY121_PREFIXES = (
    "consensus/",
    "blocksync/",
    "light/",
    "statesync/",
    "evidence/",
)

# direct-construction spellings of the batch-verifier backends plus
# the factory; any of these in a hot plane is an unscheduled verify
_ASY121_CTORS = {
    "CpuBatchVerifier",
    "CpuParallelBatchVerifier",
    "TpuBatchVerifier",
    "CudaBatchVerifier",
    "MeshBatchVerifier",
    "create_batch_verifier",
}


@rule(
    "ASY121",
    "verify-bypass-scheduler",
    "a hot-plane module (consensus/blocksync/light/statesync/"
    "evidence) constructing a BatchVerifier or reaching the "
    "parallel-verify pool directly: signature work dispatched outside "
    "the unified scheduler's priority classes can starve the live "
    "round — submit through crypto/scheduler.py (the types/validation "
    "seam does this for every commit-verify entry point)",
)
def verify_bypass_scheduler(ctx: FileContext) -> List[Finding]:
    if not in_planes(ctx.path, _ASY121_PREFIXES):
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func) or ""
        parts = name.split(".")
        offending = None
        if parts[-1] in _ASY121_CTORS:
            offending = parts[-1]
        elif "parallel_verify" in parts[:-1]:
            # parallel_verify.engine() / .dispatch_stats_if_running()
            # etc: stats reads are harmless but verification through
            # the raw pool bypasses the classes — route the batch via
            # the scheduler and read stats through obs/queues.py
            if not parts[-1].endswith("_if_running"):
                offending = name
        if offending is None:
            continue
        out.append(
            Finding(
                ctx.path, node.lineno, node.col_offset,
                "ASY121", "verify-bypass-scheduler",
                f"`{name}(...)` verifies outside the unified "
                "scheduler: this plane's batches must submit through "
                "crypto/scheduler.py (priority class "
                "live/light/catchup) or the types/validation seam — "
                "a direct backend verify here shares no queue with "
                "the live round and can starve it",
            )
        )
    return out


# Fleet code that serves a request off a replica's serving plane
# without going through SessionRouter admission (ASY122): the router
# is the ONE seam that holds the fleet's invariants — gate admission
# (counted sheds, bounded waits), consistency tokens (never serve
# below the token), lag-aware degradation and failover accounting. A
# direct plane call from fleet/ code serves unadmitted, untokened and
# uncounted. The sanctioned module is router.py itself; plane
# lifecycle calls (drain/resume/stats/register_queues) are not
# serving and stay clean.
_ASY122_PREFIX = "fleet/"
_ASY122_ROUTER_SEAM = "router.py"

# serving entry points on the plane/cache/session objects; "serve" is
# matched only through an explicit plane receiver so unrelated
# `.serve()` spellings elsewhere in fleet code don't false-positive
_ASY122_SERVE_CALLS = {"open_session", "verified_block", "get_or_verify"}


@rule(
    "ASY122",
    "serve-bypass-router",
    "fleet/ code reaching a replica's serving plane directly "
    "(open_session / verified_block / get_or_verify / "
    "light_plane.serve) instead of going through SessionRouter "
    "admission: a bypass serves unadmitted (no gate, no counted "
    "shed), untokened (can serve below a consistency token) and "
    "invisible to lag degradation/failover — route through "
    "router.serve_light / route_light / subscribe",
)
def serve_bypass_router(ctx: FileContext) -> List[Finding]:
    path = ctx.path.replace("\\", "/")
    if not in_planes(path, (_ASY122_PREFIX,)) or path.endswith(
        "/" + _ASY122_ROUTER_SEAM
    ):
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func) or ""
        parts = name.split(".")
        offending = None
        if parts[-1] in _ASY122_SERVE_CALLS:
            offending = parts[-1]
        elif parts[-1] == "serve" and any(
            "plane" in p for p in parts[:-1]
        ):
            offending = name
        if offending is None:
            continue
        out.append(
            Finding(
                ctx.path, node.lineno, node.col_offset,
                "ASY122", "serve-bypass-router",
                f"`{name}(...)` reaches the serving plane without "
                "SessionRouter admission: fleet code must serve "
                "through the router seam (serve_light / route_light "
                "/ subscribe) so the request is gate-admitted, "
                "token-checked and counted by lag/failover "
                "accounting",
            )
        )
    return out
