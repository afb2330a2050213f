"""Interprocedural async-safety rules (whole-program pass).

These run over the callgraph.Project model (symbol table + inferred
attribute types + project call graph), so they see through the exact
blind spot docs/LINT.md documented for the single-file pass: "a
deeper chain like ``self.pool.stop()`` targets an object whose
methods the single-file pass cannot see".

- **ASY114 transitive-blocking-call** — a sync helper that blocks
  (time.sleep, sync socket/sqlite/subprocess, fsync) reachable from
  an ``async def`` in a hot plane through ANY call chain. The direct
  form is ASY101; this is the same loop stall hidden one or more
  frames down.
- **ASY115 await-holding-lock** — blocking work reached while a lock
  is held (``with <threading lock>`` or ``async with <asyncio
  lock>``), directly or through sync callees: the exact shape of the
  fsync-held-inside-the-append-lock 10x liveness loss. The
  direct await-under-sync-lock form is ASY105; this rule adds the
  interprocedural (and the async-lock) half.
- **ASY102 (deep-chain upgrade)** — ``self.pool.stop()`` as a bare
  statement where attribute-type inference proves ``stop`` is an
  ``async def``: the coroutine is created and dropped, it never
  runs. Reported under the same id as the single-file ASY102.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional

from ..astutil import dotted, in_planes
from ..callgraph import BLOCKING_LEAVES, Project, walk_with_lambdas
from ..findings import Finding
from ..registry import project_rule
from .async_rules import _HOT_PLANE_PREFIXES, _lockish

# where a transitively-blocking call from async context is a
# hot-plane loop stall (ASY109's package list + node/: the node's
# start/shutdown paths run on the same loop as every reactor)
_ASY114_PREFIXES = _HOT_PLANE_PREFIXES + ("node/",)


def _in_scope(path: str, prefixes) -> bool:
    return in_planes(path, prefixes)


def _region_nodes(with_node) -> Iterator[ast.AST]:
    """Every node executed while the with-block's locks are held
    (lambda bodies included, nested defs excluded)."""
    for stmt in with_node.body:
        yield stmt
        yield from walk_with_lambdas(stmt)


def _chain_msg(project: Project, first_spelling: str,
               callee_qual: str) -> Optional[str]:
    chain = project.blocking_chain(callee_qual)
    if chain is None:
        return None
    site = project.blocking_site(callee_qual)
    reason = f" ({site.reason})" if site is not None else ""
    return " -> ".join([f"`{first_spelling}`"] + chain) + reason


@project_rule(
    "ASY114",
    "transitive-blocking-call",
    "a sync helper that blocks (sleep / sync I/O / subprocess / "
    "fsync) is reachable from an async def in a hot plane through a "
    "call chain; the loop stalls exactly as if the blocking call "
    "were inline (ASY101), it is just hidden N frames down",
)
def transitive_blocking_call(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for fi in project.functions.values():
        if not fi.is_async or not _in_scope(fi.path, _ASY114_PREFIXES):
            continue
        for cs in fi.calls:
            callee = project.functions.get(cs.callee)
            if callee is None or callee.is_async:
                continue  # async callee blocks are ITS findings
            msg = _chain_msg(project, cs.spelling, cs.callee)
            if msg is None:
                continue
            out.append(
                Finding(
                    fi.path, cs.line, cs.col,
                    "ASY114", "transitive-blocking-call",
                    f"call chain from `async def {fi.name}` reaches "
                    f"a blocking call: {msg} — the event loop parks "
                    "for the whole chain; offload the blocking leaf "
                    "(asyncio.to_thread / executor) or make the "
                    "helper loop-safe",
                )
            )
    return out


def _lock_regions(fi) -> Iterator[tuple]:
    """(with_node, lock_spelling, is_async_lock) for every lock-ish
    with-block in this function."""
    for node in walk_with_lambdas(fi.node):
        if not isinstance(node, (ast.With, ast.AsyncWith)):
            continue
        held = [
            n
            for item in node.items
            if (n := _lockish(item.context_expr)) is not None
        ]
        if held:
            yield node, held[0], isinstance(node, ast.AsyncWith)


@project_rule(
    "ASY115",
    "await-holding-lock",
    "blocking work (sleep / sync I/O / fsync) runs while a lock is "
    "held — directly or through sync callees. Every other "
    "acquirer (and with an asyncio lock, every waiter's task) "
    "queues behind the stall: the fsync-inside-the-append-"
    "lock shape, worth 10x liveness",
)
def await_holding_lock(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for fi in project.functions.values():
        if not _in_scope(fi.path, _ASY114_PREFIXES):
            continue
        local_types = None
        for with_node, lock_name, is_async_lock in _lock_regions(fi):
            kind = "async lock" if is_async_lock else "lock"
            for node in _region_nodes(with_node):
                if not isinstance(node, ast.Call):
                    continue
                name = dotted(node.func)
                if name in BLOCKING_LEAVES:
                    if project._sanctioned(fi.path, node.lineno):
                        continue  # sanctioned sink: same contract as
                        # chains through it (docs/LINT.md)
                    out.append(
                        Finding(
                            fi.path, node.lineno, node.col_offset,
                            "ASY115", "await-holding-lock",
                            f"`{name}` ({BLOCKING_LEAVES[name]}) "
                            f"while `{lock_name}` ({kind}) is held "
                            f"in `{fi.name}`: every contender queues "
                            "behind the stall — move the blocking "
                            "work outside the critical section "
                            "(the WAL seam fsyncs on a dup'd fd "
                            "OUTSIDE its append lock for exactly "
                            "this reason)",
                        )
                    )
                    continue
                if local_types is None:
                    local_types = project._local_var_types(fi)
                callee = project.resolve_call(fi, node, local_types)
                if callee is None or callee.is_async:
                    continue
                msg = _chain_msg(
                    project, name or callee.name, callee.qualname
                )
                if msg is None:
                    continue
                out.append(
                    Finding(
                        fi.path, node.lineno, node.col_offset,
                        "ASY115", "await-holding-lock",
                        f"call chain {msg} runs while `{lock_name}` "
                        f"({kind}) is held in `{fi.name}`: every "
                        "contender queues behind the blocking leaf "
                        "— move it outside the critical section or "
                        "hand it to the WAL/offload seam",
                    )
                )
    return out


# DB-write leaves by method spelling: a `*.write_batch(...)` /
# `*.executemany(...)` call is a sync disk write regardless of the
# receiver's inferred type (the KV seam is an abstract base, so
# type-resolved chains die at the interface — the spelling doesn't)
_DB_WRITE_SUFFIXES = {
    "write_batch": "is a sync DB batch write",
    "executemany": "is a sync DB write",
    "fsync": "is a disk barrier",
    "fdatasync": "is a disk barrier",
}

# listener BFS bound: chains deeper than this are beyond what a
# reader can audit anyway and the walk must terminate on cycles
_ASY116_MAX_DEPTH = 8


def _listener_blocking_chain(
    project: Project, start, suppressed
) -> Optional[str]:
    """BFS from a sync-listener callback through resolved SYNC
    callees; returns a rendered chain when any reachable function
    contains a blocking leaf (BLOCKING_LEAVES or a DB-write
    spelling), else None. Leaf lines suppressed for ASY116 in their
    own file are sanctioned (same escape-hatch contract as ASY114's
    sinks — justification comment required)."""
    seen = {start.qualname}
    queue = [(start, [f"`{start.name}`"], 0)]
    while queue:
        fn, chain, depth = queue.pop(0)
        for node in walk_with_lambdas(fn.node):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name is None:
                continue
            reason = BLOCKING_LEAVES.get(name) or _DB_WRITE_SUFFIXES.get(
                name.rsplit(".", 1)[-1]
            )
            if reason is None:
                continue
            if suppressed(fn.path, node.lineno):
                continue
            return " -> ".join(chain + [f"`{name}` ({reason})"])
        if depth >= _ASY116_MAX_DEPTH:
            continue
        for cs in fn.calls:
            callee = project.functions.get(cs.callee)
            if (
                callee is None
                or callee.is_async
                or callee.qualname in seen
            ):
                continue
            seen.add(callee.qualname)
            queue.append(
                (callee, chain + [f"`{cs.spelling}`"], depth + 1)
            )
    return None


@project_rule(
    "ASY116",
    "sync-listener-blocking-call",
    "a bus.add_sync_listener callback reaches a blocking leaf (DB "
    "write, fsync, sync I/O) through its call chain: sync listeners "
    "run INSIDE every publish, on the publisher's thread — the "
    "consensus finalize path pays the write. Accumulate in memory "
    "and flush from a bounded async drain instead (the "
    "state/indexer.py shape)",
)
def sync_listener_blocking_call(project: Project) -> List[Finding]:
    def suppressed(path: str, line: int) -> bool:
        return project._suppressed(path, line, "ASY116")

    out: List[Finding] = []
    for fi in project.functions.values():
        for node in walk_with_lambdas(fi.node):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            name = dotted(node.func)
            if name is None or not name.endswith("add_sync_listener"):
                continue
            cb_name = dotted(node.args[0])
            if cb_name is None:
                continue
            cb = project._resolve_dotted(fi, cb_name)
            if cb is None or cb.is_async:
                continue
            msg = _listener_blocking_chain(project, cb, suppressed)
            if msg is None:
                continue
            out.append(
                Finding(
                    fi.path, node.lineno, node.col_offset,
                    "ASY116", "sync-listener-blocking-call",
                    f"sync listener `{cb_name}` registered here "
                    f"reaches a blocking call: {msg} — every "
                    "bus.publish (the consensus finalize path "
                    "included) pays it inline; accumulate in memory "
                    "and flush from a bounded async drain "
                    "(state/indexer.py IndexerService)",
                )
            )
    return out


@project_rule(
    "ASY102",
    "unawaited-coroutine-deep",
    "deep-chain upgrade of ASY102: `self.pool.stop()` as a bare "
    "statement where the inferred attribute types prove `stop` is "
    "an async def — the coroutine is created and dropped, it never "
    "runs (the documented single-file blind spot)",
)
def unawaited_coroutine_deep(project: Project) -> List[Finding]:
    out: List[Finding] = []
    for fi in project.functions.values():
        for node in walk_with_lambdas(fi.node):
            if not (
                isinstance(node, ast.Expr)
                and isinstance(node.value, ast.Call)
            ):
                continue
            call = node.value
            name = dotted(call.func)
            if name is None:
                continue
            parts = name.split(".")
            # exactly the deep chains the single-file rule documents
            # as invisible: `self.a.b()` and deeper (len==2 is the
            # file rule's exact `self.x()` case)
            if parts[0] not in ("self", "cls") or len(parts) < 3:
                continue
            callee = project._resolve_dotted(fi, name)
            if callee is None or not callee.is_async:
                continue
            out.append(
                Finding(
                    fi.path, node.lineno, node.col_offset,
                    "ASY102", "unawaited-coroutine",
                    f"`{name}(...)` resolves (via inferred attribute "
                    f"types) to `async def {callee.name}` — the "
                    "coroutine is created and dropped, it never "
                    "runs; await it or wrap it in a retained task "
                    "(utils.tasks.spawn)",
                )
            )
    return out
