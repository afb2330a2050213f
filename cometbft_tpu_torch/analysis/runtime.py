"""Runtime concurrency sanitizer (a copy of the JAX package's
``analysis/runtime.py``).

Three cooperating guards, one per-process singleton
(``get_sanitizer()``), enabled via ``[instrumentation] sanitizer``
(``config.test_config`` turns it on, so the port's tests run
sanitized; a production node keeps it off; ``node/inprocess.build_node``
enables it before any plane builds its locks):

- **lock-order graph** (``sanitized_lock``): hot-plane locks are
  wrapped at construction time; every acquire records "held A while
  acquiring B" edges keyed by lock NAME (lockdep-style lock classes,
  so an ABBA inversion across two *instances* of the same pair of
  planes still counts — that interleaving is one scheduler decision
  away). A new edge that closes a cycle is a deadlock-potential
  finding carrying BOTH acquisition stacks. Single-threaded
  sequential inversions count too: the graph records ORDER, not
  contention, which is what makes ``inject_lock_inversion``
  deterministic.
- **loop-affinity guard** (``tag``/``touch``/``handoff``): hot-plane
  objects that are loop-affine by design (consensus state, mempool
  pool, the switch peer map) are tagged with their owning thread;
  a touch from a foreign thread without a sanctioned ``handoff``
  context is a finding with the offending stack.
- **stall attribution** (``attribute_frames``): buckets a
  LoopWatchdog flight-record's loop stack by owning subsystem (the
  innermost frame that lives in a known plane package), so a stall
  names the guilty plane, not just a raw stack. The port adds three
  buckets to the JAX planes: ``torch`` (a frame of the torch library:
  a synchronous CUDA call on the loop), ``ops`` and ``kernels``.

Disabled mode is free by construction: ``sanitized_lock`` returns
the raw lock unchanged, ``touch`` is one attribute check, and
nothing else runs. ``snapshot()`` drains nothing: a caller reads the
findings (``chip_smoke.py`` phase 19) and ``reset()``s between runs.

Pure stdlib; importing this module pulls in no torch.
"""
from __future__ import annotations

import contextlib
import threading
import traceback
from collections import deque
from typing import Dict, List, Optional, Set, Tuple

_STACK_LIMIT = 16
_MAX_FINDINGS = 128

# subsystem buckets for stall attribution, matched against the
# directory component of a flight-record frame ("wal.py:254 write"
# frames carry "consensus/wal.py" once obs/watchdog keeps the parent
# dir; bare basenames fall back to the basename table below)
_PLANES = (
    "consensus", "mempool", "p2p", "lp2p", "blocksync", "statesync",
    "rpc", "light", "evidence", "abci", "crypto", "store", "state",
    "chaos", "obs", "trace", "types", "node", "e2e", "privval",
    "utils", "ops", "kernels",
)


class SanitizerFinding:
    """One runtime violation: deadlock potential or affinity breach."""

    __slots__ = ("kind", "message", "detail")

    def __init__(self, kind: str, message: str, detail: dict):
        self.kind = kind
        self.message = message
        self.detail = detail

    def render(self) -> str:
        return f"sanitizer[{self.kind}]: {self.message}"

    def to_json(self) -> dict:
        return {
            "kind": self.kind,
            "message": self.message,
            "detail": self.detail,
        }


def _stack(skip: int = 2) -> List[str]:
    """Compact acquisition stack: innermost-last 'file.py:ln func'."""
    out = []
    for fr in traceback.extract_stack(limit=_STACK_LIMIT + skip)[:-skip]:
        fname = fr.filename.replace("\\", "/")
        parts = fname.rsplit("/", 2)
        short = "/".join(parts[-2:]) if len(parts) > 1 else fname
        out.append(f"{short}:{fr.lineno} {fr.name}")
    return out


class _TLS(threading.local):
    def __init__(self):
        self.held: List[str] = []  # lock names, outermost first
        self.handoffs: Set[str] = set()


class ConcurrencySanitizer:
    """Per-process lock-order + loop-affinity sanitizer (module doc).

    All mutable state is guarded by one internal lock; the internal
    lock is never held while calling out, so the sanitizer itself
    cannot deadlock the planes it watches."""

    def __init__(self) -> None:
        self.enabled = False
        self._mu = threading.Lock()
        self._tls = _TLS()
        # (held, acquiring) -> first-seen stacks for both sides
        self._edges: Dict[Tuple[str, str], dict] = {}
        self._cycles_seen: Set[frozenset] = set()
        self._affinity: Dict[str, dict] = {}  # name -> owner record
        self._affinity_seen: Set[Tuple[str, str]] = set()
        self.findings: "deque[SanitizerFinding]" = deque(
            maxlen=_MAX_FINDINGS
        )
        self.lock_acquires = 0

    # --- lifecycle ----------------------------------------------------

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        """Fresh graph + findings + affinity tags (chaos runs isolate
        per schedule; planes re-tag at their next start, adopt-on-
        first-use owners re-adopt on the run's own thread)."""
        with self._mu:
            self._edges.clear()
            self._cycles_seen.clear()
            self._affinity.clear()
            self._affinity_seen.clear()
            self.findings.clear()

    # --- lock-order graph ---------------------------------------------

    def note_acquire(self, name: str) -> None:
        """Record edges held->name, detect a fresh cycle, push name
        onto this thread's held stack. The fast path (nothing else
        held, or all edges already known) never takes the internal
        mutex: dict reads and the counters are GIL-atomic enough for
        diagnostics; only a NEW edge pays for the lock + stack
        capture + cycle check."""
        tls = self._tls
        held = tls.held
        self.lock_acquires += 1
        if name in held:  # reentrant (RLock): no self-edges
            held.append(name)
            return
        if held:
            for h in held:
                if h == name:
                    continue
                edge = self._edges.get((h, name))
                if edge is not None:
                    edge["count"] += 1
                    continue
                acq_stack = _stack(skip=3)
                with self._mu:
                    if (h, name) in self._edges:
                        self._edges[(h, name)]["count"] += 1
                        continue
                    self._edges[(h, name)] = {
                        "holder": h,
                        "acquirer": name,
                        "stack": acq_stack,
                        "thread": threading.current_thread().name,
                        "count": 1,
                    }
                    self._check_cycle_locked(h, name)
        held.append(name)

    def note_release(self, name: str) -> None:
        held = self._tls.held
        # remove the LAST occurrence (release order can interleave)
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    def _check_cycle_locked(self, src: str, dst: str) -> None:
        """The new edge src->dst closes a cycle iff dst already
        reaches src. DFS over the (small) edge set; report once per
        distinct lock set, with both first-acquisition stacks."""
        path = self._find_path_locked(dst, src)
        if path is None:
            return
        cycle_nodes = frozenset(path + [dst])
        if cycle_nodes in self._cycles_seen:
            return
        self._cycles_seen.add(cycle_nodes)
        fwd = self._edges[(src, dst)]
        # the reverse direction's first edge (dst -> path[1] ... src)
        rev_key = (dst, path[1]) if len(path) > 1 else (dst, src)
        rev = self._edges.get(rev_key, {})
        order = " -> ".join(path + [dst])
        self.findings.append(
            SanitizerFinding(
                "lock-order-cycle",
                f"lock-order inversion: held `{src}` while acquiring "
                f"`{dst}`, but the reverse order `{order}` was also "
                "observed — a deadlock is one unlucky interleaving "
                "away",
                {
                    "locks": sorted(cycle_nodes),
                    "edge": f"{src}->{dst}",
                    "reverse": order,
                    "stack_forward": fwd.get("stack", []),
                    "thread_forward": fwd.get("thread", ""),
                    "stack_reverse": rev.get("stack", []),
                    "thread_reverse": rev.get("thread", ""),
                },
            )
        )

    def _find_path_locked(
        self, start: str, goal: str
    ) -> Optional[List[str]]:
        stack = [(start, [start])]
        seen = {start}
        adj: Dict[str, List[str]] = {}
        for (a, b) in self._edges:
            adj.setdefault(a, []).append(b)
        while stack:
            node, path = stack.pop()
            if node == goal:
                return path
            for nxt in adj.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    stack.append((nxt, path + [nxt]))
        return None

    # --- loop-affinity guard ------------------------------------------

    def tag(self, name: str, owner_ident: Optional[int] = None) -> None:
        """Tag (or re-bind) a hot-plane object as affine to the
        calling (or given) thread — typically called from the plane's
        start() on its event loop."""
        ident = owner_ident or threading.get_ident()
        owner = threading.current_thread().name
        with self._mu:
            self._affinity[name] = {"ident": ident, "name": owner}

    def touch(self, name: str) -> None:
        """Assert the caller is the tagged owner thread (or inside a
        sanctioned handoff). Hot-path contract: callers pre-check
        ``sanitizer.enabled`` so the disabled cost is one attribute
        read."""
        if not self.enabled:
            return
        rec = self._affinity.get(name)
        if rec is None or rec["ident"] == threading.get_ident():
            return
        if name in self._tls.handoffs:
            return
        thread = threading.current_thread().name
        key = (name, thread)
        with self._mu:
            if key in self._affinity_seen:
                return
            self._affinity_seen.add(key)
            self.findings.append(
                SanitizerFinding(
                    "loop-affinity",
                    f"`{name}` (affine to thread "
                    f"`{rec['name']}`) touched from foreign thread "
                    f"`{thread}` without a sanctioned handoff — "
                    "cross-thread mutation of a loop-affine object "
                    "races the event loop",
                    {
                        "object": name,
                        "owner": rec["name"],
                        "thread": thread,
                        "stack": _stack(skip=2),
                    },
                )
            )

    def touch_adopt(self, name: str) -> None:
        """``touch`` with adopt-on-first-use: the first toucher
        becomes the owner (for planes with no explicit start() to tag
        from — the mempool pool's owner is whoever runs commit).
        The adopt is check-then-act under the mutex so two threads
        racing the first touch cannot BOTH adopt (one wins the tag,
        the loser falls through to a real touch and gets flagged)."""
        if not self.enabled:
            return
        adopted = False
        if name not in self._affinity:
            with self._mu:
                if name not in self._affinity:
                    self._affinity[name] = {
                        "ident": threading.get_ident(),
                        "name": threading.current_thread().name,
                    }
                    adopted = True
        if not adopted:
            self.touch(name)

    @contextlib.contextmanager
    def handoff(self, name: str):
        """Mark the calling thread as a SANCTIONED foreign toucher of
        ``name`` for the duration (the executor-drain / recheck-worker
        seams that are cross-thread by design, behind the object's own
        lock)."""
        tls = self._tls
        fresh = name not in tls.handoffs
        if fresh:
            tls.handoffs.add(name)
        try:
            yield
        finally:
            if fresh:
                tls.handoffs.discard(name)

    # --- introspection ------------------------------------------------

    def snapshot(self) -> List[dict]:
        with self._mu:
            return [f.to_json() for f in self.findings]

    def stats(self) -> dict:
        with self._mu:
            return {
                "enabled": self.enabled,
                "lock_acquires": self.lock_acquires,
                "edges": len(self._edges),
                "tagged": sorted(self._affinity),
                "findings": len(self.findings),
            }


class SanitizedLock:
    """Proxy over a threading.Lock/RLock feeding the order graph.

    Forwards the Condition protocol (``_is_owned`` /
    ``_release_save`` / ``_acquire_restore``) so
    ``threading.Condition(sanitized_lock(...))`` keeps exact RLock
    semantics — and keeps the held-stack honest across a
    ``Condition.wait`` (the wait releases the lock; so does the
    bookkeeping)."""

    __slots__ = ("_san", "_lock", "name")

    def __init__(self, san: ConcurrencySanitizer, lock, name: str):
        self._san = san
        self._lock = lock
        self.name = name

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._san.note_acquire(self.name)
        return got

    def release(self) -> None:
        self._lock.release()
        self._san.note_release(self.name)

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        return self._lock.locked()

    # Condition protocol (threading.Condition probes these)
    def _is_owned(self):
        inner = getattr(self._lock, "_is_owned", None)
        if inner is not None:
            return inner()
        if self._lock.acquire(False):
            self._lock.release()
            return False
        return True

    def _release_save(self):
        inner = getattr(self._lock, "_release_save", None)
        state = inner() if inner is not None else self._lock.release()
        self._san.note_release(self.name)
        return state

    def _acquire_restore(self, state) -> None:
        inner = getattr(self._lock, "_acquire_restore", None)
        if inner is not None:
            inner(state)
        else:
            self._lock.acquire()
        self._san.note_acquire(self.name)

    def __repr__(self) -> str:
        return f"<SanitizedLock {self.name} {self._lock!r}>"


# --- process-wide singleton + convenience seams ------------------------

_SANITIZER = ConcurrencySanitizer()


def get_sanitizer() -> ConcurrencySanitizer:
    return _SANITIZER


def enable() -> ConcurrencySanitizer:
    _SANITIZER.enable()
    return _SANITIZER


def disable() -> None:
    _SANITIZER.disable()


def sanitized_lock(lock, name: str):
    """Wrap ``lock`` for the order graph — construction-time decision:
    with the sanitizer disabled the RAW lock comes back, so disabled
    mode costs literally nothing per acquire. Planes call this where
    they build their locks; enablement (node build / chaos / tests)
    happens before plane construction."""
    if not _SANITIZER.enabled:
        return lock
    return SanitizedLock(_SANITIZER, lock, name)


# --- stall attribution -------------------------------------------------

def attribute_frames(frames: List[str]) -> str:
    """Owning subsystem for a flight-record stack (innermost-first
    "dir/file.py:ln func" lines): the innermost frame that lives in a
    known plane package, or in the torch library ("torch/..."), names
    the guilty subsystem."""
    for line in frames:
        head = line.split(":", 1)[0]
        parts = head.replace("\\", "/").split("/")
        if len(parts) >= 2 and parts[0] == "torch":
            # a frame of the torch library (obs/watchdog keeps its path
            # from the library's root): a synchronous CUDA call
            return "torch"
        if len(parts) >= 2 and parts[-2] in _PLANES:
            return parts[-2]
        stem = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
        if stem in _PLANES:
            return stem
    return "unknown"


def attribute_stall(record: dict) -> str:
    """Subsystem bucket for one LoopWatchdog flight record."""
    return attribute_frames(record.get("loop_stack", []))


# --- chaos injection ---------------------------------------------------

def inject_lock_inversion() -> dict:
    """Deterministically exercise BOTH guards (the chaos
    ``lock_inversion`` nemesis action): acquire two sanitizer-named
    locks in A-B then B-A order (the graph records ORDER, so a
    sequential single-threaded demonstration suffices — no timing
    race), and touch a loop-affine probe object from a short-lived
    foreign thread. Returns what was injected and what the sanitizer
    observed."""
    san = _SANITIZER
    if not san.enabled:
        return {"enabled": False}
    la = SanitizedLock(san, threading.Lock(), "chaos.inversion.a")
    lb = SanitizedLock(san, threading.Lock(), "chaos.inversion.b")
    with la:
        with lb:
            pass
    with lb:
        with la:
            pass
    san.tag("chaos.affinity_probe")
    t = threading.Thread(
        target=lambda: san.touch("chaos.affinity_probe"),
        name="chaos-foreign-toucher",
    )
    t.start()
    t.join(5.0)
    kinds = [f.kind for f in san.findings]
    return {
        "enabled": True,
        "injected": ["lock-order-cycle", "loop-affinity"],
        "observed": sorted(
            {
                k for k in kinds
                if k in ("lock-order-cycle", "loop-affinity")
            }
        ),
    }


def injected_finding(f: dict) -> bool:
    """True when a finding came from inject_lock_inversion's probes
    (expected; everything else is a fault)."""
    detail = f.get("detail", {})
    names = list(detail.get("locks", [])) + [
        detail.get("object", "")
    ]
    return any(str(n).startswith("chaos.") for n in names)
