"""Whole-program symbol table + project call graph.

The per-file rules (rules/async_rules.py) see one module at a time,
so a chain like ``self.pool.stop()`` — an object whose methods live
in another file — is invisible to them (docs/LINT.md documented the
blind spot explicitly). This module builds the interprocedural model
the deeper ASY rules need:

- a **symbol table** over every scanned module: classes with their
  methods (decorators do not hide a def), module-level functions,
  nested defs, and per-module import aliases;
- **attribute-type inference** from ``__init__`` assignments:
  ``self.pool = BlockPool(...)`` types ``self.pool`` as
  ``BlockPool``; an annotated parameter stored on self
  (``def __init__(self, wal: WAL): self.wal = wal``) and
  ``self.x: Foo`` annotations type the same way;
- a **call graph**: one edge per resolved call expression, with the
  source location, the written spelling, and whether the call was
  awaited. Resolution handles ``self``/``cls`` chains through the
  inferred attribute types, inheritance + ``super()`` dispatch,
  imported names, class constructors (edge to ``__init__``),
  ``functools.partial(f, ...)`` (edge to ``f``), and lambda bodies
  (a lambda's callees are attributed to the enclosing function).

Everything is name-based and best-effort, like the rest of bftlint:
an unresolvable call simply creates no edge, so the interprocedural
rules under-approximate rather than guess. Pure stdlib — importing
this module must never pull in torch or jax.

Reachability helpers answer the question the rules ask: *can this
function, executed synchronously, hit a blocking call* — traversing
only sync callees (calling an ``async def`` without awaiting it
executes nothing) and stopping at offload seams (a function
reference passed to ``asyncio.to_thread`` / ``run_in_executor`` /
``Thread(target=...)`` is an argument, not a call, so no edge exists
in the first place).
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Set, Tuple

from .astutil import dotted

# Sync calls that block the calling thread: the ASY101 name set plus
# the barrier-ish leaves that only matter through a call chain (a
# direct os.fsync on a hot plane is ASY111's business; REACHED from
# an async def it is a loop stall regardless of module).
BLOCKING_LEAVES: Dict[str, str] = {
    "time.sleep": "blocks the thread",
    "os.system": "blocks on a subprocess",
    "os.wait": "blocks on a subprocess",
    "os.waitpid": "blocks on a subprocess",
    "os.fsync": "is a disk barrier",
    "os.fdatasync": "is a disk barrier",
    "subprocess.run": "blocks on a subprocess",
    "subprocess.call": "blocks on a subprocess",
    "subprocess.check_call": "blocks on a subprocess",
    "subprocess.check_output": "blocks on a subprocess",
    "urllib.request.urlopen": "does sync network I/O",
    "requests.get": "does sync network I/O",
    "requests.post": "does sync network I/O",
    "requests.put": "does sync network I/O",
    "requests.delete": "does sync network I/O",
    "requests.request": "does sync network I/O",
    "socket.create_connection": "does sync network I/O",
    "socket.getaddrinfo": "does sync DNS resolution",
    "sqlite3.connect": "does sync disk I/O",
    "select.select": "blocks on file descriptors",
}

# method-suffix leaves: a blocking call regardless of receiver
# spelling (``<ticket>.wait()``, ``<thread>.join()``, ``<proc>
# .communicate()``); ``.wait`` / ``.join`` need a lock/thread-ish or
# event-ish receiver to avoid flagging asyncio.Event().wait-style
# awaitables — we require the call NOT be awaited at the site, which
# the index records, and leave the judgment to the rule.
BLOCKING_METHOD_SUFFIXES: Dict[str, str] = {
    "getaddrinfo": "does sync DNS resolution",
}


@dataclass
class CallSite:
    """One resolved call expression inside a function body."""

    callee: str  # qualname of the resolved FunctionInfo
    spelling: str  # the dotted source spelling, e.g. "self.pool.stop"
    line: int
    col: int
    awaited: bool


@dataclass
class BlockingSite:
    """One known-blocking leaf call inside a function body."""

    spelling: str
    reason: str
    line: int
    col: int


@dataclass
class FunctionInfo:
    qualname: str  # "path::Class.name" / "path::name" / nested "a.<locals>.b"
    name: str
    path: str
    node: ast.AST  # FunctionDef | AsyncFunctionDef
    is_async: bool
    class_name: Optional[str] = None
    calls: List[CallSite] = field(default_factory=list)
    blocking: List[BlockingSite] = field(default_factory=list)


@dataclass
class ClassInfo:
    name: str
    path: str
    node: ast.ClassDef
    bases: List[str] = field(default_factory=list)  # dotted spellings
    methods: Dict[str, FunctionInfo] = field(default_factory=dict)
    attr_types: Dict[str, str] = field(default_factory=dict)


def walk_with_lambdas(node: ast.AST) -> Iterator[ast.AST]:
    """Walk a function body without descending into nested def/class
    bodies, but INCLUDING lambda bodies: a lambda's callees belong to
    the enclosing function for reachability purposes (it is built and
    almost always invoked from the same execution context)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(
            child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            continue
        stack.extend(ast.iter_child_nodes(child))


def _is_super_call(func: ast.AST) -> Optional[str]:
    """``super().m`` -> "m", else None."""
    if (
        isinstance(func, ast.Attribute)
        and isinstance(func.value, ast.Call)
        and dotted(func.value.func) == "super"
    ):
        return func.attr
    return None


class Project:
    """The whole-program model: build once, query from project rules.

    ``sanctioned(path, line) -> bool`` marks blocking-leaf call sites
    that are deliberate, calibrated sinks (the engine wires it to
    ``# bftlint: disable=ASY114`` suppressions in the LEAF's own
    file): a sanctioned leaf is not a blocking leaf at all, so every
    chain through it vanishes for ASY114 *and* ASY115 — the one
    escape hatch for seams like the WAL barrier, which must carry a
    justification comment at the leaf."""

    def __init__(
        self,
        files: List[Tuple[str, ast.Module]],
        sanctioned=None,
        suppressed=None,
    ):
        self.files = files
        self._sanctioned = sanctioned or (lambda path, line: False)
        # ``suppressed(path, line, rule_id)`` — generic per-line
        # suppression lookup for rules that sanction LEAF lines in a
        # different file than the finding (ASY116's listener chains);
        # the engine wires it to the parsed suppression tables
        self._suppressed = suppressed or (
            lambda path, line, rule_id: False
        )
        self.functions: Dict[str, FunctionInfo] = {}
        self.classes: Dict[str, List[ClassInfo]] = {}  # by bare name
        self.module_functions: Dict[str, Dict[str, FunctionInfo]] = {}
        self.module_classes: Dict[str, Dict[str, ClassInfo]] = {}
        # per-module import table: local name -> dotted source ("pkg.mod"
        # for ``import pkg.mod``/aliases, "pkg.mod.obj" for from-imports)
        self.imports: Dict[str, Dict[str, str]] = {}
        self._blocking_chain_cache: Dict[str, Optional[List[str]]] = {}
        for path, tree in files:
            self._index_module(path, tree)
        for cls_list in self.classes.values():
            for ci in cls_list:
                self._infer_attr_types(ci)
        for fi in list(self.functions.values()):
            self._extract_calls(fi)

    # --- indexing -----------------------------------------------------

    def _index_module(self, path: str, tree: ast.Module) -> None:
        self.module_functions[path] = {}
        self.module_classes[path] = {}
        imports: Dict[str, str] = {}
        self.imports[path] = imports
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imports[alias.asname or alias.name.split(".")[0]] = (
                        alias.name
                    )
            elif isinstance(node, ast.ImportFrom):
                mod = node.module or ""
                for alias in node.names:
                    imports[alias.asname or alias.name] = (
                        f"{mod}.{alias.name}" if mod else alias.name
                    )
        for node in tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._add_function(path, node, class_name=None)
            elif isinstance(node, ast.ClassDef):
                self._index_class(path, node)

    def _index_class(self, path: str, node: ast.ClassDef) -> None:
        ci = ClassInfo(
            name=node.name,
            path=path,
            node=node,
            bases=[b for base in node.bases if (b := dotted(base))],
        )
        self.classes.setdefault(node.name, []).append(ci)
        self.module_classes[path][node.name] = ci
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                fi = self._add_function(path, item, class_name=node.name)
                ci.methods[item.name] = fi

    def _add_function(
        self, path: str, node, class_name: Optional[str], prefix: str = ""
    ) -> FunctionInfo:
        base = f"{class_name}." if class_name else ""
        qual = f"{path}::{prefix}{base}{node.name}"
        fi = FunctionInfo(
            qualname=qual,
            name=node.name,
            path=path,
            node=node,
            is_async=isinstance(node, ast.AsyncFunctionDef),
            class_name=class_name,
        )
        self.functions[qual] = fi
        if not class_name and not prefix:
            self.module_functions[path][node.name] = fi
        # nested defs: registered so a local call to the name resolves
        for child in ast.walk(node):
            if child is node:
                continue
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nested_prefix = f"{prefix}{base}{node.name}.<locals>."
                nq = f"{path}::{nested_prefix}{child.name}"
                if nq not in self.functions:
                    self._add_function(
                        path, child, class_name=None,
                        prefix=nested_prefix,
                    )
        return fi

    # --- attribute-type inference -------------------------------------

    def _class_of_value(
        self, path: str, value: ast.AST, ann_params: Dict[str, str]
    ) -> Optional[str]:
        """Class NAME for an assignment RHS: a constructor call, a
        bare copy of an annotated parameter, or None."""
        if isinstance(value, ast.Call):
            name = dotted(value.func)
            if name is None:
                return None
            last = name.rsplit(".", 1)[-1]
            if self._resolve_class(path, last) is not None:
                return last
            return None
        if isinstance(value, ast.Name):
            return ann_params.get(value.id)
        return None

    @staticmethod
    def _ann_name(ann: Optional[ast.AST]) -> Optional[str]:
        if ann is None:
            return None
        name = dotted(ann)
        if name:
            return name.rsplit(".", 1)[-1]
        # Optional[Foo] / "Foo" string annotations
        if isinstance(ann, ast.Subscript):
            inner = ann.slice
            return Project._ann_name(inner)
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            return ann.value.rsplit(".", 1)[-1].strip("'\" ")
        return None

    def _infer_attr_types(self, ci: ClassInfo) -> None:
        """``self.x`` types from assignments; ``__init__`` first so
        the constructor's view wins over later re-assignments."""
        ordered = sorted(
            ci.methods.values(), key=lambda m: m.name != "__init__"
        )
        for m in ordered:
            ann_params: Dict[str, str] = {}
            args = m.node.args
            for p in args.posonlyargs + args.args + args.kwonlyargs:
                t = self._ann_name(p.annotation)
                if t and self._resolve_class(ci.path, t) is not None:
                    ann_params[p.arg] = t
            for node in walk_with_lambdas(m.node):
                target = None
                value = None
                ann = None
                if isinstance(node, ast.Assign) and len(node.targets) == 1:
                    target, value = node.targets[0], node.value
                elif isinstance(node, ast.AnnAssign):
                    target, value, ann = node.target, node.value, node.annotation
                if not (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                ):
                    continue
                attr = target.attr
                if attr in ci.attr_types:
                    continue  # first writer (init-first order) wins
                t = self._ann_name(ann) if ann is not None else None
                if t is None and value is not None:
                    t = self._class_of_value(ci.path, value, ann_params)
                if t and self._resolve_class(ci.path, t) is not None:
                    ci.attr_types[attr] = t

    # --- resolution ---------------------------------------------------

    def _resolve_class(
        self, path: str, name: str
    ) -> Optional[ClassInfo]:
        """Class by bare name: same module first, then the import
        table, then a unique global match (ambiguity -> None: the
        rules must under-approximate, never guess)."""
        own = self.module_classes.get(path, {}).get(name)
        if own is not None:
            return own
        src = self.imports.get(path, {}).get(name)
        candidates = self.classes.get(name, [])
        if src is not None and candidates:
            want = src.replace(".", "/")
            for ci in candidates:
                mod = ci.path[:-3] if ci.path.endswith(".py") else ci.path
                if mod.endswith(want.rsplit("/", 1)[0]) or want.endswith(
                    mod.rsplit("/", 1)[-1]
                ):
                    return ci
            return candidates[0]
        if len(candidates) == 1:
            return candidates[0]
        return None

    def resolve_method(
        self, ci: Optional[ClassInfo], name: str,
        _seen: Optional[Set[str]] = None,
    ) -> Optional[FunctionInfo]:
        """Method lookup through the inheritance chain (C3-ish: own
        methods, then bases left-to-right, cycle-safe)."""
        if ci is None:
            return None
        seen = _seen or set()
        key = f"{ci.path}::{ci.name}"
        if key in seen:
            return None
        seen.add(key)
        if name in ci.methods:
            return ci.methods[name]
        for base in ci.bases:
            bci = self._resolve_class(ci.path, base.rsplit(".", 1)[-1])
            hit = self.resolve_method(bci, name, seen)
            if hit is not None:
                return hit
        return None

    def _class_of(self, fi: FunctionInfo) -> Optional[ClassInfo]:
        if fi.class_name is None:
            return None
        return self.module_classes.get(fi.path, {}).get(fi.class_name)

    def _local_var_types(self, fi: FunctionInfo) -> Dict[str, str]:
        """``x = Foo(...)`` / annotated params inside one function."""
        out: Dict[str, str] = {}
        args = fi.node.args
        for p in args.posonlyargs + args.args + args.kwonlyargs:
            t = self._ann_name(p.annotation)
            if t and self._resolve_class(fi.path, t) is not None:
                out[p.arg] = t
        for node in walk_with_lambdas(fi.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Call)
            ):
                name = dotted(node.value.func)
                if name is None:
                    continue
                last = name.rsplit(".", 1)[-1]
                if self._resolve_class(fi.path, last) is not None:
                    out.setdefault(node.targets[0].id, last)
        return out

    def resolve_call(
        self,
        fi: FunctionInfo,
        call: ast.Call,
        local_types: Optional[Dict[str, str]] = None,
    ) -> Optional[FunctionInfo]:
        func = call.func
        # functools.partial(f, ...): the edge goes to f
        fname = dotted(func)
        if fname in ("functools.partial", "partial") and call.args:
            inner = call.args[0]
            iname = dotted(inner)
            if iname is not None:
                return self._resolve_dotted(fi, iname, local_types)
            return None
        sup = _is_super_call(func)
        if sup is not None:
            ci = self._class_of(fi)
            if ci is None:
                return None
            for base in ci.bases:
                bci = self._resolve_class(
                    ci.path, base.rsplit(".", 1)[-1]
                )
                hit = self.resolve_method(bci, sup)
                if hit is not None:
                    return hit
            return None
        if fname is None:
            return None
        return self._resolve_dotted(fi, fname, local_types)

    def _resolve_dotted(
        self,
        fi: FunctionInfo,
        name: str,
        local_types: Optional[Dict[str, str]] = None,
    ) -> Optional[FunctionInfo]:
        parts = name.split(".")
        ci = self._class_of(fi)
        if parts[0] in ("self", "cls") and ci is not None:
            cur: Optional[ClassInfo] = ci
            for seg in parts[1:-1]:
                tname = cur.attr_types.get(seg) if cur else None
                cur = (
                    self._resolve_class(cur.path, tname)
                    if (cur and tname)
                    else None
                )
                if cur is None:
                    return None
            return self.resolve_method(cur, parts[-1])
        if len(parts) == 1:
            # nested def in this function
            prefix = fi.qualname.split("::", 1)[1]
            nested = self.functions.get(
                f"{fi.path}::{prefix}.<locals>.{parts[0]}"
            )
            if nested is not None:
                return nested
            own = self.module_functions.get(fi.path, {}).get(parts[0])
            if own is not None:
                return own
            # class constructor -> __init__
            cls = self._resolve_class(fi.path, parts[0])
            if cls is not None:
                return self.resolve_method(cls, "__init__")
            # imported function
            src = self.imports.get(fi.path, {}).get(parts[0])
            if src is not None:
                return self._function_from_import(src, parts[0])
            return None
        # a.b(...): a is a local var / param with an inferred type,
        # an imported module, or a class (static-ish dispatch)
        head, tail = parts[0], parts[1:]
        if local_types is None:
            local_types = self._local_var_types(fi)
        tname = local_types.get(head)
        if tname is not None:
            cur = self._resolve_class(fi.path, tname)
            for seg in tail[:-1]:
                t2 = cur.attr_types.get(seg) if cur else None
                cur = (
                    self._resolve_class(cur.path, t2)
                    if (cur and t2)
                    else None
                )
            return self.resolve_method(cur, tail[-1])
        cls = self._resolve_class(fi.path, head)
        if cls is not None and len(tail) == 1:
            return self.resolve_method(cls, tail[0])
        src = self.imports.get(fi.path, {}).get(head)
        if src is not None and len(tail) == 1:
            return self._function_from_import(
                f"{src}.{tail[0]}", tail[0]
            )
        return None

    def _function_from_import(
        self, src: str, name: str
    ) -> Optional[FunctionInfo]:
        """Match an import source like ``..utils.tasks.spawn`` (or
        ``cometbft_tpu_torch.utils.tasks`` + name) to an indexed function by
        module-path suffix."""
        mod_path = src.rsplit(".", 1)[0] if src.endswith(
            f".{name}"
        ) else src
        want = mod_path.replace(".", "/")
        best: Optional[FunctionInfo] = None
        n = 0
        for path, fns in self.module_functions.items():
            fn = fns.get(name)
            if fn is None:
                continue
            mod = path[:-3] if path.endswith(".py") else path
            if want and (mod.endswith(want) or want.endswith(
                mod.rsplit("/", 1)[-1]
            )):
                return fn
            best = fn
            n += 1
        return best if n == 1 else None

    # --- call extraction ----------------------------------------------

    def _extract_calls(self, fi: FunctionInfo) -> None:
        awaited_ids: Set[int] = set()
        for node in walk_with_lambdas(fi.node):
            if isinstance(node, ast.Await) and isinstance(
                node.value, ast.Call
            ):
                awaited_ids.add(id(node.value))
        local_types = self._local_var_types(fi)
        for node in walk_with_lambdas(fi.node):
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name is not None:
                if name in BLOCKING_LEAVES:
                    if not self._sanctioned(fi.path, node.lineno):
                        fi.blocking.append(
                            BlockingSite(
                                name, BLOCKING_LEAVES[name],
                                node.lineno, node.col_offset,
                            )
                        )
                    continue
                last = name.rsplit(".", 1)[-1]
                if (
                    last in BLOCKING_METHOD_SUFFIXES
                    and id(node) not in awaited_ids
                ):
                    if not self._sanctioned(fi.path, node.lineno):
                        fi.blocking.append(
                            BlockingSite(
                                name, BLOCKING_METHOD_SUFFIXES[last],
                                node.lineno, node.col_offset,
                            )
                        )
                    continue
            callee = self.resolve_call(fi, node, local_types)
            if callee is None or callee.qualname == fi.qualname:
                continue
            spelling = name or f"super().{_is_super_call(node.func)}"
            if name in ("functools.partial", "partial") and node.args:
                # the edge goes to the wrapped function; name IT
                spelling = dotted(node.args[0]) or callee.name
            fi.calls.append(
                CallSite(
                    callee=callee.qualname,
                    spelling=spelling,
                    line=node.lineno,
                    col=node.col_offset,
                    awaited=id(node) in awaited_ids,
                )
            )

    # --- reachability -------------------------------------------------

    def blocking_chain(self, qualname: str) -> Optional[List[str]]:
        """Spelling chain from this function to a known-blocking leaf
        through SYNC execution: own leaves first, then sync callees
        (an async callee does not run when merely called; awaiting it
        is the awaited function's own problem, reported there).
        Returns e.g. ``["self._flush", "os.fsync"]`` or None.
        Memoized; cycle-safe (a cycle contributes nothing)."""
        cache = self._blocking_chain_cache
        if qualname in cache:
            return cache[qualname]
        cache[qualname] = None  # in-progress sentinel: cycles stop here
        fi = self.functions.get(qualname)
        if fi is None:
            return None
        best: Optional[List[str]] = None
        if fi.blocking:
            site = fi.blocking[0]
            best = [site.spelling]
        else:
            for cs in fi.calls:
                callee = self.functions.get(cs.callee)
                if callee is None or callee.is_async:
                    continue
                sub = self.blocking_chain(cs.callee)
                if sub is not None and (
                    best is None or len(sub) + 1 < len(best)
                ):
                    best = [cs.spelling] + sub
        cache[qualname] = best
        return best

    def blocking_site(self, qualname: str) -> Optional[BlockingSite]:
        """The leaf at the end of blocking_chain(qualname)."""
        fi = self.functions.get(qualname)
        if fi is None:
            return None
        if fi.blocking:
            return fi.blocking[0]
        chain = self.blocking_chain(qualname)
        if not chain:
            return None
        for cs in fi.calls:
            sub = self.blocking_chain(cs.callee)
            if sub is not None and [cs.spelling] + sub == chain:
                return self.blocking_site(cs.callee)
        return None
