"""Loop-domain dataflow over the callgraph.Project model.

Every ``for``/``async for``/comprehension gets an ITERATION DOMAIN —
what the loop is O(...) in — inferred from the iterable expression:

- spelling tables: ``valset.validators``, ``self.peers.values()``,
  ``commit.signatures`` all spell a committee-scale domain;
- element-type annotations: a ``Sequence[Validator]`` parameter is
  validators-domain wherever it is iterated;
- wrapper unwrapping: ``zip()``, ``enumerate()``, ``sorted()``,
  ``reversed()``, ``range(len(x))`` / ``range(x.size())`` and
  ``.values()/.items()/.keys()`` are transparent — the domain is the
  wrapped iterable's (the exact vote-loop shapes that previously
  evaded inference, see docs/LINT.md);
- local dataflow: ``updates = [c for c in changes if ...]`` inherits
  the domain of ``changes``;
- attribute types: the callgraph's inferred attribute types name the
  receiver class in the trace (``self.val_set`` is a ValidatorSet).

Domains propagate INTERPROCEDURALLY: a committee-domain loop in a
callee is charged to every caller chain that reaches it — sync calls
always, async calls only when awaited at the site (a spawned task is
not per-message work). The model feeds three project rules
(rules/complexity_rules.py: ASY117/ASY118/ASY119) and names the call
sites the empirical probe (analysis/scaling.py) drives.

Pure stdlib, like the rest of the analysis plane.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .astutil import dotted
from .callgraph import CallSite, FunctionInfo, Project, walk_with_lambdas

# --- domains -----------------------------------------------------------

VALIDATORS = "validators"
PEERS = "peers"
SUBSCRIBERS = "subscribers"
HEIGHTS = "heights"
TXS = "txs"

#: the committee-scale domains: O(these) per message is O(V^2) per
#: height once every validator sends (ROADMAP item 1's blowup class)
COMMITTEE_DOMAINS = (VALIDATORS, PEERS)

# final name segment -> domain. A spelling match is evidence by
# convention: the tree consistently names validator-indexed lanes
# (votes, signatures) and peer tables this way.
_SPELLINGS: Dict[str, str] = {
    "validators": VALIDATORS,
    "votes": VALIDATORS,
    "votes_by_index": VALIDATORS,
    "signatures": VALIDATORS,
    "extended_signatures": VALIDATORS,
    "commit_sigs": VALIDATORS,
    "peers": PEERS,
    "peer_states": PEERS,
    "subscribers": SUBSCRIBERS,
    "members": SUBSCRIBERS,
    "sessions": SUBSCRIBERS,
    "waiters": SUBSCRIBERS,
    "heights": HEIGHTS,
    "txs": TXS,
}

# element-type annotation -> domain (``Sequence[Validator]``,
# ``Dict[int, Vote]``, ``List[Peer]`` parameters)
_ELEM_TYPES: Dict[str, str] = {
    "Validator": VALIDATORS,
    "Vote": VALIDATORS,
    "CommitSig": VALIDATORS,
    "ExtendedCommitSig": VALIDATORS,
    "Peer": PEERS,
    "FanoutSubscriber": SUBSCRIBERS,
}

# receiver class whose .size()/len() counts committee members:
# ``range(vs.size())`` iterates the validators domain
_SIZED_TYPES: Dict[str, str] = {
    "ValidatorSet": VALIDATORS,
    "VoteSet": VALIDATORS,
}

# calls transparent to the iteration domain (the satellite gap fix:
# zip/enumerate destructuring used to evade inference entirely)
_UNWRAP_CALLS = {
    "zip", "enumerate", "sorted", "list", "set", "tuple",
    "frozenset", "reversed", "iter",
}
# methods transparent to the iteration domain
_UNWRAP_METHODS = {"values", "items", "keys", "copy"}


@dataclass(frozen=True)
class DomainHit:
    """One classified iterable: the domain plus the inference steps
    that led there (rendered into ASY117/118 messages)."""

    domain: str
    spelling: str
    trace: Tuple[str, ...]


@dataclass(frozen=True)
class DomainLoop:
    """One loop/comprehension whose iterable classified."""

    domain: str
    line: int
    col: int
    spelling: str
    kind: str  # "for" | "async for" | "comprehension"
    trace: Tuple[str, ...]


@dataclass
class CallInLoop:
    """A resolved call site lexically inside a committee-domain
    loop: the edge ASY118's interprocedural half walks."""

    site: CallSite
    loop: DomainLoop


@dataclass
class FuncSummary:
    fi: FunctionInfo
    loops: List[DomainLoop] = field(default_factory=list)
    nested: List[Tuple[DomainLoop, DomainLoop]] = field(
        default_factory=list
    )  # (outer, inner) committee x committee, same function
    calls_in_loops: List[CallInLoop] = field(default_factory=list)

    @property
    def committee_loops(self) -> List[DomainLoop]:
        return [l for l in self.loops if l.domain in COMMITTEE_DOMAINS]


@dataclass(frozen=True)
class ChainHit:
    """Nearest reachable committee loop + the call chain to it."""

    loop: DomainLoop
    path: str  # file containing the loop
    func_name: str  # function containing the loop
    chain: Tuple[str, ...]  # call spellings walked (may be empty)


# --- iterable classification ------------------------------------------


class _Classifier:
    """Domain classification for one function's expressions."""

    def __init__(self, project: Project, fi: FunctionInfo):
        self.project = project
        self.fi = fi
        self.local_types = project._local_var_types(fi)
        self.env: Dict[str, DomainHit] = self._param_domains()
        self._fold_local_assignments()

    # parameters: by spelling or by element-type annotation
    def _param_domains(self) -> Dict[str, DomainHit]:
        out: Dict[str, DomainHit] = {}
        a = self.fi.node.args
        for p in a.posonlyargs + a.args + a.kwonlyargs:
            if p.arg in _SPELLINGS:
                d = _SPELLINGS[p.arg]
                out[p.arg] = DomainHit(
                    d, p.arg,
                    (f"parameter `{p.arg}` spells the {d} domain",),
                )
                continue
            d = _ann_elem_domain(p.annotation)
            if d is not None:
                out[p.arg] = DomainHit(
                    d, p.arg,
                    (f"parameter `{p.arg}` is annotated with "
                     f"{d}-domain elements",),
                )
        return out

    def _fold_local_assignments(self) -> None:
        """``updates = [c for c in changes ...]`` inherits the domain
        of ``changes``. Two passes so chained assignments resolve
        regardless of walk order."""
        for _ in range(2):
            changed = False
            for node in walk_with_lambdas(self.fi.node):
                if not (
                    isinstance(node, ast.Assign)
                    and len(node.targets) == 1
                    and isinstance(node.targets[0], ast.Name)
                ):
                    continue
                name = node.targets[0].id
                if name in self.env:
                    continue
                hit = self.classify(node.value)
                if hit is not None:
                    self.env[name] = DomainHit(
                        hit.domain, name,
                        hit.trace + (f"assigned to `{name}`",),
                    )
                    changed = True
            if not changed:
                break

    def _type_of(self, expr) -> Optional[str]:
        """Inferred class name of a dotted expression (inferred
        attribute types + annotated/constructed locals)."""
        name = dotted(expr)
        if name is None:
            return None
        parts = name.split(".")
        if parts[0] in ("self", "cls"):
            ci = self.project._class_of(self.fi)
            t: Optional[str] = None
            for seg in parts[1:]:
                if ci is None:
                    return None
                t = ci.attr_types.get(seg)
                ci = (
                    self.project._resolve_class(ci.path, t)
                    if t else None
                )
            return t
        t = self.local_types.get(parts[0])
        for seg in parts[1:]:
            ci = (
                self.project._resolve_class(self.fi.path, t)
                if t else None
            )
            if ci is None:
                return None
            t = ci.attr_types.get(seg)
        return t

    def classify(self, expr) -> Optional[DomainHit]:
        return self._classify(expr, ())

    def _classify(self, expr, trace) -> Optional[DomainHit]:
        if isinstance(expr, ast.Call):
            return self._classify_call(expr, trace)
        if isinstance(expr, ast.Attribute):
            if expr.attr in _SPELLINGS:
                d = _SPELLINGS[expr.attr]
                spelling = dotted(expr) or expr.attr
                recv_t = self._type_of(expr.value)
                step = f"`{spelling}` spells the {d} domain"
                if recv_t is not None:
                    step += f" (receiver resolves to {recv_t})"
                return DomainHit(d, spelling, trace + (step,))
            return None
        if isinstance(expr, ast.Name):
            hit = self.env.get(expr.id)
            if hit is not None:
                return DomainHit(
                    hit.domain, expr.id, trace + hit.trace
                )
            if expr.id in _SPELLINGS:
                d = _SPELLINGS[expr.id]
                return DomainHit(
                    d, expr.id,
                    trace + (f"`{expr.id}` spells the {d} domain",),
                )
            return None
        if isinstance(expr, ast.Subscript):
            # a slice of a committee lane is still the committee lane
            # (``self.validators[1:]``); a single index is not
            if isinstance(expr.slice, ast.Slice):
                return self._classify(
                    expr.value, trace + ("unwrap slice",)
                )
            return None
        if isinstance(expr, ast.Starred):
            return self._classify(expr.value, trace)
        if isinstance(expr, ast.BinOp) and isinstance(
            expr.op, ast.Add
        ):
            return (
                self._classify(expr.left, trace)
                or self._classify(expr.right, trace)
            )
        if isinstance(expr, ast.IfExp):
            return (
                self._classify(expr.body, trace)
                or self._classify(expr.orelse, trace)
            )
        if isinstance(
            expr,
            (ast.ListComp, ast.SetComp, ast.GeneratorExp, ast.DictComp),
        ):
            # the comprehension's cardinality is its first
            # generator's (filters only shrink it)
            if expr.generators:
                return self._classify(
                    expr.generators[0].iter,
                    trace + ("via comprehension",),
                )
            return None
        return None

    def _classify_call(self, expr: ast.Call, trace):
        fname = dotted(expr.func)
        base = fname.rsplit(".", 1)[-1] if fname else None
        if base in _UNWRAP_CALLS and expr.args:
            step = trace + (f"unwrap `{base}(...)`",)
            for a in expr.args:
                hit = self._classify(a, step)
                if hit is not None:
                    return hit
            return None
        if base == "range" and len(expr.args) == 1:
            a = expr.args[0]
            if isinstance(a, ast.Call):
                g = dotted(a.func)
                gb = g.rsplit(".", 1)[-1] if g else None
                if gb == "len" and a.args:
                    return self._classify(
                        a.args[0],
                        trace + ("unwrap `range(len(...))`",),
                    )
                if gb in ("size", "__len__") and isinstance(
                    a.func, ast.Attribute
                ):
                    recv = a.func.value
                    t = self._type_of(recv)
                    if t in _SIZED_TYPES:
                        d = _SIZED_TYPES[t]
                        spelling = dotted(recv) or "<recv>"
                        return DomainHit(
                            d, spelling,
                            trace + (
                                f"`range({spelling}.{gb}())` counts "
                                f"a {t}: the {d} domain",
                            ),
                        )
            return None
        if (
            base in _UNWRAP_METHODS
            and isinstance(expr.func, ast.Attribute)
            and not expr.args
        ):
            return self._classify(
                expr.func.value, trace + (f"unwrap `.{base}()`",)
            )
        return None


def _ann_elem_domain(ann) -> Optional[str]:
    """Element domain of an annotation: any identifier inside it
    (``Sequence[Validator]``, ``Dict[int, Vote]``, ``"List[Peer]"``)
    that names a committee element type."""
    if ann is None:
        return None
    for n in ast.walk(ann):
        name = None
        if isinstance(n, ast.Name):
            name = n.id
        elif isinstance(n, ast.Attribute):
            name = n.attr
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            # string annotation: cheap split, not a parse
            for tok in (
                n.value.replace("[", " ").replace("]", " ")
                .replace(",", " ").split()
            ):
                t = tok.rsplit(".", 1)[-1]
                if t in _ELEM_TYPES:
                    return _ELEM_TYPES[t]
        if name in _ELEM_TYPES:
            return _ELEM_TYPES[name]
    return None


# --- per-function summaries -------------------------------------------


def _innermost_committee(stack: List[DomainLoop]) -> Optional[DomainLoop]:
    for dl in reversed(stack):
        if dl.domain in COMMITTEE_DOMAINS:
            return dl
    return None


def summarize(project: Project, fi: FunctionInfo) -> FuncSummary:
    """Walk one function body tracking the loop stack; nested defs
    are skipped (they summarize separately), lambdas are inline."""
    cls = _Classifier(project, fi)
    out = FuncSummary(fi)
    by_pos: Dict[Tuple[int, int], CallSite] = {}
    for cs in fi.calls:
        by_pos.setdefault((cs.line, cs.col), cs)

    def add_loop(iter_expr, node, kind, stack) -> Optional[DomainLoop]:
        hit = cls.classify(iter_expr)
        if hit is None:
            return None
        dl = DomainLoop(
            hit.domain, node.lineno, node.col_offset,
            hit.spelling, kind, hit.trace,
        )
        out.loops.append(dl)
        if dl.domain in COMMITTEE_DOMAINS:
            outer = _innermost_committee(stack)
            if outer is not None:
                out.nested.append((outer, dl))
        return dl

    def visit(node, stack) -> None:
        if isinstance(
            node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
        ):
            return
        if isinstance(node, (ast.For, ast.AsyncFor)):
            visit(node.iter, stack)
            kind = (
                "async for" if isinstance(node, ast.AsyncFor) else "for"
            )
            dl = add_loop(node.iter, node, kind, stack)
            inner = stack + [dl] if dl is not None else stack
            for n in [node.target] + node.body + node.orelse:
                visit(n, inner)
            return
        if isinstance(
            node,
            (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp),
        ):
            st = stack
            for gen in node.generators:
                visit(gen.iter, st)
                dl = add_loop(gen.iter, node, "comprehension", st)
                if dl is not None:
                    st = st + [dl]
                for cond in gen.ifs:
                    visit(cond, st)
            if isinstance(node, ast.DictComp):
                visit(node.key, st)
                visit(node.value, st)
            else:
                visit(node.elt, st)
            return
        if isinstance(node, ast.Call):
            cs = by_pos.get((node.lineno, node.col_offset))
            loop = _innermost_committee(stack)
            if cs is not None and loop is not None:
                out.calls_in_loops.append(CallInLoop(cs, loop))
        for child in ast.iter_child_nodes(node):
            visit(child, stack)

    for stmt in fi.node.body:
        visit(stmt, [])
    return out


# --- the whole-program model ------------------------------------------

_MAX_CHAIN_DEPTH = 8  # same audit bound as ASY116


class ComplexityModel:
    """Lazy per-function summaries + interprocedural committee-loop
    reachability, cached on the Project instance (ASY117 and ASY118
    share one model per engine run)."""

    def __init__(self, project: Project):
        self.project = project
        self._summaries: Dict[str, FuncSummary] = {}

    def summary(self, qualname: str) -> Optional[FuncSummary]:
        s = self._summaries.get(qualname)
        if s is None:
            fi = self.project.functions.get(qualname)
            if fi is None:
                return None
            s = summarize(self.project, fi)
            self._summaries[qualname] = s
        return s

    def committee_chain(
        self,
        qualname: str,
        rule_id: str,
        skip=None,
    ) -> Optional[ChainHit]:
        """BFS from ``qualname`` (inclusive) to the nearest
        committee-domain loop. Sync callees always count; async
        callees only when awaited at the site (spawned work is not
        per-message). Loops suppressed for ``rule_id`` in their own
        file are sanctioned sinks — chains through them vanish, one
        justified comment kills the whole fan (the ASY114 escape-
        hatch contract)."""
        fi0 = self.project.functions.get(qualname)
        if fi0 is None:
            return None
        seen: Set[str] = {qualname}
        queue: List[Tuple[FunctionInfo, Tuple[str, ...], int]] = [
            (fi0, (), 0)
        ]
        while queue:
            fi, chain, depth = queue.pop(0)
            s = self.summary(fi.qualname)
            for dl in s.committee_loops:
                if self.project._suppressed(fi.path, dl.line, rule_id):
                    continue
                return ChainHit(dl, fi.path, fi.name, chain)
            if depth >= _MAX_CHAIN_DEPTH:
                continue
            for cs in fi.calls:
                callee = self.project.functions.get(cs.callee)
                if callee is None or callee.qualname in seen:
                    continue
                if callee.is_async and not cs.awaited:
                    continue
                if skip is not None and skip(callee):
                    continue
                seen.add(callee.qualname)
                queue.append(
                    (callee, chain + (cs.spelling,), depth + 1)
                )
        return None


def reachable_from(project: Project, roots) -> Set[str]:
    """Qualnames reachable from ``roots`` (inclusive) through sync
    calls and awaited async calls, bounded at _MAX_CHAIN_DEPTH — the
    per-message closure ASY119 scopes grow sites to."""
    seen: Set[str] = set()
    queue: List[Tuple[FunctionInfo, int]] = []
    for fi in roots:
        if fi.qualname not in seen:
            seen.add(fi.qualname)
            queue.append((fi, 0))
    while queue:
        fi, depth = queue.pop(0)
        if depth >= _MAX_CHAIN_DEPTH:
            continue
        for cs in fi.calls:
            callee = project.functions.get(cs.callee)
            if callee is None or callee.qualname in seen:
                continue
            if callee.is_async and not cs.awaited:
                continue
            seen.add(callee.qualname)
            queue.append((callee, depth + 1))
    return seen


def model_for(project: Project) -> ComplexityModel:
    m = getattr(project, "_complexity_model", None)
    if m is None:
        m = ComplexityModel(project)
        project._complexity_model = m
    return m


# --- unbounded-growth analysis (ASY119's engine) ----------------------

_GROW_METHODS = {
    "append", "add", "appendleft", "insert", "setdefault",
    "extend", "update",
}
_PRUNE_METHODS = {
    "pop", "popitem", "remove", "discard", "clear", "popleft",
}


def _empty_container(expr) -> Optional[str]:
    """Container kind when ``expr`` initializes an EMPTY growable
    container (``{}``, ``[]``, ``set()``, ``deque()`` without
    maxlen, ``field(default_factory=dict)``), else None."""
    if isinstance(expr, ast.Dict) and not expr.keys:
        return "dict"
    if isinstance(expr, ast.List) and not expr.elts:
        return "list"
    if isinstance(expr, ast.Call):
        f = dotted(expr.func)
        base = f.rsplit(".", 1)[-1] if f else None
        if base in ("dict", "list", "set", "OrderedDict"):
            if not expr.args and not expr.keywords:
                return base
        if base == "defaultdict" and not any(
            kw.arg == "maxlen" for kw in expr.keywords
        ):
            return "defaultdict"
        if base == "deque" and not any(
            kw.arg == "maxlen" for kw in expr.keywords
        ):
            return "deque"
        if base == "field":
            for kw in expr.keywords:
                if kw.arg == "default_factory":
                    n = dotted(kw.value)
                    nb = n.rsplit(".", 1)[-1] if n else None
                    if nb in (
                        "dict", "list", "set", "OrderedDict", "deque"
                    ):
                        return nb
    return None


@dataclass(frozen=True)
class GrowthSite:
    path: str
    line: int
    op: str  # ".append", "[k] =", ...
    func_qual: str  # qualname of the method containing the add


@dataclass
class GrowableAttr:
    class_name: str
    attr: str
    kind: str  # container kind
    path: str
    line: int  # the init site (where the finding lands)
    col: int
    grows: List[GrowthSite] = field(default_factory=list)


def _attr_of_target(expr) -> Optional[str]:
    """Attribute name for ``<recv>.x`` shapes, any receiver."""
    if isinstance(expr, ast.Attribute):
        return expr.attr
    return None


def collect_pruned_attrs(project: Project) -> Set[str]:
    """Attribute names with ANY reachable shrink anywhere in the
    tree: ``<recv>.x.pop(...)``, ``del <recv>.x[...]``, slice
    rewrite, or reassignment outside an ``__init__``. Name-based on
    purpose — cross-object prunes (a reactor clearing a peer-state
    map) must count, and an under-approximated GROW with an over-
    approximated PRUNE keeps ASY119's false-positive rate down."""
    pruned: Set[str] = set()
    for fi in project.functions.values():
        in_init = fi.name == "__init__"
        # local aliases of attributes: ``fifo = self._durable_fifo``
        # followed by ``fifo.pop(0)`` prunes the attribute
        aliases: Dict[str, str] = {}
        for node in walk_with_lambdas(fi.node):
            if (
                isinstance(node, ast.Assign)
                and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)
                and isinstance(node.value, ast.Attribute)
            ):
                aliases[node.targets[0].id] = node.value.attr
        for node in walk_with_lambdas(fi.node):
            if isinstance(node, ast.Call) and isinstance(
                node.func, ast.Attribute
            ):
                if node.func.attr in _PRUNE_METHODS:
                    recv = node.func.value
                    a = _attr_of_target(recv)
                    if a is None and isinstance(recv, ast.Name):
                        a = aliases.get(recv.id)
                    if a is not None:
                        pruned.add(a)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    v = t.value if isinstance(t, ast.Subscript) else t
                    a = _attr_of_target(v)
                    if a is not None:
                        pruned.add(a)
            elif isinstance(node, ast.Assign):
                for t in node.targets:
                    if (
                        isinstance(t, ast.Subscript)
                        and isinstance(t.slice, ast.Slice)
                    ):
                        a = _attr_of_target(t.value)
                        if a is not None:
                            pruned.add(a)  # x[:] = ... rewrite
                    elif not in_init:
                        a = _attr_of_target(t)
                        if a is not None:
                            pruned.add(a)  # reassignment resets it
    return pruned


def collect_growable_attrs(
    project: Project, path_filter
) -> List[GrowableAttr]:
    """Per class (in paths accepted by ``path_filter``): attributes
    initialized as empty containers in ``__init__``/class body, with
    the grow sites reachable through the class's own methods."""
    out: List[GrowableAttr] = []
    for path, classes in sorted(project.module_classes.items()):
        if not path_filter(path):
            continue
        for ci in classes.values():
            attrs: Dict[str, GrowableAttr] = {}
            # class-body fields (dataclass field defaults / shared
            # class-level containers)
            for stmt in ci.node.body:
                target = value = None
                if isinstance(stmt, ast.AnnAssign) and isinstance(
                    stmt.target, ast.Name
                ):
                    target, value = stmt.target.id, stmt.value
                elif isinstance(stmt, ast.Assign) and len(
                    stmt.targets
                ) == 1 and isinstance(stmt.targets[0], ast.Name):
                    target, value = stmt.targets[0].id, stmt.value
                if target is None or value is None:
                    continue
                kind = _empty_container(value)
                if kind is not None:
                    attrs[target] = GrowableAttr(
                        ci.name, target, kind, path,
                        stmt.lineno, stmt.col_offset,
                    )
            init = ci.methods.get("__init__")
            if init is not None:
                for node in walk_with_lambdas(init.node):
                    # both `self.x = {}` and `self.x: Dict[...] = {}`
                    if isinstance(node, ast.Assign) and len(
                        node.targets
                    ) == 1:
                        t = node.targets[0]
                    elif isinstance(node, ast.AnnAssign):
                        t = node.target
                    else:
                        continue
                    if node.value is None:
                        continue
                    if not (
                        isinstance(t, ast.Attribute)
                        and isinstance(t.value, ast.Name)
                        and t.value.id == "self"
                    ):
                        continue
                    kind = _empty_container(node.value)
                    if kind is not None:
                        attrs[t.attr] = GrowableAttr(
                            ci.name, t.attr, kind, path,
                            node.lineno, node.col_offset,
                        )
            if not attrs:
                continue
            for mname, m in ci.methods.items():
                if mname == "__init__":
                    continue
                for node in walk_with_lambdas(m.node):
                    if isinstance(node, ast.Call) and isinstance(
                        node.func, ast.Attribute
                    ):
                        if node.func.attr not in _GROW_METHODS:
                            continue
                        recv = node.func.value
                        if (
                            isinstance(recv, ast.Attribute)
                            and isinstance(recv.value, ast.Name)
                            and recv.value.id == "self"
                            and recv.attr in attrs
                        ):
                            attrs[recv.attr].grows.append(
                                GrowthSite(
                                    m.path, node.lineno,
                                    f".{node.func.attr}",
                                    m.qualname,
                                )
                            )
                    elif isinstance(node, (ast.Assign, ast.AugAssign)):
                        targets = (
                            node.targets
                            if isinstance(node, ast.Assign)
                            else [node.target]
                        )
                        for t in targets:
                            if not (
                                isinstance(t, ast.Subscript)
                                and not isinstance(t.slice, ast.Slice)
                            ):
                                continue
                            recv = t.value
                            if (
                                isinstance(recv, ast.Attribute)
                                and isinstance(recv.value, ast.Name)
                                and recv.value.id == "self"
                                and recv.attr in attrs
                            ):
                                attrs[recv.attr].grows.append(
                                    GrowthSite(
                                        m.path, node.lineno, "[k] =",
                                        m.qualname,
                                    )
                                )
            out.extend(
                a for _, a in sorted(attrs.items()) if a.grows
            )
    return out


def render_trace(trace: Tuple[str, ...]) -> str:
    return " ; ".join(trace)


def render_chain(
    handler: str, chain: Tuple[str, ...], hit: ChainHit
) -> str:
    steps = [f"`{handler}`"] + [f"`{c}`" for c in chain]
    loc = f"{hit.path}:{hit.loop.line}"
    steps.append(
        f"{hit.loop.kind} over `{hit.loop.spelling}` at {loc}"
    )
    return " -> ".join(steps)
