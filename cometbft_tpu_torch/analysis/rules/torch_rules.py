"""Torch hot-path hygiene rules (TCH2xx): the port's counterparts of the
JAX package's JAX201-204.

The failure class is the same silent one: nothing crashes, but a host
sync on the event loop parks every reactor behind the card, a Python
loop over a tensor launches one tiny kernel (or one device read) per
element, and a kernel build or library load per call puts ``nvcc`` or
``dlopen`` on the dispatch path. Each rule is the counterpart of one
JAX rule:

- TCH201 (JAX201 host-sync-in-jit): a host sync (``.item()``,
  ``.cpu()``, ``.tolist()``, ``.numpy()``, ``torch.cuda.synchronize()``,
  an event's or stream's ``.synchronize()``) inside a coroutine of a
  hot async plane: the calls the loop watchdog names as loop stalls
  (``obs/watchdog.py``).
- TCH202 (JAX202 stray-block-until-ready): ``torch.cuda.synchronize()``
  outside the designated sync points: ``ops/``, ``kernels.py`` and
  ``chip_smoke.py``.
- TCH203 (JAX203 traced-loop): a Python loop over a tensor's elements
  in ``ops/``.
- TCH204 (JAX204 per-call-jit): a kernel build or library load
  (``kernels.build_all``, ``ctypes.CDLL``, ``torch.compile``,
  ``cpp_extension.load``) inside a loop, inside a per-dispatch
  function, or invoked in the expression that made it.
"""
from __future__ import annotations

import ast
from typing import List, Optional

from ..astutil import dotted, in_planes, package_path, walk_in_function
from ..findings import Finding
from ..registry import FileContext, rule
from .async_rules import _HOT_PLANE_PREFIXES

# the async planes whose coroutines run on the node's event loop
# (ASY114's scope: the hot planes and node/)
_ASYNC_PLANES = _HOT_PLANE_PREFIXES + ("node/",)

_SYNC_METHODS = {"item", "cpu", "tolist", "numpy"}


def _host_sync(call: ast.Call) -> Optional[str]:
    """The spelling of a host sync, or None."""
    name = dotted(call.func)
    if name is not None and name.endswith("cuda.synchronize"):
        return name
    if isinstance(call.func, ast.Attribute):
        attr = call.func.attr
        if attr in _SYNC_METHODS and not call.args and not call.keywords:
            return f".{attr}()"
        if attr == "synchronize" and not call.args:
            return ".synchronize()"
    return None


@rule(
    "TCH201",
    "host-sync-in-async-plane",
    ".item()/.cpu()/.tolist()/.numpy()/synchronize() inside a "
    "coroutine of a hot async plane blocks the event loop until the "
    "card drains",
)
def host_sync_in_async_plane(ctx: FileContext) -> List[Finding]:
    if not in_planes(ctx.path, _ASYNC_PLANES):
        return []
    out: List[Finding] = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, ast.AsyncFunctionDef):
            continue
        for node in walk_in_function(fn):
            if not isinstance(node, ast.Call):
                continue
            spelling = _host_sync(node)
            if spelling is not None:
                out.append(
                    Finding(
                        ctx.path, node.lineno, node.col_offset,
                        "TCH201", "host-sync-in-async-plane",
                        f"`{spelling}` inside coroutine `{fn.name}` "
                        "waits for the card on the event loop — wait "
                        "on the dispatch's event off the loop "
                        "(asyncio.to_thread / the scheduler's watcher) "
                        "and read the result there",
                    )
                )
    return out


def _sync_point(path: str) -> bool:
    rel = package_path(path)
    if rel is not None and (rel.startswith("ops/") or rel == "kernels.py"):
        return True
    return path.replace("\\", "/").rsplit("/", 1)[-1] == "chip_smoke.py"


@rule(
    "TCH202",
    "stray-cuda-synchronize",
    "torch.cuda.synchronize() outside the designated sync points "
    "(ops/, kernels.py, chip_smoke.py) serializes the host against "
    "every stream of the card",
)
def stray_cuda_synchronize(ctx: FileContext) -> List[Finding]:
    if _sync_point(ctx.path):
        return []
    out: List[Finding] = []
    for node in ast.walk(ctx.tree):
        if not isinstance(node, ast.Call):
            continue
        name = dotted(node.func)
        if name is not None and name.endswith("cuda.synchronize"):
            out.append(
                Finding(
                    ctx.path, node.lineno, node.col_offset,
                    "TCH202", "stray-cuda-synchronize",
                    f"`{name}()` waits for every stream of the card; "
                    "wait on the dispatch's own CUDA event, or mark a "
                    "designated sync point `# bftlint: disable=TCH202` "
                    "with a justification",
                )
            )
    return out


_STATIC_ITERATORS = {"range", "reversed"}
_WRAPPING_ITERATORS = {"enumerate", "zip"}
# calls whose result is a tensor: torch.<anything>, and the methods
# that return a tensor of the same elements
_TENSOR_METHODS = {"to", "view", "reshape", "contiguous", "flatten", "cuda", "t", "clone"}


def _tensor_expr(node: ast.AST, tensors: set) -> bool:
    """Whether ``node`` evaluates to a tensor, as far as one module can
    tell: a name bound to one, a ``torch.*`` call, a tensor method of
    a tensor, or ``.tolist()`` / ``.numpy()`` of one (the same
    elements, read to the host)."""
    if isinstance(node, ast.Name):
        return node.id in tensors
    if isinstance(node, ast.Call):
        name = dotted(node.func) or ""
        if name.startswith("torch.") and not name.startswith("torch.cuda."):
            return True
        if isinstance(node.func, ast.Attribute) and (
            node.func.attr in _TENSOR_METHODS or node.func.attr in ("tolist", "numpy")
        ):
            return _tensor_expr(node.func.value, tensors)
    return False


def _tensor_names(fn: ast.AST) -> set:
    """Names a function binds to tensors: parameters annotated
    ``torch.Tensor`` / ``Tensor`` and assignments from a tensor
    expression (one pass, in source order)."""
    names = set()
    args = fn.args
    for a in args.posonlyargs + args.args + args.kwonlyargs:
        ann = dotted(a.annotation) if a.annotation is not None else None
        if ann in ("torch.Tensor", "Tensor"):
            names.add(a.arg)
    assigns = sorted(
        (n for n in walk_in_function(fn) if isinstance(n, ast.Assign)),
        key=lambda n: (n.lineno, n.col_offset),
    )
    for node in assigns:
        if _tensor_expr(node.value, names):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
    return names


def _loop_source(it: ast.expr, tensors: set) -> Optional[str]:
    if isinstance(it, ast.Call):
        fname = dotted(it.func)
        if fname in _STATIC_ITERATORS:
            return None
        if fname in _WRAPPING_ITERATORS:
            for arg in it.args:
                if _tensor_expr(arg, tensors):
                    return ast.unparse(arg)
            return None
    return ast.unparse(it) if _tensor_expr(it, tensors) else None


@rule(
    "TCH203",
    "tensor-element-loop",
    "a Python loop over a tensor's elements in ops/ runs one kernel or "
    "one device read per element; use a vector op or a kernel",
)
def tensor_element_loop(ctx: FileContext) -> List[Finding]:
    if not in_planes(ctx.path, ("ops/",)):
        return []
    out: List[Finding] = []
    for fn in ast.walk(ctx.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        tensors = _tensor_names(fn)
        for node in walk_in_function(fn):
            if isinstance(node, (ast.For, ast.AsyncFor)):
                its = [(node, node.iter)]
            elif isinstance(node, (ast.ListComp, ast.SetComp, ast.DictComp, ast.GeneratorExp)):
                its = [(node, g.iter) for g in node.generators]
            else:
                continue
            for at, it in its:
                src = _loop_source(it, tensors)
                if src is not None:
                    out.append(
                        Finding(
                            ctx.path, at.lineno, at.col_offset,
                            "TCH203", "tensor-element-loop",
                            f"Python loop over the elements of `{src}` "
                            f"in `{fn.name}`: one kernel or device read "
                            "per element — use a tensor op or a kernel",
                        )
                    )
    return out


_BUILDERS = ("kernels.build_all", "ctypes.CDLL", "torch.compile", "cpp_extension.load")
# per-dispatch functions: the entry points a verify dispatch runs once
# a call (the kernel wrappers and the dispatch layer)
_DISPATCH_PREFIXES = ("verify", "dispatch", "launch", "submit")


def _builder(call: ast.Call) -> Optional[str]:
    name = dotted(call.func) or ""
    for b in _BUILDERS:
        if name == b or name.endswith("." + b):
            return name
    if name == "CDLL":
        return name
    return None


def _per_dispatch(name: str) -> bool:
    return name.startswith(_DISPATCH_PREFIXES) or name.endswith("_launch")


@rule(
    "TCH204",
    "per-call-kernel-build",
    "a kernel build or library load (kernels.build_all, ctypes.CDLL, "
    "torch.compile, cpp_extension.load) per call — in a loop, in a "
    "per-dispatch function, or invoked where it is made — puts nvcc or "
    "dlopen on the dispatch path",
)
def per_call_kernel_build(ctx: FileContext) -> List[Finding]:
    out: List[Finding] = []
    # build calls already reported by the build-and-invoke branch on
    # their enclosing call: skip them in the loop branch so
    # `for ...: torch.compile(f)(x)` reports once
    invoked: set = set()

    def report(node: ast.AST, name: str, why: str) -> None:
        out.append(
            Finding(
                ctx.path, node.lineno, node.col_offset,
                "TCH204", "per-call-kernel-build",
                f"`{name}(...)` {why} — build or load once (the "
                "kernels module's cached load) and keep the handle",
            )
        )

    def visit(node: ast.AST, loop_depth: int, dispatch: Optional[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            dispatch = node.name if _per_dispatch(node.name) else None
            loop_depth = 0
        if isinstance(node, ast.Call):
            # torch.compile(f)(x) / ctypes.CDLL(p).fn(...): made and
            # invoked in one expression
            inner = node.func.value if isinstance(node.func, ast.Attribute) else node.func
            if isinstance(inner, ast.Call):
                iname = _builder(inner)
                if iname is not None:
                    invoked.add(id(inner))
                    report(node, iname, "is made and invoked in one expression: the handle dies "
                           "with the statement")
            name = _builder(node)
            if name is not None and id(node) not in invoked:
                if loop_depth > 0:
                    report(node, name, "inside a loop: each iteration builds or loads again")
                elif dispatch is not None:
                    report(node, name, f"inside per-dispatch `{dispatch}`: every dispatch builds "
                           "or loads again")
        entering = isinstance(node, (ast.For, ast.AsyncFor, ast.While))
        for child in ast.iter_child_nodes(node):
            visit(child, loop_depth + (1 if entering else 0), dispatch)

    visit(ctx.tree, 0, None)
    return out

