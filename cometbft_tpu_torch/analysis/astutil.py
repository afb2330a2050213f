"""Shared AST helpers for bftlint rules (stdlib ``ast`` only)."""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional


# the package directories whose planes the path-scoped rules know: the
# port's and the JAX package's. A rule's plane prefixes ("consensus/")
# are relative to the package a file lies in, so the same planes apply
# to a scan of either tree.
PACKAGE_DIRS = ("cometbft_tpu_torch", "cometbft_tpu")


def package_path(path: str) -> Optional[str]:
    """``path`` relative to the package directory it lies in (its
    first component named in PACKAGE_DIRS), posix-style; None for a
    file outside both packages."""
    parts = path.replace("\\", "/").split("/")
    for i, part in enumerate(parts[:-1]):
        if part in PACKAGE_DIRS:
            return "/".join(parts[i + 1:])
    return None


def in_planes(path: str, prefixes) -> bool:
    """Whether ``path`` lies in a plane of ``prefixes`` (package-
    relative, e.g. "consensus/") of either package."""
    rel = package_path(path)
    return rel is not None and rel.startswith(tuple(prefixes))


def dotted(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def walk_in_function(node: ast.AST) -> Iterator[ast.AST]:
    """Like ast.walk over a function body, but does not descend into
    nested function/class definitions (their bodies run in a different
    execution context)."""
    stack: List[ast.AST] = list(ast.iter_child_nodes(node))
    while stack:
        child = stack.pop()
        yield child
        if isinstance(
            child,
            (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef,
             ast.Lambda),
        ):
            continue
        stack.extend(ast.iter_child_nodes(child))


def body_awaits(node: ast.AST) -> bool:
    """True if executing this node can hit an await / async-for /
    async-with in the *same* function (nested defs excluded)."""
    return any(
        isinstance(n, (ast.Await, ast.AsyncFor, ast.AsyncWith))
        for n in walk_in_function(node)
    )
