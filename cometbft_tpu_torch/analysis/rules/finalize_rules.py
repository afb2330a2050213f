"""Finalize-path batching rule (whole-program pass).

ASY123 guards the native finalize lane (state/native_finalize.py):
once the per-block hash/encode work is batched into ONE GIL-releasing
native pass, any NEW Python ``for``-loop (or comprehension) that
hashes or encodes per item on a finalize-reachable call path quietly
reintroduces the host overhead the lane removed — and, on the
pipelined path, work that no longer releases the GIL while riding
``asyncio.to_thread``. The sanctioned shape is the batch seam itself:
``native_finalize.finalize_pass`` / ``merkle.hash_from_byte_slices``
(both route native and are excluded below), with downstream consumers
reading the precomputed ``FinalizeArtifacts`` instead of re-deriving.

Portable FALLBACK loops (the no-compiler twin, replay/compat decode
paths) are real and allowed — suppress their loop lines with a
justified ``# bftlint: disable=ASY123 — ...`` comment, the same
sanctioned-sink contract as ASY114/ASY116.
"""
from __future__ import annotations

import ast
from typing import Iterator, List, Optional, Tuple

from ..astutil import dotted, in_planes
from ..callgraph import Project, walk_with_lambdas
from ..findings import Finding
from ..registry import project_rule

# the finalize phases (state/execution.py) — BFS roots; everything
# they reach synchronously runs per committed block
_FINALIZE_ROOTS = {
    "apply_block",
    "apply_verified_block",
    "apply_finalize",
    "apply_hash_persist",
    "apply_complete",
}

# where a per-item hash/encode loop on the finalize path is THIS
# rule's bug class (the state plane owns the finalize data path)
_ASY123_PREFIXES = ("state/",)  # relative to the scanned package

# the sanctioned batch seams: they ARE the native lane (portable
# twins included — differential tests pin them byte-identical)
_SEAM_PATHS = (
    "state/native_finalize.py",
    "crypto/merkle.py",
    "utils/wirecodec.py",
)

# hash/encode leaves by call spelling (last dotted component)
_HASH_ENC_LEAVES = {
    "sha256": "hashes per item",
    "leaf_hash": "leaf-hashes per item",
    "inner_hash": "hashes per item",
    "_enc_abci_event": "encodes an ABCI event per item",
    "_enc_tx_result": "encodes a tx result per item",
    "attr_kvi": "flattens event attributes per item",
}

_ASY123_MAX_DEPTH = 8


def _target_names(t: ast.AST) -> set:
    return {
        n.id for n in ast.walk(t) if isinstance(n, ast.Name)
    }


def _loop_regions(fn_node) -> Iterator[Tuple[ast.AST, set, list, str]]:
    """(anchor, loop-var names, body nodes, kind) per loop/comp."""
    for node in walk_with_lambdas(fn_node):
        if isinstance(node, ast.For):
            body = []
            for stmt in node.body:
                body.append(stmt)
                body.extend(walk_with_lambdas(stmt))
            yield node, _target_names(node.target), body, "for-loop"
        elif isinstance(
            node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                   ast.DictComp)
        ):
            names: set = set()
            for gen in node.generators:
                names |= _target_names(gen.target)
            elts = (
                [node.key, node.value]
                if isinstance(node, ast.DictComp)
                else [node.elt]
            )
            body = []
            for e in elts:
                body.append(e)
                body.extend(walk_with_lambdas(e))
            yield node, names, body, "comprehension"


def _per_item_calls(fn) -> Iterator[Tuple[ast.Call, str, str, str]]:
    """(call, spelling, why, kind) for hash/encode work done per
    iterated item: a known leaf called in a loop body, or
    ``<loopvar>.encode()`` (the per-result proto encode pattern —
    receiver-checked so ordinary ``str.encode`` on non-items stays
    out)."""
    for _, names, body, kind in _loop_regions(fn.node):
        for node in body:
            if not isinstance(node, ast.Call):
                continue
            name = dotted(node.func)
            if name is None:
                continue
            last = name.rsplit(".", 1)[-1]
            why = _HASH_ENC_LEAVES.get(last)
            if why is None and last == "encode":
                root = name.split(".", 1)[0]
                if root in names:
                    why = "proto-encodes per item"
            if why is not None:
                yield node, name, why, kind


@project_rule(
    "ASY123",
    "per-item-hash-in-finalize-path",
    "a Python for-loop/comprehension hashes or encodes per item on a "
    "finalize-reachable call path: the native finalize lane "
    "(state/native_finalize.py) batches exactly this work into one "
    "GIL-releasing pass per block — thread its FinalizeArtifacts "
    "through instead, or justify the loop line (portable fallbacks)",
)
def per_item_hash_in_finalize_path(project: Project) -> List[Finding]:
    # BFS the synchronous call tree from the finalize phase roots
    roots = [
        fi
        for fi in project.functions.values()
        if fi.name in _FINALIZE_ROOTS
        and in_planes(fi.path, _ASY123_PREFIXES)
    ]
    reach = {}  # qualname -> (root name, chain of call spellings)
    queue = []
    for r in roots:
        if r.qualname not in reach:
            reach[r.qualname] = (r.name, ())
            queue.append((r, 0))
    while queue:
        fn, depth = queue.pop(0)
        if depth >= _ASY123_MAX_DEPTH:
            continue
        root, chain = reach[fn.qualname]
        for cs in fn.calls:
            callee = project.functions.get(cs.callee)
            if callee is None or callee.qualname in reach:
                continue
            reach[callee.qualname] = (root, chain + (cs.spelling,))
            queue.append((callee, depth + 1))

    out: List[Finding] = []
    seen = set()
    for qual in sorted(reach):
        fi = project.functions.get(qual)
        if fi is None:
            continue
        p = fi.path.replace("\\", "/")
        if not in_planes(p, _ASY123_PREFIXES):
            continue  # reached code outside the state plane: not ours
        if any(seam in p for seam in _SEAM_PATHS):
            continue  # the sanctioned batch seam itself
        root, chain = reach[qual]
        for call, name, why, kind in _per_item_calls(fi):
            if project._suppressed(fi.path, call.lineno, "ASY123"):
                continue
            key = (fi.path, call.lineno, name)
            if key in seen:
                continue
            seen.add(key)
            via = (
                " via " + " -> ".join(f"`{c}`" for c in chain)
                if chain
                else ""
            )
            out.append(
                Finding(
                    fi.path, call.lineno, call.col_offset,
                    "ASY123", "per-item-hash-in-finalize-path",
                    f"`{name}` {why} inside a {kind} in `{fi.name}`, "
                    f"reached from finalize root `{root}`{via} — this "
                    "runs per committed block on the apply path; "
                    "batch it through the native finalize lane "
                    "(state/native_finalize.finalize_pass artifacts) "
                    "or justify the line as a portable fallback",
                    chain=(root,) + chain + (fi.name,),
                )
            )
    return sorted(out)
