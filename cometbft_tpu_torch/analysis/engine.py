"""bftlint engine: walk paths, parse, run every rule, apply
suppressions.  Pure stdlib — importing this package must never pull
in torch or jax (the linter runs in CI lanes with no accelerator
deps)."""
from __future__ import annotations

import ast
import os
import time
from pathlib import Path
from typing import Dict, Iterable, List, Optional

from .findings import Finding
from .registry import FileContext, all_project_rules, all_rules
from .suppress import parse_suppressions

# repo root = parents[2] of this file (analysis/ -> cometbft_tpu_torch/ -> .)
REPO_ROOT = Path(__file__).resolve().parents[2]

_SKIP_DIRS = {"__pycache__", ".git", ".hypothesis", "node_modules"}


def iter_py_files(paths: Iterable[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if not path.exists():
            # a typo'd path must be a hard error, not a "clean" run
            # (and never an accidental --update-baseline wipe)
            raise FileNotFoundError(f"no such path: {p}")
        if path.is_dir():
            for dirpath, dirnames, filenames in os.walk(path):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in _SKIP_DIRS
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        out.append(Path(dirpath) / fn)
        elif path.suffix == ".py":
            out.append(path)
    return out


def rel_key(path: Path, root: Path = REPO_ROOT) -> str:
    """Stable posix-style key for findings and baseline entries."""
    try:
        return path.resolve().relative_to(root).as_posix()
    except ValueError:
        return path.as_posix()


def _analyze_file(key: str, source: str, timings=None):
    """Parse + per-file rules for ONE source: the shared pipeline
    behind both analyze_source (tests) and run (the gate). Returns
    ``(findings, suppressions_or_None, tree_or_None)`` — tree is
    None when the file does not parse (SYN000 already appended)."""
    t0 = time.perf_counter()
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return (
            [
                Finding(
                    key, e.lineno or 1, (e.offset or 1) - 1,
                    "SYN000", "syntax-error",
                    f"file does not parse: {e.msg}",
                )
            ],
            None,
            None,
        )
    finally:
        if timings is not None:
            timings["parse"] = (
                timings.get("parse", 0.0) + time.perf_counter() - t0
            )
    sup = parse_suppressions(key, source)
    ctx = FileContext(key, tree, source, source.splitlines())
    findings: List[Finding] = list(sup.errors)
    for r in all_rules():
        t0 = time.perf_counter()
        for f in r.check(ctx):
            if not sup.is_suppressed(f.line, f.rule_id):
                findings.append(f)
        if timings is not None:
            timings[r.rule_id] = (
                timings.get(r.rule_id, 0.0)
                + time.perf_counter() - t0
            )
    return findings, sup, tree


def analyze_source(source: str, path: str) -> List[Finding]:
    """Run every rule — file AND project (over a one-file project) —
    on one in-memory file (test entry point)."""
    findings, sup, tree = _analyze_file(path, source)
    if tree is not None:
        findings.extend(
            _run_project_rules([(path, tree)], {path: sup})
        )
    return sorted(findings)


def _run_project_rules(
    files, sups, timings: Optional[Dict[str, float]] = None
) -> List[Finding]:
    """Build the whole-program model once, then run every registered
    interprocedural rule over it (docs/LINT.md "Interprocedural
    rules"). Suppression comments apply exactly as for file rules,
    keyed by the finding's path."""
    from .callgraph import Project

    def sanctioned(path: str, line: int) -> bool:
        # a blocking-leaf line suppressed for ASY114 in ITS OWN file
        # is a sanctioned sink: chains through it vanish (see
        # callgraph.Project docstring / docs/LINT.md)
        sup = sups.get(path)
        return sup is not None and sup.is_suppressed(line, "ASY114")

    def suppressed(path: str, line: int, rule_id: str) -> bool:
        # generic per-line lookup for rules whose chains cross files
        # (ASY116 sanctions listener-registration lines by id)
        sup = sups.get(path)
        return sup is not None and sup.is_suppressed(line, rule_id)

    t0 = time.perf_counter()
    project = Project(
        list(files), sanctioned=sanctioned, suppressed=suppressed
    )
    if timings is not None:
        timings["callgraph-build"] = (
            timings.get("callgraph-build", 0.0)
            + time.perf_counter() - t0
        )
    out: List[Finding] = []
    for pr in all_project_rules():
        t0 = time.perf_counter()
        for f in pr.check(project):
            sup = sups.get(f.path)
            if sup is not None and sup.is_suppressed(f.line, f.rule_id):
                continue
            out.append(f)
        if timings is not None:
            key = f"{pr.rule_id}*"
            timings[key] = (
                timings.get(key, 0.0) + time.perf_counter() - t0
            )
    return out


def run(
    paths: Iterable[str],
    root: Path = REPO_ROOT,
    timings: Optional[Dict[str, float]] = None,
) -> List[Finding]:
    """Full pass: per-file rules over every file, then the
    interprocedural rules over the whole parsed set. ``timings``
    (optional dict) accumulates per-rule wall seconds — the CLI's
    ``--timings`` table, so the interprocedural pass's cost stays
    visible as the tree grows."""
    findings: List[Finding] = []
    parsed = []  # (key, tree) for the project pass
    sups = {}
    for file in iter_py_files(paths):
        key = rel_key(file, root)
        try:
            source = file.read_text(encoding="utf-8")
        except (OSError, UnicodeDecodeError) as e:
            findings.append(
                Finding(key, 1, 0, "SYN000", "syntax-error",
                        f"unreadable: {e}")
            )
            continue
        file_findings, sup, tree = _analyze_file(key, source, timings)
        findings.extend(file_findings)
        if tree is not None:
            sups[key] = sup
            parsed.append((key, tree))
    findings.extend(_run_project_rules(parsed, sups, timings))
    return sorted(findings)
