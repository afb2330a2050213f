"""Rule registry.

A rule is a callable ``check(ctx) -> Iterable[Finding]`` registered
under a stable id (``ASY101``) and a human name
(``blocking-call-in-async``).  Suppression comments and the baseline
refer to rules by either spelling.
"""
from __future__ import annotations

import ast
from typing import Callable, Dict, Iterable, List, NamedTuple

from .findings import Finding


class FileContext(NamedTuple):
    """Everything a rule gets to look at for one file."""

    path: str  # relative posix path used in findings
    tree: ast.Module
    source: str
    lines: List[str]


class Rule(NamedTuple):
    rule_id: str
    name: str
    doc: str
    check: Callable[[FileContext], Iterable[Finding]]


class ProjectRule(NamedTuple):
    """A whole-program rule: ``check(project) -> Iterable[Finding]``
    over the callgraph.Project model instead of one FileContext.
    Project rules may share a rule id with a file rule (the ASY102
    deep-chain upgrade reports under the same id as the single-file
    pass); suppressions and the baseline treat them identically."""

    rule_id: str
    name: str
    doc: str
    check: Callable[["object"], Iterable[Finding]]


_RULES: Dict[str, Rule] = {}
_PROJECT_RULES: Dict[str, ProjectRule] = {}


def rule(rule_id: str, name: str, doc: str):
    """Decorator registering ``check`` under ``rule_id``/``name``."""

    def deco(fn: Callable[[FileContext], Iterable[Finding]]):
        if rule_id in _RULES or any(
            r.name == name for r in _RULES.values()
        ):
            raise ValueError(f"duplicate rule {rule_id}/{name}")
        _RULES[rule_id] = Rule(rule_id, name, fn.__doc__ or doc, fn)
        return fn

    return deco


def project_rule(rule_id: str, name: str, doc: str):
    """Decorator registering an interprocedural rule."""

    def deco(fn):
        if rule_id in _PROJECT_RULES:
            raise ValueError(f"duplicate project rule {rule_id}")
        _PROJECT_RULES[rule_id] = ProjectRule(
            rule_id, name, fn.__doc__ or doc, fn
        )
        return fn

    return deco


def all_rules() -> List[Rule]:
    _load_builtin()
    return [r for _, r in sorted(_RULES.items())]


def all_project_rules() -> List[ProjectRule]:
    _load_builtin()
    return [r for _, r in sorted(_PROJECT_RULES.items())]


def resolve(spec: str) -> str | None:
    """Map an id or name (as written in a suppression) to a rule id."""
    _load_builtin()
    spec = spec.strip()
    if spec in _RULES or spec in _PROJECT_RULES:
        return spec
    for r in _RULES.values():
        if r.name == spec:
            return r.rule_id
    for pr in _PROJECT_RULES.values():
        if pr.name == spec:
            return pr.rule_id
    return None


def _load_builtin() -> None:
    # Import for side effect of registration; idempotent.
    from . import rules  # noqa: F401
