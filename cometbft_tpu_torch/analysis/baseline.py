"""Checked-in baseline of pre-existing violations.

The baseline maps ``path -> rule_id -> count``.  Counts, not line
numbers: unrelated edits shift lines constantly, and a count contract
("this file has at most N ASY104s") is stable under reflow while
still ratcheting — any NEW violation pushes the count over and fails
the run, and fixing one makes the entry stale so it gets ratcheted
down rather than quietly becoming headroom.
"""
from __future__ import annotations

import json
from typing import Dict, List, NamedTuple, Tuple

from .findings import Finding

VERSION = 1

BaselineMap = Dict[str, Dict[str, int]]


class StaleEntry(NamedTuple):
    path: str
    rule_id: str
    allowed: int
    current: int

    def render(self) -> str:
        return (
            f"stale baseline: {self.path} {self.rule_id} allows "
            f"{self.allowed} but only {self.current} remain — "
            f"regenerate with --update-baseline"
        )


def load(path: str) -> BaselineMap:
    with open(path, encoding="utf-8") as f:
        data = json.load(f)
    if not isinstance(data, dict) or "entries" not in data:
        raise ValueError(f"{path}: not a bftlint baseline file")
    return {
        p: dict(rules) for p, rules in data["entries"].items()
    }


def save(path: str, entries: BaselineMap) -> None:
    doc = {
        "version": VERSION,
        "note": (
            "pre-existing bftlint violations; regenerate with "
            "`python -m cometbft_tpu_torch.analysis --update-baseline`"
        ),
        "entries": {
            p: {r: entries[p][r] for r in sorted(entries[p])}
            for p in sorted(entries)
        },
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(doc, f, indent=1, sort_keys=False)
        f.write("\n")


def build(findings: List[Finding]) -> BaselineMap:
    entries: BaselineMap = {}
    for f in findings:
        entries.setdefault(f.path, {}).setdefault(f.rule_id, 0)
        entries[f.path][f.rule_id] += 1
    return entries


def apply(
    findings: List[Finding], baseline: BaselineMap
) -> Tuple[List[Finding], List[StaleEntry]]:
    """Split current findings against the baseline.

    Returns ``(new, stale)``.  A (path, rule) pair whose current count
    exceeds its allowance reports ALL its findings (line numbers can't
    tell old from new); a pair under its allowance is stale.
    """
    current = build(findings)
    new: List[Finding] = []
    for f in findings:
        allowed = baseline.get(f.path, {}).get(f.rule_id, 0)
        got = current[f.path][f.rule_id]
        if got > allowed:
            note = (
                f" ({got} found, baseline allows {allowed})"
                if allowed
                else ""
            )
            new.append(
                Finding(
                    f.path, f.line, f.col, f.rule_id, f.rule_name,
                    f.message + note,
                    chain=f.chain,
                    domain_trace=f.domain_trace,
                )
            )
    stale: List[StaleEntry] = []
    for p, rules in baseline.items():
        for rid, allowed in rules.items():
            got = current.get(p, {}).get(rid, 0)
            if got < allowed:
                stale.append(StaleEntry(p, rid, allowed, got))
    return new, sorted(stale)
