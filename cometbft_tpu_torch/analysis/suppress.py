"""Suppression comments.

Three spellings, all comment-based so they survive formatters:

``# bftlint: disable=ASY101[,TCH201]``
    silences the named rule(s) on this line only.
``# bftlint: disable-next=ASY101``
    silences the named rule(s) on the following line.
``# bftlint: disable-file=ASY101``
    silences the named rule(s) for the whole file (conventionally
    placed near the top).

Rules may be named by id (``ASY101``) or name
(``blocking-call-in-async``); ``all`` matches every rule.  Unknown
rule names in a suppression are themselves reported as findings
(``SUP001``) so typos cannot silently disable nothing.
"""
from __future__ import annotations

import io
import re
import tokenize
from typing import List, NamedTuple, Set, Tuple

from .findings import Finding
from .registry import resolve

_DIRECTIVE = re.compile(
    r"#\s*bftlint:\s*(disable(?:-next|-file)?)\s*=\s*"
    r"([A-Za-z0-9_\-]+(?:\s*,\s*[A-Za-z0-9_\-]+)*)"
)

ALL = "all"


class Suppressions(NamedTuple):
    # (line, rule_id-or-ALL) pairs; file-wide entries use line 0
    by_line: Set[Tuple[int, str]]
    file_wide: Set[str]
    errors: List[Finding]

    def is_suppressed(self, line: int, rule_id: str) -> bool:
        return (
            rule_id in self.file_wide
            or ALL in self.file_wide
            or (line, rule_id) in self.by_line
            or (line, ALL) in self.by_line
        )


def parse_suppressions(path: str, source: str) -> Suppressions:
    by_line: Set[Tuple[int, str]] = set()
    file_wide: Set[str] = set()
    errors: List[Finding] = []
    for lineno, comment in _comments(source):
        m = _DIRECTIVE.search(comment)
        if m is None:
            continue
        kind, spec = m.group(1), m.group(2)
        for raw in spec.split(","):
            raw = raw.strip()
            rid = ALL if raw == ALL else resolve(raw)
            if rid is None:
                errors.append(
                    Finding(
                        path, lineno, 0, "SUP001", "unknown-suppression",
                        f"suppression names unknown rule {raw!r}",
                    )
                )
                continue
            if kind == "disable":
                by_line.add((lineno, rid))
            elif kind == "disable-next":
                by_line.add((lineno + 1, rid))
            else:  # disable-file
                file_wide.add(rid)
    return Suppressions(by_line, file_wide, errors)


def _comments(source: str):
    """Yield (lineno, text) for every comment token.

    Falls back to a line-regex scan if tokenization fails (the engine
    reports the syntax error separately via ast.parse).
    """
    try:
        for tok in tokenize.generate_tokens(
            io.StringIO(source).readline
        ):
            if tok.type == tokenize.COMMENT:
                yield tok.start[0], tok.string
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for i, ln in enumerate(source.splitlines(), 1):
            if "#" in ln:
                yield i, ln[ln.index("#"):]
