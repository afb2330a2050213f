"""Pubsub query language (reference libs/pubsub/query). A copy of the
JAX package's ``utils/pubsub_query.py``.

Grammar subset (covers everything the reference's RPC docs use):
  query     = condition { "AND" condition }
  condition = key op value
  op        = "=" | "<" | ">" | "<=" | ">=" | "CONTAINS" | "EXISTS"
  value     = 'single-quoted string' | number
Keys are dotted event-attribute names ("tm.event", "tx.height",
"transfer.sender"). Numbers compare numerically; strings lexically.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, List, Union

_TOKEN = re.compile(
    r"\s*(?:(?P<op><=|>=|=|<|>)|(?P<kw>AND\b|CONTAINS\b|EXISTS\b)"
    r"|(?P<str>'(?:[^'\\]|\\.)*')|(?P<num>-?\d+(?:\.\d+)?)"
    r"|(?P<key>[\w.\-/]+))"
)


@dataclass
class Condition:
    key: str
    op: str  # '=', '<', '>', '<=', '>=', 'CONTAINS', 'EXISTS'
    value: Union[str, float, None]


class Query:
    """Compiled query; match against {attr_key: [values...]}."""

    def __init__(self, conditions: List[Condition], source: str = ""):
        self.conditions = conditions
        self.source = source

    def __repr__(self) -> str:
        return f"Query({self.source!r})"

    def matches(self, attrs: Dict[str, List[str]]) -> bool:
        return all(self._match_one(c, attrs) for c in self.conditions)

    @staticmethod
    def _match_one(c: Condition, attrs: Dict[str, List[str]]) -> bool:
        values = attrs.get(c.key)
        if values is None:
            return False
        if c.op == "EXISTS":
            return True
        for v in values:
            if c.op == "CONTAINS":
                if str(c.value) in v:
                    return True
                continue
            if isinstance(c.value, float):
                try:
                    lhs = float(v)
                except ValueError:
                    continue
                rhs = c.value
            else:
                lhs, rhs = v, str(c.value)
            if (
                (c.op == "=" and lhs == rhs)
                or (c.op == "<" and lhs < rhs)
                or (c.op == ">" and lhs > rhs)
                or (c.op == "<=" and lhs <= rhs)
                or (c.op == ">=" and lhs >= rhs)
            ):
                return True
        return False


def parse(s: str) -> Query:
    toks = []
    pos = 0
    while pos < len(s):
        m = _TOKEN.match(s, pos)
        if m is None or m.end() == pos:
            if s[pos:].strip():
                raise ValueError(f"bad query near {s[pos:]!r}")
            break
        pos = m.end()
        kind = m.lastgroup
        toks.append((kind, m.group(kind)))
    conds: List[Condition] = []
    i = 0
    while i < len(toks):
        if toks[i] == ("kw", "AND"):
            i += 1
            continue
        if toks[i][0] != "key":
            raise ValueError(f"expected key, got {toks[i]}")
        key = toks[i][1]
        i += 1
        if i >= len(toks):
            raise ValueError("truncated condition")
        kind, tok = toks[i]
        if (kind, tok) == ("kw", "EXISTS"):
            conds.append(Condition(key, "EXISTS", None))
            i += 1
            continue
        if kind == "op":
            op = tok
        elif (kind, tok) == ("kw", "CONTAINS"):
            op = "CONTAINS"
        else:
            raise ValueError(f"expected operator, got {tok!r}")
        i += 1
        if i >= len(toks):
            raise ValueError("missing value")
        vkind, vtok = toks[i]
        if vkind == "str":
            value: Union[str, float] = (
                vtok[1:-1].replace("\\'", "'").replace("\\\\", "\\")
            )
        elif vkind == "num":
            value = float(vtok)
        else:
            raise ValueError(f"expected value, got {vtok!r}")
        conds.append(Condition(key, op, value))
        i += 1
    if not conds:
        raise ValueError("empty query")
    return Query(conds, s)
