"""Finding: one rule violation at one source location."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str  # posix-style, relative to the scan root when possible
    line: int  # 1-based
    col: int  # 0-based (ast convention)
    rule_id: str
    rule_name: str
    message: str
    # structured detail for machine consumers (--json): the call
    # chain an interprocedural finding rode in on, and the
    # domain-inference steps behind a complexity classification.
    # Defaults keep the positional 6-arg constructor (every existing
    # rule) and the frozen/order contract intact.
    chain: tuple = ()
    domain_trace: tuple = ()

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: "
            f"{self.rule_id} [{self.rule_name}] {self.message}"
        )

    def to_json(self) -> dict:
        return dataclasses.asdict(self)
