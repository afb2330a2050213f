"""Module-scoped logfmt error records.

The part of the JAX package's ``utils/log.py`` that the port uses: the
verify scheduler and the vote coalescer report a failed dispatch, and
the blocksync reactor a refused block, as one logfmt line on stderr
(``ts=... level=error module=crypto.sched msg="..." lanes=150``).
"""

from __future__ import annotations

import sys
import threading
import time
from typing import Any

_lock = threading.Lock()


def _quote(v: Any) -> str:
    s = f"{v:.6g}" if isinstance(v, float) else str(v)
    if any(c in s for c in ' "=\n'):
        s = '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'
    return s


class Logger:
    __slots__ = ("module",)

    def __init__(self, module: str) -> None:
        self.module = module

    def error(self, msg: str, **fields: Any) -> None:
        self._write("error", msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._write("info", msg, fields)

    def _write(self, level: str, msg: str, fields) -> None:
        now = time.time()
        line = (
            f"ts={time.strftime('%Y-%m-%dT%H:%M:%S', time.gmtime(now))}"
            f".{int(now * 1000) % 1000:03d}Z level={level} module={self.module}"
            f" msg={_quote(msg)}"
            + "".join(f" {k}={_quote(v)}" for k, v in fields.items())
            + "\n"
        )
        with _lock:
            try:
                sys.stderr.write(line)
            except Exception:
                pass


def get_logger(module: str) -> Logger:
    return Logger(module)
