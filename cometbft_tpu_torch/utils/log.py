"""Module-scoped logfmt records with levels and lazy values.

The JAX package's ``utils/log.py`` (reference libs/log) but for its
``lazy_hex`` helper and its cache of loggers, which nothing here uses:
one logfmt line per record (``ts=... level=error module=crypto.sched
msg="..." lanes=150``; bytes as hex, booleans as ``true``/``false``), a
level chosen globally and per module
(``set_level("consensus:debug,*:info")``, which the command line's
``--log-level`` and ``base.log_level`` call, or the ``CMT_LOG_LEVEL``
environment variable; default ``info``), :class:`Lazy` values rendered
only when a record is written, bound fields (``with_fields``) and a
pluggable writer (``set_writer``). One departure: with no writer set
(``set_writer(None)``, the default) a record goes to ``sys.stderr`` as
it stands when the record is written, where the JAX module keeps the
stream it found at import.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from typing import Any, Callable, Dict, Optional, TextIO

DEBUG, INFO, ERROR, NONE = 10, 20, 40, 100
_LEVEL_NAMES = {DEBUG: "debug", INFO: "info", ERROR: "error"}
_NAME_LEVELS = {"debug": DEBUG, "info": INFO, "error": ERROR, "none": NONE}

_lock = threading.Lock()
_writer: Optional[TextIO] = None  # None: sys.stderr at write time
_global_level = _NAME_LEVELS.get(os.environ.get("CMT_LOG_LEVEL", "info").lower(), INFO)
_module_levels: Dict[str, int] = {}


class Lazy:
    """Defers a value until (and unless) the record is written."""

    __slots__ = ("_fn",)

    def __init__(self, fn: Callable[[], Any]):
        self._fn = fn

    def render(self) -> Any:
        try:
            return self._fn()
        except Exception as e:  # a log value must never raise
            return f"<lazy error: {e}>"


def set_writer(w: Optional[TextIO]) -> None:
    """Where records go; None is ``sys.stderr`` at write time."""
    global _writer
    with _lock:
        _writer = w


def set_level(spec: str) -> None:
    """``"info"`` or ``"consensus:debug,blocksync:error,*:info"``.
    Unknown names raise ValueError."""
    global _global_level
    mods: Dict[str, int] = {}
    glob = None
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        mod, name = part.rsplit(":", 1) if ":" in part else ("*", part)
        name = name.strip().lower()
        if name not in _NAME_LEVELS:
            raise ValueError(f"unknown log level {name!r}")
        if mod.strip() in ("*", ""):
            glob = _NAME_LEVELS[name]
        else:
            mods[mod.strip()] = _NAME_LEVELS[name]
    with _lock:
        _module_levels.clear()
        _module_levels.update(mods)
        if glob is not None:
            _global_level = glob


def _quote(v: Any) -> str:
    if isinstance(v, Lazy):
        v = v.render()
    if isinstance(v, float):
        s = f"{v:.6g}"
    elif isinstance(v, (bytes, bytearray)):
        s = v.hex()
    elif isinstance(v, bool):
        s = "true" if v else "false"
    else:
        s = str(v)
    if any(c in s for c in ' "=\n'):
        s = '"' + s.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n") + '"'
    return s


class Logger:
    """Module-scoped logfmt logger with optional bound fields."""

    __slots__ = ("module", "_bound")

    def __init__(self, module: str, bound: Optional[Dict[str, Any]] = None) -> None:
        self.module = module
        self._bound = bound or {}

    def with_fields(self, **fields: Any) -> "Logger":
        """A child whose records carry ``fields`` (reference logger.With)."""
        return Logger(self.module, {**self._bound, **fields})

    def error(self, msg: str, **fields: Any) -> None:
        self._write(ERROR, msg, fields)

    def info(self, msg: str, **fields: Any) -> None:
        self._write(INFO, msg, fields)

    def debug(self, msg: str, **fields: Any) -> None:
        self._write(DEBUG, msg, fields)

    def _write(self, level: int, msg: str, fields) -> None:
        if level < _module_levels.get(self.module, _global_level):
            return
        now = time.time()
        line = (
            f"ts={time.strftime('%Y-%m-%dT%H:%M:%S', time.gmtime(now))}"
            f".{int(now * 1000) % 1000:03d}Z level={_LEVEL_NAMES[level]} module={self.module}"
            f" msg={_quote(msg)}"
            + "".join(f" {k}={_quote(v)}" for k, v in self._bound.items())
            + "".join(f" {k}={_quote(v)}" for k, v in fields.items())
            + "\n"
        )
        with _lock:
            try:
                (_writer or sys.stderr).write(line)
            except Exception:
                pass


def get_logger(module: str) -> Logger:
    return Logger(module)
