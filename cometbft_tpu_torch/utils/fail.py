"""Crash-point injection (reference libs/fail/fail.go:28).

Every call to fail_point() increments a process-wide counter; when the
counter reaches the value of the FAIL_TEST_INDEX environment variable
the process exits hard (os._exit, no cleanup, no atexit — simulating a
power cut at exactly that interleaving). Used by crash/recovery tests
to prove WAL + handshake replay restore every intermediate state.

Callsites mirror the reference's (consensus/state.go:1769-1837,
state/execution.go:313-363): around block save, WAL end-height, ABCI
finalize and commit. A copy of the JAX package's ``utils/fail.py``.
"""

from __future__ import annotations

import os

_counter = 0
_target = None


def _get_target():
    global _target
    if _target is None:
        v = os.environ.get("FAIL_TEST_INDEX", "")
        _target = int(v) if v else -1
    return _target


def fail_point(name: str = "") -> None:
    global _counter
    target = _get_target()
    if target < 0:
        return
    if _counter == target:
        import sys

        print(f"FAIL_TEST_INDEX={target} hit at {name!r}; dying",
              file=sys.stderr, flush=True)
        os._exit(99)
    _counter += 1


def reset() -> None:  # test helper
    global _counter, _target
    _counter = 0
    _target = None
