"""A hard wall limit for the port's tests that start an event loop, a
node or a verify scheduler.

``asyncio.wait_for`` cannot end a loop whose thread is blocked, and a
thread left blocked in an executor keeps a test process from exiting
(``asyncio.run`` waits for it, and so does the interpreter's exit). So
the limit is kept outside Python's threads: ``faulthandler`` dumps
every thread's stack to the test run's stderr and ends the process when
a test outlives ``LIMIT_S``. Under pytest-xdist that fails the test
("worker crashed") and a new worker takes the tests queued behind it,
so a hang costs one test, not the run. A test module takes the limit
by importing the fixture::

    from torch_hard_limit import hard_limit  # noqa: F401
"""

import faulthandler
import sys

import pytest

# the slowest of these tests takes under a minute on a loaded CPU
LIMIT_S = 300.0


def _stderr_fd(config) -> int:
    """The test run's stderr (pytest keeps a duplicate that its output
    capture does not redirect), else the process's."""
    try:
        from _pytest.faulthandler import fault_handler_stderr_fd_key

        return config.stash[fault_handler_stderr_fd_key]
    except (ImportError, KeyError):
        return sys.__stderr__.fileno()


@pytest.fixture(autouse=True)
def hard_limit(request):
    faulthandler.dump_traceback_later(LIMIT_S, exit=True, file=_stderr_fd(request.config))
    yield
    faulthandler.cancel_dump_traceback_later()
