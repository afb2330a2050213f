"""The build and the loaders of the host's native lanes (``native/*.cpp``).

Four C++ sources at the repository root, outside both packages, read
and never written: ``batchverify.cpp`` (the host plane's chunk
verifier), ``wirecodec.cpp`` (commit encode and decode, merkle roots,
SHA-256 in bulk, varints), ``finalize.cpp`` (the finalize pass) and
``logdb.cpp`` (the log-structured storage engine). The first three are
CPython extensions; ``logdb`` is a plain C library loaded with ctypes.

One routine builds all four, with ``g++``, into ``build/native/`` at the
repository root (git-ignored): under an ``fcntl.flock`` on
``build/native/.build.lock`` it checks again whether a library is stale
(missing, or older than its source), has ``g++`` write a temporary name
in the same directory and renames it into place. A process therefore
never loads a half-written library, and two processes building at once
both load whole ones. ``build_all`` starts one ``g++`` a source, all
together. The JAX package keeps its own builds elsewhere; the two never
share a library.

``Lane`` is the loader of one extension. ``module()`` returns it, or
None when the lane's environment gate is ``"0"``, when the build or the
load failed (``reason`` keeps ``g++``'s stderr), or, for a non-blocking
lane, while another thread is building it; the reason is logged once.
Every caller keeps a byte-identical portable path for None.
``prewarm()`` starts the build on a daemon thread, so no event loop
waits on ``g++``.
"""

from __future__ import annotations

import fcntl
import importlib.util
import os
import subprocess
import sysconfig
import tempfile
import threading
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Callable, Dict, Iterable, Optional, Tuple

from .log import get_logger

ROOT = Path(__file__).resolve().parent.parent.parent
SOURCES = ROOT / "native"
BUILD = ROOT / "build" / "native"

# lane -> (library file stem, source file, a CPython extension)
LANES: Dict[str, Tuple[str, str, bool]] = {
    "batchverify": ("_batchverify", "batchverify.cpp", True),
    "wirecodec": ("_wirecodec", "wirecodec.cpp", True),
    "finalize": ("_finalize", "finalize.cpp", True),
    "logdb": ("liblogdb", "logdb.cpp", False),
}

_log = get_logger("native")


class BuildError(RuntimeError):
    """A lane did not build; ``errors`` maps each such lane to g++'s
    stderr."""

    def __init__(self, errors: Dict[str, str]):
        super().__init__("; ".join(f"{k}: {v.strip()[-2000:]}" for k, v in errors.items()))
        self.errors = errors


def library(lane: str) -> Path:
    return BUILD / f"{LANES[lane][0]}.so"


def source(lane: str) -> Path:
    return SOURCES / LANES[lane][1]


def stale(lane: str, path: Optional[Path] = None) -> bool:
    path = Path(path or library(lane))
    return not path.exists() or path.stat().st_mtime < source(lane).stat().st_mtime


def _command(lane: str, out: str) -> list:
    _, src, python = LANES[lane]
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC"]
    if python:
        cmd += ["-I", sysconfig.get_paths()["include"]]
    cmd += [str(SOURCES / src), "-o", out]
    if python:
        cmd.append("-ldl")  # SHA-256 and ed25519 come from a dlopen'ed libcrypto
    return cmd


@contextmanager
def _locked(directory: Path):
    directory.mkdir(parents=True, exist_ok=True)
    fd = os.open(directory / ".build.lock", os.O_RDWR | os.O_CREAT, 0o644)
    try:
        fcntl.flock(fd, fcntl.LOCK_EX)
        yield
    finally:
        os.close(fd)  # releases the lock


def _build(jobs: Iterable[Tuple[str, Path]], force: bool) -> Dict[str, float]:
    """Build each (lane, library path) that is stale (every one with
    ``force``), one g++ a source started together, under the lock of
    the libraries' directory. Returns the seconds from the start to each
    built library's rename; raises ``BuildError``."""
    jobs = [(lane, Path(p)) for lane, p in jobs]
    (directory,) = {p.parent for _, p in jobs}
    built: Dict[str, float] = {}
    errors: Dict[str, str] = {}
    with _locked(directory):
        todo = [(lane, p) for lane, p in jobs if force or stale(lane, p)]
        t0 = time.perf_counter()
        running = []
        for lane, p in todo:
            fd, tmp = tempfile.mkstemp(prefix=f".{p.stem}.", suffix=".tmp.so", dir=directory)
            os.close(fd)
            try:
                proc = subprocess.Popen(_command(lane, tmp), stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE)
            except OSError as e:  # no g++ on this machine
                os.unlink(tmp)
                errors[lane] = f"g++ did not start: {e}"
                continue
            running.append((lane, p, tmp, proc))
        for lane, p, tmp, proc in running:
            try:
                _, err = proc.communicate()
                if proc.returncode == 0:
                    os.replace(tmp, p)
                    built[lane] = time.perf_counter() - t0
                else:
                    errors[lane] = err.decode(errors="replace")
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
    if errors:
        raise BuildError(errors)
    return built


def ensure(lane: str, path: Optional[Path] = None) -> Path:
    """The lane's library, built first if it is stale."""
    path = Path(path or library(lane))
    _build([(lane, path)], force=False)
    return path


def build_all(force: bool = False) -> Dict[str, float]:
    """Build every lane that is stale (all of them with ``force``), in
    parallel under one lock; seconds to each rename."""
    return _build([(lane, library(lane)) for lane in LANES], force)


def load_extension(lane: str, path: Path):
    spec = importlib.util.spec_from_file_location(LANES[lane][0], str(path))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Lane:
    """The loader of one native extension. ``blocking`` lanes make a
    caller wait for a build in flight on another thread; the others
    return None meanwhile (the caller's portable path runs), so an
    event loop never parks on ``g++``. ``check`` vets the loaded module
    (None or False: not used)."""

    def __init__(self, lane: str, gate: str, blocking: bool = False,
                 check: Optional[Callable] = None):
        self.lane = lane
        self.gate = gate
        self.blocking = blocking
        self.check = check
        self.path = library(lane)
        self.reason = "not loaded yet"
        self._mod = None
        self._tried = False
        self._lock = threading.Lock()
        self._logged = None

    def _note(self, reason: str) -> None:
        self.reason = reason
        if self._logged != reason.split(":")[0]:
            self._logged = reason.split(":")[0]
            _log.info("native lane not loaded", lane=self.lane, reason=reason[:400])

    def module(self):
        if self._tried:
            return self._mod
        if not self._lock.acquire(blocking=self.blocking):
            # a build is in flight on another thread (the prewarm):
            # the caller's portable path runs rather than waiting
            self._note("building: a build is in flight on another thread")
            return None
        try:
            if self._tried:
                return self._mod
            self._tried = True
            if os.environ.get(self.gate) == "0":
                self._note(f"disabled: {self.gate}=0")
                return None
            try:
                ensure(self.lane, self.path)
                mod = load_extension(self.lane, self.path)
            except BuildError as e:
                self._note(f"build failed: {e.errors.get(self.lane, e)}")
                return None
            except (OSError, ImportError) as e:
                self._note(f"load failed: {e!r}")
                return None
            if self.check is not None and not self.check(mod):
                self._note(f"unusable: {self.lane} refused by its check")
                return None
            self._mod = mod
            self.reason = f"loaded from {self.path}"
            return mod
        finally:
            self._lock.release()

    def prewarm(self) -> Optional[threading.Thread]:
        """Start the one-time build and load on a daemon thread (None
        once tried)."""
        if self._tried:
            return None
        t = threading.Thread(target=self.module, name=f"{self.lane}-prewarm", daemon=True)
        t.start()
        return t

    def wait(self):
        """The module once no build is in flight: a thread that needs
        the lane (a measurement, a test) waits for the prewarm."""
        with self._lock:
            pass
        return self.module()

    def force_portable(self) -> None:
        """Load nothing until ``restore``: every caller runs its
        portable path."""
        with self._lock:
            self._mod, self._tried = None, True
            self.reason = "forced portable"

    def restore(self):
        """Undo ``force_portable`` (or a failed attempt) and load
        again; the library is reused when it is fresh."""
        with self._lock:
            self._mod, self._tried = None, False
        return self.wait()
