"""The native log-structured KV engine (``native/logdb.cpp``, via ctypes).

The port's counterpart of the JAX package's ``utils/logdb.py``: an
append log with an ordered index, CRC-framed records (a torn tail is
truncated on replay), atomic batches (one frame), prefix iteration over
a snapshot, compaction, and an exclusive ``flock`` on the file, so a
second process cannot open it. ``utils/native.py`` builds the library
into ``build/native/liblogdb.so``; ``open_kv("logdb", path)`` opens one.

Fix over the JAX package (ROADMAP C21): the engine's ``logdb_close``
frees its handle, and the JAX binding's ``close`` waits only for a
background compaction, so a ``get``, ``write_batch`` or ``compact``
running on another thread (ctypes releases the GIL) then ran on freed
memory. Here every native call holds a count of calls in flight, and
``close`` marks the handle closed, waits for that count to reach zero
and only then frees the handle; any call after ``close`` raises
``OSError``, the next step of an iterator opened before it included.
"""

from __future__ import annotations

import ctypes
import threading
from contextlib import contextmanager
from typing import Iterator, Optional, Tuple

from . import native
from .kv import KV

_lib = None
_load_lock = threading.Lock()

# compact on a background thread once this much of the log is dead
AUTO_COMPACT_DEAD_BYTES = 64 * 1024 * 1024

_P8 = ctypes.POINTER(ctypes.c_uint8)


def _load():
    global _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(native.ensure("logdb")))
        v, c, u32, u64 = ctypes.c_void_p, ctypes.c_char_p, ctypes.c_uint32, ctypes.c_uint64
        sigs = {
            "logdb_open": (v, [c]),
            "logdb_get": (ctypes.c_int, [v, c, u32, ctypes.POINTER(_P8), ctypes.POINTER(u32)]),
            "logdb_put": (ctypes.c_int, [v, c, u32, c, u32]),
            "logdb_del": (ctypes.c_int, [v, c, u32]),
            "logdb_batch": (ctypes.c_int, [v, c, u64]),
            "logdb_iter_new": (v, [v, c, u32]),
            "logdb_iter_next": (ctypes.c_int, [v, ctypes.POINTER(_P8), ctypes.POINTER(u32),
                                               ctypes.POINTER(_P8), ctypes.POINTER(u32)]),
            "logdb_iter_free": (None, [v]),
            "logdb_compact": (ctypes.c_int64, [v]),
            "logdb_count": (u64, [v]),
            "logdb_dead_bytes": (u64, [v]),
            "logdb_flush": (None, [v]),
            "logdb_close": (None, [v]),
            "logdb_free": (None, [v]),
        }
        for name, (res, args) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _lib = lib
        return lib


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, native.BuildError):
        return False


class LogDB(KV):
    """The KV interface over the native engine. Thread-safe: the engine
    serializes its operations on its own mutex, and ``close`` waits for
    every call in flight."""

    def __init__(self, path: str):
        self._lib = _load()
        self._h = self._lib.logdb_open(path.encode())
        if not self._h:
            raise OSError(f"logdb_open failed for {path} (locked by another process, "
                          "unreadable, or unwritable)")
        self._closed = False
        self._inflight = 0
        self._idle = threading.Condition()
        self._compacting = threading.Lock()

    @contextmanager
    def _call(self):
        """The handle, held for one native call: ``close`` waits for
        the call to return before freeing it."""
        with self._idle:
            if self._closed:
                raise OSError("logdb handle is closed")
            self._inflight += 1
        try:
            yield self._h
        finally:
            with self._idle:
                self._inflight -= 1
                if not self._inflight:
                    self._idle.notify_all()

    def get(self, key: bytes) -> Optional[bytes]:
        out, outl = _P8(), ctypes.c_uint32()
        with self._call() as h:
            rc = self._lib.logdb_get(h, bytes(key), len(key), ctypes.byref(out), ctypes.byref(outl))
        if rc == 1:
            return None
        if rc != 0:
            raise OSError("logdb_get failed")
        try:
            return ctypes.string_at(out, outl.value)
        finally:
            self._lib.logdb_free(out)

    def set(self, key: bytes, value: bytes) -> None:
        with self._call() as h:
            rc = self._lib.logdb_put(h, bytes(key), len(key), bytes(value), len(value))
        if rc != 0:
            raise OSError("logdb_put failed")

    def delete(self, key: bytes) -> None:
        with self._call() as h:
            rc = self._lib.logdb_del(h, bytes(key), len(key))
        if rc != 0:
            raise OSError("logdb_del failed")

    def write_batch(self, sets, deletes=()) -> None:
        sets, deletes = list(sets), list(deletes)
        parts = [len(sets).to_bytes(4, "little")]
        for k, v in sets:
            k, v = bytes(k), bytes(v)
            parts += [len(k).to_bytes(4, "little"), len(v).to_bytes(4, "little"), k, v]
        parts.append(len(deletes).to_bytes(4, "little"))
        for k in deletes:
            k = bytes(k)
            parts += [len(k).to_bytes(4, "little"), k]
        buf = b"".join(parts)
        with self._call() as h:
            rc = self._lib.logdb_batch(h, buf, len(buf))
            dead = self._lib.logdb_dead_bytes(h) if rc == 0 else 0
        if rc != 0:
            raise OSError("logdb_batch failed")
        if dead > AUTO_COMPACT_DEAD_BYTES and self._compacting.acquire(blocking=False):
            # off the commit path: the batch has committed; the rewrite
            # runs on a thread (the engine's mutex orders it with the
            # other calls, and close waits for it like for any call)
            def bg():
                try:
                    self.compact()
                except OSError:
                    pass  # closed meanwhile
                finally:
                    self._compacting.release()

            threading.Thread(target=bg, daemon=True, name="logdb-compact").start()

    def iter_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        with self._call() as h:
            it = self._lib.logdb_iter_new(h, bytes(prefix), len(prefix))
        if not it:
            raise OSError("logdb_iter_new failed")
        try:
            k, v, kl, vl = _P8(), _P8(), ctypes.c_uint32(), ctypes.c_uint32()
            while True:
                # the iterator is a snapshot the engine copied out, but
                # a step after close is refused like any other call
                with self._call():
                    rc = self._lib.logdb_iter_next(it, ctypes.byref(k), ctypes.byref(kl),
                                                   ctypes.byref(v), ctypes.byref(vl))
                    if rc != 0:
                        return
                    item = (ctypes.string_at(k, kl.value), ctypes.string_at(v, vl.value))
                yield item
        finally:
            self._lib.logdb_iter_free(it)

    def compact(self) -> int:
        with self._call() as h:
            freed = self._lib.logdb_compact(h)
        if freed < 0:
            raise OSError("logdb_compact failed")
        return int(freed)

    def count(self) -> int:
        with self._call() as h:
            return int(self._lib.logdb_count(h))

    def flush(self) -> None:
        with self._call() as h:
            self._lib.logdb_flush(h)

    def close(self) -> None:
        """Refuse new calls, wait for those in flight, then sync and
        free the handle (and release the file's lock). Idempotent."""
        with self._idle:
            if self._closed:
                return
            self._closed = True
            while self._inflight:
                self._idle.wait()
        self._lib.logdb_close(self._h)
