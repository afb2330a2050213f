"""Embedded key-value stores: the block and state stores sit on these.

A copy of the JAX package's ``utils/kv.py`` (the reference's
cometbft-db seam): ``MemKV`` (a dict, like memdb) and ``SqliteKV``
(sqlite3, durable and transactional). Keys and values are bytes;
batches are atomic. The native log-structured ``logdb`` is not ported.

Fix over the JAX package (ROADMAP C2): ``SqliteKV.close`` takes the
lock every other call holds, so it waits for a ``write_batch`` in
flight instead of closing the connection under it, and a call after
``close`` raises instead of touching a closed connection.
"""

from __future__ import annotations

import sqlite3
import threading
from typing import Dict, Iterator, Optional, Tuple


class KV:
    def get(self, key: bytes) -> Optional[bytes]:
        raise NotImplementedError

    def set(self, key: bytes, value: bytes) -> None:
        raise NotImplementedError

    def delete(self, key: bytes) -> None:
        raise NotImplementedError

    def write_batch(self, sets, deletes=()) -> None:
        """Atomic batch: sets = [(k, v)], deletes = [k]."""
        raise NotImplementedError

    def iter_prefix(self, prefix: bytes) -> Iterator[Tuple[bytes, bytes]]:
        raise NotImplementedError

    def close(self) -> None:
        pass


class MemKV(KV):
    def __init__(self):
        self._d: Dict[bytes, bytes] = {}
        self._lock = threading.RLock()

    def get(self, key):
        with self._lock:
            return self._d.get(key)

    def set(self, key, value):
        with self._lock:
            self._d[bytes(key)] = bytes(value)

    def delete(self, key):
        with self._lock:
            self._d.pop(key, None)

    def write_batch(self, sets, deletes=()):
        with self._lock:
            for k, v in sets:
                self._d[bytes(k)] = bytes(v)
            for k in deletes:
                self._d.pop(k, None)

    def iter_prefix(self, prefix):
        with self._lock:
            items = sorted((k, v) for k, v in self._d.items() if k.startswith(prefix))
        yield from items


class SqliteKV(KV):
    def __init__(self, path: str):
        self._conn = sqlite3.connect(path, check_same_thread=False)
        self._conn.execute("CREATE TABLE IF NOT EXISTS kv (k BLOB PRIMARY KEY, v BLOB)")
        self._conn.execute("PRAGMA journal_mode=WAL")
        self._conn.execute("PRAGMA synchronous=NORMAL")
        self._conn.commit()
        self._lock = threading.RLock()
        self._closed = False

    def _db(self) -> sqlite3.Connection:
        """The connection; the caller holds the lock."""
        if self._closed:
            raise sqlite3.ProgrammingError("SqliteKV is closed")
        return self._conn

    def get(self, key):
        with self._lock:
            row = self._db().execute("SELECT v FROM kv WHERE k = ?", (key,)).fetchone()
        return row[0] if row else None

    def set(self, key, value):
        with self._lock:
            db = self._db()
            db.execute("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", (key, value))
            db.commit()

    def delete(self, key):
        with self._lock:
            db = self._db()
            db.execute("DELETE FROM kv WHERE k = ?", (key,))
            db.commit()

    def write_batch(self, sets, deletes=()):
        with self._lock:
            db = self._db()
            db.executemany("INSERT OR REPLACE INTO kv (k, v) VALUES (?, ?)", list(sets))
            if deletes:
                db.executemany("DELETE FROM kv WHERE k = ?", [(k,) for k in deletes])
            db.commit()

    def iter_prefix(self, prefix):
        hi = prefix + b"\xff" * 8
        with self._lock:
            rows = self._db().execute(
                "SELECT k, v FROM kv WHERE k >= ? AND k <= ? ORDER BY k", (prefix, hi)
            ).fetchall()
        for k, v in rows:
            if bytes(k).startswith(prefix):
                yield bytes(k), bytes(v)

    def close(self):
        """Idempotent; waits for any call in flight (the C2 fix)."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._conn.close()


def open_kv(backend: str, path: Optional[str] = None) -> KV:
    if backend == "memdb":
        return MemKV()
    if backend == "sqlite":
        if not path:
            raise ValueError("the sqlite backend needs a path")
        return SqliteKV(path)
    raise ValueError(f"unknown db backend {backend}")
