"""The port's key-value stores, and its fix for ROADMAP C2.

- ``MemKV`` and ``SqliteKV`` answer a sequence of sets, batches,
  deletes and prefix scans exactly as the JAX package's do.
- C2: ``SqliteKV.close`` takes the lock ``write_batch`` holds, so a
  close issued while a batch is in flight waits for it: the batch
  commits whole, nothing writes to a closed connection, and a call
  after the close raises ``sqlite3.ProgrammingError`` instead of
  reaching a closed handle. (The JAX package's close takes no lock;
  there the same interleaving can crash the process.)
"""

import sqlite3
import threading
import time

import pytest

from cometbft_tpu.utils import kv as jkv
from cometbft_tpu_torch.utils import kv


def _ops(store):
    store.set(b"a:1", b"x")
    store.write_batch([(b"a:2", b"y"), (b"b:1", b"z"), (b"a:3", b"w")], deletes=[b"a:1"])
    store.set(b"a:2", b"y2")
    store.delete(b"b:1")
    return (
        [store.get(k) for k in (b"a:1", b"a:2", b"a:3", b"b:1")],
        list(store.iter_prefix(b"a:")),
        list(store.iter_prefix(b"b:")),
    )


@pytest.mark.parametrize("backend", ["memdb", "sqlite"])
def test_stores_match_jax(backend, tmp_path):
    port = kv.open_kv(backend, str(tmp_path / "port.db"))
    ref = jkv.open_kv(backend, str(tmp_path / "jax.db"))
    try:
        assert _ops(port) == _ops(ref)
    finally:
        port.close()
        ref.close()


def test_sqlite_close_waits_for_write_batch_in_flight(tmp_path):
    path = str(tmp_path / "c2.db")
    store = kv.SqliteKV(path)
    n = 2000
    inside = threading.Event()
    errors = []

    def rows():
        # runs inside write_batch, under its lock
        inside.set()
        time.sleep(0.2)  # keep the batch in flight while close() is called
        for i in range(n):
            yield (b"k%05d" % i, b"v%d" % i)

    def writer():
        try:
            store.write_batch(rows())
        except Exception as e:  # a write to a closed connection lands here
            errors.append(e)

    t = threading.Thread(target=writer)
    t.start()
    assert inside.wait(30)
    store.close()  # must wait for the batch, not close under it
    t.join(30)
    assert not t.is_alive()
    assert errors == []
    with pytest.raises(sqlite3.ProgrammingError):
        store.get(b"k00000")
    store.close()  # idempotent
    again = kv.SqliteKV(path)
    try:
        got = list(again.iter_prefix(b"k"))
        assert len(got) == n and got[-1] == (b"k%05d" % (n - 1), b"v%d" % (n - 1))
    finally:
        again.close()


def test_open_kv_rejects_unknown_backends():
    # logdb is a backend since the native lanes came in (utils/logdb.py);
    # a name neither package has is still refused, and so is a disk
    # backend without a path
    with pytest.raises(ValueError):
        kv.open_kv("goleveldb", "store.db")
    with pytest.raises(ValueError):
        kv.open_kv("sqlite")
    with pytest.raises(ValueError):
        kv.open_kv("logdb")
