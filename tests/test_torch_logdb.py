"""The port's logdb storage engine (``native/logdb.cpp`` via ctypes)
and the shared native build.

- The seven cases of ``tests/test_logdb.py`` on the port: the KV
  contract and the file lock, batches and ordered prefix iteration,
  persistence across a reopen, a torn tail truncated on replay,
  compaction, a node on logdb, and crash-atomic batches.
- A port node on logdb replays a 40-block chain to the same state rows
  as a JAX node on logdb replaying the JAX package's twin of it, and
  the two engines' files then hold the same blocks and states.
- ROADMAP C21, fixed in the port: ``close`` waits for a native call in
  flight (a ``write_batch`` held inside the engine) and then refuses
  every call, the next step of an iterator opened before it included,
  with ``OSError``; nothing crashes.
- Two processes building the four native lanes into one directory at
  once both load whole libraries: one builds each lane, the other
  finds it fresh under the lock, and no temporary file is left.

Inputs come from seeded numpy generators; every comparison is exact.
"""

import asyncio
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.utils import logdb
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
CPU = "cpu"

pytestmark = pytest.mark.skipif(not logdb.available(), reason="g++ unavailable to build logdb")


def test_kv_contract(tmp_path):
    db = logdb.LogDB(str(tmp_path / "a.db"))
    with pytest.raises(OSError):  # a second opener fails while the flock is held
        logdb.LogDB(str(tmp_path / "a.db"))
    assert db.get(b"k") is None
    db.set(b"k", b"v1")
    assert db.get(b"k") == b"v1"
    db.set(b"k", b"v2")
    assert db.get(b"k") == b"v2"
    db.set(b"empty", b"")
    assert db.get(b"empty") == b""
    db.delete(b"k")
    assert db.get(b"k") is None
    db.delete(b"never-existed")
    db.close()
    db.close()  # idempotent
    with pytest.raises(OSError):  # a clean Python error, not a native crash
        db.get(b"k")


def test_batch_and_prefix_iteration(tmp_path):
    db = logdb.LogDB(str(tmp_path / "b.db"))
    sets = [(b"blk:%08d" % i, b"v%d" % i) for i in range(100)]
    sets += [(b"st:%04d" % i, b"s%d" % i) for i in range(10)]
    db.write_batch(sets, deletes=[])
    got = list(db.iter_prefix(b"blk:"))
    assert len(got) == 100 and got == sorted(got)
    assert got[0] == (b"blk:00000000", b"v0")
    db.write_batch([], deletes=[b"blk:%08d" % i for i in range(50)])
    assert len(list(db.iter_prefix(b"blk:"))) == 50
    assert db.count() == 60
    db.close()


def test_persistence_across_reopen(tmp_path):
    path = str(tmp_path / "c.db")
    db = logdb.LogDB(path)
    rng = np.random.default_rng(7)
    model = {}
    for _ in range(300):
        k = b"k%03d" % int(rng.integers(80))
        if rng.random() < 0.25:
            db.delete(k)
            model.pop(k, None)
        else:
            v = rng.bytes(int(rng.integers(0, 200)))
            db.set(k, v)
            model[k] = v
    db.close()
    db2 = logdb.LogDB(path)
    assert db2.count() == len(model)
    for k, v in model.items():
        assert db2.get(k) == v, k
    db2.close()


def test_torn_tail_truncated_on_replay(tmp_path):
    path = str(tmp_path / "d.db")
    db = logdb.LogDB(path)
    db.set(b"good", b"value")
    db.flush()
    db.close()
    size = os.path.getsize(path)
    with open(path, "ab") as f:  # a crash mid-append: half a record
        f.write(b"\x01\x02\x03\x04\x05\x06\x07")
    db2 = logdb.LogDB(path)
    assert db2.get(b"good") == b"value"
    db2.set(b"after", b"recovery")
    db2.close()
    db3 = logdb.LogDB(path)
    assert (db3.get(b"good"), db3.get(b"after")) == (b"value", b"recovery")
    db3.close()
    assert os.path.getsize(path) > size


def test_compaction_reclaims_dead_space(tmp_path):
    path = str(tmp_path / "e.db")
    db = logdb.LogDB(path)
    for i in range(50):
        db.set(b"hot", b"x" * 1000)  # 49 dead versions
        db.set(b"cold%02d" % i, b"y")
    before = os.path.getsize(path)
    assert db.compact() > 45_000
    assert os.path.getsize(path) < before
    assert db.get(b"hot") == b"x" * 1000 and db.count() == 51
    db.set(b"post", b"compaction")
    db.close()
    db2 = logdb.LogDB(path)
    assert db2.get(b"post") == b"compaction" and db2.count() == 52
    db2.close()


def test_node_runs_on_logdb(tmp_path):
    """A one-validator node commits on logdb; its stores reopen with the
    chain after ``close_stores`` released the files' locks."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import build_node, make_genesis, make_privvals

    gen, privs = make_genesis(1, chain_id="logdb-chain")
    pv = make_privvals(privs, root=str(tmp_path))[0]
    cfg = make_test_cfg(str(tmp_path))
    cfg.base.db_backend = "logdb"

    async def go():
        parts = build_node(gen, privval=pv, config=cfg, home=str(tmp_path), device=CPU)
        await parts.cs.start()
        for _ in range(400):
            if parts.block_store.height() >= 3:
                break
            await asyncio.sleep(0.05)
        assert parts.block_store.height() >= 3
        blk = parts.block_store.load_block(2)
        assert blk is not None and blk.height == 2
        await parts.cs.stop()
        parts.close_stores()

    asyncio.run(asyncio.wait_for(go(), 60))
    parts2 = build_node(gen, config=cfg, home=str(tmp_path), device=CPU)
    assert isinstance(parts2.block_db, logdb.LogDB)
    assert parts2.block_store.height() >= 3
    parts2.close_stores()


def test_batch_is_crash_atomic(tmp_path):
    """A torn batch record applies none of its operations on replay."""
    path = str(tmp_path / "f.db")
    db = logdb.LogDB(path)
    db.set(b"pre", b"existing")
    db.flush()
    pre_size = os.path.getsize(path)
    db.write_batch([(b"height", b"h-1"), (b"meta", b"m")], deletes=[b"pre"])
    db.close()
    full_size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.truncate(pre_size + (full_size - pre_size) // 2)
    db2 = logdb.LogDB(path)
    assert (db2.get(b"height"), db2.get(b"meta"), db2.get(b"pre")) == (None, None, b"existing")
    db2.close()


# --- a node on logdb against a JAX node on logdb ------------------------------


def test_logdb_replay_equals_jax_node_on_logdb(tmp_path):
    from cometbft_tpu.blocksync.reactor import BlockSyncReactor as JReactor
    from cometbft_tpu.config.config import test_config as jtest_config
    from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
    from cometbft_tpu.node.inprocess import build_node as jbuild_node
    from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
    from cometbft_tpu.utils import chaingen as jchaingen
    from cometbft_tpu.utils.logdb import LogDB as JLogDB
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.crypto import parallel_verify as pv
    from cometbft_tpu_torch.crypto import scheduler as sched_mod
    from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
    from cometbft_tpu_torch.utils import chaingen

    n_blocks = 40
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(4, chain_id="logdb-parity", genesis_time_ns=1_700_000_000_000_000_000,
                                  seed=17)
        src = chaingen.make_chain(gen, privs, n_blocks, txs_per_block=2, device=CPU)
        jgen = JGenesisDoc.from_json(gen.to_json())
        jsrc = jchaingen.make_chain(jgen, [JPriv.from_seed(p.seed) for p in privs], n_blocks,
                                    txs_per_block=2)

        def replay(fresh, reactor_cls, peer_cls, chain, **kw):
            rows = {}
            real = fresh.block_exec.apply_verified_block

            def wrapped(state, bid, block):
                st = real(state, bid, block)
                rows[st.last_block_height] = (bytes(st.app_hash), bytes(st.last_results_hash),
                                              st.validators.hash(), st.last_block_id.key())
                return st

            fresh.block_exec.apply_verified_block = wrapped

            async def main():
                caught = asyncio.Event()
                r = reactor_cls(fresh.state, fresh.block_exec, fresh.block_store,
                                on_caught_up=lambda st: caught.set(), verify_window=8, **kw)
                r.pool.set_peer_range("src", peer_cls(chain), 1, n_blocks)
                await r.start()
                await asyncio.wait_for(caught.wait(), 90)
                await r.stop()

            asyncio.run(asyncio.wait_for(main(), 120))
            return rows

        home, jhome = str(tmp_path / "port"), str(tmp_path / "jax")
        fresh = build_node(gen, db_backend="logdb", home=home, device=CPU)
        rows = replay(fresh, BlockSyncReactor, chaingen.StorePeerClient, src, device=CPU)
        os.makedirs(jhome)
        jcfg = jtest_config(jhome)
        jcfg.base.db_backend = "logdb"
        jfresh = jbuild_node(jgen, None, config=jcfg, home=jhome)
        jrows = replay(jfresh, JReactor, jchaingen.StorePeerClient, jsrc)
        common = sorted(set(rows) & set(jrows))
        assert len(common) >= n_blocks - 2 and common == list(range(1, len(common) + 1))
        assert [rows[h] for h in common] == [jrows[h] for h in common]
        top = min(fresh.block_store.height(), jfresh.block_store.height())
        assert top >= n_blocks - 2
        fresh.close_stores()
        jfresh.close_stores()
    finally:
        sched_mod.set_scheduler(None)
        pv.set_engine(None)
        eng.close()
    # the engines' files, reopened by the other package's engine: the
    # same block rows, finalize responses and validator sets
    from cometbft_tpu.state.store import Store as JStateStore
    from cometbft_tpu_torch.state.store import Store as StateStore

    bdb, jbdb = logdb.LogDB(os.path.join(home, "blockstore.db")), JLogDB(os.path.join(jhome, "blockstore.db"))
    sdb, jsdb = logdb.LogDB(os.path.join(home, "state.db")), JLogDB(os.path.join(jhome, "state.db"))
    try:
        for prefix in (b"H:", b"P:", b"C:"):
            rows_of = [[kv for kv in d.iter_prefix(prefix) if int.from_bytes(kv[0][2:10], "big") <= top]
                       for d in (bdb, jbdb)]
            assert rows_of[0] == rows_of[1] and rows_of[0], prefix
        ss, jss = StateStore(sdb), JStateStore(jsdb)
        for h in range(1, top + 1):
            assert ss.load_finalize_block_response(h) == jss.load_finalize_block_response(h), h
            assert ss.load_validators(h).hash() == jss.load_validators(h).hash(), h
    finally:
        for d in (bdb, jbdb, sdb, jsdb):
            d.close()


# --- ROADMAP C21 ---------------------------------------------------------------


class _HeldBatch:
    """The engine's library with ``logdb_batch`` held until released:
    a write_batch stays in flight inside the native call."""

    def __init__(self, lib):
        self._lib, self.entered, self.release = lib, threading.Event(), threading.Event()

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def logdb_batch(self, h, buf, n):
        self.entered.set()
        assert self.release.wait(30)
        return self._lib.logdb_batch(h, buf, n)


def test_close_waits_for_a_write_batch_in_flight(tmp_path):
    path = str(tmp_path / "c21.db")
    db = logdb.LogDB(path)
    held = db._lib = _HeldBatch(db._lib)
    sets = [(b"k%04d" % i, b"v%d" % i) for i in range(500)]
    outcome = {}

    def writer():
        try:
            db.write_batch(sets)
            outcome["writer"] = "ok"
        except BaseException as e:  # noqa: BLE001 - reported below
            outcome["writer"] = repr(e)

    w = threading.Thread(target=writer)
    w.start()
    assert held.entered.wait(30)
    closer = threading.Thread(target=db.close)
    closer.start()
    time.sleep(0.2)
    # close has refused new calls and waits for the batch in flight
    assert closer.is_alive()
    with pytest.raises(OSError, match="closed"):
        db.get(b"k0001")
    with pytest.raises(OSError, match="closed"):
        db.write_batch([(b"late", b"x")])
    held.release.set()
    closer.join(30)
    w.join(30)
    assert not closer.is_alive() and outcome["writer"] == "ok"
    with pytest.raises(OSError):
        db.count()
    # the batch that was in flight is whole on disk; the file is free
    db2 = logdb.LogDB(path)
    assert db2.count() == 500 and db2.get(b"k0499") == b"v499" and db2.get(b"late") is None
    db2.close()


def test_close_ends_an_open_iterator_with_oserror(tmp_path):
    db = logdb.LogDB(str(tmp_path / "it.db"))
    db.write_batch([(b"p:%03d" % i, b"v") for i in range(10)])
    it = db.iter_prefix(b"p:")
    assert next(it) == (b"p:000", b"v")
    db.close()
    with pytest.raises(OSError, match="closed"):
        next(it)
    with pytest.raises(StopIteration):  # the generator is finished, its snapshot freed
        next(it)
    with pytest.raises(OSError):
        list(db.iter_prefix(b"p:"))


# --- two processes building the native lanes at once ---------------------------

_BUILD_SCRIPT = """
import ctypes, json, sys
from pathlib import Path
from cometbft_tpu_torch.utils import native
native.BUILD = Path(sys.argv[1])
built = native.build_all()
loaded = []
for lane, (stem, src, python) in native.LANES.items():
    path = native.library(lane)
    if python:
        mod = native.load_extension(lane, path)
    else:
        mod = ctypes.CDLL(str(path))
        assert mod.logdb_open
    loaded.append(lane)
print(json.dumps({"built": sorted(built), "loaded": loaded}))
"""


def test_two_processes_build_the_lanes_at_once_and_load_whole_libraries(tmp_path):
    out = tmp_path / "native"
    env = dict(os.environ, PYTHONPATH=str(REPO))
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_SCRIPT, str(out)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(2)]
    results = []
    for p in procs:
        so, se = p.communicate(timeout=240)
        assert p.returncode == 0, se
        results.append(json.loads(so.strip().splitlines()[-1]))
    lanes = ["batchverify", "wirecodec", "finalize", "logdb"]
    assert all(r["loaded"] == lanes for r in results)
    # each lane built by exactly one of them; the other found it fresh
    built = [b for r in results for b in r["built"]]
    assert sorted(built) == sorted(lanes)
    assert sorted(os.listdir(out)) == [".build.lock", "_batchverify.so", "_finalize.so",
                                       "_wirecodec.so", "liblogdb.so"]
