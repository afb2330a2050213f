"""The port's tx and block indexers and IndexerService held to the JAX
package's (``tests/test_indexer_batch.py``'s cases): the same blocks,
tx results and events go through both packages' modules, and every
case asserts the reference's contract on each and that both leave
byte-identical kv rows and answer searches alike. Per-height batched
indexing, the async drain and its barrier, crash replay with no gap
and no duplicate, the contiguous marker, overflow and its failures;
the reference's reindex-event CLI case becomes a cross-package one:
rows the JAX package's ``reindex-event`` wrote over a gap are read by
the port's indexer, and the port's replay closes the gap."""

import asyncio
import hashlib
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from cometbft_tpu import types as JT
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.state import execution as jexec
from cometbft_tpu.state import indexer as jidx
from cometbft_tpu.state.store import Store as JStateStore
from cometbft_tpu.store import BlockStore as JBlockStore
from cometbft_tpu.types import events as jev
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu.utils import kv as jkv
from cometbft_tpu.utils.pubsub_query import parse as jparse
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.state import execution as pexec
from cometbft_tpu_torch.state import indexer as pidx
from cometbft_tpu_torch.state.store import Store as PStateStore
from cometbft_tpu_torch.store.block_store import BlockStore as PBlockStore
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import events as pev
from cometbft_tpu_torch.types.part_set import PartSet as PPartSet
from cometbft_tpu_torch.types.validator_set import Validator as PVal
from cometbft_tpu_torch.types.validator_set import ValidatorSet as PValSet
from cometbft_tpu_torch.utils import codec as pcodec
from cometbft_tpu_torch.utils import kv as pkv
from cometbft_tpu_torch.utils.pubsub_query import parse as pparse
from torch_hard_limit import hard_limit  # noqa: F401

NOW = int(time.time() * 1e9)
CHAIN = "idx-chain"
SEED = 1515

JAX = SimpleNamespace(
    name="jax", abci=jabci, idx=jidx, exec=jexec, StateStore=JStateStore, BlockStore=JBlockStore,
    ev=jev, codec=jcodec, kv=jkv, parse=jparse, Data=JT.Data, Commit=JT.Commit, Header=JT.Header,
    Block=JT.Block, BlockID=JT.BlockID, PartSet=JT.PartSet, ValidatorSet=JT.ValidatorSet,
    Validator=JT.Validator, Priv=JPriv,
)
PORT = SimpleNamespace(
    name="port", abci=pabci, idx=pidx, exec=pexec, StateStore=PStateStore, BlockStore=PBlockStore,
    ev=pev, codec=pcodec, kv=pkv, parse=pparse, Data=pblock.Data, Commit=pblock.Commit,
    Header=pblock.Header, Block=pblock.Block, BlockID=pblock.BlockID, PartSet=PPartSet,
    ValidatorSet=PValSet, Validator=PVal, Priv=PPriv,
)


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)


def counting_kv(ns):
    class CountingKV(ns.kv.MemKV):
        def __init__(self):
            super().__init__()
            self.batches = 0

        def write_batch(self, sets, deletes=()):
            self.batches += 1
            super().write_batch(sets, deletes)

    return CountingKV()


def tx_result(ns, i):
    return ns.abci.ExecTxResult(
        code=0, events=[ns.abci.Event("transfer", [ns.abci.EventAttribute("sender", f"addr{i}", True)])]
    )


def block_events(ns):
    return [ns.abci.Event("commit_meta", [ns.abci.EventAttribute("lane", "a", True)])]


def blocks(ns, n, txs_per_height=2):
    """n linked blocks from one seeded validator (the same bytes in
    both packages)."""
    key = ns.Priv.from_seed(np.random.default_rng(SEED).bytes(32))
    vs = ns.ValidatorSet([ns.Validator(key.pub_key(), 100)])
    prev = ns.BlockID()
    out = []
    for h in range(1, n + 1):
        data = ns.Data(txs=[b"k%d_%d=v" % (h, i) for i in range(txs_per_height)])
        last_commit = ns.Commit(h - 1, 0, prev, []) if h > 1 else None
        header = ns.Header(
            chain_id=CHAIN, height=h, time_ns=NOW + h, last_block_id=prev,
            validators_hash=vs.hash(), next_validators_hash=vs.hash(), app_hash=b"\x01" * 32,
            proposer_address=vs.validators[0].address, data_hash=data.hash(),
            last_commit_hash=last_commit.hash() if last_commit else b"",
        )
        blk = ns.Block(header=header, data=data, last_commit=last_commit)
        prev = ns.BlockID(blk.hash(), ns.PartSet.from_data(ns.codec.encode_block(blk)).header)
        out.append(blk)
    return out


def publish_height(ns, bus, blk):
    """The executor's event shape (state/execution.py _fire_events)."""
    bus.publish_type(ns.ev.EVENT_NEW_BLOCK,
                     {"block": blk, "block_id": None, "result_events": block_events(ns)},
                     height=blk.height)
    for i, tx in enumerate(blk.data.txs):
        bus.publish_type(ns.ev.EVENT_TX,
                         {"height": blk.height, "index": i, "tx": tx, "result": tx_result(ns, i)},
                         hash=hashlib.sha256(tx).hexdigest())


def service(ns, db=None):
    db = db if db is not None else counting_kv(ns)
    return db, ns.idx.IndexerService(ns.idx.TxIndexer(db), ns.idx.BlockIndexer(db), ns.ev.EventBus())


def searches(ns, svc, heights):
    """What the indexers answer, in plain data."""
    out = {}
    for h in heights:
        out[f"tx.height={h}"] = [(r[0], r[1], r[2], r[4]) for r in svc.tx_indexer.search(ns.parse(f"tx.height={h}"))]
    q = "transfer.sender='addr1'"
    out[q] = [(r[0], r[1], r[2], r[4]) for r in svc.tx_indexer.search(ns.parse(q))]
    out["blocks"] = svc.block_indexer.search(ns.parse("commit_meta.lane='a'"))
    return out


def both(case):
    """Run ``case(ns)`` on each package; they must observe the same."""
    got = case(JAX)
    assert case(PORT) == got
    return got


def test_one_write_batch_per_height_inline():
    def case(ns):
        db, svc = service(ns)
        svc.start()
        for blk in blocks(ns, 3):
            publish_height(ns, svc.bus, blk)
        assert db.batches == 3  # one per height, never per tx
        assert svc.tx_indexer.last_indexed_height() == 3
        s = searches(ns, svc, (1, 2, 3))
        assert all(len(s[f"tx.height={h}"]) == 2 for h in (1, 2, 3))
        assert len(s["transfer.sender='addr1'"]) == 3 and s["blocks"] == [1, 2, 3]
        return s, dict(db._d)

    both(case)


def test_async_drain_flush_and_barrier():
    def case(ns):
        async def main():
            db, svc = service(ns)
            svc.start()
            svc.bus.set_loop(asyncio.get_running_loop())
            await svc.start_async()
            for blk in blocks(ns, 4):
                publish_height(ns, svc.bus, blk)
            assert db.batches <= 4  # the publish path touched no db
            await svc.barrier()
            assert db.batches == 4 and svc.tx_indexer.last_indexed_height() == 4
            assert svc.flushed_heights == 4
            await svc.stop()
            return searches(ns, svc, (1, 2, 3, 4)), dict(db._d)

        return asyncio.run(asyncio.wait_for(main(), 60))

    both(case)


def test_zero_tx_height_seals_immediately():
    def case(ns):
        db, svc = service(ns)
        svc.start()
        publish_height(ns, svc.bus, blocks(ns, 1, txs_per_height=0)[0])
        assert db.batches == 1 and svc.tx_indexer.last_indexed_height() == 1
        return dict(db._d)

    both(case)


def stores_with_chain(ns, n):
    """A block and a state store holding n heights with stored
    finalize responses (the replay source)."""
    bs, ss = ns.BlockStore(ns.kv.MemKV()), ns.StateStore(ns.kv.MemKV())
    blks = blocks(ns, n)
    for blk in blks:
        pset = ns.PartSet.from_data(ns.codec.encode_block(blk))
        bs.save_block(blk, pset, ns.Commit(blk.height, 0, ns.BlockID(blk.hash(), pset.header), []))
        resp = ns.abci.ResponseFinalizeBlock(
            events=block_events(ns), tx_results=[tx_result(ns, i) for i in range(len(blk.data.txs))],
            app_hash=b"\x01" * 32,
        )
        ss.save_finalize_block_response(blk.height, ns.exec.encode_finalize_response(resp))
    return bs, ss, blks


def test_kill_mid_index_restart_replays_no_gap_no_dup():
    def case(ns):
        bs, ss, blks = stores_with_chain(ns, 5)
        db, svc = service(ns)
        svc.start()
        for blk in blks[:3]:
            publish_height(ns, svc.bus, blk)
        assert svc.tx_indexer.last_indexed_height() == 3
        after_crash = dict(db._d)
        _, svc2 = service(ns, db)
        assert svc2.replay(bs, ss) == 2  # heights 4..5 only
        assert svc2.tx_indexer.last_indexed_height() == 5
        s = searches(ns, svc2, range(1, 6))
        assert all(len(s[f"tx.height={h}"]) == 2 for h in range(1, 6)) and s["blocks"] == [1, 2, 3, 4, 5]
        rows = [k for k, _ in db.iter_prefix(b"tx:a:tx.height=")]
        assert len(rows) == len(set(rows)) == 10
        rows = [k for k, _ in db.iter_prefix(b"tx:a:transfer.sender=")]
        assert len(rows) == len(set(rows)) == 10
        for k, v in after_crash.items():
            if k != ns.idx.LAST_INDEXED_KEY:
                assert db._d[k] == v, k
        full = dict(db._d)
        assert svc2.replay(bs, ss) == 0 and dict(db._d) == full
        db.set(ns.idx.LAST_INDEXED_KEY, b"\x00" * 8)
        assert svc2.replay(bs, ss) == 5 and dict(db._d) == full
        return s, full

    both(case)


def bundles(ns, blks):
    return [ns.idx.HeightBundle(b.height, [(i, tx, tx_result(ns, i)) for i, tx in enumerate(b.data.txs)],
                                block_events(ns)) for b in blks]


def test_marker_advances_contiguously_out_of_order():
    def case(ns):
        db, svc = service(ns)
        bs = bundles(ns, blocks(ns, 4))
        marks = []
        for i in (0, 3, 2, 1):  # h=1, then 4 and 3 out of order, then 2
            svc._flush(bs[i])
            marks.append(svc.tx_indexer.last_indexed_height())
        assert marks == [1, 1, 1, 4] and svc._done_heights == set()
        db2, svc2 = service(ns)
        svc2._flush(bs[3], anchored=True)  # replay's anchored walk may jump
        assert svc2.tx_indexer.last_indexed_height() == 4
        return marks, dict(db._d), dict(db2._d)

    both(case)


def test_joiner_far_above_marker_still_advances():
    def case(ns):
        db, svc = service(ns)
        for h in (50, 51, 52):
            svc._seal(ns.idx.HeightBundle(h, [(0, b"j%d=v" % h, tx_result(ns, 0))], block_events(ns)))
        assert svc.tx_indexer.last_indexed_height() == 52
        assert svc._done_heights == set() and svc._first_sealed == 50
        return dict(db._d)

    both(case)


def test_overflow_never_drops(monkeypatch):
    def case(ns):
        async def main():
            db, svc = service(ns)
            monkeypatch.setattr(ns.idx.IndexerService, "QUEUE_SIZE", 2)
            svc._queue = type(svc._queue)(2, name="state.index")
            svc.start()
            svc.bus.set_loop(asyncio.get_running_loop())
            svc._loop = asyncio.get_running_loop()  # the drain is not running
            for blk in blocks(ns, 6):
                publish_height(ns, svc.bus, blk)
            await asyncio.sleep(0.3)
            await svc.start_async()
            await svc.barrier()
            deadline = asyncio.get_running_loop().time() + 10
            while svc.tx_indexer.last_indexed_height() < 6:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.02)
            s = searches(ns, svc, range(1, 7))
            assert all(len(s[f"tx.height={h}"]) == 2 for h in range(1, 7))
            assert svc._queue.dropped >= 1  # the overflow path ran
            await svc.stop()
            return s, dict(db._d)

        return asyncio.run(asyncio.wait_for(main(), 60))

    both(case)


def test_overflow_flush_failure_counted(monkeypatch):
    def case(ns):
        async def main():
            db, svc = service(ns)
            svc._queue = type(svc._queue)(1, name="state.index")
            svc.start()
            svc.bus.set_loop(asyncio.get_running_loop())
            svc._loop = asyncio.get_running_loop()

            def boom(bundle, anchored=False):
                raise RuntimeError("disk hiccup (injected)")

            monkeypatch.setattr(svc, "_flush", boom)
            for blk in blocks(ns, 3):
                publish_height(ns, svc.bus, blk)
            deadline = asyncio.get_running_loop().time() + 10
            while svc.flush_failures < 2:
                assert asyncio.get_running_loop().time() < deadline
                await asyncio.sleep(0.01)
            await svc.start_async()
            t0 = asyncio.get_running_loop().time()
            await svc.barrier(timeout_s=5.0)
            assert asyncio.get_running_loop().time() - t0 < 4.0
            assert svc.flush_failures == 3
            await svc.stop()
            return svc.flush_failures, dict(db._d)

        return asyncio.run(asyncio.wait_for(main(), 60))

    both(case)


def test_jax_reindex_rows_read_by_the_port_and_its_replay_closes_the_gap(tmp_path):
    """The JAX package's ``reindex-event`` over heights 5-6 of a 6-height
    sqlite home writes rows without moving the marker past the gap;
    the port's indexer reads them as the JAX one does, and the port's
    replay fills heights 1-4 to the rows and marker a JAX full
    reindex gives."""
    from cometbft_tpu.cmd.main import cmd_reindex_event

    def home(name):
        data = tmp_path / name / "data"
        data.mkdir(parents=True)
        bdb = jkv.open_kv("sqlite", str(data / "blockstore.db"))
        sdb = jkv.open_kv("sqlite", str(data / "state.db"))
        bs, ss = JBlockStore(bdb), JStateStore(sdb)
        for blk in blocks(JAX, 6):
            pset = JT.PartSet.from_data(jcodec.encode_block(blk))
            bs.save_block(blk, pset, JT.Commit(blk.height, 0, JT.BlockID(blk.hash(), pset.header), []))
            resp = jabci.ResponseFinalizeBlock(
                events=block_events(JAX), tx_results=[tx_result(JAX, i) for i in range(len(blk.data.txs))],
                app_hash=b"\x01" * 32)
            ss.save_finalize_block_response(blk.height, jexec.encode_finalize_response(resp))
        bdb.close()
        sdb.close()
        return tmp_path / name, data

    partial, data = home("partial")
    assert cmd_reindex_event(SimpleNamespace(home=str(partial), start_height=5, end_height=6)) == 0
    full, full_data = home("full")
    assert cmd_reindex_event(SimpleNamespace(home=str(full), start_height=None, end_height=None)) == 0

    idb = pkv.open_kv("sqlite", str(data / "tx_index.db"))
    bdb = pkv.open_kv("sqlite", str(data / "blockstore.db"))
    sdb = pkv.open_kv("sqlite", str(data / "state.db"))
    try:
        svc = pidx.IndexerService(pidx.TxIndexer(idb), pidx.BlockIndexer(idb), pev.EventBus())
        assert svc.tx_indexer.last_indexed_height() == 0
        assert len(svc.tx_indexer.search(pparse("tx.height=5"))) == 2
        assert svc.replay(PBlockStore(bdb), PStateStore(sdb)) == 6
        assert svc.tx_indexer.last_indexed_height() == 6
        got = dict(idb.iter_prefix(b""))
    finally:
        for db in (idb, bdb, sdb):
            db.close()
    jdb = jkv.open_kv("sqlite", str(full_data / "tx_index.db"))
    try:
        want = dict(jdb.iter_prefix(b""))
    finally:
        jdb.close()
    assert got == want
