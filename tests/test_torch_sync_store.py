"""The reference cases of the replay's storage path on the port.

From ``tests/test_sync.py``: blocksync catches up and converges on the
source's app hash and blocks; a tampering peer is refused and the
honest block stored; the coalesced commit check passes a run of honest
commits and fails exactly the one with a corrupted signature, as the
JAX package's check does on its twin of the chain. From
``tests/test_parallel_verify.py``: the reactor's loop keeps ticking
while a window's verify wait blocks; the block store writes one batch
a window; ``save_block_batch`` refuses gaps and round-trips, the last
two on each storage engine (memdb, sqlite, logdb). Chains come from
seeded keys; comparisons are exact.
"""

import asyncio
import time

import pytest
import torch

from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.types import validation as JV
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu_torch.blocksync import reactor as reactor_mod
from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
from cometbft_tpu_torch.types import block as B
from cometbft_tpu_torch.types import validation as V
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.utils import codec, kv
from cometbft_tpu_torch.utils.chaingen import StorePeerClient, TamperingPeerClient, make_chain
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
CHAIN_LEN = 30
GENESIS_TIME_NS = 1_700_000_000_000_000_000


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


@pytest.fixture(scope="module")
def source_chain():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(4, chain_id="sync-chain", genesis_time_ns=GENESIS_TIME_NS, seed=5)
        return gen, privs, make_chain(gen, privs, CHAIN_LEN, txs_per_block=1, device=CPU)
    finally:
        pv.set_engine(None)
        eng.close()


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _catch_up(fresh, peers, top, **kw):
    caught = asyncio.Event()
    reactor = BlockSyncReactor(fresh.state, fresh.block_exec, fresh.block_store,
                               on_caught_up=lambda st: caught.set(), device=CPU, **kw)
    for name, peer in peers:
        reactor.pool.set_peer_range(name, peer, 1, top)
    await reactor.start()
    await asyncio.wait_for(caught.wait(), 90)
    await reactor.stop()
    return reactor


def test_blocksync_catches_up(source_chain):
    gen, _, src = source_chain
    top = src.block_store.height()
    fresh = build_node(gen, device=CPU)
    reactor = run(_catch_up(fresh, [("src", StorePeerClient(src))], top))
    # within one block of the source: block h needs h+1's commit
    assert fresh.block_store.height() >= top - 1
    assert reactor.blocks_applied >= CHAIN_LEN - 1
    h = fresh.block_store.height()
    assert fresh.state_store.load().app_hash == src.block_store.load_block(h + 1).header.app_hash
    for hh in (1, h // 2, h):
        assert fresh.block_store.load_block(hh).hash() == src.block_store.load_block(hh).hash()


def test_blocksync_bans_tampering_peer(source_chain):
    gen, _, src = source_chain
    top = src.block_store.height()
    fresh = build_node(gen, device=CPU)
    run(_catch_up(fresh, [("evil", TamperingPeerClient(src, bad_height=5)),
                          ("good", StorePeerClient(src))], top))
    assert fresh.block_store.height() >= top - 1
    assert fresh.block_store.load_block(5).hash() == src.block_store.load_block(5).hash()


def _jobs(store, state_store, heights):
    return [(state_store.load_validators(h - 1), store.load_block_meta(h - 1).block_id, h - 1,
             store.load_block(h).last_commit) for h in heights]


def _corrupt_first_sig(job, commit_cls, sig_cls):
    vals, bid, h, c = job
    cs = c.signatures[0]
    bad = sig_cls(cs.block_id_flag, cs.validator_address, cs.timestamp_ns,
                  bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
    return (vals, bid, h, commit_cls(c.height, c.round, c.block_id, [bad] + list(c.signatures[1:])))


def test_coalesced_commit_verification(source_chain):
    """The cross-height batch: ten honest commits pass, and a corrupted
    signature in the fifth fails that commit alone; the JAX package's
    check gives the same verdicts on its twin of the chain."""
    from cometbft_tpu.types import block as JB

    gen, privs, src = source_chain
    jgen = JGenesisDoc.from_json(gen.to_json())
    jsrc = jchaingen.make_chain(jgen, [JPriv.from_seed(p.seed) for p in privs], 12, txs_per_block=1)
    heights = range(2, 12)
    jobs = _jobs(src.block_store, src.state_store, heights)
    jjobs = _jobs(jsrc.block_store, jsrc.state_store, heights)
    assert V.verify_commits_coalesced(gen.chain_id, jobs, light=False, device=CPU) == [None] * 10
    assert JV.verify_commits_coalesced(jgen.chain_id, jjobs, light=False) == [None] * 10
    jobs[4] = _corrupt_first_sig(jobs[4], B.Commit, B.CommitSig)
    jjobs[4] = _corrupt_first_sig(jjobs[4], JB.Commit, JB.CommitSig)
    errors = V.verify_commits_coalesced(gen.chain_id, jobs, light=False, device=CPU)
    jerrors = JV.verify_commits_coalesced(jgen.chain_id, jjobs, light=False)
    assert [e is None for e in errors] == [e is None for e in jerrors] == [i != 4 for i in range(10)]


def test_event_loop_responsive_during_window_verify(source_chain, monkeypatch):
    """The verify wait runs off the loop: a heartbeat keeps ticking
    while each window's (deliberately slow, 0.4 s) result blocks."""
    gen, _, src = source_chain
    real = reactor_mod.verify_commits_coalesced_async
    slow_calls = []

    class Slow:
        def __init__(self, handle, n):
            self._handle, self._n = handle, n

        def __getattr__(self, name):
            return getattr(self._handle, name)

        def result(self):
            slow_calls.append(self._n)
            time.sleep(0.4)
            return self._handle.result()

    monkeypatch.setattr(reactor_mod, "verify_commits_coalesced_async",
                        lambda chain_id, jobs, **kw: Slow(real(chain_id, jobs, **kw), len(jobs)))

    async def main():
        fresh = build_node(gen, device=CPU)
        gaps, stop = [], asyncio.Event()

        async def heartbeat():
            last = time.monotonic()
            while not stop.is_set():
                await asyncio.sleep(0.01)
                now = time.monotonic()
                gaps.append(now - last)
                last = now

        hb = asyncio.create_task(heartbeat())
        await _catch_up(fresh, [("src", StorePeerClient(src))], 24, verify_window=8)
        stop.set()
        await hb
        return fresh, max(gaps)

    fresh, max_gap = run(main())
    assert fresh.block_store.height() >= 22
    assert len(slow_calls) >= 2, "the test must take at least two slow waits"
    assert max_gap < 0.25, f"event loop starved: max gap {max_gap:.3f}s"


BACKENDS = ["memdb", "sqlite", "logdb"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_block_store_writes_one_batch_per_window(source_chain, backend, tmp_path):
    gen, _, src = source_chain
    fresh = build_node(gen, db_backend=backend, home=str(tmp_path), device=CPU)
    db = fresh.block_store.db
    counts = []
    orig = db.write_batch

    def counting(sets, deletes=()):
        sets = list(sets)
        counts.append(len(sets))
        return orig(sets, deletes)

    db.write_batch = counting
    try:
        reactor = run(_catch_up(fresh, [("src", StorePeerClient(src))], CHAIN_LEN, verify_window=8))
        applied = reactor.blocks_applied
        assert applied >= CHAIN_LEN - 2
        # one write_batch a window (up to 7 blocks at window 8), not a block
        assert len(counts) < applied / 2, (len(counts), applied)
        assert max(counts) > 4, "a batch carries several blocks"
        for h in (1, applied):
            assert fresh.block_store.load_block(h).hash() == src.block_store.load_block(h).hash()
    finally:
        fresh.close_stores()


@pytest.mark.parametrize("backend", BACKENDS)
def test_save_block_batch_contiguity_and_roundtrip(source_chain, backend, tmp_path):
    from cometbft_tpu_torch.store.block_store import BlockStore

    _, _, src = source_chain
    db = kv.MemKV() if backend == "memdb" else kv.open_kv(backend, str(tmp_path / "blocks.db"))
    store = BlockStore(db)

    def entry(h):
        blk = src.block_store.load_block(h)
        return (blk, PartSet.from_data(codec.encode_block(blk)), src.block_store.load_seen_commit(h))

    try:
        store.save_block_batch([entry(1), entry(2), entry(3)])
        assert store.base() == 1 and store.height() == 3
        for h in (1, 2, 3):
            assert store.load_block(h).hash() == src.block_store.load_block(h).hash()
            assert store.load_seen_commit(h) is not None
        with pytest.raises(ValueError):
            store.save_block_batch([entry(5)])  # a gap after 3
        with pytest.raises(ValueError):
            store.save_block_batch([entry(4), entry(6)])  # a gap inside
        assert store.height() == 3
        store.save_block_batch([entry(4)])
        assert store.height() == 4
        assert store.load_block_commit(3) is not None
    finally:
        db.close()
