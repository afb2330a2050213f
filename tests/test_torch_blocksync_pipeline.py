"""The port's pipelined blocksync dispatch: the JAX package's cases.

The window loop pre-dispatches the NEXT window's signature batch
before applying the current one; the handle is reused only when its
inputs (valset hash and block hashes) match, and dropped on every
redo, ban and valset change. These tests count the dispatches at the
seam and check the end state around them. Commit checks run on
``device="cpu"`` (the host plane). Pipeline assertions rest on a
prefilled pool, never on fetch timing; every wait has a deadline.
"""

import asyncio
import copy
import dataclasses

import pytest
import torch

from cometbft_tpu_torch.blocksync import reactor as reactor_mod
from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
from cometbft_tpu_torch.types.validation import (
    verify_commits_coalesced,
    verify_commits_coalesced_async,
)
from cometbft_tpu_torch.utils.chaingen import StorePeerClient, make_chain
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


class _DispatchCounter:
    """Wraps verify_commits_coalesced_async at the reactor's seam:
    counts dispatches and the jobs each carried."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = reactor_mod.verify_commits_coalesced_async

        def wrapped(chain_id, jobs, cache=None, light=True, **kw):
            self.calls.append(len(jobs))
            return real(chain_id, jobs, cache=cache, light=light, **kw)

        monkeypatch.setattr(reactor_mod, "verify_commits_coalesced_async", wrapped)


async def _prefill(pool, n, deadline_s=60):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + deadline_s
    while len(pool.blocks) < n:
        if loop.time() > deadline:
            raise TimeoutError(f"pool prefill: {len(pool.blocks)} of {n}")
        await asyncio.sleep(0.01)


def _sync(gen, src, window=8, prefill=0):
    async def main():
        fresh = build_node(gen, device=CPU)
        caught = asyncio.Event()
        reactor = BlockSyncReactor(
            fresh.state,
            fresh.block_exec,
            fresh.block_store,
            on_caught_up=lambda st: caught.set(),
            verify_window=window,
            device=CPU,
        )
        reactor.pool.set_peer_range("src", StorePeerClient(src), 1, src.block_store.height())
        # the requesters buffer a lookahead before the loop starts, so
        # the predispatch/reuse sequence does not depend on fetch timing
        await _prefill(reactor.pool, prefill)
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 90)
        await reactor.stop()
        assert reactor.loop_errors.count == 0, reactor.loop_errors
        return fresh, reactor

    return run(main())


def test_pipeline_reuses_predispatched_windows(monkeypatch):
    """Steady state: nearly every pass consumes the handle the previous
    pass pre-dispatched, so the jobs dispatched stay close to the
    blocks applied (they would about double with no reuse)."""
    gen, privs = make_genesis(3, chain_id="pipe-chain")
    src = make_chain(gen, privs, 40, device=CPU)
    counter = _DispatchCounter(monkeypatch)
    fresh, reactor = _sync(gen, src, window=8, prefill=24)
    assert fresh.block_store.height() >= src.block_store.height() - 1
    jobs_total = sum(counter.calls)
    applied = reactor.blocks_applied
    assert jobs_total - applied <= 2 * 8, (jobs_total, applied)
    assert len(counter.calls) >= 2
    stats = reactor.pipeline_stats
    assert stats["reused"] >= stats["dispatched"], stats
    assert stats["reused"] >= 2, stats


def test_pipeline_discards_on_refetch():
    """Direct drive of _process_window: a tampered block mid-window
    breaks the pass, the pre-dispatched handle is dropped, the
    refetched honest block forces a fresh dispatch, and the store
    ends with honest content."""
    gen, privs = make_genesis(3, chain_id="pipe-evil")
    src = make_chain(gen, privs, 24, device=CPU)
    fresh = build_node(gen, device=CPU)
    reactor = BlockSyncReactor(
        fresh.state, fresh.block_exec, fresh.block_store, verify_window=8, device=CPU
    )

    def fill(h0, h1, tamper=()):
        for h in range(h0, h1 + 1):
            if h in reactor.pool.blocks:
                continue
            blk = src.block_store.load_block(h)
            if h in tamper:
                # TamperingPeerClient's corruption: an added tx
                blk.data.txs = list(blk.data.txs) + [b"evil=1"]
                blk.data._hash = None
                del blk._raw_bytes
            reactor.pool.blocks[h] = (blk, "evil" if h in tamper else "good")

    # pass 1: 1..7 applied; the lookahead 8..14 pre-dispatched
    fill(1, 17, tamper={12})
    assert reactor._process_window(reactor.pool.peek_window(16)) == 7
    assert reactor._inflight is not None
    assert reactor.pipeline_stats["predispatched"] == 1
    # pass 2: reuses the lookahead, applies 8..11, breaks at 12, and
    # its own lookahead is discarded
    assert reactor._process_window(reactor.pool.peek_window(16)) == 4
    assert reactor._inflight is None
    assert reactor.pipeline_stats["reused"] == 1
    assert reactor.pipeline_stats["discarded"] >= 1, reactor.pipeline_stats
    # the refetched window matches no old key: a fresh dispatch
    before = reactor.pipeline_stats["dispatched"]
    fill(12, 17)
    assert reactor._process_window(reactor.pool.peek_window(16)) >= 5
    assert reactor.pipeline_stats["dispatched"] == before + 1
    assert fresh.block_store.load_block(12).hash() == src.block_store.load_block(12).hash()


@pytest.mark.parametrize("lookahead", ["shorter", "longer"])
def test_overlapped_pass_reuses_partial_lookahead(lookahead):
    """Direct drive of _process_window_overlapped when the lookahead
    and the next window differ in length: a shorter lookahead is
    spliced with a fresh dispatch of the rest, a longer one gives up
    its prefix. Both passes await every ticket behind the handle and
    apply the window from the reused verdicts."""
    gen, privs = make_genesis(3, chain_id="pipe-splice")
    src = make_chain(gen, privs, 24, device=CPU)
    fresh = build_node(gen, device=CPU)
    reactor = BlockSyncReactor(
        fresh.state, fresh.block_exec, fresh.block_store, verify_window=8, device=CPU
    )

    def fill(h0, h1):
        for h in range(h0, h1 + 1):
            reactor.pool.blocks.setdefault(h, (src.block_store.load_block(h), "src"))

    async def main():
        if lookahead == "shorter":
            # pass 1 sees 1..12: its lookahead covers 8..11 only, and the
            # pool refills before pass 2, whose window verifies 8..14
            fill(1, 12)
            assert await reactor._process_window_overlapped(reactor.pool.peek_window(16)) == 7
            fill(13, 24)
            peek, applied, dispatched = 16, 7, 2
        else:
            # pass 1's lookahead covers 8..14; pass 2 applies 8..11 only
            fill(1, 24)
            assert await reactor._process_window_overlapped(reactor.pool.peek_window(16)) == 7
            peek, applied, dispatched = 4, 4, 1
        assert reactor._inflight is not None
        assert await reactor._process_window_overlapped(reactor.pool.peek_window(peek)) == applied
        return dispatched

    dispatched = run(main())
    stats = reactor.pipeline_stats
    assert stats["reused"] == 1, stats
    assert stats["discarded"] == 0, stats
    assert stats["dispatched"] == dispatched, stats
    assert reactor.loop_errors.count == 0, reactor.loop_errors
    h = 7 + (7 if lookahead == "shorter" else 4)
    assert fresh.block_store.height() == h
    assert fresh.block_store.load_block(h).hash() == src.block_store.load_block(h).hash()


def test_pipeline_discards_across_valset_change(monkeypatch):
    """A real validator-set change mid-chain (a kvstore val: tx):
    windows stop at the change, the lookahead bound to the old valset
    hash stops matching, and the sync ends verified against the new
    set."""
    gen, privs = make_genesis(4, chain_id="pipe-valset")
    src = make_chain(gen, privs, 12, device=CPU)
    newv = Ed25519PrivKey.from_seed(b"\x07" * 32)
    src.mempool.check_tx(b"val:" + newv.pub_key().key_bytes.hex().encode() + b"!5")
    make_chain(gen, privs + [newv], 28, node=src)
    assert src.state.validators.size() == 5
    _DispatchCounter(monkeypatch)
    fresh, reactor = _sync(gen, src, window=8, prefill=18)
    assert fresh.block_store.height() >= src.block_store.height() - 1
    assert fresh.state_store.load().validators.size() == 5


def test_blocksync_interrupt_and_resume(tmp_path):
    """Stopped mid-catch-up (its lookahead in flight), blocksync
    resumes from the persisted sqlite stores in a rebuilt node and
    completes."""
    gen, privs = make_genesis(3, chain_id="resume-chain")
    src = make_chain(gen, privs, 40, device=CPU)
    home = str(tmp_path / "node")

    def build():
        return build_node(gen, db_backend="sqlite", home=home, device=CPU)

    fresh = build()

    async def phase1():
        r = BlockSyncReactor(
            fresh.state, fresh.block_exec, fresh.block_store, verify_window=8, device=CPU
        )
        r.pool.set_peer_range("src", StorePeerClient(src), 1, src.block_store.height())
        await _prefill(r.pool, 20)
        await r.start()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 60
        while fresh.block_store.height() < 15:
            assert loop.time() < deadline, "no progress to height 15"
            await asyncio.sleep(0.01)
        stats = dict(r.pipeline_stats)
        await r.stop()  # abrupt: the lookahead handle dies with it
        assert stats["predispatched"] >= 1, stats
        assert r.loop_errors.count == 0, r.loop_errors

    run(phase1())
    h1 = fresh.block_store.height()
    assert h1 >= 15
    fresh.close_stores()

    # the rebuilt node resumes from disk
    fresh2 = build()
    assert fresh2.block_store.height() == h1
    assert fresh2.state.last_block_height == h1

    async def phase2():
        caught = asyncio.Event()
        r = BlockSyncReactor(
            fresh2.state,
            fresh2.block_exec,
            fresh2.block_store,
            on_caught_up=lambda st: caught.set(),
            verify_window=8,
            device=CPU,
        )
        r.pool.set_peer_range("src", StorePeerClient(src), 1, src.block_store.height())
        await r.start()
        await asyncio.wait_for(caught.wait(), 60)
        await r.stop()

    run(phase2())
    h = fresh2.block_store.height()
    assert h >= src.block_store.height() - 1
    assert fresh2.block_store.load_block(h).hash() == src.block_store.load_block(h).hash()
    fresh2.close_stores()


def test_async_handle_matches_sync_verdicts():
    """verify_commits_coalesced_async().result() equals
    verify_commits_coalesced() on the same jobs, a bad one included."""
    gen, privs = make_genesis(4, chain_id="pipe-eq")
    src = make_chain(gen, privs, 5, device=CPU)
    vs = gen.validator_set()
    store = src.block_store
    jobs = [
        (vs, store.load_block_meta(h).block_id, h, store.load_seen_commit(h)) for h in range(1, 5)
    ]
    bad = copy.deepcopy(store.load_seen_commit(2))
    sig = bytearray(bad.signatures[0].signature)
    sig[0] ^= 1
    bad.signatures[0] = dataclasses.replace(bad.signatures[0], signature=bytes(sig))
    jobs.append((vs, store.load_block_meta(2).block_id, 2, bad))
    sync_errors = verify_commits_coalesced(gen.chain_id, jobs, device=CPU)
    async_errors = verify_commits_coalesced_async(gen.chain_id, jobs, device=CPU).result()
    assert [e is None for e in sync_errors] == [e is None for e in async_errors]
    assert sync_errors[:4] == [None] * 4
    assert async_errors[4] is not None
