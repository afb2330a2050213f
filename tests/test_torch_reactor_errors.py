"""The replay reactor on a card that keeps failing.

The pool routine catches what a window raises and retries. On a card
whose device route always raises (a stand-in: the device route pinned
on ``device="cpu"`` with ``ops.ed25519.verify_batch_async`` raising a
CUDA error), the routine must keep a count and a few errors, not every
one; log the traceback of the error once; back off its retry while the
error repeats; never verify on the host plane instead; and once the
card answers again, apply the chain and reset its wait. The routine's
waits are recorded, not slept: the test holds no clock.
"""

import asyncio
import types

import pytest
import torch

from cometbft_tpu_torch.blocksync import reactor as reactor_mod
from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor, LoopErrors
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.scheduler import DeviceRouteError
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
from cometbft_tpu_torch.ops import ed25519 as ops_ed
from cometbft_tpu_torch.utils.chaingen import StorePeerClient, make_chain
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
N_BLOCKS = 20
# failing passes: enough to reach the cap and stay on it
N_FAILS = 10
CUDA_ERROR = "CUDA error: launch failed"


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    floor = crypto_batch._MIN_DEVICE_BATCH
    yield
    crypto_batch.set_min_device_batch(floor)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def test_loop_errors_keep_a_count_and_a_few():
    errs = LoopErrors()
    news = [errs.add(RuntimeError(CUDA_ERROR)) for _ in range(1000)]
    assert news[0] and not any(news[1:])
    assert errs.add(ValueError("another")) is True
    assert errs.count == 1001
    kept = errs.kept()
    assert len(kept) == 2 * LoopErrors.KEEP
    assert isinstance(kept[-1], ValueError) and CUDA_ERROR in repr(errs)


def test_failing_card_backs_off_and_recovers(monkeypatch, capsys):
    gen, privs = make_genesis(4, chain_id="failing-card", seed=3)
    src = make_chain(gen, privs, N_BLOCKS, device=CPU)
    real_async = ops_ed.verify_batch_async
    fault = RuntimeError(CUDA_ERROR)
    card = {"calls": 0}

    def dispatch(items, device=None, precomp=None):
        # the first N_FAILS dispatches fail: while the card fails, a
        # pass dispatches one window and no lookahead
        card["calls"] += 1
        if card["calls"] <= N_FAILS:
            raise fault
        return real_async(items, device=device, precomp=precomp)

    monkeypatch.setattr(ops_ed, "verify_batch_async", dispatch)
    # the routine's waits, with the error count when each was asked for
    waits = []
    real_sleep = asyncio.sleep
    holder = {}

    async def sleep(s):
        if s:
            waits.append((s, holder["reactor"].loop_errors.count))
        await real_sleep(0)

    clock = types.SimpleNamespace(**vars(asyncio))
    clock.sleep = sleep
    monkeypatch.setattr(reactor_mod, "asyncio", clock)
    crypto_batch.set_min_device_batch(1)
    sched = sched_mod.VerifyScheduler()
    sched_mod.set_scheduler(sched)

    async def main():
        fresh = build_node(gen, device=CPU)
        caught = asyncio.Event()
        reactor = BlockSyncReactor(
            fresh.state,
            fresh.block_exec,
            fresh.block_store,
            on_caught_up=lambda st: caught.set(),
            verify_window=8,
            device=CPU,
        )
        holder["reactor"] = reactor
        reactor.pool.set_peer_range("src", StorePeerClient(src), 1, src.block_store.height())
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 60)
        await reactor.stop()
        return fresh, reactor

    try:
        fresh, reactor = asyncio.run(asyncio.wait_for(main(), 120))
        stats = sched.stats()
    finally:
        sched.close()
    errs = reactor.loop_errors
    # one error per failing pass, each followed by a wait that doubles
    # from 10 ms while the error repeats, up to the 1 s cap
    assert errs.count == N_FAILS, errs
    backoff = [0.01, 0.02, 0.04, 0.08, 0.16, 0.32, 0.64, 1.0, 1.0, 1.0]
    assert waits[:N_FAILS] == list(zip(backoff, range(1, N_FAILS + 1)))
    # the card answers again: a window applies and the wait is reset,
    # so no later wait is above the floor
    assert all(w == reactor_mod.RETRY_MIN_S for w, _ in waits[N_FAILS:])
    assert reactor.retry_s == reactor_mod.RETRY_MIN_S
    assert fresh.block_store.height() >= N_BLOCKS - 1
    # the same error surfaced, each time: the scheduler's one type,
    # chained to the card's error, its frames dropped
    kept = errs.kept()
    assert len(kept) == 2 * LoopErrors.KEEP
    assert all(isinstance(e, DeviceRouteError) and e.__cause__ is fault for e in kept)
    assert all(e.__traceback__ is None for e in kept)
    # one traceback logged for the one kind of error
    assert capsys.readouterr().err.count("DeviceRouteError: verify route failed") == 1
    # the failing route raised; no window went to the host plane instead
    assert stats["degraded"] == N_FAILS and stats["host_chunks"] == 0


def _extension_chain():
    """A chain with vote extensions on from height 1, made by the
    port's 4-node ``LocalNet`` on the CPU: every height's extended
    commit signed by the validators' own consensus rounds."""
    from cometbft_tpu_torch.node.inprocess import LocalNet, make_privvals

    async def main():
        gen, privs = make_genesis(4, chain_id="c7-ext", seed=5)
        gen.consensus_params.abci.vote_extensions_enable_height = 1
        nodes = [build_node(gen, privval=p, device=CPU) for p in make_privvals(privs)]
        net = LocalNet(nodes)
        await net.start()
        await net.wait_for_height(EXT_HEIGHTS, timeout=60)
        await net.stop()
        return gen, nodes[0]

    return asyncio.run(asyncio.wait_for(main(), 120))


EXT_HEIGHTS = 8


def test_failed_route_in_the_extended_commit_check_is_no_verdict(monkeypatch):
    """C7: a stand-in card that fails every dispatch carrying extension
    lanes (the commits' own lanes pass) makes ``_check_extended_commit``
    raise a ``DeviceRouteError``. It reaches the pool routine as it is:
    counted, with no refetch, no ban and nothing stored. With the card
    working, the same replay applies every height and stores every
    extended commit."""
    gen, src = _extension_chain()
    top = src.block_store.height()
    assert all(src.block_store.load_extended_commit(h) for h in range(1, top + 1))
    real_async = ops_ed.verify_batch_async
    card = {"fail": True, "failed": 0}

    def dispatch(items, device=None, precomp=None):
        if card["fail"] and any(b"ext|" in it[0] for it in items):
            card["failed"] += 1
            raise RuntimeError(CUDA_ERROR)
        return real_async(items, device=device, precomp=precomp)

    monkeypatch.setattr(ops_ed, "verify_batch_async", dispatch)
    crypto_batch.set_min_device_batch(1)
    sched = sched_mod.VerifyScheduler()
    sched_mod.set_scheduler(sched)

    async def replay(wait_errors):
        fresh = build_node(gen, device=CPU)
        caught = asyncio.Event()
        reactor = BlockSyncReactor(
            fresh.state,
            fresh.block_exec,
            fresh.block_store,
            on_caught_up=lambda st: caught.set(),
            verify_window=4,
            device=CPU,
        )
        pool = reactor.pool
        redos = []
        real_redo = pool.redo_request

        def redo(height, ban_peer):
            redos.append((height, ban_peer))
            real_redo(height, ban_peer)

        pool.redo_request = redo
        pool.set_peer_range("src", StorePeerClient(src), 1, top)
        await reactor.start()
        loop = asyncio.get_running_loop()
        if wait_errors:
            deadline = loop.time() + 60
            while reactor.loop_errors.count < wait_errors:
                assert loop.time() < deadline, reactor.loop_errors
                await asyncio.sleep(0.01)
        else:
            await asyncio.wait_for(caught.wait(), 60)
        banned = sorted(pool.banned_peers())
        await reactor.stop()
        return fresh, reactor, redos, banned

    try:
        fresh, reactor, redos, banned = asyncio.run(replay(3))
        assert card["failed"] >= 3
        kept = reactor.loop_errors.kept()
        assert kept and all(
            isinstance(e, DeviceRouteError) and isinstance(e.__cause__, RuntimeError) for e in kept
        )
        assert redos == [] and banned == []
        assert fresh.block_store.height() == 0 and reactor.blocks_applied == 0
        assert all(fresh.block_store.load_extended_commit(h) is None for h in range(1, top + 1))

        card["fail"] = False
        fresh, reactor, redos, banned = asyncio.run(replay(0))
        assert reactor.loop_errors.count == 0 and redos == [] and banned == []
        assert fresh.block_store.height() >= top - 2
        for h in range(1, fresh.block_store.height() + 1):
            assert fresh.block_store.load_extended_commit(h) == src.block_store.load_extended_commit(h), h
            assert fresh.block_store.load_block_meta(h).block_id == src.block_store.load_block_meta(h).block_id
    finally:
        sched.close()
