"""The finalize net of ``chip_smoke.py`` phase 17b, small, on the CPU.

Four validators on sqlite with a WAL, the JAX package's finalize bench
config (pipelined finalize with the hash/persist hop off the loop, WAL
group commit, no indexer) and every vote through the state machine's
coalescer, each node a VecBank app: a seeded set of transfers fed
round-robin must each be committed once, every node must store the same
blocks and end with the same balances, equal to the JAX package's
VecBank applying the same transfers; the run with the native lanes and
the run with both forced portable end in the same balances, each block
finalized by the pass of its run. Stopping the net while the last vote
window resolves writes nothing to the closed WAL (the port drops such
votes). Exact equality throughout.
"""

import asyncio
import hashlib

import numpy as np
import pytest
import torch

from cometbft_tpu.abci import types as jabci
from cometbft_tpu.models.vecbank import VecBankApplication as JVecBank
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.models.vecbank import VecBankApplication, make_transfer
from cometbft_tpu_torch.node.inprocess import LocalNet, build_node, make_genesis, make_privvals
from cometbft_tpu_torch.state import native_finalize
from cometbft_tpu_torch.utils import wirecodec
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

ACCOUNTS = 256
TRANSFERS = 300
HEIGHTS = 4


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def _transfers():
    rng = np.random.default_rng(17)
    pairs = rng.integers(0, ACCOUNTS, size=(TRANSFERS, 2))
    return [make_transfer(int(a), int(b), i + 1) for i, (a, b) in enumerate(pairs)]


def _run(tmp_path, transfers):
    tmp_path.mkdir()
    gen, privs = make_genesis(4, chain_id="fin-net", seed=3)
    pvs = make_privvals(privs, root=str(tmp_path))
    kinds = {}
    nodes = []
    for i, pv_ in enumerate(pvs):
        home = str(tmp_path / f"n{i}")
        cfg = make_test_cfg(home)
        cfg.base.db_backend = "sqlite"
        cfg.tx_index.indexer = "null"
        cfg.consensus.wal_group_commit_ms = 2.0
        cfg.consensus.finalize_pipeline = True
        cfg.consensus.finalize_offload_apply = True
        cfg.consensus.vote_batch_window_ms = 2.0
        n = build_node(gen, VecBankApplication(n_accounts=ACCOUNTS), home=home, device="cpu",
                       privval=pv_, config=cfg, wal=True)
        real = n.block_exec.apply_hash_persist

        def hash_persist(state, bid, block, resp, _real=real, _i=i):
            out = _real(state, bid, block, resp)
            kinds[(_i, block.height)] = out[1].native
            return out

        n.block_exec.apply_hash_persist = hash_persist
        nodes.append(n)
    net = LocalNet(nodes)

    async def main():
        await net.start()
        for k in range(0, len(transfers), 50):
            for tx in transfers[k:k + 50]:
                assert nodes[k // 50 % 4].mempool.check_tx(tx).is_ok()
            await asyncio.sleep(0.02)
        committed, seen = [], 0
        for _ in range(3000):
            for h in range(seen + 1, nodes[0].block_store.height() + 1):
                committed.extend(nodes[0].block_store.load_block(h).data.txs)
                seen = h
            if len(committed) >= len(transfers) and min(n.block_store.height() for n in nodes) >= max(seen, HEIGHTS):
                break
            await asyncio.sleep(0.02)
        await net.stop()
        return committed

    try:
        committed = asyncio.run(asyncio.wait_for(main(), 120))
        top = min(n.block_store.height() for n in nodes)
        for h in range(1, top + 1):
            assert len({n.block_store.load_block_meta(h).block_id.hash for n in nodes}) == 1, h
        digests = {hashlib.sha256(n.app.balances.astype(">u8").tobytes()).digest() for n in nodes}
        return committed, digests, kinds
    finally:
        for n in nodes:
            n.close_stores()


def test_finalize_net_native_and_portable_end_alike(tmp_path, capfd):
    transfers = _transfers()
    assert wirecodec.LANE.wait() is not None and native_finalize.LANE.wait() is not None
    runs = {}
    try:
        for mode in ("native", "portable"):
            for lane in (wirecodec.LANE, native_finalize.LANE):
                lane.force_portable() if mode == "portable" else lane.restore()
            runs[mode] = _run(tmp_path / mode, transfers)
    finally:
        for lane in (wirecodec.LANE, native_finalize.LANE):
            lane.restore()
    ref = JVecBank(n_accounts=ACCOUNTS)
    ref.finalize_block(jabci.RequestFinalizeBlock(txs=transfers, height=1))
    ref.commit()
    want = hashlib.sha256(ref.balances.astype(">u8").tobytes()).digest()
    for mode, (committed, digests, kinds) in runs.items():
        assert sorted(committed) == sorted(transfers), mode  # each once
        assert digests == {want}, mode
        assert set(kinds.values()) == {mode == "native"}, mode
    assert "write to closed file" not in capfd.readouterr().err


def test_a_vote_resolving_during_stop_is_not_written_to_the_closed_wal(tmp_path, capfd):
    """ROADMAP C22: a staged vote whose verdict arrives after the stop
    closed the WAL (phase 17b on the card logged five such writes) is
    dropped; before, its callback wrote it to the closed WAL."""
    from cometbft_tpu_torch.consensus.state import VoteMessage
    from cometbft_tpu_torch.types.block import BlockID
    from cometbft_tpu_torch.types.vote import PREVOTE, Vote

    gen, privs = make_genesis(2, chain_id="c22", seed=5)
    pvs = make_privvals(privs, root=str(tmp_path))
    cfg = make_test_cfg(str(tmp_path))
    cfg.consensus.vote_batch_window_ms = 2.0
    node = build_node(gen, privval=pvs[0], config=cfg, home=str(tmp_path), device="cpu", wal=True)
    vals = gen.validator_set()
    other = next(i for i, v in enumerate(vals.validators) if v.address == privs[1].pub_key().address())
    vote = Vote(PREVOTE, 1, 0, BlockID(), gen.genesis_time_ns + 1, vals.validators[other].address, other)
    pvs[1].sign_vote(gen.chain_id, vote)

    async def main():
        cs = node.cs
        await cs.start()
        verdicts = []

        def submit(pk, sb, sig):  # the wave's verdict, held by the test
            verdicts.append(asyncio.get_running_loop().create_future())
            return verdicts[-1]

        cs._vote_coalescer.submit = submit
        cs.enqueue_nowait("vote", VoteMessage(vote), "peer1")
        for _ in range(500):
            if verdicts:
                break
            await asyncio.sleep(0.01)
        assert len(verdicts) == 1
        await cs.stop()
        assert cs.wal._f.closed
        verdicts[0].set_result(True)
        await asyncio.sleep(0.1)  # the verdict's callback runs

    asyncio.run(asyncio.wait_for(main(), 60))
    node.close_stores()
    err = capfd.readouterr().err
    assert "write to closed file" not in err and "Traceback" not in err, err[-2000:]
