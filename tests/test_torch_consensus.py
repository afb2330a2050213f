"""In-process consensus (the reference's consensus/common_test.go
strategy): single-node chains, multi-node local nets, WAL crash replay,
double-sign protection.

The port of ``tests/test_consensus.py``, each test with its JAX
counterpart's checks, on the port's ``LocalNet`` and state machine on
``device="cpu"``: votes verify one at a time on the host (the batch
path rides ``test_torch_vote_extensions.py``'s and the parity tests'
vote waves). The port's ``make_genesis`` returns raw keys;
``make_privvals`` makes the file-backed signers the JAX package's
``make_genesis`` returns.
"""

import asyncio

import pytest
import torch

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.consensus.wal import MSG_END_HEIGHT, WAL, WALMessage
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import LocalNet, build_node, make_genesis, make_privvals
from cometbft_tpu_torch.privval import DoubleSignError, FilePV
from cometbft_tpu_torch.types.block import BlockID, PartSetHeader
from cometbft_tpu_torch.types.validation import verify_commit
from cometbft_tpu_torch.types.vote import PREVOTE, Vote
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_single_node_produces_blocks():
    async def main():
        gen, privs = make_genesis(1)
        pvs = make_privvals(privs)
        node = build_node(gen, privval=pvs[0], device=CPU)
        net = LocalNet([node])
        await net.start()
        # inject a tx mid-flight
        node.mempool.check_tx(b"hello=world")
        await net.wait_for_height(3, timeout=30)
        await net.stop()
        assert node.block_store.height() >= 3
        # the tx landed in some block
        found = False
        for h in range(1, node.block_store.height() + 1):
            blk = node.block_store.load_block(h)
            if b"hello=world" in blk.data.txs:
                found = True
        assert found
        q = node.proxy.query.query(abci.RequestQuery(data=b"hello"))
        assert q.value == b"world"
        # commits verify against the valset
        vs = gen.validator_set()
        for h in range(1, 3):
            commit = node.block_store.load_seen_commit(h)
            meta = node.block_store.load_block_meta(h)
            verify_commit(
                gen.chain_id, vs, meta.block_id, h, commit, device=CPU
            )

    run(main())


def test_four_node_net_agrees():
    async def main():
        gen, privs = make_genesis(4)
        nodes = [build_node(gen, privval=pv, device=CPU) for pv in make_privvals(privs)]
        net = LocalNet(nodes)
        await net.start()
        nodes[0].mempool.check_tx(b"a=1")
        nodes[1].mempool.check_tx(b"b=2")
        await net.wait_for_height(3, timeout=40)
        await net.stop()
        # all agree on block hashes
        for h in range(1, 4):
            hashes = {
                n.block_store.load_block_meta(h).block_id.hash for n in nodes
            }
            assert len(hashes) == 1, f"disagreement at height {h}"
        # app state converged
        app_hashes = {n.app.app_hash for n in nodes}
        assert len(app_hashes) == 1

    run(main())


def test_net_survives_one_faulty_node_down():
    """3 of 4 validators are enough to keep committing."""

    async def main():
        gen, privs = make_genesis(4)
        pvs = make_privvals(privs)
        nodes = [build_node(gen, privval=pv, device=CPU) for pv in pvs[:3]]  # node 3 never runs
        net = LocalNet(nodes)
        await net.start()
        await net.wait_for_height(2, timeout=60)
        await net.stop()
        assert all(n.block_store.height() >= 2 for n in nodes)

    run(main())


def test_wal_replay_after_crash(tmp_path):
    async def main():
        home = str(tmp_path)
        gen, privs = make_genesis(1)
        pvs = make_privvals(privs, root=home)
        node = build_node(gen, privval=pvs[0], home=home, wal=True, device=CPU)
        net = LocalNet([node])
        await net.start()
        await net.wait_for_height(2, timeout=30)
        await net.stop()
        h_before = node.block_store.height()
        wal_path = node.cs._wal_path
        msgs = list(WAL.iter_messages(wal_path))
        assert any(m.kind == MSG_END_HEIGHT for m in msgs)
        # "crash": discard the node, rebuild from the same dbs + WAL
        # (memdb is per-instance, so rebuild from stores via a fresh app
        # exercises the ABCI handshake replay path)
        node2 = build_node(
            gen,
            privval=pvs[0],
            home=home,
            wal=True,
            device=CPU,
        )
        # fresh app replayed to stored height
        assert node2.app.height == 0  # memdb: new app, fresh dbs
        await node2.cs.stop()

    run(main())


def test_handshake_replays_blocks_to_fresh_app(tmp_path):
    """Crash-recovery: store has blocks, app restarts at 0 ->
    handshake replays them (reference consensus/replay.go:288)."""

    async def main():
        gen, privs = make_genesis(1)
        cfgdir = str(tmp_path)
        pvs = make_privvals(privs, root=cfgdir)
        cfg = make_test_cfg(cfgdir)
        cfg.base.db_backend = "sqlite"
        node = build_node(gen, privval=pvs[0], config=cfg, home=cfgdir, device=CPU)
        net = LocalNet([node])
        await net.start()
        node.mempool.check_tx(b"x=y")
        await net.wait_for_height(3, timeout=30)
        await net.stop()
        height = node.block_store.height()
        app_hash = node.app.app_hash
        node.block_db.close()
        node.state_db.close()
        # new process: fresh app, same disk stores
        node2 = build_node(gen, privval=pvs[0], config=cfg, home=cfgdir, device=CPU)
        assert node2.app.height == height >= 3
        assert node2.app.app_hash == app_hash
        q = node2.proxy.query.query(abci.RequestQuery(data=b"x"))
        assert q.value == b"y"
        await node2.cs.stop()

    run(main())


def test_double_sign_protection(tmp_path):

    pv = FilePV.generate(
        str(tmp_path / "key.json"), str(tmp_path / "state.json")
    )
    bid = BlockID(b"\x01" * 32, PartSetHeader(1, b"\x02" * 32))
    v1 = Vote(
        type_=PREVOTE,
        height=5,
        round=0,
        block_id=bid,
        timestamp_ns=1000,
        validator_address=pv.pub_key().address(),
        validator_index=0,
    )
    pv.sign_vote("c", v1)
    assert v1.signature
    # same vote again: same signature returned
    v2 = Vote(**{**v1.__dict__, "signature": b""})
    pv.sign_vote("c", v2)
    assert v2.signature == v1.signature
    # conflicting block at same HRS: refuse
    v3 = Vote(
        **{
            **v1.__dict__,
            "signature": b"",
            "block_id": BlockID(b"\x03" * 32, PartSetHeader(1, b"\x04" * 32)),
        }
    )
    with pytest.raises(DoubleSignError):
        pv.sign_vote("c", v3)
    # height regression: refuse
    v4 = Vote(**{**v1.__dict__, "signature": b"", "height": 4})
    with pytest.raises(DoubleSignError):
        pv.sign_vote("c", v4)
    # state survives reload
    pv2 = FilePV.load(
        str(tmp_path / "key.json"), str(tmp_path / "state.json")
    )
    with pytest.raises(DoubleSignError):
        pv2.sign_vote("c", v3)


def test_wal_corruption_tolerant(tmp_path):
    path = str(tmp_path / "wal")
    w = WAL(path)
    for h in (1, 2, 3):
        w.write_sync(WALMessage(kind=MSG_END_HEIGHT, height=h))
    w.close()
    msgs = list(WAL.iter_messages(path))
    assert len(msgs) == 3
    # corrupt the tail
    with open(path, "ab") as f:
        f.write(b"\x00garbage\xff" * 3)
    msgs = list(WAL.iter_messages(path))
    assert len(msgs) == 3  # stops at corruption
    assert WAL.search_for_end_height(path, 2) == 2
    n = WAL.truncate_corrupt_tail(path)
    assert n == 3
