"""The fork's own features in the port against the JAX package, on the
CPU: the app-side mempool (``AppMempool``, ``AppMempoolKVStore``,
``AppMempoolReactor``), the autopool and the TTL guard.

- Two cases of the JAX package's tests/test_fork_features.py, on the
  port: three Nodes with the app-owned mempool commit a tx submitted at
  one of them, which every app then answers queries for; the autopool
  grows against a backlog and shrinks back when idle.
- The same inputs, from one numpy seed, through both packages, the
  clock monkeypatched: ``TTLGuard`` gives the same verdicts; an
  ``AppMempool`` over an ``AppMempoolKVStore`` gives the same CheckTx
  verdicts, reaps, ``iter_txs`` and ``size`` across commits; an
  ``AppMempoolReactor`` puts the same bytes on the wire for a local
  submission and for a relayed tx, a stamp-magic-prefixed one among
  them, and forwards to every peer but the sender.
"""

import asyncio
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.abci import types as jabci
from cometbft_tpu.abci.client import LocalClient as JLocalClient
from cometbft_tpu.mempool import mempool as jmempool
from cometbft_tpu.mempool import reactor as jreactor
from cometbft_tpu.models import kvstore as jkv
from cometbft_tpu.p2p.node_info import NodeInfo as JNodeInfo
from cometbft_tpu.p2p.switch import Switch as JSwitch
from cometbft_tpu.utils import guard as jguard
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import LocalClient
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.mempool import mempool as pmempool
from cometbft_tpu_torch.mempool import reactor as preactor
from cometbft_tpu_torch.models import kvstore as pkv
from cometbft_tpu_torch.p2p.node_info import NodeInfo
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.utils import guard as pguard
from cometbft_tpu_torch.utils.autopool import AutoPool
from torch_hard_limit import hard_limit  # noqa: F401

SEED = 0xF0


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def test_app_mempool_net_commits_txs(host_plane):
    """Nodes with the app-owned mempool: a tx submitted at one node is
    gossiped, stored by the app, reaped into a block network-wide."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node

    gen, privs = make_genesis(3, chain_id="appmem-chain")
    pvs = make_privvals(privs)

    async def main():
        nodes = []
        for i, pv_ in enumerate(pvs):
            cfg = make_test_cfg(".")
            cfg.base.moniker = f"node{i}"
            cfg.blocksync.enable = False
            cfg.mempool.type_ = "app"
            nodes.append(Node(cfg, gen, privval=pv_, app=pkv.AppMempoolKVStore(), device="cpu"))
        for n in nodes:
            assert isinstance(n.parts.mempool, pmempool.AppMempool)
            assert isinstance(n.mempool_reactor, preactor.AppMempoolReactor)
            await n.start()
        try:
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            # submit through the reactor's local path (RPC equivalent)
            nodes[1].mempool_reactor.submit_local(b"appmem=works")

            async def committed():
                while True:
                    for n in nodes:
                        for h in range(1, n.height + 1):
                            blk = n.parts.block_store.load_block(h)
                            if blk and b"appmem=works" in blk.data.txs:
                                return True
                    await asyncio.sleep(0.05)

            assert await asyncio.wait_for(committed(), 30)

            async def queryable():
                while True:
                    res = nodes[2].parts.proxy.query.query(abci.RequestQuery(path="/store", data=b"appmem"))
                    if res.value == b"works":
                        return True
                    await asyncio.sleep(0.05)

            assert await asyncio.wait_for(queryable(), 15)
        finally:
            for n in nodes:
                await n.stop()

    run(main())


def test_autopool_scales_up_and_down():
    async def main():
        pool = AutoPool(min_workers=1, max_workers=4)
        pool.start()
        assert pool.size == 1
        gate = asyncio.Event()

        async def slow_job():
            await gate.wait()

        for _ in range(400):
            pool.submit(slow_job)
        # scaler should grow the pool against the backlog
        for _ in range(40):
            if pool.size >= 2:
                break
            await asyncio.sleep(0.1)
        assert pool.size >= 2
        gate.set()
        # drain, then shrink back toward min
        for _ in range(100):
            if pool.queue.qsize() == 0 and pool.size == 1:
                break
            await asyncio.sleep(0.1)
        assert pool.queue.qsize() == 0
        assert pool.size == 1
        assert pool.processed >= 400
        assert pool.max_size >= 2
        await pool.stop()

    run(main())


# --- the same inputs through both packages -------------------------------


class _Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def test_ttl_guard_verdicts_match_jax(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    rng = np.random.default_rng(SEED)
    keys = [rng.bytes(8) for _ in range(1500)]
    guards = [pguard.TTLGuard(ttl_s=5.0, max_size=1200), jguard.TTLGuard(ttl_s=5.0, max_size=1200)]
    verdicts = ([], [])
    for step in range(4000):
        key = keys[int(rng.integers(0, len(keys)))]
        for g, out in zip(guards, verdicts):
            out.append(g.check_and_set(key))
        clock.now += float(rng.exponential(0.01))
        if step % 500 == 0:
            assert len(guards[0]) == len(guards[1])
    assert verdicts[0] == verdicts[1]
    assert 0 < sum(verdicts[0]) < len(verdicts[0])  # both refusals and admissions
    assert len(guards[0]) == len(guards[1]) <= 1200


def _app_mempool(mod_mempool, mod_kv, mod_client):
    app = mod_kv.AppMempoolKVStore()
    return mod_mempool.AppMempool(mod_client(app)), app


def _drive_app_mempool(mp, app, mod_abci, seq, clock):
    out = []
    height = 0
    for op, arg in seq:
        if op == "check":
            r = mp.check_tx(arg)
            out.append(("check", r.code, r.log))
        elif op == "reap":
            out.append(("reap", mp.reap_max_bytes_max_gas(arg, -1), mp.txs_available().is_set()))
        elif op == "commit":
            height += 1
            txs = mp.reap_max_bytes_max_gas(arg, -1)
            app.finalize_block(mod_abci.RequestFinalizeBlock(txs=txs, height=height))
            app.commit()
            mp.update(height, txs, [])
            out.append(("commit", txs, mp.iter_txs(), mp.size(), mp.txs_available().is_set()))
        else:
            clock.now += arg
    return out


def test_app_mempool_verdicts_match_jax(monkeypatch):
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    rng = np.random.default_rng(SEED + 1)
    pool = [b"k%03d=v%03d" % (i, int(rng.integers(0, 5))) for i in range(60)] + [b"no-equals", b""]
    seq = []
    for _ in range(400):
        r = rng.random()
        if r < 0.7:
            seq.append(("check", pool[int(rng.integers(0, len(pool)))]))
        elif r < 0.8:
            seq.append(("reap", int(rng.integers(-1, 200))))
        elif r < 0.9:
            seq.append(("commit", int(rng.integers(-1, 300))))
        else:
            seq.append(("tick", float(rng.uniform(0, 40))))
    port = _drive_app_mempool(*_app_mempool(pmempool, pkv, LocalClient), abci, seq, clock)
    clock.now = 1000.0
    jax = _drive_app_mempool(*_app_mempool(jmempool, jkv, JLocalClient), jabci, seq, clock)
    assert port == jax
    codes = [o[1] for o in port if o[0] == "check"]
    logs = {o[2] for o in port if o[0] == "check"}
    assert 0 in codes and 1 in codes and "duplicate (guard)" in logs
    assert any(o[0] == "commit" and o[1] for o in port)
    assert all(o[3] == -1 for o in port if o[0] == "commit")  # size() of an app-owned pool


class _Peer:
    def __init__(self, peer_id):
        self.peer_id = peer_id
        self.sent = []

    def try_send(self, chan_id, msg):
        self.sent.append((chan_id, bytes(msg)))
        return True


def _relay(switch_cls, info_cls, mod_reactor, mod_mempool, mod_kv, mod_client, txs):
    async def main():
        sw = switch_cls(None, info_cls(node_id="aa" * 20, network="wire"))
        mp, _ = _app_mempool(mod_mempool, mod_kv, mod_client)
        r = sw.add_reactor("mempool", mod_reactor.AppMempoolReactor(mp))
        peers = [_Peer(c * 40) for c in "bcd"]
        for p in peers:
            sw.peers[p.peer_id] = p
        verdicts = [r.submit_local(tx).code for tx in txs[:3]]
        for tx in txs[3:]:
            r.receive(mod_reactor.MEMPOOL_CHANNEL, peers[0], tx)
        for _ in range(200):
            if sum(len(p.sent) for p in peers) >= 3 * 3 + 2 * (len(txs) - 3 - 1):
                break
            await asyncio.sleep(0.01)
        await asyncio.sleep(0.05)
        return verdicts, [p.sent for p in peers]

    return run(main())


def test_app_mempool_reactor_wire_matches_jax():
    from cometbft_tpu.p2p import tracewire as jtw

    txs = [b"local=1", jtw.MAGIC + b"=magic", b"local=1",  # a duplicate: refused, not sent
           b"relay=1", b"relay=2", b"relay=1", jtw.MAGIC + b"relay=3"]
    port = _relay(Switch, NodeInfo, preactor, pmempool, pkv, LocalClient, txs)
    jax = _relay(JSwitch, JNodeInfo, jreactor, jmempool, jkv, JLocalClient, txs)
    assert port == jax
    verdicts, sent = port
    assert verdicts == [0, 0, 1]
    # the sender of the relayed txs hears only the local submissions
    assert [m for _, m in sent[0]] == [b"local=1", sent[1][1][1]]
    assert sent[1][1][1] != txs[1]  # the magic-prefixed tx went out escaped
    assert all(c == preactor.MEMPOOL_CHANNEL for s in sent for c, _ in s)
    assert len(sent[1]) == len(sent[2]) == 2 + 3
