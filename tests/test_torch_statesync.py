"""Statesync on the port held to the JAX package's (``tests/test_statesync.py``).

- The four reference cases on port nodes (``device="cpu"``, RPC on
  ``127.0.0.1:0``): a fresh node restores an app snapshot light-verified
  against two validators' RPC, blocksyncs the tail and follows the chain,
  and the restored app proves a pre-snapshot key against the certified
  app hash; the same into adaptive sync; unreachable RPC servers stop the
  node; offline ``bootstrap_state`` seeds an empty home that then
  blocksyncs from there.
- Across packages: a port joiner restores from three JAX validators'
  snapshots (their RPC and their snapshot and chunk channels), and every
  block from its base up and every stored FinalizeBlock response equal
  the JAX sources' byte for byte, every validator set hashes alike, and
  the restored app state and the restored bytes equal the JAX app's.
"""

import asyncio

import pytest
import torch

from cometbft_tpu.config.config import test_config as jax_test_cfg
from cometbft_tpu.node.inprocess import make_genesis as jax_make_genesis
from cometbft_tpu.node.node import Node as JaxNode
from cometbft_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu_torch.abci import types as abci_t
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.models.kvstore import KVStoreApplication
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.utils import codec
from torch_hard_limit import hard_limit  # noqa: F401

N_VALS = 3


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _cfg(moniker, rpc=True):
    cfg = make_test_cfg(".")
    cfg.base.moniker = moniker
    if rpc:
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
    return cfg


async def _validators(gen, privs, app=None):
    vals = []
    for i, pv_ in enumerate(make_privvals(privs)):
        cfg = _cfg(f"val{i}")
        cfg.blocksync.enable = False
        vals.append(Node(cfg, gen, privval=pv_, app=app() if app else None, device="cpu"))
    for n in vals:
        await n.start()
    for i, a in enumerate(vals):
        for b in vals[i + 1:]:
            await a.dial(b.listen_addr)
    return vals


def _joiner_cfg(moniker, servers, trust):
    cfg = _cfg(moniker, rpc=False)
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = servers
    cfg.statesync.trust_height = 1
    cfg.statesync.trust_hash = bytes(trust.hash()).hex()
    cfg.statesync.discovery_time_s = 10.0
    cfg.blocksync.enable = True
    return cfg


async def _wait(cond, what, timeout=120.0):
    for _ in range(int(timeout / 0.05)):
        if cond():
            return
        await asyncio.sleep(0.05)
    raise AssertionError(f"timed out: {what}")


def test_statesync_bootstrap_then_follow():
    gen, privs = make_genesis(N_VALS, chain_id="ss-chain")

    async def main():
        import aiohttp

        vals = await _validators(gen, privs, app=lambda: KVStoreApplication(prove=True))
        try:
            # a tx BEFORE the first snapshot, so the restored state
            # carries a provable key
            async with aiohttp.ClientSession() as s:
                async with s.get(
                    f"http://{vals[0].rpc_server.listen_addr}/broadcast_tx_commit?tx=0x"
                    + (b"ss=snap").hex()
                ) as resp:
                    body = await resp.json()
            assert "error" not in body or not body["error"], body
            r = body.get("result") or {}
            assert r.get("check_tx", {}).get("code", 1) == 0, r
            # the key lands before the height-10 snapshot, or the proof
            # below would test ordinary blocksync replay instead
            assert int(r["height"]) < 10, r
            await _wait(lambda: vals[0].height >= 13, "height 13")

            trust = vals[0].parts.block_store.load_block(1)
            cfg = _joiner_cfg("statesyncer", [v.rpc_server.listen_addr for v in vals[:2]], trust)
            fresh = Node(cfg, gen, app=KVStoreApplication(prove=True), device="cpu")
            vals.append(fresh)
            await fresh.start()
            for v in vals[:N_VALS]:
                await fresh.dial(v.listen_addr)

            # statesync (skipping the early blocks), then follow the tip
            target = vals[0].height + 3
            await _wait(lambda: fresh.height >= target, f"the joiner at {target}")
            assert fresh.statesync_error is None
            # the early blocks were never replayed
            assert fresh.parts.block_store.base() > 1
            h = fresh.height
            assert bytes(fresh.parts.block_store.load_block(h).hash()) == bytes(
                vals[0].parts.block_store.load_block(h).hash()
            )
            # the restored app serves proofs: the pre-snapshot key proves
            # against the certified AppHash of query_height+1
            res = fresh.parts.app.query(abci_t.RequestQuery(data=b"ss", path="/store", prove=True))
            assert res.code == 0 and res.value == b"snap"
            await _wait(lambda: fresh.parts.block_store.height() >= res.height + 1, "the next header")
            want_hash = fresh.parts.block_store.load_block(res.height + 1).header.app_hash
            merkle.ProofRuntime().verify_value(
                merkle.decode_proof_ops(res.proof_ops), want_hash, b"ss", b"snap"
            )
        finally:
            for n in vals:
                await n.stop()

    run(main(), timeout=240)


def test_statesync_adaptive_handoff():
    """statesync -> adaptive blocksync: verified blocks are ingested
    straight into the freshly started consensus state machine."""
    gen, privs = make_genesis(N_VALS, chain_id="ssa-chain")

    async def main():
        vals = await _validators(gen, privs)
        try:
            await _wait(lambda: vals[0].height >= 13, "height 13")
            trust = vals[0].parts.block_store.load_block(1)
            cfg = _joiner_cfg("adaptive-ss", [vals[0].rpc_server.listen_addr], trust)
            cfg.blocksync.adaptive_sync = True
            fresh = Node(cfg, gen, device="cpu")
            vals.append(fresh)
            await fresh.start()
            for v in vals[:N_VALS]:
                await fresh.dial(v.listen_addr)
            target = vals[0].height + 3
            await _wait(lambda: fresh.height >= target, f"the joiner at {target}")
            assert fresh._cs_started  # consensus was live during the sync
            assert fresh.parts.block_store.base() > 1
        finally:
            for n in vals:
                await n.stop()

    run(main())


def test_statesync_failure_is_fatal():
    """Unreachable RPC servers: the node stops, it does not idle."""
    gen, _ = make_genesis(1, chain_id="ssf-chain")

    async def main():
        cfg = _cfg("ssf", rpc=False)
        cfg.statesync.enable = True
        cfg.statesync.rpc_servers = ["127.0.0.1:1"]  # nothing there
        cfg.statesync.trust_height = 1
        cfg.statesync.trust_hash = "ab" * 32
        cfg.statesync.discovery_time_s = 1.0
        node = Node(cfg, gen, device="cpu")
        await node.start()
        await _wait(lambda: node.statesync_error is not None, "the statesync error", timeout=20)
        assert not node._cs_started
        await node.stop()

    run(main())


def test_bootstrap_state_offline(tmp_path):
    """Offline statesync (reference node.BootstrapState): seed an empty
    home's stores with light-verified state, then start the node and
    watch it blocksync from that height instead of genesis."""
    from cometbft_tpu_torch.node.bootstrap import bootstrap_state

    gen, privs = make_genesis(N_VALS, chain_id="bs-chain")

    async def main():
        vals = await _validators(gen, privs)
        try:
            await _wait(lambda: vals[0].height >= 8, "height 8")
            trust = vals[0].parts.block_store.load_block(1)
            cfg = make_test_cfg(str(tmp_path))
            cfg.base.db_backend = "sqlite"  # persists across processes
            cfg.base.moniker = "bootstrapped"
            cfg.statesync.rpc_servers = [vals[0].rpc_server.listen_addr]
            cfg.statesync.trust_height = 1
            cfg.statesync.trust_hash = bytes(trust.hash()).hex()
            target_h = 5
            h = await asyncio.to_thread(bootstrap_state, cfg, gen, str(tmp_path), target_h, "cpu")
            assert h == target_h
            # again, over the now-populated store: refused
            with pytest.raises(RuntimeError, match="refusing"):
                await asyncio.to_thread(bootstrap_state, cfg, gen, str(tmp_path), target_h, "cpu")

            cfg2 = make_test_cfg(str(tmp_path))
            cfg2.base.db_backend = "sqlite"
            cfg2.blocksync.enable = True
            node = Node(cfg2, gen, home=str(tmp_path), device="cpu")
            vals.append(node)
            await node.start()
            for v in vals[:N_VALS]:
                await node.dial(v.listen_addr)
            target = vals[0].height + 2
            await _wait(lambda: node.height >= target, f"the bootstrapped node at {target}")
            # blocks before the bootstrap height were never fetched
            assert node.parts.block_store.load_block(2) is None
        finally:
            for n in vals:
                await n.stop()

    run(main())


def test_port_joiner_restores_from_jax_sources():
    """A port joiner statesyncs from three JAX validators: the snapshot
    and chunk codec, the RPC the state provider reads and the stores
    it bootstraps agree byte for byte across the packages."""
    jgen, jpvs = jax_make_genesis(N_VALS, chain_id="ss-mixed")
    gen = GenesisDoc.from_json(jgen.to_json())
    assert isinstance(jgen, JaxGenesisDoc)

    async def main():
        srcs = []
        for i, p in enumerate(jpvs):
            cfg = jax_test_cfg(".")
            cfg.base.moniker = f"jval{i}"
            cfg.p2p.pex = False  # the port has no PEX channel
            cfg.blocksync.enable = False
            srcs.append(JaxNode(cfg, jgen, privval=p))
        joiner = None
        try:
            for n in srcs:
                await n.start()
            for i, a in enumerate(srcs):
                for b in srcs[i + 1:]:
                    await a.dial(b.listen_addr)
            # txs before the first snapshot: the snapshot carries state
            for i in range(40):
                srcs[0].parts.mempool.check_tx(b"mk%d=v%d" % (i, i))
            await _wait(lambda: srcs[0].height >= 23, "height 23")
            assert len(srcs[0].parts.app.state) == 40
            trust = srcs[0].parts.block_store.load_block(1)
            cfg = _joiner_cfg("port-joiner", [s.rpc_server.listen_addr for s in srcs[:2]], trust)
            joiner = Node(cfg, gen, device="cpu")
            await joiner.start()
            for s in srcs:
                await joiner.dial(s.listen_addr)
            target = srcs[0].height + 2
            await _wait(lambda: joiner.height >= target, f"the joiner at {target}")
            assert joiner.statesync_error is None
            syncer = joiner.statesync_reactor.syncer
            snap_h = syncer.last_sync["height"]
            assert snap_h >= 20 and snap_h % 10 == 0
            bs, ss = joiner.parts.block_store, joiner.parts.state_store
            jbs, jss = srcs[0].parts.block_store, srcs[0].parts.state_store
            assert bs.base() == snap_h + 1
            top = min(joiner.height, srcs[0].height)
            for h in range(snap_h + 1, top + 1):
                assert codec.encode_block(bs.load_block(h)) == jcodec.encode_block(jbs.load_block(h)), h
                assert bs.load_block_meta(h).encode() == jbs.load_block_meta(h).encode(), h
                assert ss.load_finalize_block_response(h) == jss.load_finalize_block_response(h), h
                # the set's hash: the source's pointer records rebuild
                # proposer priorities by increments (state/store.py)
                assert ss.load_validators(h).hash() == jss.load_validators(h).hash(), h
            # the restored app: the JAX snapshot's blob, then the tail
            japp = srcs[0].parts.app
            blob = b"".join(
                japp.load_snapshot_chunk(snap_h, 1, i) for i in range(syncer.last_sync["chunks"])
            )
            assert syncer.last_sync["bytes"] == len(blob)
            assert joiner.parts.app.state == japp.state
            assert joiner.parts.app.height == joiner.height
            assert bs.load_block(top).header.app_hash == jbs.load_block(top).header.app_hash
        finally:
            nodes = srcs + ([joiner] if joiner is not None else [])
            for n in nodes:
                await n.stop()

    run(main(), timeout=240)
