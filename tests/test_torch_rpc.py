"""The port's RPC server, routes and client held to the JAX package's
(``tests/test_rpc.py`` and ``tests/test_rpc_contract.py``), and the two
packages' RPC held to each other.

- The reference cases run on a one-validator node of each package
  (``device="cpu"`` for the port's): status, block, commit, validators,
  ``broadcast_tx_commit`` and ``tx``/``tx_search`` with proofs,
  ``abci_query``, a websocket subscription, the serving role and the
  fleet route's error, the other routes, and the unsafe routes.
  Departure named in the health case: the port has no loop watchdog
  (ROADMAP A10), so its ``health`` carries no loop-lag fields, as the
  JAX route does when its watchdog is off.
- The route table matches ``docs/openapi.yaml`` and every documented
  route answers on a port node.
- One chain (built by the port, on sqlite) served by a JAX node and a
  port node: every route of ``ROUTES`` answers with equal JSON, apart
  from the node-specific fields ``NODE_SPECIFIC`` names; the JAX
  package's ``HTTPClient`` and ``HTTPProvider`` read the port node as
  they read the JAX node, and the port's read the JAX node; a JAX
  websocket subscriber follows a port validator's blocks.
"""

import asyncio
import base64
import copy
import hashlib
import os
import shutil

import aiohttp
import pytest
import torch
import yaml

from cometbft_tpu.config.config import test_config as jax_test_cfg
from cometbft_tpu.light.http_provider import HTTPProvider as JaxHTTPProvider
from cometbft_tpu.node.inprocess import make_genesis as jax_make_genesis
from cometbft_tpu.node.node import Node as JaxNode
from cometbft_tpu.rpc import client as jclient
from cometbft_tpu.rpc import core as jcore
from cometbft_tpu.types.genesis import GenesisDoc as JaxGenesisDoc
from cometbft_tpu_torch.config.config import test_config as port_test_cfg
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.light.http_provider import HTTPProvider as PortHTTPProvider
from cometbft_tpu_torch.node.inprocess import build_node
from cometbft_tpu_torch.node.inprocess import make_genesis as port_make_genesis
from cometbft_tpu_torch.node.inprocess import make_privvals
from cometbft_tpu_torch.node.node import Node as PortNode
from cometbft_tpu_torch.rpc import client as pclient
from cometbft_tpu_torch.rpc import core as pcore
from cometbft_tpu_torch.types.block import tx_hash
from cometbft_tpu_torch.utils.chaingen import make_chain
from torch_hard_limit import hard_limit  # noqa: F401

WS_ONLY = {"subscribe", "unsubscribe"}


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


async def single_node(pkg, tmp_path, chain_id="rpc-chain"):
    """A one-validator node of ``pkg`` serving RPC, at height 2 or
    more, and an HTTPClient of the same package."""
    if pkg == "jax":
        gen, pvs = jax_make_genesis(1, chain_id=chain_id)
        node = JaxNode(jax_test_cfg("."), gen, privval=pvs[0])
        client = jclient
    else:
        gen, privs = port_make_genesis(1, chain_id=chain_id)
        cfg = port_test_cfg(".")
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        node = PortNode(cfg, gen, privval=make_privvals(privs, root=str(tmp_path))[0], device="cpu")
        client = pclient
    await node.start()
    while node.height < 2:
        await asyncio.sleep(0.05)
    return node, client.HTTPClient(node.rpc_server.listen_addr), client.RPCClientError


PKGS = ["jax", "port"]


@pytest.mark.parametrize("pkg", PKGS)
def test_status_block_commit_validators(pkg, tmp_path):
    async def main():
        node, cli, err = await single_node(pkg, tmp_path)
        st = await cli.status()
        assert st["node_info"]["network"] == "rpc-chain"
        assert int(st["sync_info"]["latest_block_height"]) >= 2
        blk = await cli.block_decoded(1)
        assert blk.height == 1 and bytes(blk.hash()) == bytes(node.parts.block_store.load_block(1).hash())
        hdr, cm = await cli.commit_decoded(1)
        assert cm.height == 1 and hdr.height == 1
        vs = await cli.validators_decoded(1)
        assert vs.size() == 1 and bytes(vs.hash()) == bytes(node.parts.state_store.load_validators(1).hash())
        with pytest.raises(err):
            await cli.block(10_000)
        await cli.close()
        await node.stop()

    run(main())


@pytest.mark.parametrize("pkg", PKGS)
def test_broadcast_tx_commit_and_tx_query(pkg, tmp_path):
    async def main():
        node, cli, _ = await single_node(pkg, tmp_path)
        tx = b"rpckey=rpcval"
        res = await cli.broadcast_tx_commit(tx)
        assert res["check_tx"]["code"] == 0 and res["tx_result"]["code"] == 0
        height = int(res["height"])
        assert height >= 1
        txr = await cli.call("tx", hash=hashlib.sha256(tx).hexdigest())
        assert int(txr["height"]) == height and base64.b64decode(txr["tx"]) == tx
        sr = await cli.call("tx_search", query=f"tx.height={height}", prove=True)
        assert int(sr["total_count"]) >= 1
        hit = next(t for t in sr["txs"] if base64.b64decode(t["tx"]) == tx)
        proof = merkle.decode_proof(base64.b64decode(hit["proof"]["proof_b64"]))
        assert proof.verify(bytes.fromhex(hit["proof"]["root_hash"]), tx_hash(tx))
        q = await cli.abci_query("/store", b"rpckey")
        assert base64.b64decode(q["response"]["value"] or "") == b"rpcval"
        await cli.close()
        await node.stop()

    run(main())


@pytest.mark.parametrize("pkg", PKGS)
def test_ws_subscription_new_block(pkg, tmp_path):
    async def main():
        node, cli, _ = await single_node(pkg, tmp_path)
        got = []
        async for e in await cli.subscribe("tm.event='NewBlock'"):
            got.append(e)
            if len(got) >= 2:
                break
        assert all(e["data"]["type"] == "tendermint/event/NewBlock" for e in got)
        heights = [int(e["data"]["value"]["block"]["header"]["height"]) for e in got]
        assert heights[1] == heights[0] + 1
        await cli.close()
        await node.stop()

    run(main())


@pytest.mark.parametrize("pkg", PKGS)
def test_serving_role(pkg, tmp_path):
    """The role half of the reference's serving-role case: a node with
    a signer is a validator with no replica lag, and the fleet route
    answers a clean JSON-RPC error."""

    async def main():
        node, cli, err = await single_node(pkg, tmp_path)
        st = await cli.status()
        assert st["serving_role"] == "validator" and st["replica_lag_heights"] == "0"
        h = await cli.call("health")
        assert h["serving_role"] == "validator" and h["replica_lag_heights"] == 0
        assert "fleet" not in h
        with pytest.raises(err, match="serving fleet"):
            await cli.call("fleet_status")
        await cli.close()
        await node.stop()

    run(main())


@pytest.mark.parametrize("pkg", PKGS)
def test_misc_routes(pkg, tmp_path):
    async def main():
        node, cli, err = await single_node(pkg, tmp_path)
        h = await cli.call("health")
        assert h["status"] in ("ok", "degraded")
        # the JAX node's loop watchdog; the port has none (ROADMAP A10)
        assert ("loop_lag_ms" in h) == (pkg == "jax")
        assert "queue_high_watermarks" in h and int(h["latest_block_height"]) >= 1
        bd = h["last_height_commit_breakdown"]
        assert bd["height"] >= 1 and bd["dominant"] in bd["phases"]
        assert {"persist_ms", "wal_ms", "apply_ms", "total_ms"} <= set(bd["phases"])
        assert all(v >= 0 for v in bd["phases"].values())
        dt = await cli.call("dump_tasks")
        assert int(dt["n_tasks"]) >= 1 and any(t["stack"] for t in dt["tasks"])
        assert (await cli.call("genesis"))["genesis"]["chain_id"] == "rpc-chain"
        assert (await cli.call("net_info"))["n_peers"] == "0"
        bc = await cli.call("blockchain", minHeight="1", maxHeight="2")
        assert len(bc["block_metas"]) == 2
        cp = await cli.call("consensus_params")
        assert int(cp["consensus_params"]["block"]["max_bytes"]) > 0
        assert int((await cli.call("consensus_state"))["round_state"]["height"]) >= 1
        assert int((await cli.call("abci_info"))["response"]["last_block_height"]) >= 1
        assert "n_txs" in await cli.call("num_unconfirmed_txs")
        with pytest.raises(err):
            await cli.call("nonexistent_route")
        await cli.close()
        await node.stop()

    run(main())


@pytest.mark.parametrize("pkg", PKGS)
def test_unsafe_routes_gated_and_functional(pkg, tmp_path):
    async def main():
        node, cli, err = await single_node(pkg, tmp_path)
        with pytest.raises(err, match="not found"):
            await cli.call("unsafe_flush_mempool")
        node.config.rpc.unsafe = True
        await cli.call("broadcast_tx_sync", tx="0x" + b"u=1".hex())
        n0 = int((await cli.call("num_unconfirmed_txs")).get("total", "0"))
        await cli.call("unsafe_flush_mempool")
        n1 = int((await cli.call("num_unconfirmed_txs")).get("total", "0"))
        assert n1 == 0 <= n0
        assert "disconnected" in (await cli.call("unsafe_disconnect_peers"))["log"]
        assert "dialing" in (await cli.call("dial_peers", peers=[]))["log"]
        await cli.close()
        await node.stop()

    run(main())


# --- the route table against docs/openapi.yaml -------------------------


def _spec_methods():
    path = os.path.join(os.path.dirname(__file__), "..", "docs", "openapi.yaml")
    with open(path) as f:
        return {p.lstrip("/") for p in yaml.safe_load(f)["paths"]}


def test_route_tables_are_the_jax_packages():
    assert set(pcore.ROUTES) == set(jcore.ROUTES)
    assert set(pcore.UNSAFE_ROUTES) == set(jcore.UNSAFE_ROUTES)


def test_every_route_is_documented():
    missing = set(pcore.ROUTES) - _spec_methods()
    assert not missing, f"routes missing from openapi.yaml: {missing}"


def test_every_documented_method_exists():
    phantom = _spec_methods() - set(pcore.ROUTES) - WS_ONLY
    assert not phantom, f"openapi.yaml documents unknown methods: {phantom}"


def test_documented_methods_respond(tmp_path):
    async def main():
        node, cli, _ = await single_node("port", tmp_path, chain_id="contract-chain")
        base = f"http://{node.rpc_server.listen_addr}"
        results = {}
        try:
            async with aiohttp.ClientSession() as sess:
                for m in sorted(_spec_methods() - WS_ONLY):
                    async with sess.get(f"{base}/{m}") as r:
                        body = await r.json()
                        results[m] = (r.status, "result" in body or "error" in body)
        finally:
            await cli.close()
            await node.stop()
        return results

    results = run(main())
    bad = {m: r for m, r in results.items() if r[0] != 200 or not r[1]}
    assert not bad, f"endpoints violating the contract: {bad}"


# --- one chain, served by a JAX node and a port node ---------------------

# fields that describe the node serving, not the chain: its identity,
# listen addresses, its loop, queue and connectivity planes, how far
# its consensus got in the wall-clock time the test took, and the
# asyncio tasks it runs
NODE_SPECIFIC = {
    "health": ("loop_lag_ms", "loop_stalls", "last_commit_age_s", "queue_high_watermarks",
               "queue_dropped_total", "connectivity", "last_height_commit_breakdown", "reasons",
               "status"),
    "status": ("node_info",),
    "net_info": ("listeners",),
    "dump_tasks": ("n_tasks", "tasks"),
}

CHAIN_HEIGHTS = 6


def _chain_home(tmp_path):
    """A 6-height port chain (one tx a block) on sqlite, its genesis
    and two copies of its home."""
    gen, privs = port_make_genesis(2, chain_id="same-chain")
    src_home = str(tmp_path / "src")
    src = build_node(gen, db_backend="sqlite", home=src_home, device="cpu")
    make_chain(gen, privs, CHAIN_HEIGHTS, node=src)
    src.close_stores()
    homes = []
    for name in ("jax", "port"):
        h = str(tmp_path / name)
        shutil.copytree(src_home, h)
        homes.append(h)
    return gen, homes


async def _serve_chain(gen, homes):
    """A JAX node and a port node (no signer, blocksync waiting for
    peers) over copies of one chain, both serving RPC."""
    jcfg = jax_test_cfg(homes[0])
    jcfg.base.db_backend = "sqlite"
    jnode = JaxNode(jcfg, JaxGenesisDoc.from_json(gen.to_json()), home=homes[0])
    pcfg = port_test_cfg(homes[1])
    pcfg.base.db_backend = "sqlite"
    pcfg.rpc.laddr = "tcp://127.0.0.1:0"
    pnode = PortNode(pcfg, gen, home=homes[1], device="cpu")
    for n in (jnode, pnode):
        await n.start()
    return jnode, pnode


def _route_params(txs):
    """Parameters for each route, the same for both nodes."""
    h = "3"
    tx = txs[2]
    return {
        "genesis_chunked": {"chunk": "0"},
        "blockchain": {"minHeight": "1", "maxHeight": str(CHAIN_HEIGHTS)},
        "block": {"height": h}, "header": {"height": h}, "commit": {"height": h},
        "block_results": {"height": h}, "validators": {"height": h}, "consensus_params": {"height": h},
        "unconfirmed_txs": {"limit": "5"},
        "check_tx": {"tx": "0x" + b"k=v".hex()},
        "broadcast_tx_async": {"tx": "0x" + b"no-separator".hex()},
        "broadcast_tx_sync": {"tx": "0x" + b"no-separator".hex()},
        "broadcast_tx_commit": {"tx": "0x" + b"no-separator".hex()},
        "broadcast_evidence": {"evidence": "0x00"},
        "abci_query": {"path": "/store", "data": "0x" + tx.split(b"=")[0].hex()},
        "tx": {"hash": hashlib.sha256(tx).hexdigest(), "prove": "true"},
        "tx_search": {"query": f"tx.height={h}", "prove": "true"},
        "block_search": {"query": "block.height>2"},
    }


async def _answer(cli, route, params, err):
    try:
        return {"result": await cli.call(route, **params)}
    except err as e:
        return {"error": [e.code, e.message, e.data]}


def _strip(route, answer):
    answer = copy.deepcopy(answer)
    res = answer.get("result")
    for field in NODE_SPECIFIC.get(route, ()):
        if isinstance(res, dict):
            res.pop(field, None)
    return answer


def test_every_route_answers_alike_on_the_same_chain(tmp_path):
    gen, homes = _chain_home(tmp_path)

    async def main():
        jnode, pnode = await _serve_chain(gen, homes)
        jc = jclient.HTTPClient(jnode.rpc_server.listen_addr)
        pc = pclient.HTTPClient(pnode.rpc_server.listen_addr)
        try:
            txs = [pnode.parts.block_store.load_block(h).data.txs[0] for h in range(1, CHAIN_HEIGHTS + 1)]
            # by-hash routes: the hash of block 3, the same in both stores
            params = _route_params(txs)
            bh = pnode.parts.block_store.load_block_meta(3).block_id.hash.hex()
            params["block_by_hash"] = params["header_by_hash"] = {"hash": bh}
            out = {}
            for route in sorted(pcore.ROUTES):
                p = params.get(route, {})
                out[route] = (await _answer(jc, route, p, jclient.RPCClientError),
                              await _answer(pc, route, p, pclient.RPCClientError))
            return out
        finally:
            await jc.close()
            await pc.close()
            await jnode.stop()
            await pnode.stop()

    out = run(main())
    assert set(out) == set(jcore.ROUTES)
    differ = {r: (j, p) for r, (j, p) in out.items() if _strip(r, j) != _strip(r, p)}
    assert not differ, differ
    # the answers are real: the block route served the chain's block
    assert "result" in out["block"][1] and out["tx"][1]["result"]["proof"]


def test_jax_clients_read_a_port_node_and_port_clients_a_jax_node(tmp_path):
    gen, homes = _chain_home(tmp_path)

    async def main():
        jnode, pnode = await _serve_chain(gen, homes)
        got = {}
        try:
            for reader, node, client in (("jax-on-port", pnode, jclient), ("port-on-jax", jnode, pclient)):
                cli = client.HTTPClient(node.rpc_server.listen_addr)
                try:
                    blk = await cli.block_decoded(4)
                    hdr, cm = await cli.commit_decoded(4)
                    vs = await cli.validators_decoded(4)
                    q = await cli.abci_query("/store", b"h4_0")
                    got[reader] = (bytes(blk.hash()), bytes(hdr.hash()), bytes(cm.block_id.hash),
                                   bytes(vs.hash()), q["response"]["value"])
                finally:
                    await cli.close()
            providers = (("jax-on-port", JaxHTTPProvider, pnode), ("port-on-jax", PortHTTPProvider, jnode))
            for reader, Provider, node in providers:
                prov = Provider(gen.chain_id, node.rpc_server.listen_addr)
                try:
                    lb = await asyncio.to_thread(prov.light_block, 5)
                    got[reader + "-provider"] = (bytes(lb.hash()), bytes(lb.validator_set.hash()),
                                                 bytes(lb.commit.block_id.hash))
                finally:
                    await asyncio.to_thread(prov.close)
            return got, bytes(pnode.parts.block_store.load_block(4).hash()), \
                bytes(pnode.parts.block_store.load_block(5).hash())
        finally:
            await jnode.stop()
            await pnode.stop()

    got, h4, h5 = run(main())
    assert got["jax-on-port"] == got["port-on-jax"] and got["jax-on-port"][0] == h4
    assert got["jax-on-port"][4] == base64.b64encode(b"v4").decode()
    assert got["jax-on-port-provider"] == got["port-on-jax-provider"]
    assert got["jax-on-port-provider"][0] == h5


def test_jax_websocket_subscriber_follows_a_port_validator(tmp_path):
    async def main():
        node, pcli, _ = await single_node("port", tmp_path)
        jcli = jclient.HTTPClient(node.rpc_server.listen_addr)
        try:
            got = []
            async for e in await jcli.subscribe("tm.event='NewBlock'"):
                got.append(e)
                if len(got) >= 3:
                    break
            heights = [int(e["data"]["value"]["block"]["header"]["height"]) for e in got]
            assert heights == list(range(heights[0], heights[0] + 3))
            for e, h in zip(got, heights):
                blk = node.parts.block_store.load_block(h)
                assert e["data"]["value"]["block"]["header"]["app_hash"] == blk.header.app_hash.hex().upper()
                assert e["query"] == "tm.event='NewBlock'" and e["events"]["tm.event"] == ["NewBlock"]
        finally:
            await jcli.close()
            await pcli.close()
            await node.stop()

    run(main())
