"""The port's proof operators, provable kvstore and verifying light
proxy held to the JAX package's (``tests/test_light_proxy_proofs.py``'s
four cases that need no CLI, ``tests/test_light_http.py``), and the
proof-op runtime held to the JAX one.

- The proof-op units run on both packages' kvstore (``prove=True``) and
  ``crypto/merkle``: the same state gives byte-identical app hashes and
  proof ops, each package's runtime accepts the other's proofs, and
  both refuse the same tampering and out-of-range indices; seeded
  random bytes decode and verify alike.
- The proxy case runs the reference's fourteen checks on a port proxy
  over two port nodes (``device="cpu"``), a tampering primary included.
- The HTTP light client case runs the port's Client and HTTPProvider
  against port nodes and against JAX nodes.
"""

import asyncio
import base64

import aiohttp
import numpy as np
import pytest
import torch

from cometbft_tpu.abci import types as jabci
from cometbft_tpu.config.config import test_config as jax_test_cfg
from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.models.kvstore import KVStoreApplication as JaxKV
from cometbft_tpu.node.inprocess import make_genesis as jax_make_genesis
from cometbft_tpu.node.node import Node as JaxNode
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.config.config import test_config as port_test_cfg
from cometbft_tpu_torch.crypto import merkle as pmerkle
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.light import Client, TrustOptions
from cometbft_tpu_torch.light.http_provider import HTTPProvider
from cometbft_tpu_torch.light.proxy import LightProxy
from cometbft_tpu_torch.models.kvstore import KVStoreApplication as PortKV
from cometbft_tpu_torch.node.inprocess import make_genesis as port_make_genesis
from cometbft_tpu_torch.node.inprocess import make_privvals
from cometbft_tpu_torch.node.node import Node as PortNode
from cometbft_tpu_torch.state.state_types import ConsensusParams
from torch_hard_limit import hard_limit  # noqa: F401

PKGS = {"jax": (JaxKV, jabci, jmerkle), "port": (PortKV, pabci, pmerkle)}


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


def rehash(app, KV):
    """The app hash of the app's state (the port's kvstore has no
    ``_compute_hash``)."""
    return app._hash_state(app.height, app.state) if KV is PortKV else app._compute_hash()


def proved_app(KV):
    app = KV(prove=True)
    app.height = 7
    app.state = {b"a": b"1", b"c": b"3", b"e": b"5"}
    app.app_hash = rehash(app, KV)
    return app


def ops_of(app, abci, merkle, key):
    res = app.query(abci.RequestQuery(data=key, path="/store", prove=True))
    return merkle.decode_proof_ops(res.proof_ops), res


def both(case):
    got = {name: case(*mods) for name, mods in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


# --- proof-op runtime units --------------------------------------------


def test_value_and_absence_proofs_roundtrip():
    def case(KV, abci, merkle):
        app = proved_app(KV)
        rt = merkle.ProofRuntime()
        seen = [app.app_hash]
        ops, res = ops_of(app, abci, merkle, b"c")
        assert res.value == b"3"
        rt.verify_value(ops, app.app_hash, b"c", b"3")
        seen.append(merkle.encode_proof_ops(ops))
        new_state = dict(app.state)
        new_state[b"d"] = b""
        app.state, app.height = new_state, 8
        app.app_hash = rehash(app, KV)
        ops, res = ops_of(app, abci, merkle, b"d")
        assert res.code == 0 and res.value == b""
        rt.verify_value(ops, app.app_hash, b"d", b"")
        seen += [app.app_hash, merkle.encode_proof_ops(ops)]
        for k in (b"b", b"0", b"zz"):
            ops, res = ops_of(app, abci, merkle, k)
            assert res.code != 0
            rt.verify_absence(ops, app.app_hash, k)
            seen.append(merkle.encode_proof_ops(ops))
        empty = KV(prove=True)
        empty.height = 1
        empty.app_hash = rehash(empty, KV)
        ops, _ = ops_of(empty, abci, merkle, b"x")
        rt.verify_absence(ops, empty.app_hash, b"x")
        seen += [empty.app_hash, merkle.encode_proof_ops(ops)]
        return seen

    both(case)


def test_tampered_proofs_rejected():
    def case(KV, abci, merkle):
        app = proved_app(KV)
        rt = merkle.ProofRuntime()
        errs = []
        ops, _ = ops_of(app, abci, merkle, b"c")
        for args in ((ops, app.app_hash, b"c", b"4"), (ops, b"\x00" * 32, b"c", b"3")):
            with pytest.raises(merkle.ProofError) as e:
                rt.verify_value(*args)
            errs.append(str(e.value))
        ops, _ = ops_of(app, abci, merkle, b"b")
        ops[0].key = b"c"
        with pytest.raises(merkle.ProofError) as e:
            rt.verify_absence(ops, app.app_hash, b"c")
        errs.append(str(e.value))
        ops, _ = ops_of(app, abci, merkle, b"a")
        p = merkle.decode_proof(ops[0].data)
        p.aunts[0] = bytes(32)
        ops[0].data = merkle.encode_proof(p)
        with pytest.raises(merkle.ProofError) as e:
            rt.verify_value(ops, app.app_hash, b"a", b"1")
        errs.append(str(e.value))
        return errs

    both(case)


def test_out_of_bounds_proof_indices_rejected():
    def case(KV, abci, merkle):
        app = proved_app(KV)
        rt = merkle.ProofRuntime()

        def mutate(key, index=None, total=None):
            ops, _ = ops_of(app, abci, merkle, key)
            p = merkle.decode_proof(ops[0].data)
            if index is not None:
                p.index = index
            if total is not None:
                p.total = total
            ops[0].data = merkle.encode_proof(p)
            return ops

        errs = []
        for idx, tot in ((5, 3), (3, 3), (2, 0), (2, -1)):
            with pytest.raises(merkle.ProofError) as e:
                rt.verify_value(mutate(b"e", index=idx, total=tot), app.app_hash, b"e", b"5")
            errs.append(str(e.value))
        with pytest.raises(merkle.ProofError) as e:
            rt.verify_value(mutate(b"a", index=-1), app.app_hash, b"a", b"1")
        errs.append(str(e.value))
        ops, _ = ops_of(app, abci, merkle, b"e")
        rt.verify_value(ops, app.app_hash, b"e", b"5")
        return errs

    both(case)


def test_each_runtime_accepts_the_other_packages_proofs():
    japp, papp = proved_app(JaxKV), proved_app(PortKV)
    assert japp.app_hash == papp.app_hash
    for key in (b"a", b"c", b"e", b"b", b"0", b"zz"):
        jres = japp.query(jabci.RequestQuery(data=key, path="/store", prove=True))
        pres = papp.query(pabci.RequestQuery(data=key, path="/store", prove=True))
        assert (jres.code, jres.value, jres.proof_ops) == (pres.code, pres.value, pres.proof_ops)
        for merkle, raw in ((jmerkle, pres.proof_ops), (pmerkle, jres.proof_ops)):
            ops = merkle.decode_proof_ops(raw)
            if pres.code == 0:
                merkle.ProofRuntime().verify_value(ops, japp.app_hash, key, pres.value)
            else:
                merkle.ProofRuntime().verify_absence(ops, japp.app_hash, key)


def test_seeded_garbage_proof_ops_decode_and_verify_alike():
    """Adversarial proof-op bytes (a peer's) give the same outcome in
    both packages: the same ops, or the same refusal."""
    rng = np.random.default_rng(4242)
    app = proved_app(PortKV)
    good = app.query(pabci.RequestQuery(data=b"c", path="/store", prove=True)).proof_ops

    def outcome(merkle, raw):
        try:
            ops = merkle.decode_proof_ops(raw)
        except Exception as e:
            return "decode", type(e).__name__
        try:
            merkle.ProofRuntime().verify_value(ops, app.app_hash, b"c", b"3")
            return "verified", None
        except Exception as e:
            return "refused", type(e).__name__, str(e)

    samples = [bytes(rng.bytes(int(rng.integers(0, 64)))) for _ in range(150)]
    for i in range(50):  # single-byte corruptions of a genuine chain
        b = bytearray(good)
        b[int(rng.integers(0, len(b)))] ^= 1 << int(rng.integers(0, 8))
        samples.append(bytes(b))
    samples.append(good)
    results = [(outcome(jmerkle, s), outcome(pmerkle, s)) for s in samples]
    assert all(j == p for j, p in results)
    assert results[-1][1] == ("verified", None)


# --- the proxy over a live port net --------------------------------------


class TamperingPrimary:
    """Wraps the proxy's HTTPClient; corrupts selected responses the
    way a byzantine full node would."""

    def __init__(self, real):
        self._real = real
        self.mode = None

    async def call(self, method, **params):
        if method == "abci_query" and self.mode == "substitute":
            return await self._real.call(method, **dict(params, data="0x" + b"other".hex()))
        res = await self._real.call(method, **params)
        if method == "abci_query" and self.mode == "value":
            res["response"]["value"] = base64.b64encode(b"forged").decode()
        if method == "abci_query" and self.mode == "absence":
            res["response"]["code"] = 1
            res["response"]["value"] = ""
        if method == "tx" and self.mode == "tx":
            res["tx"] = base64.b64encode(b"forged-tx=1").decode()
        if method == "tx" and self.mode == "txheight":
            res["height"] = "0"
        if method == "block_results" and self.mode == "results":
            for tr in res.get("txs_results") or []:
                tr["gas_used"] = str(int(tr.get("gas_used") or 0) + 7)
        if method == "consensus_params" and self.mode == "params":
            cp = ConsensusParams.decode(base64.b64decode(res["params_b64"]))
            cp.block.max_bytes += 1
            res["params_b64"] = base64.b64encode(cp.encode()).decode()
        if method == "consensus_params" and self.mode == "params_dict":
            res["consensus_params"]["block"]["max_bytes"] = "1"
        return res

    def __getattr__(self, name):
        return getattr(self._real, name)


def _port_net(tmp_path, n, chain_id, node_kw):
    """n port validators serving RPC; ``node_kw()`` gives each its
    extra constructor arguments."""
    gen, privs = port_make_genesis(n, chain_id=chain_id)
    pvs = make_privvals(privs, root=str(tmp_path))
    nodes = []
    for pv_ in pvs:
        cfg = port_test_cfg(".")
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        nodes.append(PortNode(cfg, gen, privval=pv_, device="cpu", **node_kw()))
    return gen, nodes


def test_proxy_verifies_queries_and_rejects_tampering(tmp_path):
    async def main():
        gen, (n0, n1) = _port_net(tmp_path, 2, "lproxy-prove", lambda: {"app": PortKV(prove=True)})
        await n0.start()
        await n1.start()
        await n0.dial(n1.listen_addr)
        async with aiohttp.ClientSession() as s:
            for txb in (b"foo=bar", b"other=val"):
                url = f"http://{n0.rpc_server.listen_addr}/broadcast_tx_commit?tx=0x" + txb.hex()
                async with s.get(url) as resp:
                    body = await resp.json()
        tx_height = int(body["result"]["height"])
        tx_hash_hex = body["result"]["hash"]
        while n0.height < tx_height + 2:
            await asyncio.sleep(0.05)
        trust = n0.parts.block_store.load_block(1)
        provider = HTTPProvider("lproxy-prove", n0.rpc_server.listen_addr)
        lc = await asyncio.to_thread(Client, "lproxy-prove",
                                     TrustOptions(period_ns=3600 * 10**9, height=1, hash=trust.hash()),
                                     provider, device="cpu")
        proxy = LightProxy(lc, n0.rpc_server.listen_addr)
        tamper = TamperingPrimary(proxy.primary)
        proxy.primary = tamper
        await proxy.start("127.0.0.1:0")

        async def get(path):
            async with aiohttp.ClientSession() as s:
                async with s.get(f"http://{proxy.listen_addr}{path}") as resp:
                    return await resp.json()

        def refused(body):
            assert "error" in body and body["error"], body

        try:
            body = await get('/abci_query?path="/store"&data=0x' + b"foo".hex())
            r = body.get("result") or pytest.fail(str(body))
            assert r["verified"] is True and base64.b64decode(r["response"]["value"]) == b"bar"
            body = await get('/abci_query?path="/store"&data=0x' + b"nope".hex())
            assert body["result"]["verified"] is True and int(body["result"]["response"]["code"]) != 0
            for mode in ("value", "absence", "substitute"):
                tamper.mode = mode
                refused(await get('/abci_query?path="/store"&data=0x' + b"foo".hex()))
            tamper.mode = None
            assert (await get(f"/tx?hash={tx_hash_hex}"))["result"]["verified"] is True
            tamper.mode = "tx"
            refused(await get(f"/tx?hash={tx_hash_hex}"))
            tamper.mode = None
            refused(await get("/tx"))
            tamper.mode = "txheight"
            refused(await get(f"/tx?hash={tx_hash_hex}"))
            tamper.mode = None
            r = (await get(f"/block_results?height={tx_height}")).get("result") or pytest.fail("block_results")
            assert r["verified"] is True and len(r["txs_results"]) >= 1
            tamper.mode = "results"
            refused(await get(f"/block_results?height={tx_height}"))
            tamper.mode = None
            assert (await get("/block_results"))["result"]["verified"] is True
            assert (await get(f"/consensus_params?height={tx_height}"))["result"]["verified"] is True
            tamper.mode = "params"
            refused(await get(f"/consensus_params?height={tx_height}"))
            tamper.mode = "params_dict"
            r = (await get(f"/consensus_params?height={tx_height}"))["result"]
            assert r["verified"] is True and int(r["consensus_params"]["block"]["max_bytes"]) != 1
        finally:
            await proxy.stop()
            await asyncio.to_thread(provider.close)
            await n0.stop()
            await n1.stop()

    run(main())


# --- the light client over HTTP ------------------------------------------


@pytest.mark.parametrize("nodes", ["port", "jax"])
def test_light_bisection_over_http(nodes, tmp_path):
    """The port's Client and HTTPProvider bisect over a live net's RPC,
    with a witness: a net of port nodes, and one of JAX nodes."""

    async def main():
        if nodes == "port":
            gen, (n0, n1) = _port_net(tmp_path, 2, "light-http", dict)
        else:
            gen, pvs = jax_make_genesis(2, chain_id="light-http")
            n0, n1 = (JaxNode(jax_test_cfg("."), gen, privval=p) for p in pvs)
        await n0.start()
        await n1.start()
        await n0.dial(n1.listen_addr)
        while n0.height < 6:
            await asyncio.sleep(0.05)
        trusted = n0.parts.block_store.load_block(1)
        target = n0.height
        provider = HTTPProvider("light-http", n0.rpc_server.listen_addr)
        witness = HTTPProvider("light-http", n1.rpc_server.listen_addr)

        def verify():
            cli = Client("light-http", TrustOptions(period_ns=3600 * 10**9, height=1, hash=trusted.hash()),
                         primary=provider, witnesses=[witness], device="cpu")
            return cli.verify_light_block_at_height(target)

        try:
            lb = await asyncio.to_thread(verify)
            assert lb.height == target
            assert bytes(lb.hash()) == bytes(n0.parts.block_store.load_block(target).hash())
        finally:
            provider.close()
            witness.close()
            await n0.stop()
            await n1.stop()

    run(main())
