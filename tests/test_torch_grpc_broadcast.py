"""The gRPC broadcast API in the port (reference rpc/grpc/api.go), on
the CPU.

- The port of ``tests/test_grpc_broadcast.py``: Ping and BroadcastTx
  against a live two-node port net, the tx committed into the app's
  state, a bad tx answered with its CheckTx code; the node serves gRPC
  with JSON-RPC off.
- Interop: the port's ``GRPCBroadcastClient`` against a JAX node's
  server, and the JAX client against a port node's, answer alike.
"""

import asyncio

from cometbft_tpu.config.config import test_config as jtest_config
from cometbft_tpu.node.inprocess import make_genesis as jmake_genesis
from cometbft_tpu.node.node import Node as JNode
from cometbft_tpu.rpc.grpc_api import GRPCBroadcastClient as JClient
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.rpc.grpc_api import GRPCBroadcastClient
from torch_hard_limit import hard_limit  # noqa: F401


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _drive(cli, key):
    """Ping, one good tx and one bad, from a worker thread (the client
    blocks; the node's loop must stay free to commit the tx)."""
    cli.ping()
    good = cli.broadcast_tx(key + b"=grpcval")
    bad = cli.broadcast_tx(b"no-equals")
    cli.close()
    return good, bad


def _check(good, bad):
    assert good["check_tx"]["code"] == 0, good
    assert good["tx_result"]["code"] == 0, good
    assert int(good["height"]) >= 1 and len(good["hash"]) == 64, good
    assert bad["check_tx"]["code"] != 0 and int(bad["height"]) == 0, bad


def test_grpc_ping_and_broadcast_tx():
    gen, privs = make_genesis(2, chain_id="grpc-chain")
    pvs = make_privvals(privs)

    async def main():
        cfg = make_test_cfg(".")
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        assert cfg.rpc.laddr == ""  # gRPC serves without JSON-RPC
        n0 = Node(cfg, gen, privval=pvs[0], device="cpu")
        n1 = Node(make_test_cfg("."), gen, privval=pvs[1], device="cpu")
        await n0.start()
        await n1.start()
        await n0.dial(n1.listen_addr)
        while n0.height < 2:
            await asyncio.sleep(0.05)
        assert n0.rpc_server is None and n0.grpc_server.port
        cli = GRPCBroadcastClient(f"127.0.0.1:{n0.grpc_server.port}")
        good, bad = await asyncio.to_thread(_drive, cli, b"grpckey")
        _check(good, bad)
        assert n0.parts.app.state.get(b"grpckey") == b"grpcval"
        await n0.stop()
        await n1.stop()

    run(main())


def test_port_client_against_a_jax_node_and_the_reverse():
    """A JAX node's BroadcastAPI answers the port's client, and a port
    node's answers the JAX client, in the same shape."""
    jgen, jpvs = jmake_genesis(1, chain_id="grpc-jax")
    gen, privs = make_genesis(1, chain_id="grpc-port")

    async def main():
        jcfg = jtest_config(".")
        jcfg.rpc.laddr = ""
        jcfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        jn = JNode(jcfg, jgen, privval=jpvs[0])
        cfg = make_test_cfg(".")
        cfg.rpc.grpc_laddr = "tcp://127.0.0.1:0"
        pn = Node(cfg, gen, privval=make_privvals(privs)[0], device="cpu")
        await jn.start()
        await pn.start()
        while jn.height < 1 or pn.height < 1:
            await asyncio.sleep(0.05)
        port_on_jax = await asyncio.to_thread(
            _drive, GRPCBroadcastClient(f"127.0.0.1:{jn.grpc_server.port}"), b"pj")
        jax_on_port = await asyncio.to_thread(_drive, JClient(f"127.0.0.1:{pn.grpc_server.port}"), b"jp")
        assert jn.parts.app.state.get(b"pj") == b"grpcval"
        assert pn.parts.app.state.get(b"jp") == b"grpcval"
        await pn.stop()
        await jn.stop()
        return port_on_jax, jax_on_port

    port_on_jax, jax_on_port = run(main())
    for good, bad in (port_on_jax, jax_on_port):
        _check(good, bad)
    assert port_on_jax[1]["check_tx"] == jax_on_port[1]["check_tx"]
    assert set(port_on_jax[0]) == set(jax_on_port[0]) == {"check_tx", "tx_result", "hash", "height"}
