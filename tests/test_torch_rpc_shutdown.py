"""Stopping a node that serves RPC while a websocket subscriber and an
HTTP client are still open (ROADMAP C11).

A one-validator node of each package serves RPC; an ``HTTPClient`` of
the same package makes a call and keeps its session, and a websocket
subscription on NewBlock is left open, its reader either still
iterating in a task or parked after its first event. The node's stop
must return within ``STOP_BOUND_S`` on both packages, and the client's
own close must end the subscriber. The port is held to what the JAX
package does on the same inputs: whether the stop spent its RPC
stage's whole budget (both do: the server's clean-up waits on the open
websocket until the stage's 5 s budget ends it) and whether an
iterating reader is still open a second after the stop (on both it is,
until its client closes). Each stop's wall is printed for the record.
"""

import asyncio
import time

import pytest
import torch

from cometbft_tpu.config.config import test_config as jax_test_cfg
from cometbft_tpu.node.inprocess import make_genesis as jax_make_genesis
from cometbft_tpu.node.node import Node as JaxNode
from cometbft_tpu.rpc import client as jclient
from cometbft_tpu_torch.config.config import test_config as port_test_cfg
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import make_genesis as port_make_genesis
from cometbft_tpu_torch.node.inprocess import make_privvals
from cometbft_tpu_torch.node.node import Node as PortNode
from cometbft_tpu_torch.rpc import client as pclient
from torch_hard_limit import hard_limit  # noqa: F401

# the port's per-stage budget is 5 s (15 s for the switch): a stop that
# needs longer than every stage's budget together has hung somewhere
STOP_BOUND_S = 30.0
RPC_STAGE_BUDGET_S = 5.0


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


async def _node(pkg):
    if pkg == "jax":
        gen, pvs = jax_make_genesis(1, chain_id="stop-chain")
        cfg = jax_test_cfg(".")
        cfg.p2p.pex = False
        node = JaxNode(cfg, gen, privval=pvs[0])
        client_mod = jclient
    else:
        gen, privs = port_make_genesis(1, chain_id="stop-chain")
        cfg = port_test_cfg(".")
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        node = PortNode(cfg, gen, privval=make_privvals(privs)[0], device="cpu")
        client_mod = pclient
    await node.start()
    return node, client_mod.HTTPClient(node.rpc_server.listen_addr)


@pytest.mark.parametrize("reader", ["iterating", "parked"])
def test_stop_with_open_subscriber_and_client(reader):
    walls = {}

    async def one(pkg):
        node, cli = await _node(pkg)
        sub = await cli.subscribe("tm.event='NewBlock'")
        await asyncio.wait_for(sub.__anext__(), 30)
        task = None
        if reader == "iterating":
            async def read():
                async for _ in sub:
                    pass

            task = asyncio.ensure_future(read())
            await asyncio.sleep(0.2)
        st = await cli.status()
        assert int(st["sync_info"]["latest_block_height"]) >= 1
        t0 = time.perf_counter()
        try:
            await asyncio.wait_for(node.stop(), STOP_BOUND_S)
        except asyncio.TimeoutError:
            pytest.fail(f"{pkg}: Node.stop did not return within {STOP_BOUND_S} s")
        walls[pkg] = time.perf_counter() - t0
        # the subscriber's connection outlives the node's stop
        await asyncio.sleep(1.0)
        open_after_stop = task is not None and not task.done()
        # the client's own close ends it at once
        await asyncio.wait_for(cli.close(), 10)
        if task is not None:
            await asyncio.wait_for(task, 10)
        else:
            await asyncio.wait_for(sub.aclose(), 10)
        # the stop waited out its rpc stage's budget, or it did not
        return walls[pkg] >= RPC_STAGE_BUDGET_S - 0.5, open_after_stop

    async def main():
        return {pkg: await one(pkg) for pkg in ("port", "jax")}

    got = asyncio.run(asyncio.wait_for(main(), 150))
    print(f"stop walls ({reader} reader): " + ", ".join(f"{k} {v:.3f} s" for k, v in walls.items())
          + f"; (budget spent, open after stop): {got}")
    assert got["port"] == got["jax"]
