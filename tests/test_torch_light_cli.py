"""The light client's command-line mode in the port (reference cmd
light, light/proxy), on the CPU.

The ports of the two CLI cases of ``tests/test_light_proxy_proofs.py``:
``python -m cometbft_tpu_torch --device cpu light ... --laddr`` serves
the light-verified proxy against a live two-node port net, answering a
proof-checked ``abci_query``; with ``--dir`` a restarted daemon resumes
from its persisted store, and a trust root that disagrees with that
store refuses to start.
"""

import asyncio
import base64
import socket
import subprocess
import sys

import aiohttp

from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.models.kvstore import KVStoreApplication
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from torch_hard_limit import hard_limit  # noqa: F401

CLI = [sys.executable, "-m", "cometbft_tpu_torch", "--device", "cpu", "light"]


def run(coro, timeout=150):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


async def _net(chain_id, prove=False):
    gen, privs = make_genesis(2, chain_id=chain_id)
    nodes = []
    for i, pv in enumerate(make_privvals(privs)):
        cfg = make_test_cfg(".")
        if i == 0:
            cfg.rpc.laddr = "tcp://127.0.0.1:0"
        nodes.append(Node(cfg, gen, privval=pv, app=KVStoreApplication(prove=prove), device="cpu"))
    for n in nodes:
        await n.start()
    await nodes[0].dial(nodes[1].listen_addr)
    return nodes


async def _poll(url, ok, timeout):
    """The first JSON body from ``url`` that ``ok`` accepts, or None."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    async with aiohttp.ClientSession() as s:
        while loop.time() < deadline:
            try:
                async with s.get(url) as resp:
                    body = await resp.json()
                if ok(body):
                    return body
            except Exception:
                pass
            await asyncio.sleep(0.3)
    return None


def test_light_cli_proxy_mode():
    async def main():
        n0, n1 = await _net("cli-proxy", prove=True)
        async with aiohttp.ClientSession() as s:
            async with s.get(f"http://{n0.rpc_server.listen_addr}/broadcast_tx_commit?tx=0x"
                             + b"cli=proxy".hex()) as resp:
                assert (await resp.json())["result"]
        while n0.height < 4:
            await asyncio.sleep(0.05)
        trust = n0.parts.block_store.load_block(1)
        port = _free_port()
        proc = subprocess.Popen(
            CLI + ["cli-proxy", "-p", n0.rpc_server.listen_addr, "--trust-height", "1",
                   "--trust-hash", trust.hash().hex(), "--laddr", f"tcp://127.0.0.1:{port}",
                   "--sequential"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        try:
            body = await _poll(f'http://127.0.0.1:{port}/abci_query?path="/store"&data=0x' + b"cli".hex(),
                               lambda b: b.get("result"), 60)
        finally:
            proc.terminate()
            proc.wait(10)
        await n0.stop()
        await n1.stop()
        assert body and body["result"]["verified"] is True, body
        assert base64.b64decode(body["result"]["response"]["value"]) == b"proxy"

    run(main())


def test_light_cli_dir_persists_trust_across_restarts(tmp_path):
    async def main():
        n0, n1 = await _net("cli-dir")
        while n0.height < 4:
            await asyncio.sleep(0.05)
        trust = n0.parts.block_store.load_block(1)

        async def run_once(trust_hash):
            port = _free_port()
            proc = subprocess.Popen(
                CLI + ["cli-dir", "-p", n0.rpc_server.listen_addr, "--trust-height", "1",
                       "--trust-hash", trust_hash, "--dir", str(tmp_path / "lighthome"),
                       "--laddr", f"tcp://127.0.0.1:{port}"],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            try:
                body = await _poll(f"http://127.0.0.1:{port}/status",
                                   lambda b: b.get("result", {}).get("verified"), 60)
            finally:
                proc.terminate()
                proc.wait(10)
            assert body, "light proxy never served status"
            return body["result"]

        first = await run_once(trust.hash().hex())
        assert int(first["sync_info"]["latest_block_height"]) >= 1
        second = await run_once(trust.hash().hex())
        assert int(second["sync_info"]["latest_block_height"]) >= 1
        # a trust root at odds with the persisted store refuses to start
        proc = subprocess.Popen(
            CLI + ["cli-dir", "-p", n0.rpc_server.listen_addr, "--trust-height", "1",
                   "--trust-hash", "00" * 32, "--dir", str(tmp_path / "lighthome"),
                   "--laddr", "tcp://127.0.0.1:0"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        out, _ = await asyncio.to_thread(proc.communicate, None, 60)
        await n0.stop()
        await n1.stop()
        assert proc.returncode != 0, out[-400:]
        assert "re-rooting" in out, out[-400:]

    run(main())
