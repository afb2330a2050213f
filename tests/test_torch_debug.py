"""The port's debug tooling (utils/debug.py) and the command line's
``debug``, on a running port ``Node``.

- ``DebugServer``'s three routes answer on the node's ``pprof_laddr``:
  ``/debug/pprof/stacks`` (every thread and task), ``/heap``
  (tracemalloc; the server stops the tracing it started when it stops,
  a port departure) and ``/profile?seconds=N`` (the sampling profile),
  and its index lists them.
- ``collect_debug_dump`` archives the node's status, net info,
  consensus dump and ABCI info from its RPC, and the stacks and heap
  from its debug server, each as the JAX function writes them.
- ``python -m cometbft_tpu_torch debug dump`` writes the archive; ``debug
  kill`` without ``--pid`` refuses. Both ran as ``cmd_unported`` before.
"""

import asyncio
import json
import tracemalloc
import urllib.request
import zipfile

import torch

from cometbft_tpu_torch.cmd.main import main as cli_main
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.utils.debug import collect_debug_dump
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as f:
        return f.status, f.read().decode()


def test_debug_server_routes_dump_and_cli(tmp_path, capsys):
    gen, privs = make_genesis(1, chain_id="debug-chain")
    cfg = make_test_cfg(".")
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.instrumentation.pprof_laddr = "127.0.0.1:0"
    node = Node(cfg, gen, privval=make_privvals(privs, root=str(tmp_path))[0], device="cpu")
    was_tracing = tracemalloc.is_tracing()

    async def main():
        await node.start()
        try:
            while node.height < 2:
                await asyncio.sleep(0.05)
            base = f"http://{node.debug_server.listen_addr}/debug/pprof"
            got = {}
            for route in ("", "/stacks", "/heap", "/heap", "/profile?seconds=0.5"):
                got.setdefault(route, []).append(await asyncio.to_thread(_get, base + route))
            rpc = node.rpc_server.listen_addr
            path = await asyncio.to_thread(collect_debug_dump, rpc, str(tmp_path / "dumps"),
                                           pprof_addr=node.debug_server.listen_addr, label="t")
            rc = await asyncio.to_thread(cli_main, ["debug", "dump", "--rpc-laddr", f"tcp://{rpc}",
                                                    "--pprof-laddr", node.debug_server.listen_addr,
                                                    "--output-dir", str(tmp_path / "cli")])
            rc_kill = await asyncio.to_thread(cli_main, ["debug", "kill", "--rpc-laddr", rpc,
                                                         "--output-dir", str(tmp_path / "cli")])
            tracing_while_up = tracemalloc.is_tracing()
        finally:
            await node.stop()
        return got, path, rc, rc_kill, tracing_while_up

    got, path, rc, rc_kill, tracing_while_up = asyncio.run(asyncio.wait_for(main(), 120))
    assert all(status == 200 and body for status, body in sum(got.values(), []))
    assert "/debug/pprof/stacks" in got[""][0][1]
    stacks = got["/stacks"][0][1]
    assert "--- thread MainThread" in stacks and "--- task" in stacks
    heap_first, heap_second = got["/heap"][0][1], got["/heap"][1][1]
    assert ("tracemalloc started" in heap_first) != was_tracing
    assert "current=" in heap_second
    assert "samples over 0.5s" in got["/profile?seconds=0.5"][0][1]
    # the server stopped the tracing its /heap started
    assert tracing_while_up and tracemalloc.is_tracing() == was_tracing

    with zipfile.ZipFile(path) as z:
        names = set(z.namelist())
        assert {"status.json", "net_info.json", "consensus_state.json", "abci_info.json", "stacks.txt",
                "heap.txt", "meta.json"} <= names, names
        status = json.loads(z.read("status.json"))
        assert status["result"]["node_info"]["network"] == "debug-chain"
        assert "--- thread" in z.read("stacks.txt").decode()
    assert rc == 0 and rc_kill == 1
    out = capsys.readouterr()
    assert "wrote " in out.out and "debug kill requires --pid" in out.err
    dumps = list((tmp_path / "cli").glob("*.zip"))
    assert len(dumps) == 2 and {p.name.split("-")[0] for p in dumps} == {"dump", "kill"}
