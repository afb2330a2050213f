"""What the port's command line stands on, on the CPU.

- The TOML round trip: ``write_toml`` then ``load_toml`` gives the same
  config; the JAX loader reads the port's file to the same values; the
  port's loader refuses a key or section it lacks, or a key it does not
  read set away from its JAX default (the JAX loader skips both), and ``BaseConfig`` has the JAX defaults of the fields ``cmd/``
  reads.
- The kernel build across processes: two processes that build the
  kernels into one directory at once, with a stub compiler that writes
  its output slowly, both load whole libraries, and the sources are
  compiled once.
- The light subcommands: ``init``, ``testnet``, ``signer`` and
  ``abci-server`` import no torch; ``testnet`` writes homes whose config
  loads and whose genesis holds every node's key.
- ``node_from_home``, as ``start`` uses it: a home whose config names a
  remote signer and an out-of-process app builds a node that signs
  through a ``RetrySignerClient`` and finalizes in the app (both in
  child processes started through the command line), and
  ``abci = "kvstore-appmem"`` gives the app-side mempool's kvstore.
"""

import asyncio
import os
import signal
import socket
import subprocess
import sys
import textwrap
import time
from dataclasses import fields
from pathlib import Path

import pytest

from cometbft_tpu.config import config as jconfig
from cometbft_tpu_torch.config import config as pconfig
from torch_hard_limit import hard_limit  # noqa: F401

REPO = Path(__file__).resolve().parent.parent
CLI = [sys.executable, "-m", "cometbft_tpu_torch"]


def test_toml_round_trip_and_the_jax_loader(tmp_path):
    path = str(tmp_path / "config" / "config.toml")
    cfg = pconfig.default_config(str(tmp_path))
    cfg.base.proxy_app = "tcp://127.0.0.1:26658"
    cfg.base.abci = "grpc"
    cfg.base.priv_validator_laddr = "tcp://127.0.0.1:26659"
    cfg.rpc.grpc_laddr = "tcp://127.0.0.1:9090"
    cfg.statesync.rpc_servers = ["127.0.0.1:1", "127.0.0.1:2"]
    cfg.consensus.timeout_commit_s = 0.25
    cfg.tx_index.psql_conn = "postgres://x"
    pconfig.write_toml(cfg, path)
    back = pconfig.load_toml(path)
    assert back == cfg and back.root_dir == str(tmp_path)
    j = jconfig.load_toml(path)
    for section in ("base", "rpc", "p2p", "mempool", "statesync", "blocksync", "consensus", "storage",
                    "tx_index", "instrumentation"):
        ours, theirs = getattr(back, section), getattr(j, section)
        for f in fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), (section, f.name)


def test_base_config_has_the_jax_defaults():
    ours, theirs = pconfig.BaseConfig(), jconfig.BaseConfig()
    for f in fields(ours):
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert {f.name for f in fields(ours)} == {f.name for f in fields(theirs)}


@pytest.mark.parametrize("text, what", [
    ('[base]\nproxy_app_addr = "tcp://x:1"\n', "proxy_app_addr"),
    # a key the JAX package writes and the port does not read loads only
    # at its JAX default: set, it is refused rather than ignored
    ('[p2p]\nexternal_address = "tcp://1.2.3.4:26656"\n', "external_address"),
])
def test_load_toml_refuses_what_the_port_lacks(tmp_path, text, what):
    path = tmp_path / "config" / "config.toml"
    path.parent.mkdir()
    path.write_text(text)
    with pytest.raises(ValueError, match=what):
        pconfig.load_toml(str(path))
    jconfig.load_toml(str(path))  # the JAX loader skips it


STUB_NVCC = """\
#!{python}
import os, subprocess, sys, time
args = sys.argv[1:]
out = args[args.index("-o") + 1]
tmp = out + ".stub"
subprocess.run(["g++", "-shared", "-fPIC", "-x", "c", os.environ["STUB_C"], "-o", tmp], check=True)
data = open(tmp, "rb").read()
os.remove(tmp)
with open(out, "wb") as f:  # slowly, so a reader could see half a library
    f.write(data[: len(data) // 2])
    f.flush()
    time.sleep(0.6)
    f.write(data[len(data) // 2:])
with open(os.environ["STUB_LOG"], "a") as f:
    f.write(out + "\\n")
"""

LOADER = """\
import sys, pathlib
from cometbft_tpu_torch import kernels
kernels.BUILD_DIR = pathlib.Path(sys.argv[1])
kernels._nvcc = lambda: sys.argv[2]
for name in kernels.SOURCES:
    kernels.load(name)
print("loaded", sorted(kernels._libs))
"""


def test_two_processes_building_at_once_both_load_whole_libraries(tmp_path):
    from cometbft_tpu_torch import kernels

    names = sorted({fn for sigs in kernels.SIGNATURES.values() for fn in sigs})
    c_src = tmp_path / "stub.c"
    c_src.write_text("".join(f"int {fn}(void) {{ return 0; }}\n" for fn in names))
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(STUB_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    build, log = tmp_path / "build", tmp_path / "nvcc.log"
    env = dict(os.environ, STUB_C=str(c_src), STUB_LOG=str(log))
    procs = [subprocess.Popen([sys.executable, "-c", LOADER, str(build), str(nvcc)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for _ in range(2)]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    assert all("loaded" in o for o in outs), outs
    # one build of each source, into a temporary name moved into place
    built = log.read_text().split()
    assert len(built) == len(kernels.SOURCES), built
    assert all(Path(b).name.startswith(".lib") and Path(b).name.endswith(".tmp.so") for b in built)
    assert sorted(p.name for p in build.glob("lib*.so")) == sorted(f"lib{n}.so" for n in kernels.SOURCES)
    assert not list(build.glob(".lib*"))


def _no_torch(args, cwd):
    probe = textwrap.dedent(f"""
        import runpy, sys
        sys.argv = ["cometbft_tpu_torch"] + {args!r}
        try:
            runpy.run_module("cometbft_tpu_torch", run_name="__main__")
        except SystemExit as e:
            code = e.code
        bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "cometbft_tpu"))
        print("BAD", bad, "CODE", code)
    """)
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert "BAD [] CODE 0" in out.stdout, out.stdout + out.stderr


def test_light_subcommands_import_no_torch(tmp_path):
    # what signer and abci-server run (they serve until stopped)
    probe = ("import sys, cometbft_tpu_torch.cmd.main, cometbft_tpu_torch.privval.signer, "
             "cometbft_tpu_torch.privval.file_pv, cometbft_tpu_torch.abci.server, "
             "cometbft_tpu_torch.models.kvstore\n"
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'jax', 'cometbft_tpu')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stdout + out.stderr
    _no_torch(["--home", str(tmp_path / "h"), "init", "--chain-id", "light"], tmp_path)
    _no_torch(["testnet", "--v", "2", "--o", str(tmp_path / "net")], tmp_path)
    _no_torch(["--home", str(tmp_path / "h"), "show-validator"], tmp_path)
    from cometbft_tpu_torch.config.config import load_toml
    from cometbft_tpu_torch.types.genesis import GenesisDoc

    gens = []
    for i in range(2):
        home = tmp_path / "net" / f"node{i}"
        cfg = load_toml(str(home / "config" / "config.toml"))
        assert cfg.base.moniker == f"node{i}" and cfg.p2p.persistent_peers.count("@") == 1
        gens.append(GenesisDoc.from_json((home / "config" / "genesis.json").read_text()))
    assert gens[0].to_json() == gens[1].to_json() and len(gens[0].validators) == 2


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _child(args, log):
    return subprocess.Popen(CLI + args, cwd=REPO, stdout=open(log, "w"), stderr=subprocess.STDOUT,
                            start_new_session=True)


def _stop(proc):
    if proc.poll() is None:
        os.killpg(proc.pid, signal.SIGTERM)
    try:
        return proc.wait(10)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        return proc.wait()


def test_node_from_home_with_a_remote_signer_and_app(tmp_path):
    """A one-validator testnet home whose config names a remote signer
    and an app in child processes (``signer`` and ``abci-server``, both
    on the light path): the node built as ``start`` builds it signs
    through the signer and finalizes in the app."""
    from cometbft_tpu_torch.abci.socket_client import SocketClient
    from cometbft_tpu_torch.abci.types import RequestInfo, RequestQuery
    from cometbft_tpu_torch.cmd.main import node_from_home
    from cometbft_tpu_torch.config.config import load_toml, write_toml
    from cometbft_tpu_torch.privval.signer import RetrySignerClient

    subprocess.run(CLI + ["testnet", "--v", "1", "--o", str(tmp_path / "net"),
                          "--starting-port", str(_free_port())], cwd=REPO, check=True, capture_output=True)
    home = str(tmp_path / "net" / "node0")
    path = os.path.join(home, "config", "config.toml")
    cfg = load_toml(path)
    app_addr = f"tcp://127.0.0.1:{_free_port()}"
    signer_addr = f"tcp://127.0.0.1:{_free_port()}"
    cfg.base.proxy_app, cfg.base.abci, cfg.base.priv_validator_laddr = app_addr, "socket", signer_addr
    cfg.p2p.laddr, cfg.rpc.laddr = "tcp://127.0.0.1:0", ""
    cfg.consensus.timeout_commit_s = 0.1
    write_toml(cfg, path)
    app = _child(["--home", home, "abci-server", "-a", app_addr], tmp_path / "app.log")
    signer = _child(["--home", home, "signer", "-a", signer_addr], tmp_path / "signer.log")
    import torch

    try:
        deadline = time.monotonic() + 60
        while True:  # the app child listens
            try:
                SocketClient(app_addr, connect_timeout=1.0).close()
                break
            except OSError:
                assert time.monotonic() < deadline, (tmp_path / "app.log").read_text()
                time.sleep(0.2)

        async def main():
            node = node_from_home(home, torch.device("cpu"), out=lambda *_: None)
            assert isinstance(node.parts.privval, RetrySignerClient) and node.parts.app is None
            await node.start()
            assert node.parts.mempool.check_tx(b"remote=signed").is_ok()
            while node.height < 4:
                await asyncio.sleep(0.05)
            signed = node.parts.block_store.load_block(2).last_commit.signatures[0].signature
            await node.stop()
            node.parts.privval.close()
            return signed

        assert asyncio.run(asyncio.wait_for(main(), 120))
        q = SocketClient(app_addr)
        assert q.query(RequestQuery(path="/store", data=b"remote")).value == b"signed"
        assert q.info(RequestInfo()).last_block_height >= 4
        q.close()
    finally:
        assert _stop(app) == 0
        _stop(signer)


def test_node_from_home_kvstore_appmem(tmp_path):
    import torch

    from cometbft_tpu_torch.cmd.main import node_from_home
    from cometbft_tpu_torch.config.config import load_toml, write_toml
    from cometbft_tpu_torch.models.kvstore import AppMempoolKVStore

    subprocess.run(CLI + ["--home", str(tmp_path), "init"], cwd=REPO, check=True, capture_output=True)
    path = str(tmp_path / "config" / "config.toml")
    cfg = load_toml(path)
    cfg.base.abci, cfg.mempool.type_ = "kvstore-appmem", "app"
    write_toml(cfg, path)
    node = node_from_home(str(tmp_path), torch.device("cpu"), log_level="consensus:error,*:info")
    assert isinstance(node.parts.app, AppMempoolKVStore)
    node.parts.close_stores()
