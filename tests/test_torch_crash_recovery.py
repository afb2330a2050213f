"""Crash points through the port's command line (reference
consensus/replay_test.go, libs/fail), on the CPU.

The port of ``tests/test_crash_recovery.py``: a node home made by
``python -m cometbft_tpu_torch init``, run by ``... --device cpu start``
with ``FAIL_TEST_INDEX`` set, must die at that crash point (exit 99);
started again without it, it must recover through the WAL and the
handshake's replay, serve ``abci_info`` and keep producing blocks. The
port's crash points are the JAX package's, in the same order
(consensus around the block save and the WAL's end height, the
executor around FinalizeBlock, the stored response and Commit).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request

import pytest

from cometbft_tpu_torch.config.config import load_toml, write_toml
from torch_hard_limit import hard_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "cometbft_tpu_torch"]


def _rpc(port, path, timeout=3.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/{path}", timeout=timeout) as r:
        return json.load(r)["result"]


def _wait_height(port, h, timeout=60.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            cur = int(_rpc(port, "status")["sync_info"]["latest_block_height"])
            if cur >= h:
                return cur
        except Exception:
            pass
        time.sleep(0.3)
    raise TimeoutError(f"port {port} never reached height {h}")


def _launch(home, fail_index=None):
    env = dict(os.environ)
    env.pop("FAIL_TEST_INDEX", None)
    if fail_index is not None:
        env["FAIL_TEST_INDEX"] = str(fail_index)
    return subprocess.Popen(
        CLI + ["--home", home, "--device", "cpu", "start"],
        cwd=REPO, env=env, stdout=open(os.path.join(home, "node.log"), "a"),
        stderr=subprocess.STDOUT, start_new_session=True,
    )


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.mark.parametrize("fail_index", [0, 2, 5, 9, 17])
def test_crash_at_fail_point_then_recover(tmp_path, fail_index):
    home = str(tmp_path / "node")
    subprocess.run(CLI + ["--home", home, "init", "--chain-id", f"crash-{fail_index}"],
                   cwd=REPO, check=True, capture_output=True)
    # the test's ports and fast blocks
    cfg_path = os.path.join(home, "config", "config.toml")
    cfg = load_toml(cfg_path)
    port = _free_port()
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = f"tcp://127.0.0.1:{port}"
    cfg.consensus.timeout_commit_s = 0.1
    write_toml(cfg, cfg_path)

    proc = _launch(home, fail_index=fail_index)
    try:
        rc = proc.wait(timeout=120)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise
    assert rc == 99, f"expected the crash point's exit, got {rc}"

    proc = _launch(home)
    try:
        h = _wait_height(port, 3, timeout=90)
        res = _rpc(port, "abci_info")
        assert int(res["response"]["last_block_height"]) >= 1
        h2 = _wait_height(port, h + 2, timeout=30)
        assert h2 > h
    finally:
        proc.terminate()
        try:
            assert proc.wait(timeout=20) == 0  # SIGTERM stops the node cleanly
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, signal.SIGKILL)
                proc.wait()
