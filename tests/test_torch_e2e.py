"""The port's end-to-end harness (``cometbft_tpu_torch/e2e/``) held to
the JAX package's: the cases of ``tests/test_e2e.py`` (2) and
``tests/test_e2e_generated.py`` (3) on the port, with every child a
``python -m cometbft_tpu_torch --device cpu`` process (the multi-process
nets keep their ``slow`` marks), ``test_aux_tools.py``'s
``test_latency_report_math``, and what a seed fixes compared across the
packages: generated manifests and manifests read from TOML are equal.

One small runner case the JAX suite lacks runs in tier-1: four
validators as ``--device cpu`` children, one killed and restarted,
target height 5, so the runner's port is checked off the card too; a
``cometbft_tpu_torch load`` child against it then gets every tx it had
accepted committed once. A ``Node`` presents ``CMT_NODE_VERSION`` as its node-info version (the
upgrade perturbation), as the JAX node does.
"""

import asyncio
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cometbft_tpu.e2e import generator as jgenerator
from cometbft_tpu.e2e import load as jload
from cometbft_tpu.e2e.manifest import Manifest as JManifest
from cometbft_tpu_torch.e2e import runner as runner_mod
from cometbft_tpu_torch.e2e.generator import generate, generate_one
from cometbft_tpu_torch.e2e.load import latency_report, make_tx, parse_tx
from cometbft_tpu_torch.e2e.manifest import Manifest
from cometbft_tpu_torch.e2e.runner import Runner
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent

MANIFEST = {
    "chain_id": "e2e-smoke",
    "target_height": 12,
    "load_tx_rate": 4,
    "node": {
        "val0": {"mode": "validator", "evidence_at": 4, "grpc": True},
        "val1": {"mode": "validator", "kill_at": 5},
        "val2": {"mode": "validator", "pause_at": 4, "pause_s": 2.0},
        "val3": {
            "mode": "validator",
            "disconnect_at": 6,
            "disconnect_s": 2.0,
        },
        "val4": {"mode": "validator", "upgrade_at": 5},
        "full0": {
            "mode": "full",
            "start_at": 6,
            "block_sync": True,
        },
    },
}

TINY = {
    "chain_id": "e2e-tiny",
    "target_height": 5,
    "load_tx_rate": 2,
    "node": {
        "val0": {"mode": "validator"},
        "val1": {"mode": "validator", "kill_at": 3, "restart_delay_s": 1.0},
        "val2": {"mode": "validator"},
        "val3": {"mode": "validator"},
    },
}


def _as_dict(m) -> dict:
    return dataclasses.asdict(m)


def _run_net(m, base_dir, base_port, timeout_s=240.0, then=None):
    """Run the manifest's net; ``then(runner)`` runs once it converged,
    before the children stop."""
    runner = Runner(m, base_dir, base_port=base_port, device="cpu")
    runner.setup()
    heights = {}
    try:
        ok = asyncio.run(
            asyncio.wait_for(
                runner.run(timeout_s=timeout_s),
                timeout_s + runner_mod.CONVERGENCE_BUDGET_S + runner_mod.POST_BUDGET_S,
            )
        )
        heights = {name: runner._height(rn) for name, rn in runner.nodes.items()}
        if ok and then is not None:
            then(runner)
    finally:
        runner.stop()
    return runner, ok, heights


@pytest.mark.slow
def test_e2e_smoke(tmp_path):
    m = Manifest.from_dict(MANIFEST)
    runner, ok, heights = _run_net(m, str(tmp_path / "net"), 28300)
    assert ok, runner.failures
    # block-interval stats recorded (reference runner/benchmark.go)
    bench = getattr(runner, "benchmark", None)
    assert bench and bench["interval_mean_s"] > 0, bench
    # the killed validator recovered; the late full node blocksynced
    assert heights["val1"] >= m.target_height, heights
    assert heights["full0"] >= m.target_height, heights
    # the upgraded validator came back as the new version and rejoined
    assert getattr(runner, "_upgraded_ok", False), runner.failures
    assert heights["val4"] >= m.target_height, heights


def test_manifest_validation():
    with pytest.raises(ValueError):
        Manifest.from_dict({"node": {}})
    with pytest.raises(ValueError):
        Manifest.from_dict({"node": {"a": {"mode": "full"}}})
    m = Manifest.from_dict(MANIFEST)
    assert m.nodes["val0"].perturbations[0].kind == "evidence"
    assert m.nodes["val1"].perturbations[0].kind == "kill"
    assert m.nodes["val2"].perturbations[0].kind == "pause"
    assert _as_dict(m) == _as_dict(JManifest.from_dict(MANIFEST))


def test_manifest_toml_loads_equal_to_jax(tmp_path):
    path = tmp_path / "m.toml"
    path.write_text(
        'chain_id = "e2e-toml"\ntarget_height = 9\nload_tx_rate = 2.5\n'
        '[node.v0]\nmode = "validator"\npower = 20\nevidence_lca_at = 4\n'
        '[node.v1]\nkill_at = 3\nrestart_delay_s = 1.5\nupgrade_at = 6\n'
        '[node.f0]\nmode = "full"\nstart_at = 4\nblock_sync = true\n'
        'adaptive_sync = true\ndb = "logdb"\n'
        '[node.l0]\nmode = "light"\nstart_at = 3\n'
    )
    assert _as_dict(Manifest.load(str(path))) == _as_dict(JManifest.load(str(path)))


def test_generator_is_deterministic():
    a, b = generate_one(42), generate_one(42)
    assert a == b
    # different seeds explore the space
    assert any(generate_one(s) != a for s in range(43, 50))


def test_generated_manifests_equal_to_jax():
    """A seed gives the JAX package's manifest, field for field."""
    for seed in range(200):
        assert _as_dict(generate_one(seed)) == _as_dict(jgenerator.generate_one(seed)), seed
    assert [_as_dict(m) for m in generate(7, 5)] == [_as_dict(m) for m in jgenerator.generate(7, 5)]


def test_generated_manifests_valid():
    """Every generated net satisfies the manifest invariants across a
    seed sweep (cheap, no processes)."""
    for seed in range(100):
        m = generate_one(seed)
        assert any(n.mode == "validator" and n.start_at == 0 for n in m.nodes.values()), seed
        for n in m.nodes.values():
            if n.start_at > 0 and n.mode != "light":
                # light nodes sync via the light protocol, not
                # block/state sync
                assert n.block_sync or n.state_sync, (seed, n.name)
            for p in n.perturbations:
                assert 0 < p.height < m.target_height, (seed, n.name)
        # evidence perturbations only in nets with >2 validators
        n_vals = sum(1 for n in m.nodes.values() if n.mode == "validator")
        if any(p.kind == "evidence" for n in m.nodes.values() for p in n.perturbations):
            assert n_vals > 2, seed


# the JAX lane's seeds: one by default, E2E_GEN_SEEDS="2,3,4" to widen
_SEEDS = [int(s) for s in os.environ.get("E2E_GEN_SEEDS", "1").split(",") if s.strip()]


@pytest.mark.slow
@pytest.mark.parametrize("seed", _SEEDS)
def test_generated_net_runs(tmp_path, seed):
    m = generate_one(seed)
    # 30 ports a seed: up to 7 nodes x 3 ports each (p2p, rpc, grpc)
    runner, ok, _ = _run_net(m, str(tmp_path / f"gen{seed}"), 28600 + (seed % 50) * 30)
    assert ok, (seed, runner.failures)


def test_latency_report_math():
    class Hdr:
        def __init__(self, t):
            self.time_ns = t

    class Blk:
        def __init__(self, t, txs):
            self.header = Hdr(t)
            self.data = type("D", (), {"txs": txs})()

    base = 1_000_000_000_000
    blocks = {
        1: Blk(base + int(1e9), [make_tx(1, 64, base)]),
        2: Blk(base + int(2e9), [make_tx(2, 64, base), b"other=1"]),
        3: Blk(base + int(3e9), []),
    }

    class FakeClient:
        async def block_decoded(self, h):
            return blocks[h]

    rep = asyncio.run(latency_report(FakeClient(), 1, 3))
    assert rep.count == 2
    assert rep.min_s == pytest.approx(1.0)
    assert rep.max_s == pytest.approx(2.0)
    assert rep.mean_s == pytest.approx(1.5)
    assert rep.heights == 3
    assert rep.block_interval_mean_s == pytest.approx(1.0)
    # the JAX report over the same blocks says the same
    assert rep.to_dict() == asyncio.run(jload.latency_report(FakeClient(), 1, 3)).to_dict()
    # the tx format is the JAX one: each package parses the other's
    tx = make_tx(7, 96, base)
    assert parse_tx(tx) == jload.parse_tx(tx) == base
    assert parse_tx(jload.make_tx(8, 96, base)) == base


def test_node_presents_cmt_node_version(monkeypatch, tmp_path):
    from cometbft_tpu_torch.config.config import test_config as make_test_config
    from cometbft_tpu_torch.node.inprocess import make_genesis
    from cometbft_tpu_torch.node.node import Node

    gen, _ = make_genesis(1)
    default = Node(make_test_config(str(tmp_path / "a")), gen, device="cpu")
    monkeypatch.setenv("CMT_NODE_VERSION", "0.2.0-upgrade")
    upgraded = Node(make_test_config(str(tmp_path / "b")), gen, device="cpu")
    try:
        assert default.node_info.version != "0.2.0-upgrade"
        assert upgraded.node_info.version == "0.2.0-upgrade"
    finally:
        default.parts.close_stores()
        upgraded.parts.close_stores()


def test_runner_four_cpu_validators_kill_restart(tmp_path):
    """Four validators as ``--device cpu`` children with tx load, one
    killed and restarted at height 3: every node reaches height 5 and
    agrees on its block, the killed one included, and the
    block-interval benchmark is recorded. Then a ``load`` child against
    val0's RPC: every tx it got accepted is committed once."""
    m = Manifest.from_dict(TINY)
    loads = []

    def load(runner):
        rn = runner.nodes["val0"]
        proc = subprocess.run(
            [sys.executable, "-m", "cometbft_tpu_torch", "load", "--rpc-laddr", f"127.0.0.1:{rn.rpc_port}",
             "-r", "10", "-T", "2", "-s", "128"],
            cwd=REPO, capture_output=True, text=True, timeout=120,
        )
        assert proc.returncode == 0, proc.stdout + proc.stderr
        loads.append(json.loads(proc.stdout.strip().splitlines()[-1]))

    runner, ok, heights = _run_net(m, str(tmp_path / "net"), 28400, timeout_s=150.0, then=load)
    assert ok, runner.failures
    (rep,) = loads
    assert rep["accepted"] > 0 and rep["rejected"] == 0, rep
    assert rep["count"] == rep["accepted"], rep
    assert rep["p50_s"] > 0 and rep["heights"] > 0, rep
    assert all(h >= m.target_height for h in heights.values()), heights
    bench = getattr(runner, "benchmark", None)
    assert bench and bench["interval_mean_s"] > 0, bench
    # every child ran the port on the CPU, by its own command line
    for rn in runner.nodes.values():
        assert rn.proc.args[1:5] == ["-m", "cometbft_tpu_torch", "--device", "cpu"], rn.proc.args
