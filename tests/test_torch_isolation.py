"""The port stands alone, and its entry points refuse a missing GPU.

- A fresh interpreter imports every module of cometbft_tpu_torch and
  finds neither ``jax`` nor any ``cometbft_tpu.`` module loaded.
- With no CUDA device (this test lane), calling an entry point without
  ``device="cpu"`` raises instead of falling back to the CPU: the
  kernels' entry, the batch factories ("cuda" and "cpu-parallel"), the
  verify scheduler's ``submit``, the vote coalescer, every validation
  entry point, the replay's: ``build_node`` (and ``make_chain``,
  which builds one), ``BlockExecutor.validate_block`` and
  ``BlockSyncReactor``, and the light client's: ``Client``,
  ``verifier.verify_adjacent``, ``verifier.verify_non_adjacent`` and
  ``detector.check_against_witnesses``, and consensus's:
  ``ConsensusState``, ``build_node`` with a signer, a config and a WAL,
  and the adaptive-sync ingestor path (``BlockSyncReactor`` with a
  ``block_ingestor``), which on ``device="cpu"`` ingests a chain into
  a started state machine. ``LocalNet`` takes built nodes, so it runs
  where they were built.
- The network slice's modules (p2p, the secret connection's crypto
  tiers, the mempool, blocksync and consensus reactors, ``Node``, the
  stub peer) are among the modules the probe imports. ``Node`` runs on
  the card by default: it raises on a machine without one unless given
  ``device="cpu"``, and its reactors take its device. The settings of
  the operations plane (the metrics and debug servers) build a node
  that serves them, the metrics server where
  ``prometheus_listen_addr`` says; ``rpc.laddr`` makes it serve RPC. Every field the port's config shares
  with the JAX package's defaults to the JAX value, ``rpc.laddr`` aside
  (ROADMAP C10), and a field the port lacks cannot be set.
- The RPC and light serving slice's modules (``rpc/``, the indexer,
  the queue telemetry, the serving plane, the HTTP provider and the
  proxy) are among the modules the probe imports, and the serving
  plane raises without a GPU unless given ``device="cpu"``.
- The statesync slice's modules (``statesync/``, the retention plane,
  rollback, offline bootstrap) are among the modules the probe imports;
  the light-client state provider raises without a GPU unless given
  ``device="cpu"``, and ``Node`` takes ``statesync.enable`` (its
  provider then runs on the node's device).
- The fork's network plane (``lp2p/``, ``p2p/pex.py``, the autopool,
  the TTL guard) is among the modules the probe imports, and ``Node``
  takes each of its settings on ``device="cpu"``: the lp2p switch, the
  PEX reactor, a seed in the address book, the autopool, and the app
  and nop mempools.
- The operator's node (the command line, the ABCI codec, socket and
  gRPC servers and clients, the remote signer, the gRPC broadcast API,
  the psql sink's gate) is among the modules the probe imports;
  ``python -m cometbft_tpu_torch --help`` imports neither ``jax`` nor
  ``cometbft_tpu``, and ``start`` without ``--device cpu`` exits non-zero
  with the device error on a machine without a GPU, before it runs
  anything.
- The host's native lanes (``utils/native.py``, ``utils/wirecodec.py``,
  ``utils/logdb.py``, ``models/vecbank.py``) are among the modules the
  probe imports, and a fresh interpreter with its own ``HOME`` loads
  all four native libraries from ``build/native/`` at the repository
  root and writes nothing under ``~/.cache/cometbft_tpu``, the JAX
  package's build directory.
- The operations plane (the whole ``trace/``, ``obs/``, the tracewire
  stamper, ``utils/metrics.py``, ``utils/debug.py``) is among the
  modules the probe imports.
- The serving fleet (``fleet/``), the runtime sanitizer and the scaling
  probe (``analysis/``), connection fuzzing (``p2p/fuzz.py``) and the
  small host crypto modules are among the modules the probe imports;
  imported alone they load neither ``jax`` nor ``cometbft_tpu``, and
  ``analysis/``, ``p2p/fuzz.py`` and the config load no torch.
- The chaos harness (``chaos/``) and the e2e harness (``e2e/``) are
  among the modules the probe imports and, imported alone, load
  neither ``jax`` nor ``cometbft_tpu``. ``ChaosNet``, ``run_schedule``,
  ``run_scenario``, ``run_soak``, ``storm_for_chaos`` and ``Runner``
  raise without a GPU unless given ``device="cpu"``, and so do the
  chaos and e2e command lines without ``--device cpu``; the node's
  ``load`` subcommand runs (it needs no device) and no longer raises
  ``NotImplementedError``.
- bftlint (the rest of ``analysis/``), the multi-device lanes
  (``parallel/``) and the two crypto modules of the last slice
  (``crypto/mesh_backend.py``, ``crypto/bls12381.py``) are among the
  modules the probe imports and, imported alone, load neither ``jax``
  nor ``cometbft_tpu``; the linter loads no torch either. With no
  GPU, ``parallel.mesh.make_mesh()`` raises the device error.
"""

import os
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import pytest
import torch

from cometbft_tpu_torch import device as port_device
from cometbft_tpu_torch.crypto import batch
from cometbft_tpu_torch.crypto import coalesce
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.ops import ed25519 as ed
from cometbft_tpu_torch.types import block as B
from cometbft_tpu_torch.types import validation as V
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet
from torch_hard_limit import hard_limit  # noqa: F401

REPO = Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, pkgutil, sys
import cometbft_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith("jax.")
             or m == "cometbft_tpu" or m.startswith("cometbft_tpu."))
print(len(names), bad)
print(" ".join(names))
sys.exit(1 if bad else 0)
"""

# the network slice's modules: each must be among those the probe imports
NETWORK_MODULES = [
    "crypto._ossl", "crypto.x25519", "crypto.chacha20poly1305",
    "p2p", "p2p.key", "p2p.node_info", "p2p.reactor", "p2p.peer", "p2p.transport",
    "p2p.reconnect", "p2p.switch", "p2p.tracewire", "p2p.conn",
    "p2p.conn.secret_connection", "p2p.conn.connection", "utils.backoff",
    "config.config", "mempool.codec", "mempool.ingest", "mempool.mempool",
    "mempool.reactor", "blocksync.net_reactor", "consensus.reactor", "node.node",
    "utils.chaingen", "utils.loop_errors",
    # the RPC and light serving slice
    "utils.pubsub_query", "obs", "obs.queues", "state.indexer", "rpc", "rpc.encoding",
    "rpc.env", "rpc.core", "rpc.fanout", "rpc.server", "rpc.client", "light.serving",
    "light.http_provider", "light.proxy",
    # the statesync slice
    "statesync", "statesync.chunks", "statesync.snapshots", "statesync.syncer",
    "statesync.stateprovider", "statesync.reactor", "store.retention", "state.rollback",
    "node.bootstrap",
    # the fork's network plane
    "lp2p", "lp2p.mux", "lp2p.host", "lp2p.switch", "p2p.pex", "utils.autopool",
    "utils.guard",
    # the operator's node
    "abci.codec", "abci.server", "abci.socket_client", "privval.signer", "rpc.grpc_api",
    "state.psql_sink", "cmd", "cmd.main", "cmd.abci_cli", "__main__",
    # the host's native lanes
    "utils.native", "utils.wirecodec", "utils.logdb", "models.vecbank",
    "state.native_finalize", "crypto.native_verify",
    # the operations plane
    "trace", "trace.tracer", "trace.export", "trace.summary", "trace.timeline", "trace.bridge",
    "trace.cli", "trace.__main__", "obs.watchdog", "obs.shutdown", "obs.profiler", "obs.budget",
    "utils.metrics", "utils.debug",
    # the serving fleet, the runtime sanitizer and the last network pieces
    "fleet", "fleet.follower", "fleet.router", "analysis", "analysis.runtime", "analysis.scaling",
    "p2p.fuzz", "crypto.encoding", "crypto.armor", "crypto.xsalsa20symmetric", "crypto.xchacha20poly1305",
    # chaos and e2e
    "chaos", "chaos.schedule", "chaos.workload", "chaos.generator", "chaos.invariants", "chaos.links",
    "chaos.verify_storm", "chaos.nemesis", "chaos.net", "chaos.matrix", "chaos.soak", "chaos.__main__",
    "e2e", "e2e.manifest", "e2e.generator", "e2e.load", "e2e.runner",
    # bftlint and the multi-device lanes
    "analysis.findings", "analysis.astutil", "analysis.registry", "analysis.suppress",
    "analysis.baseline", "analysis.engine", "analysis.callgraph", "analysis.complexity",
    "analysis.rules", "analysis.rules.async_rules", "analysis.rules.interproc_rules",
    "analysis.rules.complexity_rules", "analysis.rules.finalize_rules", "analysis.rules.trace_rules",
    "analysis.rules.torch_rules", "analysis.cli", "analysis.__main__",
    "parallel", "parallel.mesh", "parallel.sharded_verify", "parallel.dryrun",
    "crypto.mesh_backend", "crypto.bls12381",
]


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 100, proc.stdout
    imported = set(proc.stdout.splitlines()[1].split())
    missing = [m for m in NETWORK_MODULES if f"cometbft_tpu_torch.{m}" not in imported]
    assert not missing, missing


_LANES_PROBE = """
import sys
from cometbft_tpu_torch.crypto import native_verify
from cometbft_tpu_torch.state import native_finalize
from cometbft_tpu_torch.utils import logdb, native, wirecodec
lanes = [native_verify.LANE, wirecodec.LANE, native_finalize.LANE]
mods = [lane.wait() for lane in lanes]
assert all(m is not None for m in mods), [lane.reason for lane in lanes]
assert logdb.available()
maps = open("/proc/self/maps").read().split()
print(sorted({p for p in maps if p.endswith(".so") and any(
    n in p for n in ("_batchverify", "_wirecodec", "_finalize", "liblogdb"))}))
print(sorted(str(lane.path) for lane in lanes) + [str(native.library("logdb"))])
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "cometbft_tpu"))
print(bad)
"""


_SLICE16_PROBE = """
import sys
import cometbft_tpu_torch.fleet, cometbft_tpu_torch.analysis, cometbft_tpu_torch.p2p.fuzz
import cometbft_tpu_torch.crypto.encoding, cometbft_tpu_torch.crypto.armor
import cometbft_tpu_torch.crypto.xsalsa20symmetric, cometbft_tpu_torch.crypto.xchacha20poly1305
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "cometbft_tpu")))
print("torch" in sys.modules)
"""


def test_fleet_analysis_and_fuzz_import_no_jax_and_no_reference_package():
    """``fleet/``, ``analysis/``, ``p2p/fuzz.py`` and the small host
    crypto modules, imported alone in a fresh interpreter, load neither
    ``jax`` nor any ``cometbft_tpu.`` module; ``analysis/`` and
    ``p2p/fuzz.py`` do not load torch either (the sanitizer is
    stdlib, so the light subcommands stay torch-free)."""
    proc = subprocess.run([sys.executable, "-c", _SLICE16_PROBE], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[0] == "[]", proc.stdout
    light = subprocess.run(
        [sys.executable, "-c", "import sys, cometbft_tpu_torch.analysis, cometbft_tpu_torch.p2p.fuzz, "
         "cometbft_tpu_torch.config.config; print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert light.returncode == 0, light.stderr
    assert light.stdout.strip() == "False"


_LAST_SLICE_PROBE = """
import sys
import cometbft_tpu_torch.analysis.cli, cometbft_tpu_torch.analysis.rules.torch_rules
print("torch" in sys.modules)
import cometbft_tpu_torch.parallel.sharded_verify, cometbft_tpu_torch.parallel.dryrun
import cometbft_tpu_torch.crypto.mesh_backend, cometbft_tpu_torch.crypto.bls12381
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "cometbft_tpu")))
"""


def test_last_slice_imports_no_jax_and_no_reference_package(no_gpu):
    proc = subprocess.run([sys.executable, "-c", _LAST_SLICE_PROBE], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines() == ["False", "[]"], proc.stdout
    from cometbft_tpu_torch.parallel.mesh import make_mesh

    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()


_CHAOS_PROBE = """
import sys
import cometbft_tpu_torch.chaos, cometbft_tpu_torch.chaos.soak, cometbft_tpu_torch.chaos.verify_storm
import cometbft_tpu_torch.chaos.__main__
import cometbft_tpu_torch.e2e, cometbft_tpu_torch.e2e.generator, cometbft_tpu_torch.e2e.load
import cometbft_tpu_torch.e2e.runner
print(sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "cometbft_tpu")))
"""


def test_chaos_and_e2e_import_no_jax_and_no_reference_package():
    proc = subprocess.run([sys.executable, "-c", _CHAOS_PROBE], cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.splitlines()[0] == "[]", proc.stdout


def test_native_lanes_load_from_build_native_not_the_jax_cache(tmp_path):
    """All four native libraries load from ``build/native/`` at the
    repository root; none is read from or written to the JAX package's
    ``~/.cache/cometbft_tpu`` (a fresh ``HOME`` stays empty)."""
    env = dict(os.environ, HOME=str(tmp_path))
    proc = subprocess.run([sys.executable, "-c", _LANES_PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    loaded, paths, bad = (eval(line) for line in proc.stdout.splitlines()[-3:])
    build = REPO / "build" / "native"
    want = sorted(str(build / n) for n in ("_batchverify.so", "_finalize.so", "_wirecodec.so",
                                           "liblogdb.so"))
    assert loaded == want and sorted(paths) == want
    assert bad == []
    assert not (tmp_path / ".cache").exists()


def test_p2p_layer_imports_no_higher_layer():
    """The network's lowest layer stands alone: importing ``p2p``
    loads no reactor, state machine, store or node module."""
    probe = (
        "import sys, cometbft_tpu_torch.p2p\n"
        "print(sorted(m for m in sys.modules if m.split('.')[:2] in ("
        "['cometbft_tpu_torch', 'blocksync'], ['cometbft_tpu_torch', 'consensus'], "
        "['cometbft_tpu_torch', 'mempool'], ['cometbft_tpu_torch', 'node'], "
        "['cometbft_tpu_torch', 'state'], ['cometbft_tpu_torch', 'store'])))"
    )
    proc = subprocess.run(
        [sys.executable, "-c", probe], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]", proc.stdout


def test_entry_points_raise_without_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    item = [(b"m", bytes(32), bytes(64))]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_device.resolve(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ed.verify_batch(item)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.create_batch_verifier()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        V.verify_commits_coalesced("c", [(None, None, 1, None)])
    assert port_device.resolve("cpu") == torch.device("cpu")
    # zero key and zero R are small-order points: valid under ZIP-215
    assert ed.verify_batch(item, device="cpu").tolist() == [True]


@pytest.fixture
def no_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    old = batch.default_backend()
    yield
    batch.set_default_backend(old)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def test_dispatch_layer_raises_without_a_gpu(no_gpu):
    p = Ed25519PrivKey.from_seed(bytes(32))
    lane = [(p.pub_key(), b"m", p.sign(b"m"))]
    s = sched_mod.VerifyScheduler()
    try:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.submit(lane)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            s.submit([])
        assert s.submit(lane, device="cpu").result(timeout=30) == (True, [True])
    finally:
        s.close()
    batch.set_default_backend("cpu-parallel")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        batch.create_batch_verifier()
    v = batch.create_batch_verifier(device="cpu")
    v.add(*lane[0])
    assert v.verify() == (True, [True])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        coalesce.CoalescingVerifier()


def test_new_validation_entry_points_raise_without_a_gpu(no_gpu):
    p = Ed25519PrivKey.from_seed(bytes(range(32)))
    vals = ValidatorSet([Validator(p.pub_key(), 10)])
    commit = B.Commit(1, 0, B.BlockID(b"h" * 32), [B.CommitSig.absent()])
    ec = B.ExtendedCommit(1, 0, B.BlockID(b"h" * 32), [B.ExtendedCommitSig()])
    calls = [
        (V.verify_commit_light_trusting, ("c", vals, commit)),
        (V.verify_commit_jobs_coalesced, ("c", [("trusting", vals, commit, Fraction(1, 3))])),
        (V.verify_extended_commit, ("c", vals, b"h" * 32, 1, ec)),
    ]
    for fn, args in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            fn(*args)
    # on the CPU they run: an absent-only commit tallies nothing
    with pytest.raises(V.ErrNotEnoughVotingPower):
        V.verify_commit_light_trusting("c", vals, commit, device="cpu")
    assert V.verify_commit_jobs_coalesced("c", calls[1][1][1], device="cpu")[0] is not None
    with pytest.raises(V.ErrNotEnoughVotingPower):
        V.verify_extended_commit("c", vals, b"h" * 32, 1, ec, device="cpu")


def test_replay_entry_points_raise_without_a_gpu(no_gpu):
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.utils.chaingen import make_chain

    gen, privs = make_genesis(2, chain_id="iso")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_node(gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_chain(gen, privs, 2)
    src = make_chain(gen, privs, 3, device="cpu")
    node = build_node(gen, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockSyncReactor(node.state, node.block_exec, node.block_store)
    gpu_exec = BlockExecutor(node.state_store, node.proxy.consensus, node.mempool)
    block2 = src.block_store.load_block(2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpu_exec.validate_block(src.state_store.load(), block2)
    # on the CPU the same checks run: block 1 against the genesis state
    # passes, block 2 against it does not
    node.block_exec.validate_block(node.state, src.block_store.load_block(1))
    with pytest.raises(ValueError, match="wrong height"):
        node.block_exec.validate_block(node.state, block2)
    r = BlockSyncReactor(node.state, node.block_exec, node.block_store, device="cpu")
    assert r.device == torch.device("cpu")


def test_light_entry_points_raise_without_a_gpu(no_gpu):
    from cometbft_tpu_torch.light import Client, StoreBackedProvider, TrustOptions, verifier
    from cometbft_tpu_torch.light.detector import check_against_witnesses
    from cometbft_tpu_torch.node.inprocess import make_genesis
    from cometbft_tpu_torch.utils.chaingen import make_chain

    gen, privs = make_genesis(2, chain_id="iso-light")
    src = make_chain(gen, privs, 4, device="cpu")
    provider = StoreBackedProvider(gen.chain_id, src.block_store, src.state_store)
    lb1, lb2, lb4 = (provider.light_block(h) for h in (1, 2, 4))
    opts = TrustOptions(period_ns=10**18, height=1, hash=lb1.hash())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Client(gen.chain_id, opts, provider)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verifier.verify_adjacent(gen.chain_id, lb1, lb2, lb2.validator_set, 10**18)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        verifier.verify_non_adjacent(gen.chain_id, lb1, lb1.validator_set, lb4,
                                     lb4.validator_set, 10**18)
    client = Client(gen.chain_id, opts, provider, witnesses=[provider], device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        check_against_witnesses(client, lb4)
    # on the CPU they run
    verifier.verify_adjacent(gen.chain_id, lb1, lb2, lb2.validator_set, 10**18, device="cpu")
    verifier.verify_non_adjacent(gen.chain_id, lb1, lb1.validator_set, lb4, lb4.validator_set,
                                 10**18, device="cpu")
    check_against_witnesses(client, lb4, device="cpu")
    assert client.verify_light_block_at_height(4).hash() == lb4.hash()
    assert client.witnesses == [provider]


def test_consensus_entry_points_raise_without_a_gpu(no_gpu, tmp_path):
    import asyncio

    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.consensus.state import ConsensusState
    from cometbft_tpu_torch.node.inprocess import build_node, make_genesis, make_privvals
    from cometbft_tpu_torch.utils.chaingen import StorePeerClient, make_chain

    gen, privs = make_genesis(2, chain_id="iso-cs")
    pvs = make_privvals(privs, root=str(tmp_path))
    cfg = make_test_cfg(str(tmp_path))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_node(gen, privval=pvs[0], config=cfg, home=str(tmp_path), wal=True)
    node = build_node(gen, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ConsensusState(cfg.consensus, node.state, node.block_exec, node.block_store, node.mempool)
    assert node.cs.device == torch.device("cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BlockSyncReactor(node.state, node.block_exec, node.block_store, block_ingestor=node.cs)
    # on the CPU the ingestor path runs: every block through consensus
    src = make_chain(gen, privs, 6, device="cpu")

    async def main():
        await node.cs.start()
        ingested = []
        real = node.cs.ingest_verified_block
        node.cs.ingest_verified_block = lambda b, p, c: (ingested.append(b.height), real(b, p, c))[1]
        caught = asyncio.Event()
        r = BlockSyncReactor(node.state, node.block_exec, node.block_store,
                             on_caught_up=lambda st: caught.set(), block_ingestor=node.cs,
                             device="cpu")
        r.pool.set_peer_range("src", StorePeerClient(src), 1, 6)
        await r.start()
        await asyncio.wait_for(caught.wait(), 60)
        await r.stop()
        await node.cs.stop()
        return ingested, r

    ingested, r = asyncio.run(asyncio.wait_for(main(), 90))
    assert ingested == list(range(1, len(ingested) + 1)) and len(ingested) >= 4
    assert node.cs.rs.height == ingested[-1] + 1 and r.loop_errors.count == 0
    assert node.block_store.load_block_meta(4).block_id == src.block_store.load_block_meta(4).block_id


def test_node_raises_without_a_gpu_and_takes_its_device(no_gpu):
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node

    gen, privs = make_genesis(2, chain_id="iso-node")
    cfg = make_test_cfg(".")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Node(cfg, gen)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Node(cfg, gen, privval=make_privvals(privs)[0])
    node = Node(cfg, gen, device="cpu")
    cpu = torch.device("cpu")
    assert node.device == cpu and node.parts.cs.device == cpu
    assert node.consensus_reactor.vote_verifier.device == cpu
    assert node.blocksync_reactor.inner.device == cpu
    node.parts.close_stores()


def _served(node, section, name):
    """What the node serves for an operations-plane setting: the
    metrics page or the debug server's stack dump."""
    import urllib.request

    if name == "prometheus":
        url = f"http://{node.metrics_server.listen_addr}/metrics"
    else:
        url = f"http://{node.debug_server.listen_addr}/debug/pprof/stacks"
    with urllib.request.urlopen(url, timeout=30) as f:
        return f.status, f.read().decode()


@pytest.mark.parametrize(
    "section, name, value, item",
    [
        ("instrumentation", "prometheus", True, "A10"),
        ("instrumentation", "pprof_laddr", "127.0.0.1:0", "A10"),
    ],
)
def test_node_refuses_settings_it_does_not_have(section, name, value, item):
    """The settings the port once refused, naming ROADMAP A10, now
    build a node that serves them: the metrics page or the debug
    server's stacks, on a Node that starts and stops on the CPU."""
    import asyncio

    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis
    from cometbft_tpu_torch.node.node import Node

    gen, _ = make_genesis(1, chain_id="iso-cut")
    cfg = make_test_cfg(".")
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    setattr(getattr(cfg, section), name, value)
    node = Node(cfg, gen, device="cpu")

    async def main():
        await node.start()
        try:
            return await asyncio.to_thread(_served, node, section, name)
        finally:
            await node.stop()

    status, body = asyncio.run(asyncio.wait_for(main(), 60))
    assert status == 200
    assert ('cometbft_p2p_peers{chain_id="iso-cut"}' in body) if name == "prometheus" else ("--- thread" in body)


@pytest.mark.parametrize(
    "section, name",
    [
        ("p2p", "external_address"), ("p2p", "max_num_inbound_peers"),
        ("p2p", "max_packet_msg_payload_size"),
        ("p2p", "handshake_timeout_s"), ("p2p", "dial_timeout_s"),
        ("mempool", "max_txs_bytes"),
        ("instrumentation", "prometheus_listen_addr"),
        ("storage", "discard_abci_responses"),
    ],
)
def test_config_takes_no_setting_the_port_ignores(section, name):
    """A JAX setting that nothing in the port reads is not in the
    port's config, and setting it raises rather than doing nothing.
    ``prometheus_listen_addr`` is read now: the metrics server binds
    where it says."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg

    cfg = make_test_cfg(".")
    if (section, name) == ("instrumentation", "prometheus_listen_addr"):
        import asyncio
        import socket

        from cometbft_tpu_torch.node.inprocess import make_genesis
        from cometbft_tpu_torch.node.node import Node

        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        cfg.instrumentation.prometheus = True
        cfg.instrumentation.prometheus_listen_addr = f"127.0.0.1:{port}"
        node = Node(cfg, make_genesis(1, chain_id="iso-bind")[0], device="cpu")

        async def main():
            await node.start()
            try:
                return node.metrics_server.listen_addr
            finally:
                await node.stop()

        assert asyncio.run(asyncio.wait_for(main(), 60)) == f"127.0.0.1:{port}"
        return
    with pytest.raises(AttributeError):
        setattr(getattr(cfg, section), name, 1)


SEED_ADDR = "ab" * 20 + "@127.0.0.1:26656"


def _fork_setting_took(node, setting):
    from cometbft_tpu_torch.lp2p import Lp2pSwitch
    from cometbft_tpu_torch.mempool.mempool import AppMempool, NopMempool
    from cometbft_tpu_torch.mempool.reactor import AppMempoolReactor
    from cometbft_tpu_torch.p2p.pex import PexReactor
    from cometbft_tpu_torch.utils.autopool import AutoPool

    if setting == "lp2p":
        return isinstance(node.switch, Lp2pSwitch)
    if setting == "pex":
        return isinstance(node.switch.reactor("pex"), PexReactor) and node.switch.addr_book is node.addr_book
    if setting == "seeds":
        return node.addr_book.addrs["ab" * 20].addr == SEED_ADDR
    if setting == "seed_mode":
        return node.pex_reactor.seed_mode
    if setting == "autopool":
        return isinstance(node.switch.autopool, AutoPool)
    if setting == "app":
        return isinstance(node.parts.mempool, AppMempool) and isinstance(node.mempool_reactor, AppMempoolReactor)
    return isinstance(node.parts.mempool, NopMempool) and node.mempool_reactor.mempool is node.parts.mempool


@pytest.mark.parametrize(
    "section, name, value, setting",
    [
        ("p2p", "use_libp2p_equivalent", True, "lp2p"),
        ("p2p", "pex", True, "pex"),
        ("p2p", "seeds", SEED_ADDR, "seeds"),
        ("p2p", "seed_mode", True, "seed_mode"),
        ("p2p", "use_autopool", True, "autopool"),
        ("mempool", "type_", "app", "app"),
        ("mempool", "type_", "nop", "nop"),
    ],
)
def test_node_takes_the_fork_network_settings(section, name, value, setting):
    """The settings the port once refused, naming A8, now build and run:
    each takes its plane, on a Node that starts and stops on the CPU."""
    import asyncio

    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis
    from cometbft_tpu_torch.node.node import Node

    gen, _ = make_genesis(1, chain_id="iso-fork")
    cfg = make_test_cfg(".")
    setattr(getattr(cfg, section), name, value)
    node = Node(cfg, gen, device="cpu")

    async def main():
        await node.start()
        try:
            return _fork_setting_took(node, setting)
        finally:
            await node.stop()

    assert asyncio.run(asyncio.wait_for(main(), 60))


def _config_sections():
    import dataclasses

    from cometbft_tpu_torch.config.config import Config

    return [f.name for f in dataclasses.fields(Config) if f.name != "root_dir"]


@pytest.mark.parametrize("section", _config_sections())
@pytest.mark.parametrize("make", ["default_config", "test_config"])
def test_config_defaults_equal_jax(make, section):
    """Every field of the port's config defaults to the JAX package's
    value, apart from rpc.laddr (ROADMAP C10)."""
    import dataclasses

    from cometbft_tpu.config import config as jconfig
    from cometbft_tpu_torch.config import config as pconfig

    port = getattr(getattr(pconfig, make)("."), section)
    jax = getattr(getattr(jconfig, make)("."), section)
    fields = [f.name for f in dataclasses.fields(port)]
    assert fields
    differ = {n: (getattr(port, n), getattr(jax, n)) for n in fields if getattr(port, n) != getattr(jax, n)}
    if section == "rpc":
        assert differ == {"laddr": ("", jax.laddr)}
    else:
        assert differ == {}


def test_serving_entry_points_raise_without_a_gpu(no_gpu):
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.light import Client, LightServingPlane, StoreBackedProvider, TrustOptions
    from cometbft_tpu_torch.light.serving import CoalescedCommitVerifier
    from cometbft_tpu_torch.node.inprocess import make_genesis
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.utils.chaingen import make_chain

    gen, privs = make_genesis(2, chain_id="iso-serve")
    src = make_chain(gen, privs, 3, device="cpu")
    provider = StoreBackedProvider(gen.chain_id, src.block_store, src.state_store)
    client = Client(gen.chain_id, TrustOptions(10**18, 1, provider.light_block(1).hash()), provider,
                    device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LightServingPlane([client])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CoalescedCommitVerifier(gen.chain_id)
    # on the CPU the plane serves, its engine on the CPU
    plane = LightServingPlane([client], device="cpu")
    assert plane.engine.device == torch.device("cpu")
    assert plane.serve(3).hash() == provider.light_block(3).hash()
    # a Node with rpc.laddr builds (it serves once started)
    cfg = make_test_cfg(".")
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    node = Node(cfg, gen, device="cpu")
    assert node.rpc_server is None and "rpc.fanout" in node.queues.names()
    node.parts.close_stores()


def test_statesync_entry_points_raise_without_a_gpu(no_gpu):
    """The state provider and offline bootstrap take their device; a
    Node with statesync.enable builds on the CPU and starts its restore
    with its provider on the node's device."""
    import asyncio

    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.bootstrap import bootstrap_state
    from cometbft_tpu_torch.node.inprocess import make_genesis
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.statesync.stateprovider import LightClientStateProvider

    gen, _ = make_genesis(1, chain_id="iso-ss")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LightClientStateProvider(gen.chain_id, ["127.0.0.1:1"], 1, b"\0" * 32, 10**15)
    cfg = make_test_cfg(".")
    cfg.statesync.enable = True
    cfg.statesync.rpc_servers = ["127.0.0.1:1"]
    cfg.statesync.trust_height = 1
    cfg.statesync.trust_hash = "ab" * 32
    cfg.statesync.discovery_time_s = 1.0
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bootstrap_state(cfg, gen, ".", 1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Node(cfg, gen)
    node = Node(cfg, gen, device="cpu")
    assert node.statesync_reactor.enabled and not node.blocksync_reactor.active
    assert "store.retention" in node.queues.names()

    async def main():
        await node.start()
        for _ in range(400):
            if node.statesync_error is not None:
                break
            await asyncio.sleep(0.05)
        await node.stop()

    asyncio.run(asyncio.wait_for(main(), 60))
    # nothing listens there: the sync failed, it was not refused
    assert node.statesync_error is not None
    assert not isinstance(node.statesync_error, NotImplementedError)


def test_the_command_line_imports_no_jax():
    """``python -m cometbft_tpu_torch --help`` in a fresh interpreter
    loads neither jax nor the JAX package."""
    probe = (
        "import runpy, sys\n"
        "sys.argv = ['cometbft_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('cometbft_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'cometbft_tpu'))\n"
        "print('BAD', bad)\n"
    )
    proc = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "BAD []" in proc.stdout, proc.stdout + proc.stderr
    assert "--device" in proc.stdout and "start" in proc.stdout


def test_start_without_a_gpu_exits_with_the_device_error(no_gpu, tmp_path):
    """On a machine without a GPU, ``start`` without ``--device cpu`` exits
    non-zero with the device error; the node never starts and no block
    is stored."""
    home = str(tmp_path / "home")
    cli = [sys.executable, "-m", "cometbft_tpu_torch", "--home", home]
    subprocess.run(cli + ["init"], cwd=REPO, check=True, capture_output=True, timeout=120)
    proc = subprocess.run(cli + ["start"], cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device available" in proc.stderr and "--device cpu" in proc.stderr, proc.stderr
    assert "started" not in proc.stdout + proc.stderr
    assert not any(name.endswith(".db") for name in os.listdir(os.path.join(home, "data")))


def test_chaos_and_e2e_entry_points_raise_without_a_gpu(no_gpu, tmp_path):
    import asyncio

    from cometbft_tpu_torch.chaos import ChaosNet, default_schedule, generate_scenario, run_scenario, run_schedule
    from cometbft_tpu_torch.chaos.soak import run_soak
    from cometbft_tpu_torch.chaos.verify_storm import storm_for_chaos
    from cometbft_tpu_torch.e2e.manifest import Manifest
    from cometbft_tpu_torch.e2e.runner import Runner

    m = Manifest.from_dict({"node": {"v0": {"mode": "validator"}}})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ChaosNet(4, 1, str(tmp_path / "a"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(run_schedule(default_schedule(), seed=1, base_dir=str(tmp_path / "b")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asyncio.run(run_scenario(generate_scenario(1337, 0), base_dir=str(tmp_path / "c")))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_soak(heights=1, step=1, home=str(tmp_path / "d"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        storm_for_chaos(storm_s=0.1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Runner(m, str(tmp_path / "e"))
    # on the CPU device they build
    net = ChaosNet(2, 1, str(tmp_path / "f"), device="cpu")
    assert net.device == torch.device("cpu") and len(net.nodes) == 2
    assert Runner(m, str(tmp_path / "g"), device="cpu").device == "cpu"


@pytest.mark.parametrize(
    "argv",
    [
        ["-m", "cometbft_tpu_torch.chaos", "--seed", "1"],
        ["-m", "cometbft_tpu_torch.chaos", "matrix", "--seed", "1", "--count", "1"],
        ["-m", "cometbft_tpu_torch.chaos", "soak", "--heights", "1"],
        ["-m", "cometbft_tpu_torch.e2e.runner", "MANIFEST"],
    ],
    ids=["chaos", "matrix", "soak", "e2e"],
)
def test_chaos_and_e2e_command_lines_exit_with_the_device_error(no_gpu, tmp_path, argv):
    manifest = tmp_path / "m.toml"
    manifest.write_text('[node.v0]\nmode = "validator"\n')
    argv = [str(manifest) if a == "MANIFEST" else a for a in argv]
    if "e2e.runner" in argv[1]:
        argv += ["--dir", str(tmp_path / "net")]
    proc = subprocess.run([sys.executable] + argv, cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "no CUDA device available" in proc.stderr and "--device cpu" in proc.stderr, proc.stderr
    assert not (tmp_path / "net").exists()


def test_load_subcommand_is_ported():
    """``load`` runs ``LoadGenerator`` and ``latency_report`` (it needs
    no device); with no node to talk to it exits 1 with the connection
    error, not ``NotImplementedError``."""
    from cometbft_tpu_torch.cmd import main as cmd_main

    assert not hasattr(cmd_main, "cmd_unported")
    args = cmd_main.build_parser().parse_args(["load", "--rpc-laddr", "127.0.0.1:1", "-T", "0.1"])
    assert args.fn is cmd_main.cmd_load
    assert not getattr(args.fn, "_reaches_device", False)
    proc = subprocess.run(
        [sys.executable, "-m", "cometbft_tpu_torch", "load", "--rpc-laddr", "127.0.0.1:1", "-T", "0.1"],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "NotImplementedError" not in proc.stderr and "not ported" not in proc.stderr, proc.stderr
    assert proc.stderr.startswith("Error:"), proc.stderr
