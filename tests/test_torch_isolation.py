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
  ``device="cpu"``, and its reactors take its device. The settings
  whose planes the port lacks (lp2p, PEX, statesync, RPC, the app
  mempool, the autopool, the metrics and debug servers) make ``Node``
  raise ``NotImplementedError`` naming the ROADMAP item.
"""

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


@pytest.mark.parametrize(
    "section, name, value, item",
    [
        ("p2p", "use_libp2p_equivalent", True, "A8"),
        ("p2p", "pex", True, "A8"),
        ("p2p", "seeds", "id@127.0.0.1:26656", "A8"),
        ("p2p", "use_autopool", True, "A8"),
        ("statesync", "enable", True, "A8"),
        ("rpc", "laddr", "tcp://127.0.0.1:26657", "A8"),
        ("rpc", "grpc_laddr", "127.0.0.1:9090", "A8"),
        ("mempool", "type_", "app", "A8"),
        ("instrumentation", "prometheus", True, "A10"),
        ("instrumentation", "pprof_laddr", "127.0.0.1:6060", "A10"),
    ],
)
def test_node_refuses_settings_it_does_not_have(section, name, value, item):
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis
    from cometbft_tpu_torch.node.node import Node

    gen, _ = make_genesis(1, chain_id="iso-cut")
    cfg = make_test_cfg(".")
    setattr(getattr(cfg, section), name, value)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        Node(cfg, gen, device="cpu")


@pytest.mark.parametrize(
    "section, name",
    [
        ("p2p", "external_address"), ("p2p", "max_num_inbound_peers"),
        ("p2p", "max_num_outbound_peers"), ("p2p", "max_packet_msg_payload_size"),
        ("p2p", "handshake_timeout_s"), ("p2p", "dial_timeout_s"),
        ("mempool", "max_txs_bytes"), ("mempool", "async_recheck"),
        ("instrumentation", "prometheus_listen_addr"),
    ],
)
def test_config_takes_no_setting_the_port_ignores(section, name):
    """A JAX setting that nothing in the port reads is not in the
    port's config, and setting it raises rather than doing nothing."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg

    cfg = make_test_cfg(".")
    with pytest.raises(AttributeError):
        setattr(getattr(cfg, section), name, 1)
