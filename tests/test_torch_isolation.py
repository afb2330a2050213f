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
  ``detector.check_against_witnesses``.
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
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_reference_package():
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, capture_output=True,
        text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    assert n_modules >= 67, proc.stdout


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
    with pytest.raises(NotImplementedError, match="ingestor"):
        BlockSyncReactor(node.state, node.block_exec, node.block_store,
                         block_ingestor=object(), device="cpu")
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
