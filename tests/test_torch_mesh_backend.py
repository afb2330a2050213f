"""The port's "mesh" backend and the scheduler's mesh branch, held to the
mesh cases of ``tests/test_verify_scheduler.py``.

- route: with a card, a "mesh" ticket dispatches its ed25519 lanes to
  its device once, with no calibration gate; the other curves verify
  on the host. One card takes the lanes: the JAX package degrades with
  fewer than two devices, the port only with none;
- degrade without a card: the ticket's backend is "mesh-degraded",
  ``degraded`` counts it, and its lanes take the host plane with the
  serial verdicts, as in the JAX package without a mesh;
- a failed mesh dispatch: the JAX scheduler degrades to host chunks
  (``test_mesh_degrades_on_dispatch_failure``); the port's ticket
  raises ``DeviceRouteError`` with no host verdict filled in (C3), and
  so does ``MeshBatchVerifier``;
- host parity and registration of ``MeshBatchVerifier``.

Beside them, one ticket runs the real route: the lanes split over
eight CPU entries (``parallel/mesh.mesh_for`` standing in for eight
cards), each running the kernels' plain versions.
"""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import mesh_backend as jmesh
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import mesh_backend as mesh_mod
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.batch import CpuBatchVerifier
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey, Secp256k1PrivKey
from cometbft_tpu_torch.crypto.mesh_backend import MeshBatchVerifier
from cometbft_tpu_torch.crypto.scheduler import (
    PRIORITY_CATCHUP,
    PRIORITY_LIVE,
    DeviceRouteError,
    VerifyScheduler,
)
from cometbft_tpu_torch.ops import ed25519 as ops_ed
from cometbft_tpu_torch.parallel import mesh as pmesh
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")
_RNG = np.random.default_rng(505)
_ED_KEYS = [Ed25519PrivKey.from_seed(_RNG.bytes(32)) for _ in range(8)]
_SECP_KEYS = [Secp256k1PrivKey(int.from_bytes(_RNG.bytes(31), "big") + 1) for _ in range(2)]
_PUBS = {id(k): k.pub_key() for k in _ED_KEYS + _SECP_KEYS}


def make_items(n, bad=(), mixed=False):
    items = []
    for i in range(n):
        sk = _SECP_KEYS[i % 2] if mixed and i % 5 == 4 else _ED_KEYS[i % 8]
        msg = b"sched-lane-%d" % i
        sig = sk.sign(msg)
        if i in bad:
            sig = b"\x00" * len(sig)
        items.append((_PUBS[id(sk)], msg, sig))
    return items


def serial_verdicts(items):
    v = CpuBatchVerifier()
    for pk, msg, sig in items:
        v.add(pk, msg, sig)
    return v.verify()


class FakeHandle:
    """A device handle whose verdicts are the serial ones."""

    def __init__(self, ed_items):
        self.verdicts = [_verify(m, pk, s) for m, pk, s in ed_items]

    def wait(self):
        return self

    def result(self):
        return np.asarray(self.verdicts, bool)


def _verify(m, pk, sig):
    from cometbft_tpu_torch.crypto import ref_ed25519 as ref

    return ref.verify_zip215(pk, m, sig)


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield eng
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


@pytest.fixture
def sched():
    s = VerifyScheduler()
    yield s
    s.close()


@pytest.fixture
def restore_routing():
    old_backend = crypto_batch.default_backend()
    old_floor = crypto_batch._MIN_DEVICE_BATCH
    yield
    crypto_batch.set_default_backend(old_backend)
    crypto_batch.set_min_device_batch(old_floor)


@pytest.mark.parametrize("cards", [1, 8])
def test_mesh_route_dispatches_device(sched, restore_routing, monkeypatch, cards):
    crypto_batch.set_default_backend("mesh")
    crypto_batch.set_min_device_batch(1)
    monkeypatch.setattr(mesh_mod, "mesh_devices", lambda: cards)
    dispatched = []

    def fake_async(ed_items, device=None):
        dispatched.append((len(ed_items), device))
        return FakeHandle(ed_items)

    monkeypatch.setattr(ops_ed, "verify_batch_async", fake_async)
    items = make_items(16, bad={7}, mixed=True)
    want = serial_verdicts(items)
    t = sched.submit(items, priority=PRIORITY_LIVE, label="mesh", device="cpu")
    assert t.result(timeout=30) == want
    assert t.backend == "mesh"
    n_ed = sum(1 for pk, _, _ in items if pk.type_ == "ed25519")
    assert dispatched == [(n_ed, CPU)]
    assert sched.device_dispatches == 1 and sched.degraded == 0


def test_mesh_degrades_without_mesh(sched, restore_routing, monkeypatch):
    crypto_batch.set_default_backend("mesh")
    crypto_batch.set_min_device_batch(1)
    monkeypatch.setattr(mesh_mod, "mesh_devices", lambda: 0)

    def boom(ed_items, device=None):  # pragma: no cover - must never be reached
        raise AssertionError("degraded route must not touch the device")

    monkeypatch.setattr(ops_ed, "verify_batch_async", boom)
    items = make_items(12, bad={4})
    want = serial_verdicts(items)
    t = sched.submit(items, priority=PRIORITY_CATCHUP, label="degrade", device="cpu")
    assert t.result(timeout=30) == want
    assert t.backend == "mesh-degraded"
    assert sched.degraded == 1
    assert sched.device_dispatches == 0


def test_mesh_dispatch_failure_raises_device_route_error(sched, restore_routing, monkeypatch):
    """The JAX ticket degrades to host chunks here; the port's raises
    (C3) and no lane holds a host verdict."""
    crypto_batch.set_default_backend("mesh")
    crypto_batch.set_min_device_batch(1)
    monkeypatch.setattr(mesh_mod, "mesh_devices", lambda: 8)

    def boom(ed_items, device=None):
        raise RuntimeError("no card for you")

    monkeypatch.setattr(ops_ed, "verify_batch_async", boom)
    items = make_items(10, bad={0})
    t = sched.submit(items, priority=PRIORITY_LIVE, device="cpu")
    with pytest.raises(DeviceRouteError) as ei:
        t.result(timeout=30)
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert t.backend == "mesh"
    assert sched.degraded == 1
    assert t.oks == [False] * 10


def test_mesh_route_runs_the_plain_kernels_over_eight_entries(sched, restore_routing, monkeypatch):
    crypto_batch.set_default_backend("mesh")
    crypto_batch.set_min_device_batch(1)
    monkeypatch.setattr(mesh_mod, "mesh_devices", lambda: 8)
    monkeypatch.setattr(pmesh, "mesh_for", lambda device: [CPU] * 8)
    items = make_items(16, bad={3, 11}, mixed=True)
    want = serial_verdicts(items)
    t = sched.submit(items, priority=PRIORITY_LIVE, device="cpu")
    assert t.result(timeout=60) == want
    d = ops_ed.LAST_DISPATCH
    assert d["sharded"] is True and d["n_devices"] == 8 and d["lanes"] % 8 == 0


@pytest.mark.parametrize("cards", [0, 8])
def test_mesh_backend_verifier_host_parity(restore_routing, monkeypatch, cards):
    """Without a card, or with cards below the floor, MeshBatchVerifier
    verifies on the host plane with the serial verdicts."""
    monkeypatch.setattr(mesh_mod, "mesh_devices", lambda: cards)
    crypto_batch.set_min_device_batch(1 if not cards else 64)

    def boom(ed_items, device=None):  # pragma: no cover - must never be reached
        raise AssertionError("the host route must not touch the device")

    monkeypatch.setattr(ops_ed, "verify_batch_async", boom)
    items = make_items(8, bad={2}, mixed=True)
    want = serial_verdicts(items)
    v = MeshBatchVerifier(device="cpu")
    for pk, msg, sig in items:
        v.add(pk, msg, sig)
    assert v.verify() == want
    # the JAX verifier on the same lanes, no mesh there either
    jv = jmesh.MeshBatchVerifier()
    for pk, msg, sig in items:
        cls = jkeys.Ed25519PubKey if pk.type_ == "ed25519" else jkeys.Secp256k1PubKey
        jv.add(cls(pk.key_bytes), msg, sig)
    assert jv.verify() == want


def test_mesh_backend_registered(restore_routing):
    assert "mesh" in crypto_batch.backends()
    crypto_batch.set_default_backend("mesh")
    assert isinstance(crypto_batch.create_batch_verifier(device="cpu"), MeshBatchVerifier)


@pytest.mark.parametrize("cards", [1, 8])
def test_mesh_backend_device_path(restore_routing, monkeypatch, cards):
    """With a card the lanes go to the verifier's device, which
    ``ops/ed25519`` splits over every card when there are more."""
    crypto_batch.set_min_device_batch(1)
    monkeypatch.setattr(mesh_mod, "mesh_devices", lambda: cards)
    meshes = []

    def fake_async(ed_items, device=None):
        meshes.append(device)
        return FakeHandle(ed_items)

    monkeypatch.setattr(ops_ed, "verify_batch_async", fake_async)
    items = make_items(16, bad={9}, mixed=True)
    want = serial_verdicts(items)
    v = MeshBatchVerifier(device="cpu")
    for pk, msg, sig in items:
        v.add(pk, msg, sig)
    assert v.verify() == want
    assert meshes == [CPU]


def test_mesh_backend_raises_on_kernel_error(restore_routing, monkeypatch):
    """The JAX verifier degrades to the host here; the port's raises."""
    crypto_batch.set_min_device_batch(1)
    monkeypatch.setattr(mesh_mod, "mesh_devices", lambda: 8)

    def boom(ed_items, device=None):
        raise RuntimeError("mesh fell over")

    monkeypatch.setattr(ops_ed, "verify_batch_async", boom)
    v = MeshBatchVerifier(device="cpu")
    for pk, msg, sig in make_items(8, bad={3}):
        v.add(pk, msg, sig)
    with pytest.raises(DeviceRouteError):
        v.verify()

    class FailsLate(FakeHandle):
        def result(self):
            raise RuntimeError("verdict copy failed")

    monkeypatch.setattr(ops_ed, "verify_batch_async", lambda ed_items, device=None: FailsLate(ed_items))
    with pytest.raises(DeviceRouteError):
        v.verify()
