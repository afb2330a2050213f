"""Port verdicts vs the JAX verify cores and the ZIP-215 oracle.

``ops.ed25519.verify_batch(items, device="cpu")`` (the plain versions
of K1-K3) against ``jax.jit(ed._verify_core)`` and
``_verify_core_precomp`` in compact mode, and against
``ref_ed25519.verify_zip215``. Exact: identical verdicts per lane.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import ed25519 as jed
from cometbft_tpu.ops import fe25519 as jfe
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.ops import ed25519 as ed
from torch_hard_limit import hard_limit  # noqa: F401

# the plain versions run many small torch ops: one intra-op thread per
# test process, so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

P = ref.P


@pytest.fixture
def compact():
    jfe.set_compact(True)
    try:
        yield
    finally:
        jfe.set_compact(None)


def _cases():
    rng = np.random.default_rng(42)
    good = []
    for i in range(6):
        k = Ed25519PrivKey.from_seed(rng.bytes(32))
        m = rng.bytes([0, 10, 47, 100, 175, 300][i])  # mixed lengths
        good.append((m, k.pub_key().key_bytes, k.sign(m)))
    items = list(good)
    m, pk, sig = good[0]
    items.append((m, pk, bytes([sig[0] ^ 1]) + sig[1:]))           # tampered R
    m, pk, sig = good[1]
    items.append((m, pk, sig[:40] + bytes([sig[40] ^ 2]) + sig[41:]))  # tampered S
    m, pk, sig = good[2]
    s_big = (int.from_bytes(sig[32:], "little") + ref.L) % 2**256
    items.append((m, pk, sig[:32] + s_big.to_bytes(32, "little")))   # S >= L
    m, pk, sig = good[3]
    items.append((m + b"!", pk, sig))                                # wrong message
    ident = ref.point_compress(ref.IDENTITY)
    items.append((b"whatever", ident, ident + b"\x00" * 32))         # identity key
    items.append((b"msg", (P - 1).to_bytes(32, "little"), ident + b"\x00" * 32))  # order 2
    items.append((b"m2", (P + 1).to_bytes(32, "little"), ident + b"\x00" * 32))   # y >= p
    items.append((b"m3", (2).to_bytes(32, "little"), good[4][2]))    # key off the curve
    return items


MALFORMED = [(b"short sig", bytes(32), bytes(63)), (b"short key", bytes(31), bytes(64))]


def _jax_verdicts(items, precomp):
    """The JAX cores on the same packing as JAX verify_batch_async."""
    n = len(items)
    cap = jed.bucket_cap(max(len(m) for m, _, _ in items))
    msgs = np.zeros((cap, n), np.uint8)
    lens = np.zeros(n, np.int32)
    arrs = [np.zeros((32, n), np.uint8) for _ in range(3)]
    a_arr = np.zeros((4, jfe.NLIMBS, n), np.int32)
    bad = np.zeros(n, bool)
    for i, (m, pk, sig) in enumerate(items):
        msgs[: len(m), i] = np.frombuffer(m, np.uint8)
        lens[i] = len(m)
        for arr, b in zip(arrs, (pk, sig[:32], sig[32:])):
            arr[:, i] = np.frombuffer(b, np.uint8)
        if precomp:
            A = jed._expand_pubkey(pk)
            if A is None:
                bad[i] = True
            else:
                a_arr[:, :, i] = A
    args = [jnp.asarray(msgs), jnp.asarray(lens)]
    if precomp:
        out = jax.jit(jed._verify_core_precomp)(*args, jnp.asarray(a_arr), *map(jnp.asarray, arrs))
    else:
        out = jax.jit(jed._verify_core)(*args, *map(jnp.asarray, arrs))
    out = np.array(out)
    out[bad] = False
    return out.tolist()


@pytest.mark.parametrize("precomp", [False, True], ids=["plain", "precomp"])
def test_verdicts_match_jax_core_and_oracle(compact, precomp):
    items = _cases()
    got = ed.verify_batch(items + MALFORMED, device="cpu", precomp=precomp).tolist()
    want = [ref.verify_zip215(pk, m, s) for m, pk, s in items + MALFORMED]
    assert got == want
    assert got[:6] == [True] * 6 and got[6:10] == [False] * 4
    assert got[-2:] == [False, False]
    assert got[: len(items)] == _jax_verdicts(items, precomp)
    assert ed.LAST_DISPATCH["precomp"] is precomp
    assert ed.LAST_DISPATCH["lanes"] == len(items) + 2


def test_async_handle_and_empty_batch():
    items = _cases()[:3]
    h = ed.verify_batch_async(items, device="cpu")
    assert h.wait() is h
    assert h.result().tolist() == [True] * 3
    assert ed.verify_batch([], device="cpu").tolist() == []


def test_bucket_cap_and_long_message():
    assert [ed.bucket_cap(n) for n in (0, 47, 48, 175, 176, 943)] == [
        47, 47, 175, 175, 431, 943,
    ]
    with pytest.raises(ValueError):
        ed.bucket_cap(944)
    with pytest.raises(ValueError):
        ed.verify_batch([(os.urandom(944), bytes(32), bytes(64))], device="cpu")


def test_expanded_key_cache_evicts_least_recently_used(monkeypatch):
    monkeypatch.setattr(ed, "_A_CACHE", {})
    monkeypatch.setattr(ed, "_A_CACHE_MAX", 3)
    keys = [ref.public_from_seed(bytes([i]) * 32) for i in range(3)]
    off_curve = (2).to_bytes(32, "little")
    for pk in keys:
        ed._expand_pubkey(pk)
    ed._expand_pubkey(keys[0])  # a hit makes keys[0] the newest entry
    assert ed._expand_pubkey(off_curve) is None
    assert list(ed._A_CACHE) == [keys[2], keys[0], off_curve]
    assert ed._expand_pubkey(off_curve) is None  # cached failures hit too
    assert list(ed._A_CACHE) == [keys[2], keys[0], off_curve]


def test_cuda_batch_verifier_splits_other_key_types():
    """ed25519 lanes go to the kernels (plain versions on the CPU; the
    device route pinned by the floor at 1, since the calibrated routing
    keeps 8 lanes on the host); lanes of any other key type verify on
    the host; verdicts come back in add() order."""
    from dataclasses import dataclass

    from cometbft_tpu_torch.crypto import batch, scheduler
    from cometbft_tpu_torch.crypto.keys import Ed25519PubKey, PubKey

    @dataclass(frozen=True)
    class OtherKey(PubKey):
        def verify(self, msg, sig):
            return msg == b"yes"

    items = _cases()[:8]
    bv = batch.create_batch_verifier(device="cpu")
    assert isinstance(bv, batch.CudaBatchVerifier)
    want = []
    for i, (m, pk, sig) in enumerate(items):
        bv.add(Ed25519PubKey(pk), m, sig)
        want.append(ref.verify_zip215(pk, m, sig))
        if i % 3 == 0:
            bv.add(OtherKey(b"k"), b"yes" if i % 2 else b"no", b"")
            want.append(i % 2 == 1)
    floor = batch._MIN_DEVICE_BATCH
    batch.set_min_device_batch(1)
    try:
        all_ok, oks = bv.verify()
    finally:
        batch.set_min_device_batch(floor)
        scheduler.set_scheduler(None)
    assert oks == want and all_ok is False
    assert ed.LAST_DISPATCH["lanes"] == len(items)
    batch.set_default_backend("cpu")
    try:
        cpu = batch.create_batch_verifier(device="cpu")
    finally:
        batch.set_default_backend("cuda")
    assert isinstance(cpu, batch.CpuBatchVerifier)
    for pk, m, sig in bv.items:
        cpu.add(pk, m, sig)
    assert cpu.verify() == (False, want)
    with pytest.raises(ValueError):
        batch.set_default_backend("tpu")
