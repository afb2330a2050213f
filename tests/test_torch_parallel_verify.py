"""The port's host verification plane against the JAX package's.

Ports the first seven cases of ``tests/test_parallel_verify.py``: RFC
8032 vectors, forged and edge lanes landing on their exact indices
(ZIP-215 liberal lanes, a secp256k1 lane, the ``"cpu-parallel"``
backend), order stability over chunk sizes and worker counts, the
native chunk call against the Python loop, the process tier (spawned
workers) over the pure-Python fallback, the serial degrade, and the
cuda backend's host-routed lanes riding the plane. Each verdict list is
held to the JAX package's on the same inputs, made from a numpy seed.
"""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import keys as crypto_keys
from cometbft_tpu_torch.crypto import native_verify
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey, Secp256k1PrivKey
from cometbft_tpu_torch.crypto.parallel_verify import ParallelVerifyEngine

torch.set_num_threads(1)

# RFC 8032 §7.1 TEST 1-3 (seed, pub, msg, sig)
RFC8032_VECTORS = [
    (
        "9d61b19deffd5a60ba844af492ec2cc44449c5697b326919703bac031cae7f60",
        "d75a980182b10ab7d54bfed3c964073a0ee172f3daa62325af021a68f707511a",
        "",
        "e5564300c360ac729086e2cc806e828a84877f1eb8e5d974d873e06522490155"
        "5fb8821590a33bacc61e39701cf9b46bd25bf5f0595bbe24655141438e7a100b",
    ),
    (
        "4ccd089b28ff96da9db6c346ec114e0f5b8a319f35aba624da8cf6ed4fb8a6fb",
        "3d4017c3e843895a92b70aa74d1b7ebc9c982ccf2ec4968cc0cd55f12af4660c",
        "72",
        "92a009a9f0d4cab8720e820b5f642540a2b27b5416503f8fb3762223ebdb69da"
        "085ac1e43e15996e458f3613d0f11d8c387b2eaeb4302aeeb00d291612bb0c00",
    ),
    (
        "c5aa8df43f9f837bedb7442f31dcb7b166d38535076f094b85ce3a2e0b4458f7",
        "fc51cd8e6218a1a38da47ed00230f0580816ed13ba3303ac5deb911548908025",
        "af82",
        "6291d657deec24024827e69c3abe01a30ce548a284743a445e3680d7db5ac3ac"
        "18ff9b538d16f290ae67f760984dc6594a7c15e9716ed28dc027beceea1ec40a",
    ),
]


def _vector_items():
    """Vector lanes and a forged twin of each (a signature bit flipped):
    the forgeries land on exactly the odd indices."""
    items = []
    for seed_hex, pub_hex, msg_hex, sig_hex in RFC8032_VECTORS:
        pk = crypto_keys.Ed25519PubKey(bytes.fromhex(pub_hex))
        msg, sig = bytes.fromhex(msg_hex), bytes.fromhex(sig_hex)
        assert Ed25519PrivKey.from_seed(bytes.fromhex(seed_hex)).pub_key() == pk
        items.append((pk, msg, sig))
        bad = bytearray(sig)
        bad[7] ^= 0x40
        items.append((pk, msg, bytes(bad)))
    return items


def _random_items(n, seed=3, n_keys=12):
    rng = np.random.default_rng(seed)
    privs = [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(n_keys)]
    pubs = [p.pub_key() for p in privs]
    items = []
    for i in range(n):
        m = bytes(rng.bytes(40 + (i % 90)))
        items.append((pubs[i % n_keys], m, privs[i % n_keys].sign(m)))
    return items


def _jax_verdicts(items):
    """The JAX package's serial backend on the same lanes."""
    v = jbatch.CpuBatchVerifier()
    for pk, msg, sig in items:
        cls = jkeys.Ed25519PubKey if pk.type_ == "ed25519" else jkeys.Secp256k1PubKey
        v.add(cls(pk.key_bytes), msg, sig)
    return v.verify()[1]


def _serial_verdicts(items):
    v = crypto_batch.CpuBatchVerifier()
    for it in items:
        v.add(*it)
    return v.verify()[1]


@pytest.fixture
def shared_engine():
    """The process-wide engine, two workers, closed after the test."""
    eng = ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield eng
    pv.set_engine(None)
    eng.close()


def test_rfc8032_vectors_parallel_vs_serial():
    items = _vector_items()
    want = [i % 2 == 0 for i in range(len(items))]
    assert _serial_verdicts(items) == want == _jax_verdicts(items)
    eng = ParallelVerifyEngine(min_parallel=1)
    try:
        assert eng.verify(items) == want
    finally:
        eng.close()


def test_forged_and_edge_lanes_land_on_exact_indices(shared_engine):
    """Valid lanes, a zeroed signature, a changed message, a wrong key,
    a short signature, a secp256k1 lane, and two ZIP-215 liberal lanes
    that OpenSSL rejects and the cofactored check accepts."""
    items = _random_items(120)
    sp = Secp256k1PrivKey(0x5EC9 << 200)
    items[17] = (items[17][0], items[17][1], bytes(64))
    items[41] = (items[41][0], b"mutated!", items[41][2])
    items[42] = (items[0][0], items[42][1], items[42][2])
    items[77] = (items[77][0], items[77][1], items[77][2][:60])
    items[88] = (sp.pub_key(), b"mixed-lane", sp.sign(b"mixed-lane"))
    ident = ref.point_compress(ref.IDENTITY)
    items[99] = (crypto_keys.Ed25519PubKey(ident), b"small order", ident + bytes(32))
    items[100] = (
        crypto_keys.Ed25519PubKey((ref.P + 1).to_bytes(32, "little")),
        b"liberal encoding",
        ident + bytes(32),
    )
    want = _serial_verdicts(items)
    assert want == _jax_verdicts(items)
    assert want[88] and want[99] and want[100]
    assert not (want[17] or want[41] or want[42] or want[77])
    eng = ParallelVerifyEngine(min_parallel=1, tier="thread")
    try:
        assert eng.verify(items) == want
    finally:
        eng.close()
    old = crypto_batch.default_backend()
    crypto_batch.set_default_backend("cpu-parallel")
    try:
        v = crypto_batch.create_batch_verifier(device="cpu")
        for it in items:
            v.add(*it)
        assert v.verify() == (False, want)
        v2 = crypto_batch.create_batch_verifier(device="cpu")
        for it in items:
            v2.add(*it)
        assert v2.verify_async().result() == (False, want)
    finally:
        crypto_batch.set_default_backend(old)


def test_order_stability_across_chunk_sizes_and_workers():
    items = _random_items(257)  # not chunk-aligned
    items[3] = (items[3][0], items[3][1], bytes(64))
    items[255] = (items[255][0], b"x", items[255][2])
    want = _serial_verdicts(items)
    assert want == _jax_verdicts(items)
    for workers in (2, 3):
        for target_s in (2e-4, 5e-3, 1.0):
            eng = ParallelVerifyEngine(workers=workers, min_parallel=1, chunk_target_s=target_s)
            try:
                assert eng.verify(items) == want, (workers, target_s)
            finally:
                eng.close()


def test_native_chunk_matches_python_loop():
    if native_verify.module() is None:
        pytest.skip("native extension unavailable (no compiler or Python headers)")
    items = _random_items(64)
    items[5] = (items[5][0], items[5][1], bytes(64))
    ident = ref.point_compress(ref.IDENTITY)
    items[6] = (crypto_keys.Ed25519PubKey(ident), b"small order", ident + bytes(32))
    want = [pk.verify(m, s) for pk, m, s in items]
    assert want[6] and not want[5]
    assert native_verify.verify_chunk(items) == want == _jax_verdicts(items)


def test_process_pool_tier_on_pure_python_fallback(monkeypatch):
    """With libcrypto gone the engine picks the PROCESS tier (the pure
    check holds the GIL); its workers are spawned, not forked, and the
    verdicts stay bit-identical."""
    monkeypatch.setattr(crypto_keys, "_HAVE_OSSL", False)
    monkeypatch.setattr(crypto_keys, "_HAVE_CTYPES_OSSL", False)
    monkeypatch.setattr(native_verify, "_tried", True)
    monkeypatch.setattr(native_verify, "_mod", None)
    assert not pv._ed25519_releases_gil()
    items = _random_items(8, n_keys=2)
    items[2] = (items[2][0], items[2][1], bytes(64))
    want = [pk.verify(m, s) for pk, m, s in items]
    assert want == _jax_verdicts(items)
    eng = ParallelVerifyEngine(min_parallel=1, workers=2)
    try:
        assert eng.tier == "process"
        got = eng.verify(items)
        assert eng._pool._mp_context.get_start_method() == "spawn"
        assert got == want
        assert not got[2] and got[0]
    finally:
        eng.close()


def test_pubkey_from_type_bytes_matches_jax():
    ed_raw = Ed25519PrivKey.from_seed(bytes(range(32))).pub_key().key_bytes
    secp_raw = Secp256k1PrivKey(0x5EC9 << 200).pub_key().key_bytes
    for type_, raw in (("ed25519", ed_raw), ("secp256k1", secp_raw)):
        pk = crypto_keys.pubkey_from_type_bytes(type_, raw)
        jpk = jkeys.pubkey_from_type_bytes(type_, raw)
        assert (pk.type_, pk.key_bytes, pk.address()) == (jpk.type_, jpk.key_bytes, jpk.address())
    with pytest.raises(ValueError, match="unknown key type"):
        crypto_keys.pubkey_from_type_bytes("sr25519", ed_raw)


def test_serial_degrade_when_single_worker():
    eng = ParallelVerifyEngine(workers=1)
    try:
        assert eng.tier == "serial"
        items = _random_items(30, n_keys=3)
        assert eng.verify(items) == _serial_verdicts(items) == _jax_verdicts(items)
    finally:
        eng.close()


def test_cuda_backend_host_lanes_ride_the_parallel_plane(shared_engine):
    """Host-routed batches of the default (cuda) backend go through the
    verify scheduler in chunks on the shared engine's pool, and
    verify_async hands back the pending ticket."""
    old = crypto_batch.default_backend()
    old_min = crypto_batch._MIN_DEVICE_BATCH
    crypto_batch.set_default_backend("cuda")
    crypto_batch.set_min_device_batch(1 << 30)  # host routing
    try:
        items = _random_items(80, n_keys=4)
        v = crypto_batch.create_batch_verifier(device="cpu")
        for it in items:
            v.add(*it)
        assert v.verify() == (True, [True] * 80)
        sent = shared_engine.chunks_dispatched
        assert sent >= 1
        v2 = crypto_batch.create_batch_verifier(device="cpu")
        for it in items:
            v2.add(*it)
        handle = v2.verify_async()
        assert isinstance(handle, sched_mod.VerifyTicket)
        assert handle.result(timeout=30) == (True, [True] * 80)
        assert shared_engine.chunks_dispatched > sent
        assert crypto_batch.LAST_ROUTE["path"] == "host"
    finally:
        sched_mod.set_scheduler(None)
        crypto_batch.set_min_device_batch(old_min)
        crypto_batch.set_default_backend(old)
