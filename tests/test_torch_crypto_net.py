"""The port's secret-connection crypto on every tier this machine has
(crypto/x25519.py, crypto/chacha20poly1305.py, crypto/_ossl.py): the
``cryptography`` wheel, libcrypto through ctypes and pure Python. The
X25519, AEAD and secret-connection cases of the JAX package's
tests/test_crypto_fallback.py, each run on the port's modules: RFC
vectors, the keystream core against the JAX package's vector-tested
HChaCha20, differentials of every available tier against the pure
one, and a full handshake with framed traffic over each tier."""

import asyncio
import random
import socket
import struct

import pytest

from cometbft_tpu.crypto.xchacha20poly1305 import hchacha20
from cometbft_tpu_torch.crypto import _ossl
from cometbft_tpu_torch.crypto import chacha20poly1305 as ccp
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.crypto import x25519
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from torch_hard_limit import hard_limit  # noqa: F401

TIERS = ["wheel", "ctypes", "pure"]


@pytest.fixture(params=TIERS)
def tier(request, monkeypatch):
    """Run the test on one tier; skipped where this machine lacks it."""
    if request.param not in ccp.available_tiers():
        pytest.skip(f"the {request.param} tier is not available here")
    monkeypatch.setattr(x25519, "TIER", request.param)
    monkeypatch.setattr(ccp, "ChaCha20Poly1305", ccp.aead_class(request.param))
    return request.param


# --- poly1305 (RFC 8439 2.5.2) ------------------------------------------


def test_poly1305_rfc_vector():
    key = bytes.fromhex("85d6be7857556d337f4452fe42d506a80103808afb0db2fd4abff6af4149f51b")
    tag = ccp.poly1305(key, b"Cryptographic Forum Research Group")
    assert tag == bytes.fromhex("a8061dc1305136c6c22b8baf0c0127a9")


# --- chacha20 core vs the vector-tested HChaCha20 -----------------------


def test_chacha20_core_matches_hchacha20():
    """hchacha20(key, n16) equals words (0..3, 12..15) of the raw
    permutation when n16 supplies (counter, nonce): pins the constants,
    round structure, word order and serialization of the port's
    keystream core against the JAX package's HChaCha20."""
    for key, n16 in [
        (bytes(range(32)), bytes(range(100, 116))),
        (b"\x00" * 32, b"\x00" * 16),
        (b"\xff" * 32, b"\x07" * 16),
    ]:
        counter = struct.unpack("<I", n16[:4])[0]
        nonce12 = n16[4:]
        ks = ccp.chacha20_keystream(key, nonce12, counter, 64)
        words = struct.unpack("<16I", ks)
        init = (
            list(struct.unpack("<4I", b"expand 32-byte k"))
            + list(struct.unpack("<8I", key))
            + [counter]
            + list(struct.unpack("<3I", nonce12))
        )
        perm = [(w - i) & 0xFFFFFFFF for w, i in zip(words, init)]
        got = struct.pack("<8I", *(perm[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))
        assert got == hchacha20(key, n16)


def test_chacha20_keystream_block_boundaries():
    key, nonce = bytes(range(32)), bytes(12)
    full = ccp.chacha20_keystream(key, nonce, 0, 256)
    assert ccp.chacha20_keystream(key, nonce, 1, 192) == full[64:]
    assert ccp.chacha20_keystream(key, nonce, 3, 64) == full[192:]
    assert ccp.chacha20_keystream(key, nonce, 0, 100) == full[:100]
    assert ccp.chacha20_keystream(key, nonce, 0, 0) == b""


# --- AEAD construction --------------------------------------------------


def test_aead_roundtrip_tamper_and_nonce_mismatch(tier):
    key = bytes(range(32))
    cls = ccp.aead_class(tier)
    a = cls(key)
    nonce = bytes.fromhex("000000000001020304050607")
    for pt, aad in [(b"", b""), (b"x", None), (b"hello world" * 95, b"header"), (b"\x00" * 1024, b"")]:
        ct = a.encrypt(nonce, pt, aad)
        assert len(ct) == len(pt) + 16
        assert cls(key).decrypt(nonce, ct, aad) == pt
        with pytest.raises(ccp.InvalidTag):
            cls(key).decrypt(nonce, ct[:-1] + bytes([ct[-1] ^ 1]), aad)
        with pytest.raises(ccp.InvalidTag):
            cls(key).decrypt(bytes(12), ct, aad)


def test_aead_rejects_wrong_nonce_and_key_lengths():
    """The pure tier matches the OpenSSL backends' input validation: a
    short nonce is never silently zero-extended by the keystream
    cache."""
    a = ccp.PureChaCha20Poly1305(bytes(32))
    for nonce in (b"", b"n" * 8, b"n" * 24):
        with pytest.raises(ValueError):
            a.encrypt(nonce, b"data", None)
        with pytest.raises(ValueError):
            a.decrypt(nonce, b"x" * 20, None)
    with pytest.raises(ValueError):
        ccp.PureChaCha20Poly1305(b"short")


def test_aead_sequential_cache_equals_random_access():
    key = b"\x42" * 32
    sender = ccp.PureChaCha20Poly1305(key)
    frames = {}
    for i in range(70):
        nonce = i.to_bytes(12, "little")
        pt = bytes([i]) * (1024 if i % 2 else 33)
        frames[nonce] = (pt, sender.encrypt(nonce, pt, None))
    fresh = ccp.PureChaCha20Poly1305(key)
    for nonce in sorted(frames, reverse=True):
        pt, ct = frames[nonce]
        assert fresh.decrypt(nonce, ct, None) == pt


def test_aead_tier_differential_vs_pure(tier):
    """Every available tier produces the pure construction's bytes
    (keystream cache path included) and opens them."""
    rng = random.Random(5)
    key = bytes(rng.randrange(256) for _ in range(32))
    pure, other = ccp.PureChaCha20Poly1305(key), ccp.aead_class(tier)(key)
    for i in range(50):
        nonce = i.to_bytes(12, "little")
        pt = bytes(rng.randrange(256) for _ in range(rng.randrange(0, 1500)))
        aad = bytes(rng.randrange(256) for _ in range(8))
        ct = other.encrypt(nonce, pt, aad)
        assert ct == pure.encrypt(nonce, pt, aad)
        assert pure.decrypt(nonce, ct, aad) == pt
        assert other.decrypt(nonce, ct, aad) == pt


def test_ctypes_libcrypto_differential_vs_pure():
    """The ctypes tier's ed25519 and x25519 agree byte for byte with the
    pure implementations; its AEAD refuses a bad tag."""
    if not _ossl.available():
        pytest.skip("no system libcrypto")
    rng = random.Random(11)
    for _ in range(3):
        seed = bytes(rng.randrange(256) for _ in range(32))
        msg = bytes(rng.randrange(256) for _ in range(rng.randrange(200)))
        assert _ossl.ed25519_public(seed) == ref.public_from_seed(seed)
        sig = _ossl.ed25519_sign(seed, msg)
        assert sig == ref.sign(seed, msg)
        pub = ref.public_from_seed(seed)
        assert _ossl.ed25519_verify(pub, msg, sig)
        assert not _ossl.ed25519_verify(pub, msg + b"x", sig)
    priv = bytes(rng.randrange(256) for _ in range(32))
    assert _ossl.x25519_public(priv) == x25519.scalar_mult(priv, (9).to_bytes(32, "little"))
    peer = _ossl.x25519_public(bytes(rng.randrange(256) for _ in range(32)))
    assert _ossl.x25519_shared(priv, peer) == x25519.scalar_mult(priv, peer)
    with pytest.raises(ccp.InvalidTag):
        _ossl.OsslChaCha20Poly1305(bytes(32)).decrypt(bytes(12), b"\x00" * 32, None)


# --- x25519 (RFC 7748) --------------------------------------------------


def test_x25519_rfc_vectors(tier):
    k = bytes.fromhex("a546e36bf0527c9d3b16154b82465edd62144c0ac1fc5a18506a2244ba449ac4")
    u = bytes.fromhex("e6db6867583030db3594c1a424b15f7c726624ec26b3353b10a903a6d0ab1c4c")
    assert x25519.scalar_mult(k, u) == bytes.fromhex(
        "c3da55379de9c6908e94ea4df28d084f32eccf03491c71f754b4075577a28552"
    )
    # RFC 7748 6.1: Alice/Bob key exchange, on this tier
    apriv = bytes.fromhex("77076d0a7318a57d3c16c17251b26645df4c2f87ebc0992ab177fba51db92c2a")
    bpriv = bytes.fromhex("5dab087e624a8a4b79e17f8b83800ee66f3bb1292618b6fd1c2f8b27ff88e0eb")
    apub = bytes.fromhex("8520f0098930a754748b7ddcb43ef75a0dbf3a0d26381af4eba4a98eaa9b4e6a")
    bpub = bytes.fromhex("de9edb7d7b7dc1b4d35b61c2ece435373f8343c85b78674dadfc7e146f882b4f")
    shared = bytes.fromhex("4a5d9d5ba4ce2de1728e3bf480350f25e07e21c947d19e3376f09b3c1e161742")
    assert x25519.public(apriv) == apub
    assert x25519.public(bpriv) == bpub
    assert x25519.shared(apriv, bpub) == shared
    assert x25519.shared(bpriv, apub) == shared
    with pytest.raises(ValueError):
        x25519.shared(apriv, bytes(32))  # a low-order point: zero secret


def test_x25519_dh_agreement_random_keys(tier):
    for _ in range(3):
        a, b = x25519.generate_private(), x25519.generate_private()
        assert x25519.shared(a, x25519.public(b)) == x25519.shared(b, x25519.public(a))


def test_x25519_rejects_bad_lengths():
    with pytest.raises(ValueError):
        x25519.scalar_mult(b"short", bytes(32))
    with pytest.raises(ValueError):
        x25519.scalar_mult(bytes(32), b"short")


def test_secret_connection_end_to_end_over_each_tier(tier):
    """The consumer-level proof: a full secret-connection handshake and
    framed AEAD traffic, both ends on this tier."""
    from cometbft_tpu_torch.p2p.conn.secret_connection import SecretConnection

    async def main():
        a, b = socket.socketpair()
        a.setblocking(False)
        b.setblocking(False)
        ra, wa = await asyncio.open_connection(sock=a)
        rb, wb = await asyncio.open_connection(sock=b)
        ka = Ed25519PrivKey.from_seed(bytes(range(32)))
        kb = Ed25519PrivKey.from_seed(bytes(range(1, 33)))
        ca, cb = await asyncio.gather(
            SecretConnection.handshake(ra, wa, ka),
            SecretConnection.handshake(rb, wb, kb),
        )
        assert isinstance(ca._send_aead, ccp.aead_class(tier))
        assert ca.remote_pubkey.key_bytes == kb.pub_key().key_bytes
        assert cb.remote_pubkey.key_bytes == ka.pub_key().key_bytes
        payload = b"chaos" * 300
        await ca.write_msg(payload)
        got = b""
        while len(got) < len(payload):
            got += await cb.read_chunk()
        assert got == payload
        ca.close()
        cb.close()

    asyncio.run(asyncio.wait_for(main(), 30))
