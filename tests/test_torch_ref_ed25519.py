"""The port's reference ed25519 oracle (crypto/ref_ed25519.py) against
the ``cryptography`` library (OpenSSL) and the JAX package's oracle:
every case of ``tests/test_ref_ed25519.py`` on cometbft_tpu_torch, with
seeds and messages from a seeded generator."""

import numpy as np
import pytest

from cometbft_tpu.crypto import ref_ed25519 as jref
from cometbft_tpu_torch.crypto import ref_ed25519 as ref

pytest.importorskip("cryptography", reason="the differential oracle needs the OpenSSL wheel")
from cryptography.hazmat.primitives import serialization  # noqa: E402
from cryptography.hazmat.primitives.asymmetric.ed25519 import Ed25519PrivateKey  # noqa: E402


def test_sign_matches_openssl():
    rng = np.random.default_rng(25519)
    for i in range(8):
        seed = rng.bytes(32)
        sk = Ed25519PrivateKey.from_private_bytes(seed)
        msg = rng.bytes(i * 17)
        pub = sk.public_key().public_bytes(serialization.Encoding.Raw, serialization.PublicFormat.Raw)
        assert ref.public_from_seed(seed) == pub == jref.public_from_seed(seed)
        assert ref.sign(seed, msg) == sk.sign(msg) == jref.sign(seed, msg)


def test_verify_roundtrip_and_negatives():
    seed = np.random.default_rng(7).bytes(32)
    pub = ref.public_from_seed(seed)
    msg = b"cometbft_tpu_torch vote sign bytes"
    sig = ref.sign(seed, msg)
    assert ref.verify_zip215(pub, msg, sig)
    assert not ref.verify_zip215(pub, msg + b"x", sig)
    bad = bytearray(sig)
    bad[3] ^= 1
    assert not ref.verify_zip215(pub, msg, bytes(bad))
    assert not jref.verify_zip215(pub, msg, bytes(bad))
    # non-canonical S rejected
    s = int.from_bytes(sig[32:], "little") + ref.L
    if s < 2**256:
        assert not ref.verify_zip215(pub, msg, sig[:32] + s.to_bytes(32, "little"))


def test_zip215_liberal_decoding():
    # y >= p encodings are accepted as points (reduced mod p): y = p + 1
    # is y = 1, the identity's, with sign 0
    enc = (ref.P + 1).to_bytes(32, "little")
    pt = ref.point_decompress(enc)
    assert pt is not None
    assert ref.point_equal(pt, ref.IDENTITY)
    # a small-order point (y = -1, order 2) decodes fine
    enc2 = (ref.P - 1).to_bytes(32, "little")
    assert ref.point_decompress(enc2) is not None
    assert ref.point_compress(ref.point_decompress(enc2)) == jref.point_compress(jref.point_decompress(enc2))


def test_small_order_pubkey_cofactored():
    # A = identity, R = identity, S = 0 verifies under the cofactored
    # equation: h*identity = identity, and S*B = identity iff S = 0
    ident = ref.point_compress(ref.IDENTITY)
    sig = ident + b"\x00" * 32
    assert ref.verify_zip215(ident, b"anything", sig)
    assert jref.verify_zip215(ident, b"anything", sig)
