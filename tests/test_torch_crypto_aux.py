"""The port's small host crypto modules held to the JAX package's:
every case of ``tests/test_crypto_aux.py`` (ASCII armor,
XChaCha20-Poly1305, the NaCl secretbox and the typed pubkey proto
layer) on ``cometbft_tpu_torch``, with keys, nonces and payloads from a
seeded generator. Where the JAX case draws a random nonce, the same
nonce goes to both packages' ``seal``; every output must be byte-equal
across the packages, and each package opens what the other sealed."""

import hashlib

import numpy as np
import pytest

from cometbft_tpu.crypto import armor as jarmor
from cometbft_tpu.crypto import encoding as jencoding
from cometbft_tpu.crypto import xchacha20poly1305 as jxcc
from cometbft_tpu.crypto import xsalsa20symmetric as jxs
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu_torch.crypto import armor, encoding
from cometbft_tpu_torch.crypto import xchacha20poly1305 as xcc
from cometbft_tpu_torch.crypto import xsalsa20symmetric as xs
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey


@pytest.fixture
def rng():
    return np.random.default_rng(20261018)


# --- armor (reference crypto/armor/armor_test.go shape) ----------------


def test_armor_roundtrip(rng):
    data = rng.bytes(100)
    headers = {"kdf": "bcrypt", "salt": "ABCD"}
    s = armor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
    assert s == jarmor.encode_armor("TENDERMINT PRIVATE KEY", headers, data)
    bt, got_headers, out = armor.decode_armor(s)
    assert bt == "TENDERMINT PRIVATE KEY"
    assert got_headers == headers
    assert out == data
    assert jarmor.decode_armor(s) == (bt, got_headers, out)


def test_armor_empty_headers_and_long_body(rng):
    data = rng.bytes(1000)  # multi-line base64
    s = armor.encode_armor("MESSAGE", {}, data)
    assert s == jarmor.encode_armor("MESSAGE", {}, data)
    assert armor.decode_armor(s) == ("MESSAGE", {}, data) == jarmor.decode_armor(s)


def test_armor_rejects_corruption():
    s = armor.encode_armor("MESSAGE", {}, b"payload-bytes-here")
    lines = s.split("\n")
    body_i = next(
        i for i, l in enumerate(lines)
        if l and not l.startswith("-") and ":" not in l and not l.startswith("=")
    )
    ch = "B" if lines[body_i][0] != "B" else "C"
    lines[body_i] = ch + lines[body_i][1:]
    for mod in (armor, jarmor):
        with pytest.raises(ValueError, match="checksum mismatch"):
            mod.decode_armor("\n".join(lines))
        with pytest.raises(ValueError, match="BEGIN"):
            mod.decode_armor("not armor at all")


# --- HChaCha20 differential vectors (reference vector_test.go) ---------

HCHACHA_VECTORS = [
    (
        "0000000000000000000000000000000000000000000000000000000000000000",
        "000000000000000000000000000000000000000000000000",
        "1140704c328d1d5d0e30086cdf209dbd6a43b8f41518a11cc387b669b2ee6586",
    ),
    (
        "8000000000000000000000000000000000000000000000000000000000000000",
        "000000000000000000000000000000000000000000000000",
        "7d266a7fd808cae4c02a0a70dcbfbcc250dae65ce3eae7fc210f54cc8f77df86",
    ),
    (
        "0000000000000000000000000000000000000000000000000000000000000001",
        "000000000000000000000000000000000000000000000002",
        "e0c77ff931bb9163a5460c02ac281c2b53d792b1c43fea817e9ad275ae546963",
    ),
    (
        "000102030405060708090a0b0c0d0e0f101112131415161718191a1b1c1d1e1f",
        "000102030405060708090a0b0c0d0e0f1011121314151617",
        "51e3ff45a895675c4b33b46c64f4a9ace110d34df6a2ceab486372bacbd3eff6",
    ),
]


def test_hchacha20_vectors():
    for key_h, nonce_h, want_h in HCHACHA_VECTORS:
        key, nonce = bytes.fromhex(key_h), bytes.fromhex(nonce_h)[:16]
        assert xcc.hchacha20(key, nonce).hex() == want_h == jxcc.hchacha20(key, nonce).hex()


def test_xchacha20poly1305_roundtrip_and_auth(rng):
    key, nonce = rng.bytes(32), rng.bytes(24)
    aead, jaead = xcc.XChaCha20Poly1305(key), jxcc.XChaCha20Poly1305(key)
    pt = b"the quick brown fox" * 7
    ct = aead.seal(nonce, pt, aad=b"header")
    assert ct == jaead.seal(nonce, pt, aad=b"header")
    assert len(ct) == len(pt) + aead.overhead
    assert aead.open(nonce, ct, aad=b"header") == pt
    for a in (aead, jaead):
        with pytest.raises(ValueError):
            a.open(nonce, ct, aad=b"other")
        with pytest.raises(ValueError):
            a.open(nonce, ct[:-1] + bytes([ct[-1] ^ 1]), aad=b"header")
        with pytest.raises(ValueError):
            a.seal(b"\x00" * 12, pt)  # 12B nonce is ChaCha20's, not ours
    for mod in (xcc, jxcc):
        with pytest.raises(ValueError):
            mod.XChaCha20Poly1305(b"short")


# --- xsalsa20symmetric (reference symmetric_test.go shape) -------------


def test_secretbox_roundtrip(rng):
    secret = rng.bytes(32)
    for size in (1, 15, 16, 17, 63, 64, 65, 300):
        pt, nonce = rng.bytes(size), rng.bytes(xs.NONCE_LEN)
        ct = nonce + xs.seal(pt, nonce, secret)
        assert ct == nonce + jxs.seal(pt, nonce, secret)
        assert len(ct) == len(pt) + xs.NONCE_LEN + xs.OVERHEAD
        assert xs.decrypt_symmetric(ct, secret) == pt == jxs.decrypt_symmetric(ct, secret)
        # random nonces: each package opens the other's box
        assert jxs.decrypt_symmetric(xs.encrypt_symmetric(pt, secret), secret) == pt
        assert xs.decrypt_symmetric(jxs.encrypt_symmetric(pt, secret), secret) == pt
    # reference quirk preserved (symmetric.go:42 uses <=): an empty
    # plaintext seals but its ciphertext is rejected on decrypt
    for mod in (xs, jxs):
        with pytest.raises(ValueError, match="too short"):
            mod.decrypt_symmetric(mod.encrypt_symmetric(b"", secret), secret)


def test_secretbox_rejects_wrong_secret_and_tamper(rng):
    secret = rng.bytes(32)
    ct = xs.encrypt_symmetric(b"attack at dawn", secret)
    for mod in (xs, jxs):
        with pytest.raises(ValueError):
            mod.decrypt_symmetric(ct, rng.bytes(32))
        with pytest.raises(ValueError):
            mod.decrypt_symmetric(ct[:-1] + bytes([ct[-1] ^ 1]), secret)
        with pytest.raises(ValueError):
            mod.decrypt_symmetric(ct[:30], secret)
        with pytest.raises(ValueError):
            mod.encrypt_symmetric(b"x", b"short-secret")


def test_hsalsa20_known_subkey(rng):
    """XSalsa20 with an all-zero 24B nonce must equal Salsa20 under the
    HSalsa20-derived subkey — and the derivation must be deterministic."""
    key = bytes(range(32))
    a = xs.hsalsa20(key, b"\x00" * 16)
    assert a == xs.hsalsa20(key, b"\x00" * 16) == jxs.hsalsa20(key, b"\x00" * 16)
    assert len(a) == 32 and a != key
    other, n16 = rng.bytes(32), rng.bytes(16)
    assert xs.hsalsa20(other, n16) == jxs.hsalsa20(other, n16)


def test_armored_encrypted_key_flow(rng):
    """The end-to-end armor+secretbox flow the reference tooling uses
    for private-key export, sealed by one package and opened by the
    other."""
    priv = Ed25519PrivKey.from_seed(rng.bytes(32))
    secret = hashlib.sha256(b"correct horse battery staple").digest()
    nonce = rng.bytes(xs.NONCE_LEN)
    boxed = nonce + xs.seal(priv.seed, nonce, secret)
    s = armor.encode_armor("TENDERMINT PRIVATE KEY", {"kdf": "sha256"}, boxed)
    assert s == jarmor.encode_armor(
        "TENDERMINT PRIVATE KEY", {"kdf": "sha256"}, nonce + jxs.seal(priv.seed, nonce, secret))
    bt, hdrs, data = jarmor.decode_armor(s)
    assert hdrs["kdf"] == "sha256"
    seed = jxs.decrypt_symmetric(data, secret)
    assert Ed25519PrivKey.from_seed(seed).pub_key() == priv.pub_key()
    assert JPriv.from_seed(seed).pub_key().key_bytes == priv.pub_key().key_bytes


# --- typed pubkey encoding (reference crypto/encoding/codec.go) --------


def test_pubkey_proto_roundtrip(rng):
    pk = Ed25519PrivKey.from_seed(rng.bytes(32)).pub_key()
    b = encoding.pubkey_to_proto(pk)
    assert b == jencoding.pubkey_to_proto(jencoding.pubkey_from_proto(b))
    assert encoding.pubkey_from_proto(b) == pk


def test_pubkey_from_type_and_bytes_errors():
    for enc in (encoding, jencoding):
        with pytest.raises(enc.ErrUnsupportedKey):
            enc.pubkey_from_type_and_bytes("sr25519", b"\x00" * 32)
        with pytest.raises(enc.ErrInvalidKeyLen) as ei:
            enc.pubkey_from_type_and_bytes("ed25519", b"\x00" * 31)
        assert ei.value.got == 31 and ei.value.want == 32
        with pytest.raises(enc.ErrInvalidKeyLen):
            enc.pubkey_from_type_and_bytes("secp256k1", b"\x02" * 32)
        pk = enc.pubkey_from_type_and_bytes("ed25519", b"\x01" * 32)
        assert pk.key_bytes == b"\x01" * 32
        with pytest.raises(enc.ErrUnsupportedKey):
            enc.pubkey_from_proto(b"")
    sk = encoding.pubkey_from_type_and_bytes("secp256k1", b"\x02" + b"\x07" * 32)
    assert sk.key_bytes == jencoding.pubkey_from_type_and_bytes("secp256k1", b"\x02" + b"\x07" * 32).key_bytes
