"""Host-side keys: ed25519 and secp256k1, addresses, signing, single verify.

Same observable behaviour as the JAX package's ``crypto/keys.py``
(reference crypto/crypto.go): address = first 20 bytes of
SHA-256(raw pubkey); ed25519 signing is RFC 8032; single ed25519
verification uses ZIP-215 semantics, so it agrees with the batch
kernels lane for lane. secp256k1 keys (33-byte compressed SEC1, ECDSA
over SHA-256, 64-byte r||s signatures) verify on the host only: the
batch verifiers split them off the device lanes.

Tiers: the JAX package prefers the ``cryptography`` wheel, then the
system libcrypto through ctypes, then pure Python. The port uses no
wheel: ed25519 runs on libcrypto through ctypes (``_ossl``) with the
pure-Python liberal check behind it (``ref_ed25519``), and secp256k1
runs in pure Python (correct and slow; it only serves mixed-curve
lanes). BLS12-381 keys (``crypto/bls12381.py``, pure Python) stand
behind the JAX package's gate: constructing one raises
``NotImplementedError`` unless ``COMETBFT_TPU_BLS12381`` is set, the
same variable for both packages.
"""

from __future__ import annotations

import hashlib
import os
from dataclasses import dataclass

from . import _ossl
from . import ref_ed25519 as _ref

# The host plane's tier choice (crypto/parallel_verify) reads these two
# flags, as in the JAX package: ``_HAVE_OSSL`` is the `cryptography`
# wheel tier, which the port never uses; ``_HAVE_CTYPES_OSSL`` is
# libcrypto through ctypes. Either one releases the GIL in the verify.
_HAVE_OSSL = False
_HAVE_CTYPES_OSSL = _ossl.available()

ED25519_KEY_TYPE = "ed25519"
SECP256K1_KEY_TYPE = "secp256k1"

ADDRESS_LEN = 20


def address_from_pubkey_bytes(raw: bytes) -> bytes:
    return hashlib.sha256(raw).digest()[:ADDRESS_LEN]


@dataclass(frozen=True)
class PubKey:
    """Interface marker; concrete: Ed25519PubKey, Secp256k1PubKey."""

    key_bytes: bytes

    @property
    def type_(self) -> str:
        raise NotImplementedError

    def address(self) -> bytes:
        return address_from_pubkey_bytes(self.key_bytes)

    def verify(self, msg: bytes, sig: bytes) -> bool:
        raise NotImplementedError

    def __bytes__(self) -> bytes:
        return self.key_bytes


@dataclass(frozen=True)
class Ed25519PubKey(PubKey):
    @property
    def type_(self) -> str:
        return ED25519_KEY_TYPE

    def verify(self, msg: bytes, sig: bytes) -> bool:
        """ZIP-215 verification: OpenSSL accepts a strict subset (every
        honestly made signature); only on its rejection does the
        liberal cofactored pure check run."""
        if len(self.key_bytes) != 32 or len(sig) != 64:
            return False
        if _HAVE_CTYPES_OSSL and _ossl.ed25519_verify(self.key_bytes, msg, sig):
            return True
        return _ref.verify_zip215(self.key_bytes, msg, sig)


@dataclass(frozen=True)
class Ed25519PrivKey:
    seed: bytes

    @classmethod
    def generate(cls) -> "Ed25519PrivKey":
        return cls(os.urandom(32))

    @classmethod
    def from_seed(cls, seed: bytes) -> "Ed25519PrivKey":
        if len(seed) != 32:
            raise ValueError("ed25519 seed must be 32 bytes")
        return cls(seed)

    def pub_key(self) -> Ed25519PubKey:
        if _HAVE_CTYPES_OSSL:
            return Ed25519PubKey(_ossl.ed25519_public(self.seed))
        return Ed25519PubKey(_ref.public_from_seed(self.seed))

    def sign(self, msg: bytes) -> bytes:
        if _HAVE_CTYPES_OSSL:
            return _ossl.ed25519_sign(self.seed, msg)
        return _ref.sign(self.seed, msg)


# --- secp256k1 (host only; mixed-curve lanes split off the device) ---

_SECP_P = 2**256 - 2**32 - 977
_SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_SECP_G = (
    0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798,
    0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8,
)


# inverses by pow(x, -1, m) (extended Euclid): the JAX package's
# Fermat form pow(x, m - 2, m) gives the same values, ~5x slower
def _secp_add(p, q):
    if p is None:
        return q
    if q is None:
        return p
    x1, y1 = p
    x2, y2 = q
    if x1 == x2 and (y1 + y2) % _SECP_P == 0:
        return None
    if p == q:
        lam = (3 * x1 * x1) * pow(2 * y1, -1, _SECP_P) % _SECP_P
    else:
        lam = (y2 - y1) * pow(x2 - x1, -1, _SECP_P) % _SECP_P
    x3 = (lam * lam - x1 - x2) % _SECP_P
    y3 = (lam * (x1 - x3) - y1) % _SECP_P
    return (x3, y3)


def _secp_mul(k: int, p):
    r = None
    while k:
        if k & 1:
            r = _secp_add(r, p)
        p = _secp_add(p, p)
        k >>= 1
    return r


def _secp_decompress(raw: bytes):
    if len(raw) != 33 or raw[0] not in (2, 3):
        return None
    x = int.from_bytes(raw[1:], "big")
    if x >= _SECP_P:
        return None
    y2 = (pow(x, 3, _SECP_P) + 7) % _SECP_P
    y = pow(y2, (_SECP_P + 1) // 4, _SECP_P)
    if y * y % _SECP_P != y2:
        return None
    if (y & 1) != (raw[0] & 1):
        y = _SECP_P - y
    return (x, y)


@dataclass(frozen=True)
class Secp256k1PubKey(PubKey):
    """33-byte compressed SEC1 encoding, like the reference (dcrd)."""

    @property
    def type_(self) -> str:
        return SECP256K1_KEY_TYPE

    def verify(self, msg: bytes, sig: bytes) -> bool:
        """ECDSA verify; sig = 64 bytes r||s, the message hashed with
        SHA-256. Pure Python: the JAX package's OpenSSL fast path needs
        the `cryptography` wheel, which the port does not use."""
        if len(sig) != 64:
            return False
        pt = _secp_decompress(self.key_bytes)
        if pt is None:
            return False
        r = int.from_bytes(sig[:32], "big")
        s = int.from_bytes(sig[32:], "big")
        if not (1 <= r < _SECP_N and 1 <= s < _SECP_N):
            return False
        z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % _SECP_N
        w = pow(s, -1, _SECP_N)
        u1, u2 = z * w % _SECP_N, r * w % _SECP_N
        pt2 = _secp_add(_secp_mul(u1, _SECP_G), _secp_mul(u2, pt))
        if pt2 is None:
            return False
        return pt2[0] % _SECP_N == r


@dataclass(frozen=True)
class Secp256k1PrivKey:
    d: int

    @classmethod
    def generate(cls) -> "Secp256k1PrivKey":
        while True:
            d = int.from_bytes(os.urandom(32), "big")
            if 1 <= d < _SECP_N:
                return cls(d)

    def pub_key(self) -> Secp256k1PubKey:
        x, y = _secp_mul(self.d, _SECP_G)
        return Secp256k1PubKey(bytes([2 + (y & 1)]) + x.to_bytes(32, "big"))

    def sign(self, msg: bytes) -> bytes:
        """Deterministic ECDSA (nonce by SHA-256 hash chaining over the
        key and the message digest; low-s normalized), sig = r||s."""
        z = int.from_bytes(hashlib.sha256(msg).digest(), "big") % _SECP_N
        k_seed = hashlib.sha256(
            self.d.to_bytes(32, "big") + hashlib.sha256(msg).digest()
        ).digest()
        ctr = 0
        while True:
            k = (
                int.from_bytes(
                    hashlib.sha256(k_seed + ctr.to_bytes(4, "big")).digest(),
                    "big",
                )
                % _SECP_N
            )
            ctr += 1
            if k == 0:
                continue
            pt = _secp_mul(k, _SECP_G)
            r = pt[0] % _SECP_N
            if r == 0:
                continue
            s = (z + r * self.d) * pow(k, -1, _SECP_N) % _SECP_N
            if s == 0:
                continue
            if s > _SECP_N // 2:
                s = _SECP_N - s
            return r.to_bytes(32, "big") + s.to_bytes(32, "big")


BLS12381_KEY_TYPE = "bls12381"


@dataclass(frozen=True)
class Bls12381PubKey(PubKey):
    """Feature-gated (reference crypto/bls12381 behind the `bls12381`
    build tag; stub otherwise). Construction fails unless
    COMETBFT_TPU_BLS12381 is set, mirroring the stub build's panic."""

    def __post_init__(self):
        from . import bls12381

        if not bls12381.enabled():
            raise NotImplementedError(
                "bls12381 support disabled; set COMETBFT_TPU_BLS12381=1"
            )

    @property
    def type_(self) -> str:
        return BLS12381_KEY_TYPE

    def verify(self, msg: bytes, sig: bytes) -> bool:
        from . import bls12381

        return bls12381.verify(self.key_bytes, msg, sig)


@dataclass(frozen=True)
class Bls12381PrivKey:
    sk: int

    @classmethod
    def generate(cls) -> "Bls12381PrivKey":
        from . import bls12381

        sk, _ = bls12381.keygen()
        return cls(sk)

    @classmethod
    def from_seed(cls, seed: bytes) -> "Bls12381PrivKey":
        from . import bls12381

        sk, _ = bls12381.keygen(seed)
        return cls(sk)

    def pub_key(self) -> Bls12381PubKey:
        from . import bls12381

        return Bls12381PubKey(
            bls12381.g1_compress(bls12381.g1_mul(bls12381.G1, self.sk))
        )

    def sign(self, msg: bytes) -> bytes:
        from . import bls12381

        return bls12381.sign(self.sk, msg)


def pubkey_from_type_bytes(type_: str, raw: bytes) -> PubKey:
    if type_ == ED25519_KEY_TYPE:
        return Ed25519PubKey(raw)
    if type_ == SECP256K1_KEY_TYPE:
        return Secp256k1PubKey(raw)
    if type_ == BLS12381_KEY_TYPE:
        return Bls12381PubKey(raw)
    raise ValueError(f"unknown key type {type_}")
