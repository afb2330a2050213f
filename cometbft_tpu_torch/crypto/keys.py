"""Host-side ed25519 keys: addresses, signing, single verification.

Same observable behaviour as the JAX package's ``crypto/keys.py``
(reference crypto/crypto.go): address = first 20 bytes of
SHA-256(raw pubkey); signing is RFC 8032; single verification uses
ZIP-215 semantics, so it agrees with the batch kernels lane for lane.
Two tiers: the system libcrypto through ctypes (``_ossl``), else the
pure-Python oracle (``ref_ed25519``). secp256k1 and BLS keys are not
part of this slice.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

from . import _ossl
from . import ref_ed25519 as _ref

ADDRESS_LEN = 20

_HAVE_OSSL = _ossl.available()


def address_from_pubkey_bytes(raw: bytes) -> bytes:
    return hashlib.sha256(raw).digest()[:ADDRESS_LEN]


@dataclass(frozen=True)
class PubKey:
    """Interface marker; the concrete type here is Ed25519PubKey."""

    key_bytes: bytes

    def address(self) -> bytes:
        return address_from_pubkey_bytes(self.key_bytes)

    def verify(self, msg: bytes, sig: bytes) -> bool:
        raise NotImplementedError


@dataclass(frozen=True)
class Ed25519PubKey(PubKey):
    def verify(self, msg: bytes, sig: bytes) -> bool:
        """ZIP-215 verification: OpenSSL accepts a strict subset (every
        honestly made signature); only on its rejection does the
        liberal cofactored pure check run."""
        if len(self.key_bytes) != 32 or len(sig) != 64:
            return False
        if _HAVE_OSSL and _ossl.ed25519_verify(self.key_bytes, msg, sig):
            return True
        return _ref.verify_zip215(self.key_bytes, msg, sig)


@dataclass(frozen=True)
class Ed25519PrivKey:
    seed: bytes

    @classmethod
    def from_seed(cls, seed: bytes) -> "Ed25519PrivKey":
        if len(seed) != 32:
            raise ValueError("ed25519 seed must be 32 bytes")
        return cls(seed)

    def pub_key(self) -> Ed25519PubKey:
        if _HAVE_OSSL:
            return Ed25519PubKey(_ossl.ed25519_public(self.seed))
        return Ed25519PubKey(_ref.public_from_seed(self.seed))

    def sign(self, msg: bytes) -> bytes:
        if _HAVE_OSSL:
            return _ossl.ed25519_sign(self.seed, msg)
        return _ref.sign(self.seed, msg)
