"""Public-key <-> proto conversions (reference crypto/encoding/
codec.go:45-130: PubKeyToProto / PubKeyFromProto /
PubKeyFromTypeAndBytes, with the typed length/unsupported errors).

A copy of the JAX package's ``crypto/encoding.py``. The wire form is
the tmproto.PublicKey oneof — field 1 = ed25519 bytes, field 2 =
secp256k1 bytes, field 3 = bls12381 bytes — exactly what
utils/codec.encode_pubkey emits; this module is the *typed* API layer
over it with the reference's error taxonomy.
"""

from __future__ import annotations

from ..utils import codec as _codec
from .keys import (
    BLS12381_KEY_TYPE,
    ED25519_KEY_TYPE,
    SECP256K1_KEY_TYPE,
    PubKey,
    pubkey_from_type_bytes,
)

_KEY_LENS = {
    ED25519_KEY_TYPE: 32,
    SECP256K1_KEY_TYPE: 33,
    BLS12381_KEY_TYPE: 48,
}


class ErrUnsupportedKey(ValueError):
    def __init__(self, key_type: str):
        self.key_type = key_type
        super().__init__(f"unsupported key type: {key_type!r}")


class ErrInvalidKeyLen(ValueError):
    def __init__(self, key_type: str, got: int, want: int):
        self.key_type, self.got, self.want = key_type, got, want
        super().__init__(
            f"invalid {key_type} key length: got {got}, want {want}"
        )


def pubkey_to_proto(pk: PubKey) -> bytes:
    """PubKeyToProto: typed key -> tmproto.PublicKey bytes."""
    try:
        return _codec.encode_pubkey(pk)
    except ValueError:
        raise ErrUnsupportedKey(
            getattr(pk, "type_", str(type(pk)))
        ) from None


def pubkey_from_proto(b: bytes) -> PubKey:
    """PubKeyFromProto: tmproto.PublicKey bytes -> typed key."""
    try:
        return _codec.decode_pubkey(b)
    except ValueError:
        raise ErrUnsupportedKey("<unknown oneof>") from None


def pubkey_from_type_and_bytes(key_type: str, raw: bytes) -> PubKey:
    """PubKeyFromTypeAndBytes with the reference's error taxonomy."""
    want = _KEY_LENS.get(key_type)
    if want is None:
        raise ErrUnsupportedKey(key_type)
    if len(raw) != want:
        raise ErrInvalidKeyLen(key_type, len(raw), want)
    return pubkey_from_type_bytes(key_type, raw)
