"""XChaCha20-Poly1305 AEAD (reference crypto/xchacha20poly1305/
xchachapoly.go): the 24-byte-nonce extension of ChaCha20-Poly1305.

A copy of the JAX package's ``crypto/xchacha20poly1305.py``; the inner
AEAD is this package's ``chacha20poly1305.ChaCha20Poly1305`` (its best
tier: the wheel, libcrypto through ctypes, or pure Python).

Construction (draft-irtf-cfrg-xchacha): derive a subkey with HChaCha20
over the first 16 nonce bytes, then run standard ChaCha20-Poly1305
(RFC 8439) with a 12-byte nonce of 4 zero bytes + the
remaining 8 nonce bytes. Only HChaCha20 runs in Python — it is a
fixed-cost KDF per seal/open, not a per-byte cost.
"""

from __future__ import annotations

import struct

from .chacha20poly1305 import ChaCha20Poly1305, InvalidTag

KEY_SIZE = 32
NONCE_SIZE = 24
TAG_SIZE = 16

_SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)
_MASK = 0xFFFFFFFF


def _rotl(v: int, n: int) -> int:
    return ((v << n) & _MASK) | (v >> (32 - n))


def _quarter(s, a, b, c, d):
    s[a] = (s[a] + s[b]) & _MASK
    s[d] = _rotl(s[d] ^ s[a], 16)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotl(s[b] ^ s[c], 12)
    s[a] = (s[a] + s[b]) & _MASK
    s[d] = _rotl(s[d] ^ s[a], 8)
    s[c] = (s[c] + s[d]) & _MASK
    s[b] = _rotl(s[b] ^ s[c], 7)


def hchacha20(key: bytes, nonce16: bytes) -> bytes:
    """HChaCha20 KDF: 32-byte subkey from key + 16-byte nonce prefix
    (reference xchachapoly.go:131 hChaCha20Generic; differential
    vectors in the reference's vector_test.go)."""
    if len(key) != 32 or len(nonce16) != 16:
        raise ValueError("hchacha20: need 32-byte key, 16-byte nonce")
    s = list(_SIGMA) + list(struct.unpack("<8L", key)) + list(
        struct.unpack("<4L", nonce16)
    )
    for _ in range(10):
        _quarter(s, 0, 4, 8, 12)
        _quarter(s, 1, 5, 9, 13)
        _quarter(s, 2, 6, 10, 14)
        _quarter(s, 3, 7, 11, 15)
        _quarter(s, 0, 5, 10, 15)
        _quarter(s, 1, 6, 11, 12)
        _quarter(s, 2, 7, 8, 13)
        _quarter(s, 3, 4, 9, 14)
    return struct.pack("<8L", *(s[i] for i in (0, 1, 2, 3, 12, 13, 14, 15)))


class XChaCha20Poly1305:
    """AEAD with 24-byte nonces (reference New/Seal/Open)."""

    def __init__(self, key: bytes):
        if len(key) != KEY_SIZE:
            raise ValueError("xchacha20poly1305: bad key length")
        self._key = bytes(key)

    @property
    def nonce_size(self) -> int:
        return NONCE_SIZE

    @property
    def overhead(self) -> int:
        return TAG_SIZE

    def _inner(self, nonce: bytes):
        if len(nonce) != NONCE_SIZE:
            raise ValueError("xchacha20poly1305: bad nonce length")
        sub = hchacha20(self._key, nonce[:16])
        return ChaCha20Poly1305(sub), b"\x00" * 4 + nonce[16:]

    def seal(self, nonce: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
        aead, n12 = self._inner(nonce)
        return aead.encrypt(n12, plaintext, aad or None)

    def open(self, nonce: bytes, ciphertext: bytes, aad: bytes = b"") -> bytes:
        """Raises ValueError on authentication failure."""
        aead, n12 = self._inner(nonce)
        try:
            return aead.decrypt(n12, ciphertext, aad or None)
        except InvalidTag:
            raise ValueError("xchacha20poly1305: message authentication failed")
