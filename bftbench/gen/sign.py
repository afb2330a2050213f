"""Ed25519 signing for the generators, in this process and cheap.

A signature is (R, S) with S = r + k a mod L, k = SHA-512(R || A || M):
RFC 8032's equation, so every verifier accepts it (S B = R + k A). Where
RFC 8032 draws the nonce r from the message, each key here keeps one
nonce for all its messages, derived from its seed, so that the points
A = a B and R = r B are read once a key (from OpenSSL's libcrypto,
through ctypes, as the public keys of the seed and of the nonce's seed)
and a signature costs a hash and a multiplication mod L. The reused
nonce would give the key away, which test data does not mind.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import hashlib

L = 2**252 + 27742317777372353535851937790883648493
_EVP_PKEY_ED25519 = 1087
_NONCE_TAG = b"bftbench/nonce"
_LIB = None


def _lib():
    global _LIB
    if _LIB is None:
        for name in (ctypes.util.find_library("crypto"), "libcrypto.so.3", "libcrypto.so"):
            if not name:
                continue
            try:
                lib = ctypes.CDLL(name)
                break
            except OSError:
                continue
        else:
            raise OSError("no libcrypto to derive public keys with")
        lib.EVP_PKEY_new_raw_private_key.restype = ctypes.c_void_p
        lib.EVP_PKEY_new_raw_private_key.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.EVP_PKEY_get_raw_public_key.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t)]
        lib.EVP_PKEY_free.argtypes = [ctypes.c_void_p]
        _LIB = lib
    return _LIB


def public_point(seed: bytes) -> bytes:
    """The Ed25519 public key of a 32-byte seed, as libcrypto derives it."""
    lib = _lib()
    pkey = lib.EVP_PKEY_new_raw_private_key(_EVP_PKEY_ED25519, None, seed, 32)
    if not pkey:
        raise ValueError("bad ed25519 seed")
    try:
        out = ctypes.create_string_buffer(32)
        n = ctypes.c_size_t(32)
        if lib.EVP_PKEY_get_raw_public_key(pkey, out, ctypes.byref(n)) != 1 or n.value != 32:
            raise ValueError("ed25519 public key failed")
        return out.raw
    finally:
        lib.EVP_PKEY_free(pkey)


def _scalar(seed: bytes) -> int:
    """The clamped secret scalar of a seed (RFC 8032, 5.1.5)."""
    a = int.from_bytes(hashlib.sha512(seed).digest()[:32], "little")
    return (a & ((1 << 254) - 8)) | (1 << 254)


class Signer:
    """Signs (32-byte seed, message) rows; a key's points are derived at
    its first row and kept."""

    def __init__(self):
        self._keys: dict = {}

    def _key(self, seed: bytes):
        k = self._keys.get(seed)
        if k is None:
            nonce_seed = hashlib.sha512(_NONCE_TAG + seed).digest()[:32]
            k = self._keys[seed] = (_scalar(seed), public_point(seed), _scalar(nonce_seed) % L,
                                    public_point(nonce_seed))
        return k

    def sign(self, rows) -> list:
        out = []
        for seed, msg in rows:
            a, pk, r, big_r = self._key(seed)
            k = int.from_bytes(hashlib.sha512(big_r + pk + msg).digest(), "little")
            out.append(big_r + ((r + k * a) % L).to_bytes(32, "little"))
        return out
