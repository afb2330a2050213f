"""ctypes bindings to the system libcrypto (OpenSSL >= 1.1.1): ed25519 only.

Fast host signing and verification for keys, tests and the smoke
script, without the ``cryptography`` wheel. Every binding sets
argtypes/restype explicitly (size_t truncation on 64-bit is the
classic ctypes bug) and frees its EVP objects. When libcrypto is
missing, ``available()`` is False and callers use the pure-Python
``ref_ed25519``.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_EVP_PKEY_ED25519 = 1087  # NID_ED25519

_lib = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    name = ctypes.util.find_library("crypto")
    candidates = [name] if name else []
    candidates += ["libcrypto.so.3", "libcrypto.so.1.1", "libcrypto.so"]
    for cand in candidates:
        if not cand:
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        try:
            _bind(lib)
        except AttributeError:
            continue  # too old: no raw-key EVP symbols
        _lib = lib
        return _lib
    return None


def _bind(lib: ctypes.CDLL) -> None:
    c = ctypes
    P = c.c_void_p
    S = c.c_size_t
    B = c.c_char_p
    lib.EVP_PKEY_new_raw_public_key.argtypes = [c.c_int, P, B, S]
    lib.EVP_PKEY_new_raw_public_key.restype = P
    lib.EVP_PKEY_new_raw_private_key.argtypes = [c.c_int, P, B, S]
    lib.EVP_PKEY_new_raw_private_key.restype = P
    lib.EVP_PKEY_get_raw_public_key.argtypes = [P, B, c.POINTER(S)]
    lib.EVP_PKEY_get_raw_public_key.restype = c.c_int
    lib.EVP_PKEY_free.argtypes = [P]
    lib.EVP_PKEY_free.restype = None
    lib.EVP_MD_CTX_new.restype = P
    lib.EVP_MD_CTX_free.argtypes = [P]
    lib.EVP_MD_CTX_free.restype = None
    lib.EVP_DigestVerifyInit.argtypes = [P, P, P, P, P]
    lib.EVP_DigestVerifyInit.restype = c.c_int
    lib.EVP_DigestVerify.argtypes = [P, B, S, B, S]
    lib.EVP_DigestVerify.restype = c.c_int
    lib.EVP_DigestSignInit.argtypes = [P, P, P, P, P]
    lib.EVP_DigestSignInit.restype = c.c_int
    lib.EVP_DigestSign.argtypes = [P, B, c.POINTER(S), B, S]
    lib.EVP_DigestSign.restype = c.c_int


def available() -> bool:
    return _load() is not None


def ed25519_verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """RFC 8032 (cofactorless) verify — the strict subset of ZIP-215;
    callers fall back to the liberal pure check on rejection."""
    lib = _load()
    pkey = lib.EVP_PKEY_new_raw_public_key(
        _EVP_PKEY_ED25519, None, pub, len(pub)
    )
    if not pkey:
        return False
    ctx = lib.EVP_MD_CTX_new()
    try:
        if lib.EVP_DigestVerifyInit(ctx, None, None, None, pkey) != 1:
            return False
        return lib.EVP_DigestVerify(ctx, sig, len(sig), msg, len(msg)) == 1
    finally:
        lib.EVP_MD_CTX_free(ctx)
        lib.EVP_PKEY_free(pkey)


def ed25519_sign(seed: bytes, msg: bytes) -> bytes:
    lib = _load()
    pkey = lib.EVP_PKEY_new_raw_private_key(
        _EVP_PKEY_ED25519, None, seed, len(seed)
    )
    if not pkey:
        raise ValueError("ed25519: bad private key")
    ctx = lib.EVP_MD_CTX_new()
    try:
        if lib.EVP_DigestSignInit(ctx, None, None, None, pkey) != 1:
            raise ValueError("ed25519: sign init failed")
        sig = ctypes.create_string_buffer(64)
        siglen = ctypes.c_size_t(64)
        if lib.EVP_DigestSign(ctx, sig, ctypes.byref(siglen), msg, len(msg)) != 1:
            raise ValueError("ed25519: sign failed")
        return sig.raw[: siglen.value]
    finally:
        lib.EVP_MD_CTX_free(ctx)
        lib.EVP_PKEY_free(pkey)


def ed25519_public(seed: bytes) -> bytes:
    lib = _load()
    pkey = lib.EVP_PKEY_new_raw_private_key(
        _EVP_PKEY_ED25519, None, seed, len(seed)
    )
    if not pkey:
        raise ValueError("ed25519: bad private key")
    try:
        out = ctypes.create_string_buffer(32)
        outlen = ctypes.c_size_t(32)
        if lib.EVP_PKEY_get_raw_public_key(pkey, out, ctypes.byref(outlen)) != 1:
            raise ValueError("get_raw_public_key failed")
        return out.raw[: outlen.value]
    finally:
        lib.EVP_PKEY_free(pkey)
