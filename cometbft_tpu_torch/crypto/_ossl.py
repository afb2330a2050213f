"""ctypes bindings to the system libcrypto (OpenSSL >= 1.1.1).

A copy of the JAX package's ``crypto/_ossl.py``: the narrow EVP
surface the port needs, for machines that have the library but not
the ``cryptography`` wheel. Ed25519 sign/verify/public-from-seed (fast
host signing and verification for keys, tests and the smoke script),
X25519 derive and ChaCha20-Poly1305 AEAD (the secret connection's
handshake and frames, ``crypto/x25519.py`` and
``crypto/chacha20poly1305.py``). Every binding sets argtypes/restype
explicitly (size_t truncation on 64-bit is the classic ctypes bug) and
frees its EVP objects; each function raises or returns exactly like
its wheel-backed twin. When libcrypto is missing, ``available()`` is
False and callers use the pure-Python tiers.
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_EVP_PKEY_ED25519 = 1087  # NID_ED25519
_EVP_PKEY_X25519 = 1034  # NID_X25519
_CTRL_AEAD_SET_IVLEN = 0x9
_CTRL_AEAD_GET_TAG = 0x10
_CTRL_AEAD_SET_TAG = 0x11

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
            lib = ctypes.CDLL(cand)  # bftlint: disable=TCH204 — one-time probe of the libcrypto names at first use; the handle is cached in _lib and never loaded again
        except OSError:
            continue
        try:
            _bind(lib)
        except AttributeError:
            continue  # too old: missing EVP raw-key / AEAD symbols
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
    lib.EVP_PKEY_CTX_new.argtypes = [P, P]
    lib.EVP_PKEY_CTX_new.restype = P
    lib.EVP_PKEY_CTX_free.argtypes = [P]
    lib.EVP_PKEY_CTX_free.restype = None
    lib.EVP_PKEY_derive_init.argtypes = [P]
    lib.EVP_PKEY_derive_init.restype = c.c_int
    lib.EVP_PKEY_derive_set_peer.argtypes = [P, P]
    lib.EVP_PKEY_derive_set_peer.restype = c.c_int
    lib.EVP_PKEY_derive.argtypes = [P, B, c.POINTER(S)]
    lib.EVP_PKEY_derive.restype = c.c_int
    lib.EVP_CIPHER_CTX_new.restype = P
    lib.EVP_CIPHER_CTX_free.argtypes = [P]
    lib.EVP_CIPHER_CTX_free.restype = None
    lib.EVP_chacha20_poly1305.restype = P
    lib.EVP_CipherInit_ex.argtypes = [P, P, P, B, B, c.c_int]
    lib.EVP_CipherInit_ex.restype = c.c_int
    lib.EVP_CIPHER_CTX_ctrl.argtypes = [P, c.c_int, c.c_int, P]
    lib.EVP_CIPHER_CTX_ctrl.restype = c.c_int
    lib.EVP_CipherUpdate.argtypes = [P, B, c.POINTER(c.c_int), B, c.c_int]
    lib.EVP_CipherUpdate.restype = c.c_int
    lib.EVP_CipherFinal_ex.argtypes = [P, B, c.POINTER(c.c_int)]
    lib.EVP_CipherFinal_ex.restype = c.c_int


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


def _raw_public(pkey) -> bytes:
    lib = _load()
    out = ctypes.create_string_buffer(32)
    outlen = ctypes.c_size_t(32)
    if lib.EVP_PKEY_get_raw_public_key(pkey, out, ctypes.byref(outlen)) != 1:
        raise ValueError("get_raw_public_key failed")
    return out.raw[: outlen.value]


def ed25519_public(seed: bytes) -> bytes:
    lib = _load()
    pkey = lib.EVP_PKEY_new_raw_private_key(
        _EVP_PKEY_ED25519, None, seed, len(seed)
    )
    if not pkey:
        raise ValueError("ed25519: bad private key")
    try:
        return _raw_public(pkey)
    finally:
        lib.EVP_PKEY_free(pkey)


# --- x25519 -------------------------------------------------------------


def x25519_public(priv: bytes) -> bytes:
    lib = _load()
    pkey = lib.EVP_PKEY_new_raw_private_key(_EVP_PKEY_X25519, None, priv, len(priv))
    if not pkey:
        raise ValueError("x25519: bad private key")
    try:
        return _raw_public(pkey)
    finally:
        lib.EVP_PKEY_free(pkey)


def x25519_shared(priv: bytes, peer_pub: bytes) -> bytes:
    lib = _load()
    pkey = lib.EVP_PKEY_new_raw_private_key(_EVP_PKEY_X25519, None, priv, len(priv))
    peer = lib.EVP_PKEY_new_raw_public_key(_EVP_PKEY_X25519, None, peer_pub, len(peer_pub))
    if not pkey or not peer:
        lib.EVP_PKEY_free(pkey)
        lib.EVP_PKEY_free(peer)
        raise ValueError("x25519: bad key")
    ctx = lib.EVP_PKEY_CTX_new(pkey, None)
    try:
        if lib.EVP_PKEY_derive_init(ctx) != 1 or lib.EVP_PKEY_derive_set_peer(ctx, peer) != 1:
            raise ValueError("x25519: derive init failed")
        out = ctypes.create_string_buffer(32)
        outlen = ctypes.c_size_t(32)
        if lib.EVP_PKEY_derive(ctx, out, ctypes.byref(outlen)) != 1:
            # OpenSSL refuses low-order results; match the wheel's error
            raise ValueError("x25519: low-order point, zero shared secret")
        return out.raw[: outlen.value]
    finally:
        lib.EVP_PKEY_CTX_free(ctx)
        lib.EVP_PKEY_free(peer)
        lib.EVP_PKEY_free(pkey)


# --- ChaCha20-Poly1305 --------------------------------------------------


class OsslChaCha20Poly1305:
    """API-compatible subset of the wheel's ChaCha20Poly1305, bound to
    the system libcrypto. One EVP context per operation (the contexts
    are not safely reusable across asyncio interleavings)."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)
        if _load() is None:  # pragma: no cover - guarded by callers
            raise RuntimeError("libcrypto unavailable")

    def _run(self, enc: int, nonce, data, aad, tag=None):
        from .chacha20poly1305 import InvalidTag

        lib = _load()
        ctx = lib.EVP_CIPHER_CTX_new()
        try:
            if lib.EVP_CipherInit_ex(ctx, lib.EVP_chacha20_poly1305(), None, None, None, enc) != 1:
                raise RuntimeError("chacha20poly1305: init failed")
            lib.EVP_CIPHER_CTX_ctrl(ctx, _CTRL_AEAD_SET_IVLEN, len(nonce), None)
            if lib.EVP_CipherInit_ex(ctx, None, None, self._key, bytes(nonce), enc) != 1:
                raise RuntimeError("chacha20poly1305: key/iv init failed")
            outl = ctypes.c_int(0)
            if aad:
                if lib.EVP_CipherUpdate(ctx, None, ctypes.byref(outl), aad, len(aad)) != 1:
                    raise RuntimeError("chacha20poly1305: aad failed")
            out = ctypes.create_string_buffer(len(data) or 1)
            if lib.EVP_CipherUpdate(ctx, out, ctypes.byref(outl), data, len(data)) != 1:
                raise InvalidTag("chacha20poly1305: update failed")
            n = outl.value
            if not enc:
                lib.EVP_CIPHER_CTX_ctrl(
                    ctx, _CTRL_AEAD_SET_TAG, 16, ctypes.cast(ctypes.c_char_p(tag), ctypes.c_void_p)
                )
            fin = ctypes.create_string_buffer(16)
            if lib.EVP_CipherFinal_ex(ctx, fin, ctypes.byref(outl)) != 1:
                raise InvalidTag("poly1305 tag mismatch")
            n += outl.value
            body = out.raw[:n]
            if enc:
                tagbuf = ctypes.create_string_buffer(16)
                lib.EVP_CIPHER_CTX_ctrl(
                    ctx, _CTRL_AEAD_GET_TAG, 16, ctypes.cast(tagbuf, ctypes.c_void_p)
                )
                return body + tagbuf.raw
            return body
        finally:
            lib.EVP_CIPHER_CTX_free(ctx)

    def encrypt(self, nonce, data, associated_data=None) -> bytes:
        return self._run(1, nonce, data, associated_data or b"")

    def decrypt(self, nonce, data, associated_data=None) -> bytes:
        from .chacha20poly1305 import InvalidTag

        if len(data) < 16:
            raise InvalidTag("ciphertext shorter than tag")
        return self._run(0, nonce, data[:-16], associated_data or b"", tag=data[-16:])
