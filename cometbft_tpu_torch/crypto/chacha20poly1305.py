"""ChaCha20-Poly1305 AEAD (RFC 8439) with a three-tier dependency gate.

A copy of the JAX package's ``crypto/chacha20poly1305.py``.
``ChaCha20Poly1305`` resolves to the best available backend, and
``TIER`` names it:

1. "wheel": the ``cryptography`` wheel's class, when that package is
   installed;
2. "ctypes": the system libcrypto through ctypes (crypto/_ossl.py) —
   same OpenSSL code, no wheel required (~30us per 1KB frame);
3. "pure": ``PureChaCha20Poly1305`` — numpy-vectorized ChaCha20
   (uint32 lanes wrap mod 2**32 natively; four quarter-rounds per
   dispatch) plus big-int Poly1305, with a sequential-nonce keystream
   precompute cache tuned for SecretConnection's counter nonces (~80us
   per 1KB frame warm, ~1ms cold).

``aead_class(tier)`` returns any available tier's class, so tests can
pin each tier against the others. Only the AEAD surface the secret
connection uses is provided: 32-byte key, 12-byte nonce, optional AAD,
16-byte tag appended to the ciphertext.
"""

from __future__ import annotations

import hmac
import struct

try:  # pragma: no cover - exercised only where the wheel exists
    from cryptography.exceptions import InvalidTag
    from cryptography.hazmat.primitives.ciphers.aead import (
        ChaCha20Poly1305,
    )

    HAVE_OPENSSL = True
except ImportError:
    HAVE_OPENSSL = False

    class InvalidTag(Exception):
        """Authentication failure (API-compatible with
        cryptography.exceptions.InvalidTag)."""


KEY_SIZE = 32
NONCE_SIZE = 12
TAG_SIZE = 16

_POLY_P = (1 << 130) - 5
_POLY_R_MASK = 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF


def _permute(init):
    """20-round ChaCha permutation + feed-forward over a (16, n)
    uint32 column-per-block state.

    The four quarter-rounds of each half-round are independent, so
    they run as ONE set of elementwise ops on (4, n) row bands
    (a=rows 0-3, b=4-7, c=8-11, d=12-15); the diagonal half rotates
    the b/c/d bands into place first. ~300 numpy dispatches per call
    instead of 960 — and the per-call cost is nearly independent of n,
    so callers batch as many blocks as possible (see _StreamCache)."""
    import numpy as np

    s = init.copy()
    a, b, c, d = s[0:4], s[4:8], s[8:12], s[12:16]  # in-place views

    def qr(a, b, c, d):
        a += b
        d ^= a
        d[:] = (d << np.uint32(16)) | (d >> np.uint32(16))
        c += d
        b ^= c
        b[:] = (b << np.uint32(12)) | (b >> np.uint32(20))
        a += b
        d ^= a
        d[:] = (d << np.uint32(8)) | (d >> np.uint32(24))
        c += d
        b ^= c
        b[:] = (b << np.uint32(7)) | (b >> np.uint32(25))

    for _ in range(10):
        qr(a, b, c, d)  # column round
        # diagonalize: band-local row rotations line up the diagonals
        b[:] = np.roll(b, -1, axis=0)
        c[:] = np.roll(c, -2, axis=0)
        d[:] = np.roll(d, -3, axis=0)
        qr(a, b, c, d)  # diagonal round
        b[:] = np.roll(b, 1, axis=0)
        c[:] = np.roll(c, 2, axis=0)
        d[:] = np.roll(d, 3, axis=0)
    s += init
    return s


def _init_state(key: bytes, nonces, counter: int, nblocks: int):
    """(16, len(nonces)*nblocks) init state: for each nonce, blocks
    counter..counter+nblocks-1."""
    import numpy as np

    n = len(nonces) * nblocks
    init = np.empty((16, n), dtype=np.uint32)
    init[0:4] = np.frombuffer(b"expand 32-byte k", dtype="<u4")[:, None]
    init[4:12] = np.frombuffer(key, dtype="<u4")[:, None]
    # 32-bit block counter wraps like the reference implementation
    ctr = (
        np.arange(counter, counter + nblocks, dtype=np.uint64) & 0xFFFFFFFF
    ).astype(np.uint32)
    init[12] = np.tile(ctr, len(nonces))
    for j, nc in enumerate(nonces):
        init[13:16, j * nblocks : (j + 1) * nblocks] = np.frombuffer(
            nc, dtype="<u4"
        )[:, None]
    return init


def chacha20_keystream(
    key: bytes, nonce: bytes, counter: int, length: int
) -> bytes:
    """``length`` bytes of RFC 8439 keystream starting at block
    ``counter``. numpy-vectorized over blocks."""
    if len(key) != KEY_SIZE or len(nonce) != NONCE_SIZE:
        raise ValueError("chacha20: need 32-byte key, 12-byte nonce")
    nblocks = (length + 63) // 64
    if nblocks == 0:
        return b""
    s = _permute(_init_state(key, [nonce], counter, nblocks))
    # each block serializes as 16 little-endian words
    return s.T.astype("<u4").tobytes()[:length]


def poly1305(key: bytes, msg: bytes) -> bytes:
    """RFC 8439 Poly1305 one-time MAC (16-byte tag)."""
    if len(key) != 32:
        raise ValueError("poly1305: need 32-byte one-time key")
    r = int.from_bytes(key[:16], "little") & _POLY_R_MASK
    s = int.from_bytes(key[16:], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        block = msg[i : i + 16]
        acc = (
            (acc + int.from_bytes(block, "little") + (1 << (8 * len(block))))
            * r
            % _POLY_P
        )
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _mac_data(aad: bytes, ct: bytes) -> bytes:
    def pad16(b: bytes) -> bytes:
        return b"\x00" * (-len(b) % 16)

    return (
        aad
        + pad16(aad)
        + ct
        + pad16(ct)
        + struct.pack("<QQ", len(aad), len(ct))
    )


# The dominant fallback consumer is SecretConnection, whose nonces are
# per-direction little-endian message counters and whose frames are a
# fixed 1024 bytes: once two successive nonces arrive we precompute
# keystreams for a growing window of FUTURE nonces in one numpy call,
# amortizing the fixed ~1ms permutation-dispatch cost across frames.
# Random-access nonce users (XChaCha's fresh per-seal subkey objects)
# never trigger the batch and pay single-shot cost only.
_SEQ_BLOCKS = 17  # otk block + 16 blocks = one 1024B frame
_MAX_BATCH = 48


class _StreamCache:
    def __init__(self, key: bytes):
        self.key = key
        self.entries = {}  # nonce -> 17*64B keystream (otk first)
        self.last = None  # int of last requested nonce
        self.batch = 4

    def take(self, nonce: bytes):
        cur = int.from_bytes(nonce, "little")
        sequential = self.last is not None and cur == self.last + 1
        self.last = cur
        ent = self.entries.pop(nonce, None)
        if ent is not None:
            return ent
        count = 1
        if sequential:
            count = self.batch
            self.batch = min(self.batch * 2, _MAX_BATCH)
        nonces = [
            ((cur + i) % (1 << 96)).to_bytes(12, "little")
            for i in range(count)
        ]
        s = _permute(_init_state(self.key, nonces, 0, _SEQ_BLOCKS))
        raw = s.T.astype("<u4").tobytes()
        per = _SEQ_BLOCKS * 64
        for i, nc in enumerate(nonces[1:], start=1):
            self.entries[nc] = raw[i * per : (i + 1) * per]
        if len(self.entries) > 4 * _MAX_BATCH:  # runaway guard
            self.entries.clear()
        return raw[:per]


class PureChaCha20Poly1305:
    """API-compatible subset of
    cryptography.hazmat.primitives.ciphers.aead.ChaCha20Poly1305.
    Always importable (differential tests pin it against OpenSSL);
    exported as ``ChaCha20Poly1305`` only when OpenSSL is absent."""

    def __init__(self, key: bytes):
        if len(key) != KEY_SIZE:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)
        self._cache = _StreamCache(self._key)

    def _streams(self, nonce: bytes, length: int):
        """(one-time poly key, data keystream) for this nonce."""
        if len(nonce) != NONCE_SIZE:
            # match the OpenSSL backends exactly — the cache path would
            # otherwise silently zero-extend a short nonce
            raise ValueError("ChaCha20Poly1305 nonce must be 12 bytes")
        if length <= (_SEQ_BLOCKS - 1) * 64:
            ks = self._cache.take(nonce)
            return ks[:32], ks[64 : 64 + length]
        # oversize: one contiguous run (block 0 = poly key, 1.. = data)
        ks = chacha20_keystream(self._key, nonce, 0, 64 + length)
        return ks[:32], ks[64:]

    @staticmethod
    def _xor(data: bytes, ks: bytes) -> bytes:
        import numpy as np

        return (
            np.frombuffer(data, dtype=np.uint8)
            ^ np.frombuffer(ks, dtype=np.uint8)
        ).tobytes()

    def encrypt(
        self, nonce: bytes, data: bytes, associated_data=None
    ) -> bytes:
        aad = associated_data or b""
        otk, ks = self._streams(nonce, len(data))
        ct = self._xor(data, ks)
        return ct + poly1305(otk, _mac_data(aad, ct))

    def decrypt(
        self, nonce: bytes, data: bytes, associated_data=None
    ) -> bytes:
        if len(data) < TAG_SIZE:
            raise InvalidTag("ciphertext shorter than tag")
        aad = associated_data or b""
        ct, tag = data[:-TAG_SIZE], data[-TAG_SIZE:]
        otk, ks = self._streams(nonce, len(ct))
        if not hmac.compare_digest(tag, poly1305(otk, _mac_data(aad, ct))):
            raise InvalidTag("poly1305 tag mismatch")
        return self._xor(ct, ks)


from . import _ossl as _ctossl  # noqa: E402


def available_tiers() -> list:
    """The tiers this machine can run, best first."""
    return (["wheel"] if HAVE_OPENSSL else []) + (["ctypes"] if _ctossl.available() else []) + ["pure"]


def aead_class(tier: str):
    """The AEAD class of one available tier."""
    if tier not in available_tiers():
        raise ValueError(f"AEAD tier {tier!r} is not available here")
    if tier == "wheel":
        return _WheelChaCha20Poly1305
    if tier == "ctypes":
        return _ctossl.OsslChaCha20Poly1305
    return PureChaCha20Poly1305


if HAVE_OPENSSL:
    _WheelChaCha20Poly1305 = ChaCha20Poly1305
TIER = available_tiers()[0]
ChaCha20Poly1305 = aead_class(TIER)  # noqa: F811
