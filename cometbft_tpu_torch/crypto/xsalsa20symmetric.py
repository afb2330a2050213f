"""NaCl secretbox symmetric encryption (reference
crypto/xsalsa20symmetric/symmetric.go): XSalsa20 stream cipher +
Poly1305 one-time MAC, wire format ``nonce(24) || tag(16) || ct``.
A copy of the JAX package's ``crypto/xsalsa20symmetric.py``.

Used for passphrase-encrypting armored private keys (secret = 32 bytes,
"something like Sha256(Bcrypt(passphrase))" per the reference). Pure
Python: payloads are key-sized, so throughput is irrelevant; what
matters is exact NaCl compatibility (HSalsa20 subkey derivation, Salsa20
counter stream with the first 32 bytes reserved for the Poly1305 key).
"""

from __future__ import annotations

import hmac
import os
import struct

# shared 32-bit word primitives + "expand 32-byte k" constants: the
# Salsa and ChaCha families use the same sigma and rotate
from .xchacha20poly1305 import _MASK, _SIGMA, _rotl

NONCE_LEN = 24
SECRET_LEN = 32
OVERHEAD = 16  # poly1305 tag


def _salsa_doubleround(x):
    # columnround
    x[4] ^= _rotl((x[0] + x[12]) & _MASK, 7)
    x[8] ^= _rotl((x[4] + x[0]) & _MASK, 9)
    x[12] ^= _rotl((x[8] + x[4]) & _MASK, 13)
    x[0] ^= _rotl((x[12] + x[8]) & _MASK, 18)
    x[9] ^= _rotl((x[5] + x[1]) & _MASK, 7)
    x[13] ^= _rotl((x[9] + x[5]) & _MASK, 9)
    x[1] ^= _rotl((x[13] + x[9]) & _MASK, 13)
    x[5] ^= _rotl((x[1] + x[13]) & _MASK, 18)
    x[14] ^= _rotl((x[10] + x[6]) & _MASK, 7)
    x[2] ^= _rotl((x[14] + x[10]) & _MASK, 9)
    x[6] ^= _rotl((x[2] + x[14]) & _MASK, 13)
    x[10] ^= _rotl((x[6] + x[2]) & _MASK, 18)
    x[3] ^= _rotl((x[15] + x[11]) & _MASK, 7)
    x[7] ^= _rotl((x[3] + x[15]) & _MASK, 9)
    x[11] ^= _rotl((x[7] + x[3]) & _MASK, 13)
    x[15] ^= _rotl((x[11] + x[7]) & _MASK, 18)
    # rowround
    x[1] ^= _rotl((x[0] + x[3]) & _MASK, 7)
    x[2] ^= _rotl((x[1] + x[0]) & _MASK, 9)
    x[3] ^= _rotl((x[2] + x[1]) & _MASK, 13)
    x[0] ^= _rotl((x[3] + x[2]) & _MASK, 18)
    x[6] ^= _rotl((x[5] + x[4]) & _MASK, 7)
    x[7] ^= _rotl((x[6] + x[5]) & _MASK, 9)
    x[4] ^= _rotl((x[7] + x[6]) & _MASK, 13)
    x[5] ^= _rotl((x[4] + x[7]) & _MASK, 18)
    x[11] ^= _rotl((x[10] + x[9]) & _MASK, 7)
    x[8] ^= _rotl((x[11] + x[10]) & _MASK, 9)
    x[9] ^= _rotl((x[8] + x[11]) & _MASK, 13)
    x[10] ^= _rotl((x[9] + x[8]) & _MASK, 18)
    x[12] ^= _rotl((x[15] + x[14]) & _MASK, 7)
    x[13] ^= _rotl((x[12] + x[15]) & _MASK, 9)
    x[14] ^= _rotl((x[13] + x[12]) & _MASK, 13)
    x[15] ^= _rotl((x[14] + x[13]) & _MASK, 18)


def _salsa20_block(key: bytes, block16: bytes) -> bytes:
    """Salsa20 core with the final state addition (the stream block)."""
    k = struct.unpack("<8L", key)
    n = struct.unpack("<4L", block16)
    init = [
        _SIGMA[0], k[0], k[1], k[2],
        k[3], _SIGMA[1], n[0], n[1],
        n[2], n[3], _SIGMA[2], k[4],
        k[5], k[6], k[7], _SIGMA[3],
    ]
    x = list(init)
    for _ in range(10):
        _salsa_doubleround(x)
    return struct.pack(
        "<16L", *(((a + b) & _MASK) for a, b in zip(x, init))
    )


def hsalsa20(key: bytes, nonce16: bytes) -> bytes:
    """HSalsa20 KDF (no final addition; words 0,5,10,15,6,7,8,9)."""
    k = struct.unpack("<8L", key)
    n = struct.unpack("<4L", nonce16)
    x = [
        _SIGMA[0], k[0], k[1], k[2],
        k[3], _SIGMA[1], n[0], n[1],
        n[2], n[3], _SIGMA[2], k[4],
        k[5], k[6], k[7], _SIGMA[3],
    ]
    for _ in range(10):
        _salsa_doubleround(x)
    return struct.pack(
        "<8L", *(x[i] for i in (0, 5, 10, 15, 6, 7, 8, 9))
    )


def _xsalsa20_stream(key: bytes, nonce24: bytes, length: int) -> bytes:
    sub = hsalsa20(key, nonce24[:16])
    out = bytearray()
    counter = 0
    while len(out) < length:
        block16 = nonce24[16:24] + struct.pack("<Q", counter)
        out += _salsa20_block(sub, block16)
        counter += 1
    return bytes(out[:length])


def _poly1305(key32: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(key32[:16], "little")
    r &= 0x0FFFFFFC0FFFFFFC0FFFFFFC0FFFFFFF
    s = int.from_bytes(key32[16:32], "little")
    p = (1 << 130) - 5
    acc = 0
    for i in range(0, len(msg), 16):
        chunk = msg[i : i + 16]
        n = int.from_bytes(chunk, "little") + (1 << (8 * len(chunk)))
        acc = (acc + n) * r % p
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def seal(plaintext: bytes, nonce: bytes, secret: bytes) -> bytes:
    """secretbox.Seal: returns tag(16) || ct (no nonce prefix)."""
    if len(secret) != SECRET_LEN:
        raise ValueError("secret must be 32 bytes")
    if len(nonce) != NONCE_LEN:
        raise ValueError("nonce must be 24 bytes")
    stream = _xsalsa20_stream(secret, nonce, 32 + len(plaintext))
    poly_key, pad = stream[:32], stream[32:]
    ct = bytes(a ^ b for a, b in zip(plaintext, pad))
    return _poly1305(poly_key, ct) + ct


def open_box(boxed: bytes, nonce: bytes, secret: bytes) -> bytes:
    """secretbox.Open; raises ValueError on authentication failure."""
    if len(secret) != SECRET_LEN:
        raise ValueError("secret must be 32 bytes")
    if len(boxed) < OVERHEAD:
        raise ValueError("ciphertext too short")
    tag, ct = boxed[:16], boxed[16:]
    stream = _xsalsa20_stream(secret, nonce, 32 + len(ct))
    poly_key, pad = stream[:32], stream[32:]
    if not hmac.compare_digest(tag, _poly1305(poly_key, ct)):
        raise ValueError("ciphertext decryption failed")
    return bytes(a ^ b for a, b in zip(ct, pad))


def encrypt_symmetric(plaintext: bytes, secret: bytes) -> bytes:
    """Reference EncryptSymmetric: nonce(24) || secretbox.Seal(...).
    Ciphertext is nonce+overhead = 40 bytes longer than the plaintext."""
    nonce = os.urandom(NONCE_LEN)
    return nonce + seal(plaintext, nonce, secret)


def decrypt_symmetric(ciphertext: bytes, secret: bytes) -> bytes:
    """Reference DecryptSymmetric; raises ValueError on bad input/MAC."""
    if len(ciphertext) <= NONCE_LEN + OVERHEAD:
        raise ValueError("ciphertext is too short")
    nonce = ciphertext[:NONCE_LEN]
    return open_box(ciphertext[NONCE_LEN:], nonce, secret)
