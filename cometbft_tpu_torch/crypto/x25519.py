"""X25519 Diffie-Hellman (RFC 7748) with a three-tier dependency gate.

A copy of the JAX package's ``crypto/x25519.py``. Same shape as
chacha20poly1305.py: the ``cryptography`` wheel when installed, else
the system libcrypto via ctypes (crypto/_ossl.py), else a pure-Python
Montgomery ladder. ``TIER`` names the one in use ("wheel", "ctypes" or
"pure"); ``public`` and ``shared`` dispatch on it. Keys are raw
32-byte strings on every backend so callers never touch backend
object types. The ladder is handshake-only cost (~1ms per exchange in
pure Python): bulk traffic never goes through here.
"""

from __future__ import annotations

import os

try:  # pragma: no cover - exercised only where the wheel exists
    from cryptography.hazmat.primitives.asymmetric.x25519 import (
        X25519PrivateKey,
        X25519PublicKey,
    )
    from cryptography.hazmat.primitives.serialization import (
        Encoding,
        PublicFormat,
    )

    HAVE_OPENSSL = True
except ImportError:
    HAVE_OPENSSL = False

from . import _ossl as _ctossl

_P = 2**255 - 19
_A24 = 121665
_BASE_U = 9


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def _decode_u(u: bytes) -> int:
    b = bytearray(u)
    b[31] &= 127  # RFC 7748: mask the unused high bit
    return int.from_bytes(b, "little")


def _ladder(k: int, u: int) -> int:
    x1 = u % _P
    x2, z2 = 1, 0
    x3, z3 = x1, 1
    swap = 0
    for t in reversed(range(255)):
        kt = (k >> t) & 1
        swap ^= kt
        if swap:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = kt
        a = (x2 + z2) % _P
        aa = a * a % _P
        b = (x2 - z2) % _P
        bb = b * b % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = d * a % _P
        cb = c * b % _P
        x3 = (da + cb) % _P
        x3 = x3 * x3 % _P
        z3 = (da - cb) % _P
        z3 = x1 * (z3 * z3 % _P) % _P
        x2 = aa * bb % _P
        z2 = e * ((aa + _A24 * e) % _P) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    return x2 * pow(z2, _P - 2, _P) % _P


def scalar_mult(scalar: bytes, u: bytes) -> bytes:
    """Raw RFC 7748 X25519(k, u) -> 32 bytes."""
    if len(scalar) != 32 or len(u) != 32:
        raise ValueError("x25519: need 32-byte scalar and u-coordinate")
    return _ladder(_decode_scalar(scalar), _decode_u(u)).to_bytes(32, "little")


def generate_private() -> bytes:
    """Fresh 32-byte private scalar (clamping happens at use)."""
    return os.urandom(32)


def available_tiers() -> list:
    """The tiers this machine can run, best first."""
    return (["wheel"] if HAVE_OPENSSL else []) + (["ctypes"] if _ctossl.available() else []) + ["pure"]


TIER = available_tiers()[0]


def public(priv: bytes) -> bytes:
    """Public u-coordinate for a raw private scalar."""
    if TIER == "wheel":
        return (
            X25519PrivateKey.from_private_bytes(priv)
            .public_key()
            .public_bytes(Encoding.Raw, PublicFormat.Raw)
        )
    if TIER == "ctypes":
        return _ctossl.x25519_public(priv)
    return scalar_mult(priv, _BASE_U.to_bytes(32, "little"))


def shared(priv: bytes, peer_pub: bytes) -> bytes:
    """ECDH shared secret. Raises ValueError on an all-zero result
    (low-order peer point), matching the OpenSSL backends."""
    if TIER == "wheel":
        return X25519PrivateKey.from_private_bytes(priv).exchange(
            X25519PublicKey.from_public_bytes(peer_pub)
        )
    if TIER == "ctypes":
        return _ctossl.x25519_shared(priv, peer_pub)
    out = scalar_mult(priv, peer_pub)
    if out == b"\x00" * 32:
        raise ValueError("x25519: low-order point, zero shared secret")
    return out
