"""Pure-Python reference ed25519 (RFC 8032 + ZIP-215 semantics).

This is the *correctness oracle* for the CUDA kernels behind
``cometbft_tpu_torch.ops.ed25519``, and the host expansion of public
keys for its precomp mode — slow big-int arithmetic, bit-for-bit
well-defined.  The reference framework's production verifier
(curve25519-voi, see reference crypto/ed25519/ed25519.go:10-31) uses
ZIP-215 verification semantics:

  * non-canonical point encodings (y >= p) are ACCEPTED (y reduced mod p),
  * small-order / mixed-order points are accepted,
  * x = 0 with sign bit 1 is accepted (x := -0 = 0),
  * S must be canonical (S < L),
  * the *cofactored* equation  [8][S]B = [8]R + [8][h]A  is checked.

Signing follows RFC 8032 exactly (deterministic nonce).
"""

from __future__ import annotations

import hashlib
import os

__all__ = [
    "P", "L", "D", "BASE",
    "sign", "verify_zip215", "public_from_seed", "point_decompress",
    "point_compress", "point_add", "point_mul", "point_equal", "sc_reduce",
]

# Field prime and group order.
P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493

def _inv(x: int) -> int:
    return pow(x, P - 2, P)

# Twisted Edwards curve: -x^2 + y^2 = 1 + d x^2 y^2
D = (-121665 * _inv(121666)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1)

# Points are extended homogeneous coordinates (X, Y, Z, T), x=X/Z y=Y/Z xy=T/Z.
IDENTITY = (0, 1, 1, 0)


def point_add(p, q):
    # add-2008-hwcd-3; complete for a = -1, d non-square.
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * T1 * T2 * D % P
    Dd = 2 * Z1 * Z2 % P
    E, F, G, H = (B - A) % P, (Dd - C) % P, (Dd + C) % P, (B + A) % P
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def point_double(p):
    return point_add(p, p)


def point_neg(p):
    X, Y, Z, T = p
    return ((-X) % P, Y, Z, (-T) % P)


def point_mul(s: int, p):
    q = IDENTITY
    while s > 0:
        if s & 1:
            q = point_add(q, p)
        p = point_add(p, p)
        s >>= 1
    return q


def point_equal(p, q) -> bool:
    X1, Y1, Z1, _ = p
    X2, Y2, Z2, _ = q
    return (X1 * Z2 - X2 * Z1) % P == 0 and (Y1 * Z2 - Y2 * Z1) % P == 0


def _recover_x(y: int, sign: int):
    """dalek-style decompression x from y; None if not on curve."""
    x2 = (y * y - 1) * _inv(D * y * y + 1) % P
    if x2 == 0:
        # x = 0; sign bit is ignored (-0 == 0), matching curve25519-dalek /
        # ZIP-215 semantics (RFC 8032 strict mode would reject sign=1 here).
        return 0
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P != 0:
        x = x * SQRT_M1 % P
    if (x * x - x2) % P != 0:
        return None
    if x & 1 != sign:
        x = P - x
    return x


# Base point: y = 4/5.
_by = 4 * _inv(5) % P
_bx = _recover_x(_by, 0)
BASE = (_bx, _by, 1, _bx * _by % P)


def point_decompress(s: bytes, zip215: bool = True):
    """Decompress a 32-byte point encoding. Returns extended coords or None."""
    if len(s) != 32:
        return None
    y = int.from_bytes(s, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    if y >= P:
        if not zip215:
            return None
        y %= P
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def point_compress(p) -> bytes:
    X, Y, Z, _ = p
    zinv = _inv(Z)
    x, y = X * zinv % P, Y * zinv % P
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


def sc_reduce(b: bytes) -> int:
    return int.from_bytes(b, "little") % L


def _hash(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little")


def _clamp(a: int) -> int:
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a


def public_from_seed(seed: bytes) -> bytes:
    assert len(seed) == 32
    a = _clamp(int.from_bytes(hashlib.sha512(seed).digest()[:32], "little"))
    return point_compress(point_mul(a, BASE))


def sign(seed: bytes, msg: bytes) -> bytes:
    """RFC 8032 deterministic signature; returns 64 bytes R || S."""
    h = hashlib.sha512(seed).digest()
    a = _clamp(int.from_bytes(h[:32], "little"))
    prefix = h[32:]
    A = point_compress(point_mul(a, BASE))
    r = _hash(prefix, msg) % L
    R = point_compress(point_mul(r, BASE))
    k = _hash(R, A, msg) % L
    s = (r + k * a) % L
    return R + s.to_bytes(32, "little")


def verify_zip215(public: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 verification: cofactored equation, liberal point decoding."""
    if len(public) != 32 or len(sig) != 64:
        return False
    A = point_decompress(public, zip215=True)
    if A is None:
        return False
    R = point_decompress(sig[:32], zip215=True)
    if R is None:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:  # S must be canonical
        return False
    k = _hash(sig[:32], public, msg) % L
    # [8]([S]B - [h]A - R) == identity
    sB = point_mul(s, BASE)
    kA = point_mul(k, A)
    diff = point_add(point_add(sB, point_neg(kA)), point_neg(R))
    eight = point_mul(8, diff)
    return point_equal(eight, IDENTITY)


def generate_seed() -> bytes:
    return os.urandom(32)
