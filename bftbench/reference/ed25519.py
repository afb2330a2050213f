"""Ed25519 signature verification in plain Python (RFC 8032, section
5.1.7), the reference's own: it imports nothing of the program.

Points are kept in extended coordinates (X, Y, Z, T) on the twisted
Edwards curve -x^2 + y^2 = 1 + d x^2 y^2 over GF(2^255 - 19). A
verification computes [s]B - [k]A by interleaved width-5 NAF ladders
(the odd multiples of B once, those of -A once a key) and compares the
encoding with R: the cofactorless equation. The program follows ZIP-215
(cofactored, non-canonical encodings accepted); on the inputs the
benchmark makes (canonical encodings; honest signatures, or one with a
flipped bit) the two rules give the same verdict.
"""

from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
_BY = 4 * pow(5, P - 2, P) % P
W = 5  # NAF width


def _recover_x(y: int, sign: int):
    """x with x^2 = (y^2 - 1) / (d y^2 + 1) and parity ``sign``, or None."""
    if y >= P:
        return None
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    vx2 = v * x * x % P
    if vx2 == u:
        pass
    elif vx2 == (-u) % P:
        x = x * SQRT_M1 % P
    else:
        return None
    if x == 0 and sign:
        return None
    if x & 1 != sign:
        x = P - x
    return x


def decode_point(b: bytes):
    """The point a 32-byte encoding names, in extended coordinates, or None."""
    if len(b) != 32:
        return None
    y = int.from_bytes(b, "little")
    sign = y >> 255
    y &= (1 << 255) - 1
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def encode_point(pt) -> bytes:
    x, y, z, _ = pt
    zi = pow(z, P - 2, P)
    x, y = x * zi % P, y * zi % P
    return (y | (x & 1) << 255).to_bytes(32, "little")


def add(p, q):
    x1, y1, z1, t1 = p
    x2, y2, z2, t2 = q
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def double(p):
    x1, y1, z1, _ = p
    a = x1 * x1 % P
    b = y1 * y1 % P
    c = 2 * z1 * z1 % P
    e = ((x1 + y1) * (x1 + y1) - a - b) % P
    g = b - a
    f = g - c
    h = -a - b
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def neg(p):
    x, y, z, t = p
    return (-x % P, y, z, -t % P)


IDENTITY = (0, 1, 1, 0)
B = (_recover_x(_BY, 0), _BY, 1, _recover_x(_BY, 0) * _BY % P)


def _odd_multiples(p):
    """[p, 3p, 5p, ..., (2^(W-1) - 1)p]."""
    p2 = double(p)
    out = [p]
    for _ in range((1 << (W - 2)) - 1):
        out.append(add(out[-1], p2))
    return out


def _naf(k: int):
    """Width-W NAF digits of k, least significant first."""
    out = []
    while k:
        if k & 1:
            m = k & ((1 << W) - 1)
            if m >= 1 << (W - 1):
                m -= 1 << W
            k -= m
            out.append(m)
        else:
            out.append(0)
        k >>= 1
    return out


_B_TABLE = _odd_multiples(B)
_B_NEG = [neg(q) for q in _B_TABLE]
_KEY_TABLES: dict = {}


def _key_tables(pk: bytes):
    """(odd multiples of -A, of A) for the key, or None if it does not decode."""
    t = _KEY_TABLES.get(pk)
    if t is None:
        a = decode_point(pk)
        if a is None:
            return None
        minus = _odd_multiples(neg(a))
        t = (minus, [neg(q) for q in minus])
        if len(_KEY_TABLES) < 65536:
            _KEY_TABLES[pk] = t
    return t


def _double_mult(s: int, k: int, tables):
    """[s]B + [k](-A) by interleaved NAF."""
    ns, nk = _naf(s), _naf(k)
    minus_a, plus_a = tables
    acc = IDENTITY
    for i in range(max(len(ns), len(nk)) - 1, -1, -1):
        acc = double(acc)
        if i < len(ns) and ns[i]:
            m = ns[i]
            acc = add(acc, _B_TABLE[m >> 1] if m > 0 else _B_NEG[(-m) >> 1])
        if i < len(nk) and nk[i]:
            m = nk[i]
            acc = add(acc, minus_a[m >> 1] if m > 0 else plus_a[(-m) >> 1])
    return acc


def verify(pk: bytes, msg: bytes, sig: bytes) -> bool:
    """True iff ``sig`` is a valid signature of ``msg`` by the key ``pk``."""
    if len(pk) != 32 or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    tables = _key_tables(bytes(pk))
    if tables is None:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pk + msg).digest(), "little") % L
    return encode_point(_double_mult(s, k, tables)) == bytes(sig[:32])


def verify_rows(rows) -> list:
    """``verify`` over (pk, msg, sig) rows: the unit a worker process runs."""
    return [verify(pk, m, s) for pk, m, s in rows]


def _scalar_mult_base(a: int):
    digits = _naf(a)
    acc = IDENTITY
    for i in range(len(digits) - 1, -1, -1):
        acc = double(acc)
        m = digits[i]
        if m:
            acc = add(acc, _B_TABLE[m >> 1] if m > 0 else _B_NEG[(-m) >> 1])
    return acc


def public_key(seed: bytes) -> bytes:
    """The public key of a 32-byte private seed (RFC 8032, 5.1.5)."""
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return encode_point(_scalar_mult_base(a))


def public_keys(seeds) -> list:
    return [public_key(s) for s in seeds]
