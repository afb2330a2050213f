"""BLS12-381 signatures (feature-gated, pure Python).

A copy of the JAX package's ``crypto/bls12381.py`` (it imports no JAX,
and the port imports nothing of that package): the same gate, the
same scheme and the same sign and wire formats, so a key or a
signature means the same thing to both packages.

Reference analog: crypto/bls12381 — real implementation behind the
`bls12381` build tag via the blst C library
(crypto/bls12381/key_bls12381.go:1), stub otherwise
(crypto/bls12381/key.go:1-30). Here the gate is the
COMETBFT_TPU_BLS12381 env var / `enable()` call: the key type
registers with the crypto registry only when enabled, so default
builds behave exactly like the reference's stub build.

Scheme: minimal-pubkey-size BLS (pubkeys in G1, signatures in G2),
matching the reference's choice. Hash-to-curve uses deterministic
try-and-increment (NOT the RFC 9380 SSWU map): this framework defines
its own wire/sign formats throughout, so self-consistency — not blst
byte-compatibility — is the requirement; the map is constant-free and
easy to audit. Verification: e(pk, H(m)) == e(G1, sig).

Pure-Python field towers (Fq, Fq2, Fq6, Fq12), Miller loop, final
exponentiation. Performance is irrelevant behind the gate (the
reference's default build has no BLS at all); validator-set BLS keys
are exercised by tests, not hot paths.
"""

from __future__ import annotations

import hashlib
import os
import secrets
from typing import List, Optional, Sequence, Tuple

# --- parameters ---------------------------------------------------------

P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001
X_PARAM = -0xD201000000010000  # BLS parameter (negative)

G1_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1
G2_X0 = 0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8
G2_X1 = 0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E
G2_Y0 = 0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801
G2_Y1 = 0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE

KEY_TYPE = "bls12381"
PUBKEY_SIZE = 48  # compressed G1
SIG_SIZE = 96  # compressed G2


def enabled() -> bool:
    return os.environ.get("COMETBFT_TPU_BLS12381", "") not in ("", "0")


# --- Fq -----------------------------------------------------------------


def _inv(a: int, m: int = P) -> int:
    return pow(a, m - 2, m)


# Fq2 = Fq[u]/(u^2+1); elements (a, b) = a + b*u


def f2_add(x, y):
    return ((x[0] + y[0]) % P, (x[1] + y[1]) % P)


def f2_sub(x, y):
    return ((x[0] - y[0]) % P, (x[1] - y[1]) % P)


def f2_neg(x):
    return (-x[0] % P, -x[1] % P)


def f2_mul(x, y):
    a, b = x
    c, d = y
    ac = a * c
    bd = b * d
    return ((ac - bd) % P, ((a + b) * (c + d) - ac - bd) % P)


def f2_sqr(x):
    a, b = x
    return ((a + b) * (a - b) % P, 2 * a * b % P)


def f2_muls(x, s: int):
    return (x[0] * s % P, x[1] * s % P)


def f2_inv(x):
    a, b = x
    t = _inv((a * a + b * b) % P)
    return (a * t % P, -b * t % P)


def f2_conj(x):
    return (x[0], -x[1] % P)


F2_ONE = (1, 0)
F2_ZERO = (0, 0)


def f2_pow(x, e: int):
    out = F2_ONE
    base = x
    while e:
        if e & 1:
            out = f2_mul(out, base)
        base = f2_sqr(base)
        e >>= 1
    return out


def f2_sqrt(x):
    """Square root in Fq2 (p % 4 == 3 inside; standard complex method).
    Returns None if x is not a QR."""
    if x == F2_ZERO:
        return F2_ZERO
    a, b = x
    if b == 0:
        # sqrt in Fq if possible, else sqrt(-a)*u since u^2 = -1
        s = pow(a, (P + 1) // 4, P)
        if s * s % P == a:
            return (s, 0)
        s = pow(-a % P, (P + 1) // 4, P)
        if s * s % P == (-a) % P:
            return (0, s)
        return None
    # norm = a^2 + b^2; alpha = sqrt(norm)
    norm = (a * a + b * b) % P
    alpha = pow(norm, (P + 1) // 4, P)
    if alpha * alpha % P != norm:
        return None
    # x0^2 = (a + alpha)/2  (or (a - alpha)/2)
    inv2 = _inv(2)
    for al in (alpha, -alpha % P):
        x0sq = (a + al) * inv2 % P
        x0 = pow(x0sq, (P + 1) // 4, P)
        if x0 * x0 % P == x0sq and x0 != 0:
            x1 = b * _inv(2 * x0 % P) % P
            cand = (x0, x1)
            if f2_sqr(cand) == x:
                return cand
    return None


# Fq6 = Fq2[v]/(v^3 - xi), xi = 1 + u. Elements: (c0, c1, c2) of Fq2.

XI = (1, 1)


def _mul_xi(x):
    a, b = x
    return ((a - b) % P, (a + b) % P)


F6_ZERO = (F2_ZERO, F2_ZERO, F2_ZERO)
F6_ONE = (F2_ONE, F2_ZERO, F2_ZERO)


def f6_add(x, y):
    return tuple(f2_add(a, b) for a, b in zip(x, y))


def f6_sub(x, y):
    return tuple(f2_sub(a, b) for a, b in zip(x, y))


def f6_neg(x):
    return tuple(f2_neg(a) for a in x)


def f6_mul(x, y):
    a0, a1, a2 = x
    b0, b1, b2 = y
    t0 = f2_mul(a0, b0)
    t1 = f2_mul(a1, b1)
    t2 = f2_mul(a2, b2)
    c0 = f2_add(
        t0,
        _mul_xi(
            f2_sub(
                f2_mul(f2_add(a1, a2), f2_add(b1, b2)), f2_add(t1, t2)
            )
        ),
    )
    c1 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a1), f2_add(b0, b1)), f2_add(t0, t1)),
        _mul_xi(t2),
    )
    c2 = f2_add(
        f2_sub(f2_mul(f2_add(a0, a2), f2_add(b0, b2)), f2_add(t0, t2)),
        t1,
    )
    return (c0, c1, c2)


def f6_sqr(x):
    return f6_mul(x, x)


def f6_mul_by_v(x):
    a0, a1, a2 = x
    return (_mul_xi(a2), a0, a1)


def f6_inv(x):
    a0, a1, a2 = x
    c0 = f2_sub(f2_sqr(a0), _mul_xi(f2_mul(a1, a2)))
    c1 = f2_sub(_mul_xi(f2_sqr(a2)), f2_mul(a0, a1))
    c2 = f2_sub(f2_sqr(a1), f2_mul(a0, a2))
    t = f2_inv(
        f2_add(
            f2_add(f2_mul(a0, c0), _mul_xi(f2_mul(a2, c1))),
            _mul_xi(f2_mul(a1, c2)),
        )
    )
    return (f2_mul(c0, t), f2_mul(c1, t), f2_mul(c2, t))


# Fq12 = Fq6[w]/(w^2 - v). Elements: (c0, c1) of Fq6.

F12_ONE = (F6_ONE, F6_ZERO)


def f12_mul(x, y):
    a0, a1 = x
    b0, b1 = y
    t0 = f6_mul(a0, b0)
    t1 = f6_mul(a1, b1)
    c0 = f6_add(t0, f6_mul_by_v(t1))
    c1 = f6_sub(
        f6_mul(f6_add(a0, a1), f6_add(b0, b1)), f6_add(t0, t1)
    )
    return (c0, c1)


def f12_sqr(x):
    return f12_mul(x, x)


def f12_inv(x):
    a0, a1 = x
    t = f6_inv(f6_sub(f6_sqr(a0), f6_mul_by_v(f6_sqr(a1))))
    return (f6_mul(a0, t), f6_neg(f6_mul(a1, t)))


def f12_conj(x):
    return (x[0], f6_neg(x[1]))


def f12_pow(x, e: int):
    if e < 0:
        return f12_pow(f12_inv(x), -e)
    out = F12_ONE
    base = x
    while e:
        if e & 1:
            out = f12_mul(out, base)
        base = f12_sqr(base)
        e >>= 1
    return out


# Frobenius on Fq2 coefficients of Fq12: gamma constants computed once.
# frob(c) for Fq2 is conjugation; multiply by xi^((p-1)k/6) powers.
def _frob_coeffs():
    # xi^((p-1)/6) in Fq2
    g = f2_pow(XI, (P - 1) // 6)
    gammas = [F2_ONE]
    for _ in range(5):
        gammas.append(f2_mul(gammas[-1], g))
    return gammas


_GAMMA = _frob_coeffs()


def f12_frobenius(x):
    """x -> x^p."""
    (a0, a1, a2), (b0, b1, b2) = x
    a0 = f2_conj(a0)
    a1 = f2_mul(f2_conj(a1), _GAMMA[2])
    a2 = f2_mul(f2_conj(a2), _GAMMA[4])
    b0 = f2_mul(f2_conj(b0), _GAMMA[1])
    b1 = f2_mul(f2_conj(b1), _GAMMA[3])
    b2 = f2_mul(f2_conj(b2), _GAMMA[5])
    return ((a0, a1, a2), (b0, b1, b2))


# --- curves -------------------------------------------------------------
# Jacobian-free affine arithmetic with None = infinity (performance is
# not a goal behind the gate; clarity is).


def g1_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        lam = 3 * x1 * x1 * _inv(2 * y1 % P) % P
    else:
        lam = (y2 - y1) * _inv((x2 - x1) % P) % P
    x3 = (lam * lam - x1 - x2) % P
    return (x3, (lam * (x1 - x3) - y1) % P)


def g1_neg(p):
    return None if p is None else (p[0], -p[1] % P)


def g1_mul(p, k: int):
    if k < 0:
        return g1_mul(g1_neg(p), -k)
    out = None
    while k:
        if k & 1:
            out = g1_add(out, p)
        p = g1_add(p, p)
        k >>= 1
    return out


def g1_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return (y * y - (x * x * x + 4)) % P == 0


def g2_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    if x1 == x2:
        if f2_add(y1, y2) == F2_ZERO:
            return None
        lam = f2_mul(
            f2_muls(f2_sqr(x1), 3), f2_inv(f2_muls(y1, 2))
        )
    else:
        lam = f2_mul(f2_sub(y2, y1), f2_inv(f2_sub(x2, x1)))
    x3 = f2_sub(f2_sub(f2_sqr(lam), x1), x2)
    return (x3, f2_sub(f2_mul(lam, f2_sub(x1, x3)), y1))


def g2_neg(p):
    return None if p is None else (p[0], f2_neg(p[1]))


def g2_mul(p, k: int):
    if k < 0:
        return g2_mul(g2_neg(p), -k)
    out = None
    while k:
        if k & 1:
            out = g2_add(out, p)
        p = g2_add(p, p)
        k >>= 1
    return out


B2 = (4, 4)  # 4(1+u)


def g2_on_curve(p) -> bool:
    if p is None:
        return True
    x, y = p
    return f2_sub(f2_sqr(y), f2_add(f2_mul(f2_sqr(x), x), B2)) == F2_ZERO


G1 = (G1_X, G1_Y)
G2 = ((G2_X0, G2_X1), (G2_Y0, G2_Y1))


# --- pairing ------------------------------------------------------------
# Strategy: embed G2 into E(Fq12) via the untwist map once, then run a
# textbook affine Miller loop entirely in Fq12. Slower than optimized
# line functions but free of twist-scaling subtleties (which matter
# here: aggregate verification compares products with different line
# counts, so lines must not be scaled by non-subfield constants).


def _f2_to_f12(a):
    return ((a, F2_ZERO, F2_ZERO), F6_ZERO)


def _fq_to_f12(a: int):
    return (((a % P, 0), F2_ZERO, F2_ZERO), F6_ZERO)


F12_W = (F6_ZERO, F6_ONE)  # w
_W_INV2 = f12_inv(f12_mul(F12_W, F12_W))  # w^-2
_W_INV3 = f12_inv(f12_mul(f12_mul(F12_W, F12_W), F12_W))  # w^-3


def _untwist(q):
    """E'(Fq2) -> E(Fq12): (x', y') -> (x' w^-2, y' w^-3)."""
    x, y = q
    return (
        f12_mul(_f2_to_f12(x), _W_INV2),
        f12_mul(_f2_to_f12(y), _W_INV3),
    )


def _f12_sub(x, y):
    return (f6_sub(x[0], y[0]), f6_sub(x[1], y[1]))


def _f12_eq(x, y):
    return _f12_sub(x, y) == (F6_ZERO, F6_ZERO)


def _line_f12(t, q, p12):
    """Line through t and q (E(Fq12) affine points) evaluated at p12 =
    (xp, yp) in Fq12; t == q means tangent. Returns Fq12."""
    (xt, yt), (xq, yq) = t, q
    xp, yp = p12
    if _f12_eq(xt, xq) and _f12_eq(yt, yq):
        num = f12_mul(_fq_to_f12(3), f12_mul(xt, xt))
        den = f12_mul(_fq_to_f12(2), yt)
    elif _f12_eq(xt, xq):
        return _f12_sub(xp, xt)  # vertical
    else:
        num = _f12_sub(yq, yt)
        den = _f12_sub(xq, xt)
    lam = f12_mul(num, f12_inv(den))
    return _f12_sub(_f12_sub(yp, yt), f12_mul(lam, _f12_sub(xp, xt)))


def _ec12_add(p1, p2):
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    (x1, y1), (x2, y2) = p1, p2
    if _f12_eq(x1, x2):
        if _f12_eq(f12_mul(_fq_to_f12(-1), y1), y2) or _f12_eq(
            y1, f12_mul(_fq_to_f12(-1), y2)
        ):
            if not _f12_eq(y1, y2):
                return None
        if _f12_eq(y1, y2):
            lam = f12_mul(
                f12_mul(_fq_to_f12(3), f12_mul(x1, x1)),
                f12_inv(f12_mul(_fq_to_f12(2), y1)),
            )
        else:
            return None
    else:
        lam = f12_mul(_f12_sub(y2, y1), f12_inv(_f12_sub(x2, x1)))
    x3 = _f12_sub(_f12_sub(f12_mul(lam, lam), x1), x2)
    y3 = _f12_sub(f12_mul(lam, _f12_sub(x1, x3)), y1)
    return (x3, y3)


def miller_loop(q, p):
    """f_{|x|,Q}(P) with ate-pairing conventions; q in E'(Fq2) affine,
    p in E(Fq) affine. Conjugate at the end for the negative BLS
    parameter."""
    if q is None or p is None:
        return F12_ONE
    qq = _untwist(q)
    p12 = (_fq_to_f12(p[0]), _fq_to_f12(p[1]))
    t = qq
    f = F12_ONE
    for b in bin(abs(X_PARAM))[3:]:
        f = f12_mul(f12_sqr(f), _line_f12(t, t, p12))
        t = _ec12_add(t, t)
        if b == "1":
            f = f12_mul(f, _line_f12(t, qq, p12))
            t = _ec12_add(t, qq)
    if X_PARAM < 0:
        f = f12_conj(f)
    return f


def final_exponentiation(f):
    """f^((p^12-1)/r) — easy part explicit, hard part by direct
    exponentiation (slow but obviously correct)."""
    f1 = f12_mul(f12_conj(f), f12_inv(f))  # f^(p^6-1)
    f2 = f12_mul(f12_frobenius(f12_frobenius(f1)), f1)  # ^(p^2+1)
    e = (P**4 - P**2 + 1) // R
    return f12_pow(f2, e)


def pairing(q, p):
    """e(p in G1, q in E'(Fq2) r-torsion) -> Fq12."""
    return final_exponentiation(miller_loop(q, p))


# --- hashing + serialization -------------------------------------------


def hash_to_g2(msg: bytes, dst: bytes = b"COMETBFT-TPU-BLS-SIG-V1") -> Tuple:
    """Deterministic try-and-increment map to the r-torsion of G2 (not
    RFC 9380; see module docstring). Cofactor-cleared by scalar mul."""
    # G2 cofactor: h2 = (x^8 - 4x^7 + 5x^6 - 4x^4 + 6x^3 - 4x^2 - 4x + 13)/9
    x = X_PARAM
    h2 = (x**8 - 4 * x**7 + 5 * x**6 - 4 * x**4 + 6 * x**3 - 4 * x**2 - 4 * x + 13) // 9
    ctr = 0
    while True:
        seed = hashlib.sha256(dst + b"|" + ctr.to_bytes(4, "big") + b"|" + msg).digest()
        seed2 = hashlib.sha256(b"u1|" + seed).digest()
        x0 = int.from_bytes(seed + hashlib.sha256(b"x0" + seed).digest(), "big") % P
        x1 = int.from_bytes(seed2 + hashlib.sha256(b"x1" + seed2).digest(), "big") % P
        xc = (x0, x1)
        rhs = f2_add(f2_mul(f2_sqr(xc), xc), B2)
        y = f2_sqrt(rhs)
        if y is not None:
            # canonical sign: pick lexicographically smaller y
            if (y[1], y[0]) > (f2_neg(y)[1], f2_neg(y)[0]):
                y = f2_neg(y)
            pt = (xc, y)
            pt = g2_mul(pt, h2)  # clear cofactor into r-torsion
            if pt is not None:
                return pt
        ctr += 1


def g1_compress(p) -> bytes:
    if p is None:
        return bytes([0xC0] + [0] * 47)
    x, y = p
    flag = 0x80 | (0x20 if y > (P - 1) // 2 else 0)
    b = bytearray(x.to_bytes(48, "big"))
    b[0] |= flag
    return bytes(b)


def g1_decompress(b: bytes):
    if len(b) != 48:
        raise ValueError("bad G1 encoding length")
    if b[0] & 0x40:
        if b != bytes([0xC0] + [0] * 47):
            raise ValueError("bad G1 infinity encoding")
        return None
    if not b[0] & 0x80:
        raise ValueError("uncompressed G1 not supported")
    sign = bool(b[0] & 0x20)
    x = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:], "big")
    if x >= P:
        raise ValueError("G1 x out of range")
    y2 = (x * x * x + 4) % P
    y = pow(y2, (P + 1) // 4, P)
    if y * y % P != y2:
        raise ValueError("G1 x not on curve")
    if (y > (P - 1) // 2) != sign:
        y = -y % P
    pt = (x, y)
    if g1_mul(pt, R) is not None:
        raise ValueError("G1 point not in r-torsion")
    return pt


def g2_compress(p) -> bytes:
    if p is None:
        return bytes([0xC0] + [0] * 95)
    (x0, x1), (y0, y1) = p
    flag = 0x80 | (0x20 if (y1, y0) > ((-y1) % P, (-y0) % P) else 0)
    b = bytearray(x1.to_bytes(48, "big") + x0.to_bytes(48, "big"))
    b[0] |= flag
    return bytes(b)


def g2_decompress(b: bytes):
    if len(b) != 96:
        raise ValueError("bad G2 encoding length")
    if b[0] & 0x40:
        if b != bytes([0xC0] + [0] * 95):
            raise ValueError("bad G2 infinity encoding")
        return None
    if not b[0] & 0x80:
        raise ValueError("uncompressed G2 not supported")
    sign = bool(b[0] & 0x20)
    x1 = int.from_bytes(bytes([b[0] & 0x1F]) + b[1:48], "big")
    x0 = int.from_bytes(b[48:], "big")
    if x0 >= P or x1 >= P:
        raise ValueError("G2 x out of range")
    xc = (x0, x1)
    y = f2_sqrt(f2_add(f2_mul(f2_sqr(xc), xc), B2))
    if y is None:
        raise ValueError("G2 x not on curve")
    yneg = f2_neg(y)
    if ((y[1], y[0]) > (yneg[1], yneg[0])) != sign:
        y = yneg
    pt = (xc, y)
    if g2_mul(pt, R) is not None:
        raise ValueError("G2 point not in r-torsion")
    return pt


# --- scheme -------------------------------------------------------------


def keygen(seed: Optional[bytes] = None) -> Tuple[int, bytes]:
    """Returns (secret scalar, compressed pubkey)."""
    if seed is None:
        seed = secrets.token_bytes(32)
    sk = (
        int.from_bytes(
            hashlib.sha512(b"bls-keygen|" + seed).digest(), "big"
        )
        % (R - 1)
        + 1
    )
    return sk, g1_compress(g1_mul(G1, sk))


def sign(sk: int, msg: bytes) -> bytes:
    return g2_compress(g2_mul(hash_to_g2(msg), sk))


def verify(pubkey: bytes, msg: bytes, sig: bytes) -> bool:
    try:
        pk = g1_decompress(pubkey)
        s = g2_decompress(sig)
    except ValueError:
        return False
    if pk is None or s is None:
        return False
    h = hash_to_g2(msg)
    # e(pk, H(m)) == e(G1, sig)
    return pairing(h, pk) == pairing(s, G1)


def aggregate(sigs: Sequence[bytes]) -> bytes:
    acc = None
    for s in sigs:
        acc = g2_add(acc, g2_decompress(s))
    return g2_compress(acc)


def verify_aggregate(
    pubkeys: Sequence[bytes], msgs: Sequence[bytes], agg_sig: bytes
) -> bool:
    """Distinct-message aggregate verification:
    prod e(pk_i, H(m_i)) == e(G1, sig)."""
    if len(pubkeys) != len(msgs) or not pubkeys:
        return False
    try:
        s = g2_decompress(agg_sig)
        lhs = F12_ONE
        for pkb, m in zip(pubkeys, msgs):
            pk = g1_decompress(pkb)
            if pk is None:
                return False
            lhs = f12_mul(lhs, miller_loop(hash_to_g2(m), pk))
    except ValueError:
        return False
    return final_exponentiation(lhs) == pairing(s, G1)
