"""Edwards25519 group law (plain torch) and the K2 decompression wrapper.

Points are extended coordinates (X, Y, Z, T), a tuple of four
``(10, *batch)`` int64 field elements (``fe25519``), with x = X/Z,
y = Y/Z, xy = T/Z. The formulas are those of the JAX package
(add-2008-hwcd-3, dbl-2008-hwcd, add-2008-bbjlp for the T-less
projective add), complete on edwards25519, so identity and
small-order points need no special cases. ``csrc/fe25519.cuh`` holds
the same formulas as device functions, operation for operation.

``decompress`` is the wrapper of kernel K2 (``csrc/decompress.cu``),
which replaces the JAX package's XLA stage ``curve25519.decompress``
(ZIP-215 liberal decoding: y >= p accepted, x = 0 with the sign bit
set accepted; invalid lanes give ok = False and the identity).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import fe25519 as fe

P = fe.P
D = (-121665 * pow(121666, P - 2, P)) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
_BY = 4 * pow(5, P - 2, P) % P


def _recover_bx() -> int:
    x2 = (_BY * _BY - 1) * pow(D * _BY * _BY + 1, P - 2, P) % P
    x = pow(x2, (P + 3) // 8, P)
    if (x * x - x2) % P:
        x = x * SQRT_M1 % P
    return P - x if x & 1 else x


BASE_AFFINE = (_recover_bx(), _BY)


def identity(like: torch.Tensor):
    """Identity point shaped like the field element ``like``."""
    zero = torch.zeros_like(like)
    one = zero.clone()
    one[0] = 1
    return (zero, one, one.clone(), zero.clone())


def add(p, q):
    """Complete unified addition (add-2008-hwcd-3, a = -1)."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = fe.mul(fe.sub(Y1, X1), fe.sub(Y2, X2))
    B = fe.mul(fe.add(Y1, X1), fe.add(Y2, X2))
    C = fe.mul(fe.mul(T1, fe.const(D2, T1)), T2)
    ZZ = fe.mul(Z1, Z2)
    Dv = fe.add(ZZ, ZZ)
    E, F, G, H = fe.sub(B, A), fe.sub(Dv, C), fe.add(Dv, C), fe.add(B, A)
    return (fe.mul(E, F), fe.mul(G, H), fe.mul(F, G), fe.mul(E, H))


def double(p, need_t: bool = True):
    """Doubling (dbl-2008-hwcd); T is skipped when nothing reads it."""
    X1, Y1, Z1 = p[0], p[1], p[2]
    A = fe.square(X1)
    B = fe.square(Y1)
    Zsq = fe.square(Z1)
    C = fe.add(Zsq, Zsq)
    H = fe.add(A, B)
    E = fe.sub(H, fe.square(fe.add(X1, Y1)))
    G = fe.sub(A, B)
    F = fe.add(C, G)
    return (
        fe.mul(E, F),
        fe.mul(G, H),
        fe.mul(F, G),
        fe.mul(E, H) if need_t else None,
    )


def is_identity(p):
    return fe.is_zero(p[0]) & fe.is_zero(fe.sub(p[1], p[2]))


def mul_by_cofactor(p):
    """[8]P; the result only feeds is_identity, so no double needs T."""
    return double(double(double(p, False), False), False)


def to_cached(p):
    """Cached projective form (Y+X, Y-X, Z, 2dT)."""
    X, Y, Z, T = p
    return (fe.add(Y, X), fe.sub(Y, X), Z, fe.mul(T, fe.const(D2, T)))


def add_cached(p, c):
    """Extended p + cached-projective c -> extended (8M)."""
    X1, Y1, Z1, T1 = p
    ypx, ymx, Z2, t2d = c
    A = fe.mul(fe.sub(Y1, X1), ymx)
    B = fe.mul(fe.add(Y1, X1), ypx)
    C = fe.mul(T1, t2d)
    ZZ = fe.mul(Z1, Z2)
    Dv = fe.add(ZZ, ZZ)
    E, F, G, H = fe.sub(B, A), fe.sub(Dv, C), fe.add(Dv, C), fe.add(B, A)
    return (fe.mul(E, F), fe.mul(G, H), fe.mul(F, G), fe.mul(E, H))


def add_affine_cached(p, c, need_t: bool = True):
    """Extended p + cached-affine c (y+x, y-x, 2dxy), Z2 = 1 (7M)."""
    X1, Y1, Z1, T1 = p
    ypx, ymx, t2d = c
    A = fe.mul(fe.sub(Y1, X1), ymx)
    B = fe.mul(fe.add(Y1, X1), ypx)
    C = fe.mul(T1, t2d)
    Dv = fe.add(Z1, Z1)
    E, F, G, H = fe.sub(B, A), fe.sub(Dv, C), fe.add(Dv, C), fe.add(B, A)
    return (
        fe.mul(E, F),
        fe.mul(G, H),
        fe.mul(F, G),
        fe.mul(E, H) if need_t else None,
    )


def add_projective(p, q):
    """Projective addition (add-2008-bbjlp, a = -1): reads no T, so it
    takes the ladder's T-less output. Returns (X, Y, Z, None)."""
    X1, Y1, Z1 = p[0], p[1], p[2]
    X2, Y2, Z2 = q[0], q[1], q[2]
    A = fe.mul(Z1, Z2)
    B = fe.square(A)
    C = fe.mul(X1, X2)
    Dv = fe.mul(Y1, Y2)
    E = fe.mul(fe.mul(fe.const(D, C), C), Dv)
    F = fe.sub(B, E)
    G = fe.add(B, E)
    X3 = fe.mul(
        fe.mul(A, F),
        fe.sub(fe.mul(fe.add(X1, Y1), fe.add(X2, Y2)), fe.add(C, Dv)),
    )
    Y3 = fe.mul(fe.mul(A, G), fe.add(Dv, C))
    Z3 = fe.mul(F, G)
    return (X3, Y3, Z3, None)


def decompress_plain(b: torch.Tensor):
    """(32, *batch) uint8 -> (point as (4, 10, *batch) int32, ok bool).
    Plain version of K2, the JAX package's ``curve25519.decompress``."""
    y, sign = fe.from_bytes_255(b)
    one = fe.const(1, y)
    ysq = fe.square(y)
    u = fe.sub(ysq, one)
    v = fe.add(fe.mul(ysq, fe.const(D, y)), one)
    v3 = fe.mul(fe.square(v), v)
    v7 = fe.mul(fe.square(v3), v)
    r = fe.mul(fe.mul(u, v3), fe.pow2523(fe.mul(u, v7)))
    check = fe.mul(v, fe.square(r))
    root_ok = fe.eq(check, u)
    root_neg = fe.eq(check, fe.neg(u))
    ok = root_ok | root_neg
    x = fe.select(root_neg, fe.mul(r, fe.const(SQRT_M1, r)), r)
    flip = fe.parity(x) != sign
    x = fe.select(flip, fe.neg(x), x)
    pt = torch.stack([x, y, one, fe.mul(x, y)])
    ident = torch.stack(identity(y))
    pt = torch.where(ok.unsqueeze(0).unsqueeze(0), pt, ident)
    return pt.to(torch.int32), ok


def decompress(b: torch.Tensor):
    """ZIP-215 decompression of (32, N) uint8 encodings (lanes
    contiguous; rows may be any stride apart). Returns the extended
    point (4, 10, N) int32 (the identity on invalid lanes) and ok (N,)
    bool. CPU tensors take the plain version; CUDA tensors launch K2."""
    if b.device.type == "cpu":
        return decompress_plain(b)
    n = b.shape[1]
    kernels.require(b, torch.uint8, (32, n))
    kernels.require_rows(b, b.stride(0))
    out = torch.empty((4, fe.NLIMBS, n), dtype=torch.int32, device=b.device)
    ok = torch.empty(n, dtype=torch.bool, device=b.device)
    if n:
        kernels.launch(
            "decompress", "decompress_launch",
            b.data_ptr(), b.stride(0), n, out.data_ptr(), n, ok.data_ptr(),
            kernels.stream_ptr(b.device),
        )
    return out, ok


def _aff_add(p1, p2):
    """Host-side complete affine addition (Python ints); None = identity."""
    if p1 is None:
        return p2
    if p2 is None:
        return p1
    x1, y1 = p1
    x2, y2 = p2
    t = D * x1 * x2 * y1 * y2
    x3 = (x1 * y2 + x2 * y1) * pow((1 + t) % P, P - 2, P) % P
    y3 = (y1 * y2 + x1 * x2) * pow((1 - t) % P, P - 2, P) % P
    return (x3, y3)


def base_window_table() -> np.ndarray:
    """Host: cached-affine [d]B for d in 0..15, (16, 3, 10) int64
    canonical limbs; entry 0 is the identity (1, 1, 0)."""
    out = np.zeros((16, 3, fe.NLIMBS), np.int64)
    acc = None
    for d in range(16):
        x, y = (0, 1) if acc is None else acc
        out[d, 0] = fe.to_limbs(y + x)
        out[d, 1] = fe.to_limbs(y - x)
        out[d, 2] = fe.to_limbs(D2 * x * y)
        acc = _aff_add(acc, BASE_AFFINE)
    return out
