"""Scalars mod L = 2^252 + 27742...493: plain torch ops and the K3 wrapper.

Scalars are little-endian 21-bit limbs held as int64 ``(nlimbs,
*batch)`` tensors: 13 limbs for a 256-bit scalar (the top limb holds
bits 252..255), 24 for a 512-bit digest (the top limb 29 bits). The
reduction mod L is the ref10 ``sc_reduce`` schedule: limbs at or above
2^252 fold down through 2^252 = -c (mod L), c = L - 2^252, written as
six signed 21-bit digits (``_FOLD``), with rounding and then floor
carries between folds. Every output here (h mod L, L - h, the window
digits, s < L) is canonical, so kernel and plain version agree exactly.

``hash_digits`` is the wrapper of kernel K3 (``csrc/hash_digits.cu``):
SHA-512(R || A || M) per lane, h mod L, -h mod L, the 4-bit window
digits of -h and of s, and the canonicity check s < L. It replaces the
JAX package's XLA stages ``sha512.sha512`` and ``sc25519.reduce_512``,
``neg_mod_L``, ``digits4``, ``lt_L``.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import kernels
from . import sha512 as _sha

L = 2**252 + 27742317777372353535851937790883648493
LIMB_BITS = 21
LIMB_MASK = (1 << LIMB_BITS) - 1
SCALAR_WIDTHS = (21,) * 12 + (4,)
DIGEST_WIDTHS = (21,) * 23 + (29,)
# sum(_FOLD[j] << 21j) == 2^252 - L: a limb at 2^(21k), k >= 12, adds
# s_k * _FOLD[j] to limb k - 12 + j
_FOLD = (666643, 470296, 654183, -997805, 136657, -683901)
assert sum(v << (21 * j) for j, v in enumerate(_FOLD)) == 2**252 - L


def to_limbs(x: int, n: int = 13) -> np.ndarray:
    out = np.zeros(n, np.int64)
    for i in range(n):
        out[i] = (x >> (21 * i)) & LIMB_MASK if i < n - 1 else x >> (21 * i)
    return out


def from_limbs(limbs) -> int:
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(arr[i]) << (21 * i) for i in range(arr.shape[0]))


L_LIMBS = tuple(int(v) for v in to_limbs(L))


def scalar_from_bytes(b: torch.Tensor) -> torch.Tensor:
    """(32, *batch) uint8 LE -> (13, *batch) int64 limbs of the integer."""
    from .fe25519 import pack_bits

    return pack_bits(b, SCALAR_WIDTHS)


def hash_bytes_to_limbs(b: torch.Tensor) -> torch.Tensor:
    """(64, *batch) uint8 digest (LE integer) -> (24, *batch) limbs."""
    from .fe25519 import pack_bits

    return pack_bits(b, DIGEST_WIDTHS)


def _fold(s: list, k: int) -> None:
    for j, m in enumerate(_FOLD):
        s[k - 12 + j] = s[k - 12 + j] + s[k] * m
    s[k] = torch.zeros_like(s[k])


def _carry_round(s: list, i: int) -> None:
    c = (s[i] + (1 << 20)) >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - (c << 21)


def _carry_floor(s: list, i: int) -> None:
    c = s[i] >> 21
    s[i + 1] = s[i + 1] + c
    s[i] = s[i] - (c << 21)


def reduce_512(x: torch.Tensor) -> torch.Tensor:
    """(24, *batch) limbs of a 512-bit integer -> (13, *batch) limbs of
    x mod L, canonical (limb 12 holds bit 252)."""
    s = list(x.unbind(0))
    for k in range(23, 17, -1):
        _fold(s, k)
    for i in range(6, 17, 2):
        _carry_round(s, i)
    for i in range(7, 16, 2):
        _carry_round(s, i)
    for k in range(17, 11, -1):
        _fold(s, k)
    for i in range(0, 11, 2):
        _carry_round(s, i)
    for i in range(1, 12, 2):
        _carry_round(s, i)
    _fold(s, 12)
    for i in range(12):
        _carry_floor(s, i)
    _fold(s, 12)
    for i in range(12):  # the last carry moves bit 252 into limb 12
        _carry_floor(s, i)
    return torch.stack(s[:13])


def neg_mod_L(h: torch.Tensor) -> torch.Tensor:
    """L - h for canonical h in [0, L); h = 0 maps to L (harmless in the
    cofactored check: [8][L]A is the identity)."""
    s = [L_LIMBS[i] - h[i] for i in range(13)]
    for i in range(12):
        _carry_floor(s, i)
    return torch.stack(s)


def lt_L(s: torch.Tensor) -> torch.Tensor:
    """s < L for canonical nonnegative 13-limb scalars."""
    lt = torch.zeros_like(s[0], dtype=torch.bool)
    eq = torch.ones_like(s[0], dtype=torch.bool)
    for i in reversed(range(13)):
        lt = lt | (eq & (s[i] < L_LIMBS[i]))
        eq = eq & (s[i] == L_LIMBS[i])
    return lt


def digits4(s: torch.Tensor) -> torch.Tensor:
    """(13, *batch) canonical limbs -> (64, *batch) uint8 4-bit windows,
    window j = bits 4j..4j+3 (little-endian window order)."""
    sp = torch.cat([s, torch.zeros_like(s[:1])])
    out = []
    for j in range(64):
        limb, off = divmod(4 * j, LIMB_BITS)
        v = sp[limb] >> off
        if off > LIMB_BITS - 4:
            v = v | (sp[limb + 1] << (LIMB_BITS - off))
        out.append(v & 15)
    return torch.stack(out).to(torch.uint8)


def hash_digits_plain(msgs, lens, pks, rs, ss):
    """Plain version of K3 (same outputs, torch ops)."""
    cap = msgs.shape[0]
    hin = torch.cat([rs, pks, msgs])
    digest = _sha.sha512(hin, lens.to(torch.int64).clamp(max=cap) + 64, cap + 64)
    h = reduce_512(hash_bytes_to_limbs(digest))
    s = scalar_from_bytes(ss)
    return digits4(s), digits4(neg_mod_L(h)), lt_L(s)


def hash_digits(msgs, lens, pks, rs, ss):
    """Per lane: digits4(s), digits4(-h mod L), s < L, with
    h = SHA-512(R || A || M) mod L.

    msgs (cap, N) uint8, zero past each lane's length; lens (N,) int32,
    where a length above cap counts as cap (the kernel never reads past
    the buffer); pks, rs, ss (32, N) uint8 (pks and rs may be views with
    a common lane stride). Returns ds, dh (64, N) uint8 and ok_s (N,)
    bool. CPU tensors take the plain version; CUDA tensors launch K3."""
    if msgs.device.type == "cpu":
        return hash_digits_plain(msgs, lens, pks, rs, ss)
    n = msgs.shape[1]
    cap = msgs.shape[0]
    ld_pr = pks.stride(0)
    for t, rows in ((msgs, cap), (ss, 32), (pks, 32), (rs, 32)):
        kernels.require(t, torch.uint8, (rows, n))
    kernels.require(lens, torch.int32, (n,))
    kernels.require_rows(ss, n)
    kernels.require_rows(msgs, n)
    kernels.require_rows(pks, ld_pr)
    kernels.require_rows(rs, ld_pr)
    dev = msgs.device
    ds = torch.empty((64, n), dtype=torch.uint8, device=dev)
    dh = torch.empty((64, n), dtype=torch.uint8, device=dev)
    ok_s = torch.empty(n, dtype=torch.bool, device=dev)
    if n:
        kernels.launch(
            "hash_digits", "hash_digits_launch",
            msgs.data_ptr(), cap, lens.data_ptr(), pks.data_ptr(),
            rs.data_ptr(), ld_pr, ss.data_ptr(), n, ds.data_ptr(),
            dh.data_ptr(), ok_s.data_ptr(), kernels.stream_ptr(dev),
        )
    return ds, dh, ok_s
