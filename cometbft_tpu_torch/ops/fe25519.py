"""GF(2^255 - 19) arithmetic: constants, host limb helpers, plain torch ops.

Radix 2^25.5: a field element is 10 limbs of alternately 26 and 25
bits, held as a ``(10, *batch)`` int64 tensor (limb axis first, batch
last, as in the JAX package). The JAX package's 20 x 13-bit int32
limbs exist because the TPU has no 64-bit integers; the GPU multiplies
32 x 32 -> 64 bits natively, so a multiply here is 100 products
instead of 400. The CUDA kernels (``csrc/fe25519.cuh``) use the same
radix, the same partial products and the same carry schedule, so a
kernel and its plain version agree limb for limb. Against the JAX
package values are compared canonically (mod p).

Invariants ("carried"): limbs are nonnegative and below 2^w + 64
(w = 26 or 25). ``mul`` accepts carried inputs (products stay below
2^61 in int64) and returns carried output after three parallel carry
rounds; ``add``/``sub``/``neg`` carry one round. ``sub`` adds 2p
first so no limb goes negative.
"""

from __future__ import annotations

import numpy as np
import torch

NLIMBS = 10
P = 2**255 - 19
WIDTHS = tuple(26 if i % 2 == 0 else 25 for i in range(NLIMBS))
OFFSETS = tuple(sum(WIDTHS[:i]) for i in range(NLIMBS))
MASKS = tuple((1 << w) - 1 for w in WIDTHS)


# --- host helpers --------------------------------------------------------


def raw_limbs(x: int) -> np.ndarray:
    """Python int (0 <= x < 2^256) -> 10 limbs, top limb unmasked."""
    assert 0 <= x < 1 << 256
    out = np.zeros(NLIMBS, np.int64)
    for i in range(NLIMBS - 1):
        out[i] = (x >> OFFSETS[i]) & MASKS[i]
    out[NLIMBS - 1] = x >> OFFSETS[NLIMBS - 1]
    return out


def to_limbs(x: int) -> np.ndarray:
    """Python int -> canonical limbs of x mod p."""
    return raw_limbs(x % P)


def from_limbs(limbs) -> int:
    """One limb vector (any redundancy) -> int mod p."""
    arr = np.asarray(limbs, dtype=np.int64)
    return sum(int(arr[i]) << OFFSETS[i] for i in range(NLIMBS)) % P


def limbs_from_jax(arr: np.ndarray, axis: int = -1) -> np.ndarray:
    """Carry-across: the JAX package's 20 x 13-bit int32 limb arrays
    (``curve25519.base_window_table()`` (16, 3, 20), expanded keys
    from ``ed25519._expand_pubkey`` (4, 20), or any array whose
    ``axis`` holds the 20 limbs) -> this package's canonical 10-limb
    int64 form of the same values mod p, limb axis in the same place."""
    a = np.moveaxis(np.asarray(arr, np.int64), axis, -1)
    assert a.shape[-1] == 20, a.shape
    flat = a.reshape(-1, 20)
    out = np.zeros((flat.shape[0], NLIMBS), np.int64)
    for r in range(flat.shape[0]):
        val = sum(int(flat[r, i]) << (13 * i) for i in range(20))
        out[r] = to_limbs(val)
    return np.moveaxis(out.reshape(a.shape[:-1] + (NLIMBS,)), -1, axis)


def _two_p() -> np.ndarray:
    """2p with every limb above the carried bound, so ``x + 2p - y``
    stays nonnegative limb by limb."""
    out = np.array(
        [(1 << (w + 1)) - 2 for w in WIDTHS], np.int64
    )
    out[0] -= 36
    assert sum(int(v) << o for v, o in zip(out, OFFSETS)) == 2 * P
    assert all(v >= (1 << w) + 64 for v, w in zip(out, WIDTHS))
    return out


TWO_P = _two_p()


def _mul_tables():
    """Gather indices and weights of the 10 x 10 limb convolution:
    out[k] = sum_i a[i] * b[(k - i) % 10] * w[i, j], where w doubles
    odd x odd products (radix 2^25.5) and multiplies wrapped products
    (i + j >= 10) by 19 (2^255 = 19 mod p)."""
    idx_i = np.zeros((NLIMBS, NLIMBS), np.int64)
    idx_j = np.zeros((NLIMBS, NLIMBS), np.int64)
    for k in range(NLIMBS):
        for i in range(NLIMBS):
            idx_i[k, i] = i
            idx_j[k, i] = (k - i) % NLIMBS
    w = np.ones((NLIMBS, NLIMBS), np.int64)
    for i in range(NLIMBS):
        for j in range(NLIMBS):
            if i % 2 and j % 2:
                w[i, j] *= 2
            if i + j >= NLIMBS:
                w[i, j] *= 19
    return idx_i, idx_j, w


_IDX_I, _IDX_J, _MULW = _mul_tables()

_CONSTS: dict = {}


def _consts(device: torch.device) -> dict:
    c = _CONSTS.get(device)
    if c is None:
        t = lambda a: torch.as_tensor(np.asarray(a), device=device)  # noqa: E731
        c = {
            "widths": t(np.array(WIDTHS, np.int64)),
            "masks": t(np.array(MASKS, np.int64)),
            "two_p": t(TWO_P),
            "idx_i": t(_IDX_I),
            "idx_j": t(_IDX_J),
            "mulw": t(_MULW),
        }
        _CONSTS[device] = c
    return c


def _col(v: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A (10,)-shaped constant reshaped to broadcast over (10, *batch)."""
    return v.view(v.shape + (1,) * (like.dim() - v.dim()))


# --- plain torch field ops ------------------------------------------------


def const(x: int, like: torch.Tensor) -> torch.Tensor:
    """Constant x mod p as canonical limbs broadcastable against ``like``."""
    v = torch.as_tensor(to_limbs(x), device=like.device)
    return _col(v, like).expand((NLIMBS,) + like.shape[1:])


def carry(x: torch.Tensor, rounds: int) -> torch.Tensor:
    """Parallel carry rounds: every limb splits at its width at once,
    the carry out of limb 9 re-enters limb 0 times 19."""
    c = _consts(x.device)
    w, m = _col(c["widths"], x), _col(c["masks"], x)
    for _ in range(rounds):
        hi = x >> w
        x = (x & m) + torch.cat([hi[NLIMBS - 1 :] * 19, hi[: NLIMBS - 1]])
    return x


def add(a, b):
    return carry(a + b, 1)


def sub(a, b):
    return carry(a + _col(_consts(a.device)["two_p"], a) - b, 1)


def neg(a):
    return carry(_col(_consts(a.device)["two_p"], a) - a, 1)


def mul(a, b):
    """Field multiply: the 100 limb products, then three carry rounds."""
    a, b = torch.broadcast_tensors(a, b)
    c = _consts(a.device)
    prod = a.unsqueeze(1) * b.unsqueeze(0) * _col(c["mulw"], a.unsqueeze(1))
    return carry(prod[c["idx_i"], c["idx_j"]].sum(1), 3)


def square(a):
    return mul(a, a)


def sqn(x, n: int):
    for _ in range(n):
        x = square(x)
    return x


def pow2523(x):
    """x^((p-5)/8) = x^(2^252 - 3), the standard curve25519 chain."""
    x2 = square(x)
    x9 = mul(sqn(x2, 2), x)
    x11 = mul(x9, x2)
    x_5_0 = mul(square(x11), x9)
    x_10_0 = mul(sqn(x_5_0, 5), x_5_0)
    x_20_0 = mul(sqn(x_10_0, 10), x_10_0)
    x_40_0 = mul(sqn(x_20_0, 20), x_20_0)
    x_50_0 = mul(sqn(x_40_0, 10), x_10_0)
    x_100_0 = mul(sqn(x_50_0, 50), x_50_0)
    x_200_0 = mul(sqn(x_100_0, 100), x_100_0)
    x_250_0 = mul(sqn(x_200_0, 50), x_50_0)
    return mul(sqn(x_250_0, 2), x)


def canonical(x):
    """Fully reduced limbs of x mod p (each limb in [0, 2^w)).

    Two sequential carry passes (limb 9 wraps into limb 0 times 19)
    leave a value below 2^255 + 19; then q = floor((x + 19) / 2^255)
    says whether x >= p, and x + 19q with bit 255 dropped is x - qp."""
    limbs = list(x.unbind(0))
    for _ in range(2):
        for i in range(NLIMBS):
            hi = limbs[i] >> WIDTHS[i]
            limbs[i] = limbs[i] & MASKS[i]
            if i < NLIMBS - 1:
                limbs[i + 1] = limbs[i + 1] + hi
            else:
                limbs[0] = limbs[0] + 19 * hi
    q = (limbs[0] + 19) >> WIDTHS[0]
    for i in range(1, NLIMBS):
        q = (limbs[i] + q) >> WIDTHS[i]
    limbs[0] = limbs[0] + 19 * q
    for i in range(NLIMBS - 1):
        hi = limbs[i] >> WIDTHS[i]
        limbs[i] = limbs[i] & MASKS[i]
        limbs[i + 1] = limbs[i + 1] + hi
    limbs[NLIMBS - 1] = limbs[NLIMBS - 1] & MASKS[NLIMBS - 1]
    return torch.stack(limbs)


def is_zero(x):
    return (canonical(x) == 0).all(0)


def eq(a, b):
    return is_zero(sub(a, b))


def parity(x):
    return canonical(x)[0] & 1


def select(mask, a, b):
    """Lane select: mask (*batch) bool -> where(mask, a, b) per limb."""
    return torch.where(mask.unsqueeze(0), a, b)


def pack_bits(b: torch.Tensor, widths) -> torch.Tensor:
    """(nbytes, *batch) little-endian bytes -> limbs of the given bit
    widths, as int64 (nlimbs, *batch). The last limb takes the rest."""
    b = b.to(torch.int64)
    nbytes = b.shape[0]
    out = []
    off = 0
    for i, w in enumerate(widths):
        last = i == len(widths) - 1
        hi_bit = nbytes * 8 if last else off + w
        v = torch.zeros_like(b[0])
        for k in range(off // 8, (hi_bit - 1) // 8 + 1):
            sh = 8 * k - off
            v = v + (b[k] << sh if sh >= 0 else b[k] >> -sh)
        if not last:
            v = v & ((1 << w) - 1)
        out.append(v)
        off += w
    return torch.stack(out)


def from_bytes_255(b: torch.Tensor):
    """(32, *batch) uint8 -> (y limbs, sign bit). Bit 255 is the sign;
    y >= p is kept as is (ZIP-215): later ops reduce it."""
    sign = b[31].to(torch.int64) >> 7
    b = b.clone()
    b[31] = b[31] & 0x7F
    return pack_bits(b, WIDTHS), sign
