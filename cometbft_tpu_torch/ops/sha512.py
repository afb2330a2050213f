"""Per-lane SHA-512 in plain torch, with native 64-bit words.

The JAX package splits each 64-bit word into (hi, lo) uint32 halves
because the TPU lacks int64; here words are int64 tensors with
two's-complement wrap-around for addition and masked arithmetic
shifts for the logical right shift. Layout as in the JAX package:
byte axis first, batch last; every lane runs the same number of
blocks and a lane's state stops changing after its own final block.
On the GPU this stage runs inside kernel K3 (``csrc/hash_digits.cu``);
this module is its plain version.
"""

from __future__ import annotations

import numpy as np
import torch


def _iroot(x: int, n: int) -> int:
    """floor(x ** (1 / n)) by Newton's method on Python ints."""
    if x == 0:
        return 0
    r = 1 << ((x.bit_length() + n - 1) // n)
    while True:
        nr = ((n - 1) * r + x // r ** (n - 1)) // n
        if nr >= r:
            return r
        r = nr


def _primes(n: int):
    ps, c = [], 2
    while len(ps) < n:
        if all(c % p for p in ps if p * p <= c):
            ps.append(c)
        c += 1
    return ps


def _frac_bits(p: int, root: int) -> int:
    return _iroot(p << (root * 64), root) & ((1 << 64) - 1)


K64 = [_frac_bits(p, 3) for p in _primes(80)]
H64 = [_frac_bits(p, 2) for p in _primes(8)]


def _signed(v: int) -> int:
    return v - (1 << 64) if v >= 1 << 63 else v


K_I64 = np.array([_signed(k) for k in K64], np.int64)
H_I64 = np.array([_signed(h) for h in H64], np.int64)


def _srl(x, n: int):
    return (x >> n) & ((1 << (64 - n)) - 1)


def _rotr(x, n: int):
    return _srl(x, n) | (x << (64 - n))


def _compress(state, w):
    """state: 8 int64 tensors; w: (16, *batch) block words."""
    w = list(w.unbind(0))
    for t in range(16, 80):
        s0 = _rotr(w[t - 15], 1) ^ _rotr(w[t - 15], 8) ^ _srl(w[t - 15], 7)
        s1 = _rotr(w[t - 2], 19) ^ _rotr(w[t - 2], 61) ^ _srl(w[t - 2], 6)
        w.append(w[t - 16] + s0 + w[t - 7] + s1)
    a, b, c, d, e, f, g, h = state
    for t in range(80):
        s1 = _rotr(e, 14) ^ _rotr(e, 18) ^ _rotr(e, 41)
        ch = (e & f) ^ (~e & g)
        t1 = h + s1 + ch + int(K_I64[t]) + w[t]
        s0 = _rotr(a, 28) ^ _rotr(a, 34) ^ _rotr(a, 39)
        maj = (a & b) ^ (a & c) ^ (b & c)
        h, g, f, e = g, f, e, d + t1
        d, c, b, a = c, b, a, t1 + s0 + maj
    return [x + y for x, y in zip(state, (a, b, c, d, e, f, g, h))]


def sha512(data: torch.Tensor, length: torch.Tensor, cap: int) -> torch.Tensor:
    """data (cap, *batch) uint8, zero past each lane's length; length
    (*batch) int message lengths (<= cap). Returns (64, *batch) uint8
    digests (big-endian word bytes, as hashlib)."""
    nblocks = (cap + 17 + 127) // 128
    total = nblocks * 128
    batch = data.shape[1:]
    buf = torch.zeros((total,) + batch, dtype=torch.int64, device=data.device)
    buf[:cap] = data.to(torch.int64)
    pos = torch.arange(total, device=data.device).view(
        (total,) + (1,) * len(batch)
    )
    ln = length.to(torch.int64).unsqueeze(0)
    buf = torch.where(pos < ln, buf, 0) + torch.where(pos == ln, 0x80, 0)
    final_block = (ln + 16) // 128
    bitlen = ln * 8
    for s in range(4):
        at = final_block * 128 + 124 + s
        buf = buf + torch.where(pos == at, (bitlen >> (8 * (3 - s))) & 0xFF, 0)
    words = buf.view((nblocks, 16, 8) + batch)
    shifts = torch.tensor(
        [56 - 8 * k for k in range(8)], device=data.device
    ).view((8,) + (1,) * len(batch))
    words = (words << shifts).sum(2)  # bytes are disjoint bit fields
    state = [
        torch.full(batch, int(v), dtype=torch.int64, device=data.device)
        for v in H_I64
    ]
    for blk in range(nblocks):
        new = _compress(state, words[blk])
        active = blk <= final_block[0]
        state = [torch.where(active, n, o) for n, o in zip(new, state)]
    out = []
    for v in state:
        for k in range(8):
            out.append((v >> (56 - 8 * k)) & 0xFF)
    return torch.stack(out).to(torch.uint8)
