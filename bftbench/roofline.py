"""The least time the card could take for K1-K3 on a dispatch's
inputs: a frozen copy of ``chip_smoke.py::bound`` and its counts.

Peaks: HBM bytes/s from the H100 SXM data sheet; 32-bit integer results
per clock per SM on sm_90 (IMAD, IADD, LOP, shifts: 64, the CUDA C++
Programming Guide's throughput table) times the SM count and the
highest SM clock the card reports (``nvidia-smi clocks.max.sm``). A
32 x 32 -> 64 product counts as one multiply-add at that rate: the
least it could cost."""

from __future__ import annotations

import subprocess

HBM_BYTES_S = 3.35e12
INT_PER_CLK_SM = 64
# 32-bit products per field operation, the least the function needs:
# a multiply has 10 x 10, a square 55 (pairs i <= j)
PRODUCTS = {"mul": 100, "sq": 55}
# field multiplies and squares per lane, counted from the formulas of the kernels
FE_OPS = {
    # table build 151 mul; 64 windows of 27 mul + 16 sq; epilogue 20 mul + 13 sq
    "ladder": {"mul": 151 + 64 * 27 + 20, "sq": 64 * 16 + 13},
    # pow2523 11 mul + 251 sq, around it 7 mul + 4 sq (a point; two a lane)
    "decompress": {"mul": 18, "sq": 255},
}
# SHA-512, 32-bit instructions a 128-byte block at the least: a round 28,
# a schedule word 20, the feed-forward 16, the message byte swap 32
SHA_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 16 + 32
SC_OPS = 600  # reduction mod L, negation, digits: 32-bit ops per lane
KERNELS = ("ladder", "decompress", "hash_digits")


def is_verify_kernel(name: str) -> bool:
    """A device op of the trace that is K1, K2 or K3 (by its symbol)."""
    return any(f"{k}_kernel" in name for k in KERNELS)


def fe_products(name: str) -> int:
    ops = FE_OPS[name]
    return sum(ops[k] * PRODUCTS[k] for k in PRODUCTS)


def sha_blocks(msg_len: int) -> int:
    """SHA-512 blocks of R || A || M with its padding (1 + 16 bytes)."""
    return (64 + msg_len + 16) // 128 + 1


def bound_s(n: int, cap: int, blocks: int, int_rate: float) -> float:
    """Seconds K1 + K2 + K3 need at the least for one dispatch of ``n``
    lanes whose messages take ``blocks`` SHA-512 blocks in all, in rows
    of ``cap`` bytes; each kernel bound by its operations or its bytes."""
    out = 0.0
    for nbytes, ops in (
        (n * (64 + 64 + 160 + 160 + 3 + 1), n * fe_products("ladder")),
        (2 * n * (32 + 160 + 1), 2 * n * fe_products("decompress")),
        (n * cap + n * (4 + 96 + 129), blocks * SHA_OPS_PER_BLOCK + n * SC_OPS),
    ):
        out += max(nbytes / HBM_BYTES_S, ops / int_rate)
    return out


def int_rate(device) -> float | None:
    """32-bit integer results per second of the card, or None when its
    clock cannot be read."""
    import torch

    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader",
                              f"--id={device.index or 0}"], capture_output=True, text=True, timeout=30, check=True)
        mhz = float(out.stdout.strip().splitlines()[0].split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return INT_PER_CLK_SM * sms * mhz * 1e6
