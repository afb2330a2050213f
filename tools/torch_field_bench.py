#!/usr/bin/env python3
"""What one operation of the port's field layer costs on the card.

    python3 tools/torch_field_bench.py

Builds tools/torch_field_bench.cu (a dependent chain of one field
operation of cometbft_tpu_torch/csrc/fe25519.cuh per thread) with the
kernels' nvcc flags into build/field_bench/, and runs each operation at
one, four and eight warps per SM (one block per SM). Prints the card's
name and power limit, then one JSON line: SM cycles per operation per
warp, read with clock64() by one thread.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OPS = ("mul", "sq", "add", "sub", "mul_products_only", "mul_carries_only")
ITERS = 1000


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("torch_field_bench: no CUDA device", file=sys.stderr)
        return 2
    from cometbft_tpu_torch import kernels

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    out_dir = ROOT / "build" / "field_bench"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / "libfield_bench.so"
    res = subprocess.run(
        kernels.nvcc_command(ROOT / "tools" / "torch_field_bench.cu", lib_path),
        capture_output=True, text=True, timeout=600,
    )
    if res.returncode != 0:
        print(res.stdout[-4000:] + res.stderr[-4000:], file=sys.stderr)
        return 1

    lib = ctypes.CDLL(str(lib_path))
    lib.field_chain_launch.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
    dev = torch.device("cuda", 0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    inp = torch.arange(1, 21, dtype=torch.int32, device=dev) * 1_000_003
    cycles = torch.zeros(1, dtype=torch.int64, device=dev)
    rows = {}
    for op, name in enumerate(OPS):
        rows[name] = {}
        for warps in (1, 4, 8):
            out = torch.empty(sms * warps * 32 * 10, dtype=torch.int32, device=dev)
            for _ in range(2):  # the first launch warms up
                kernels.check(lib.field_chain_launch(op, sms, warps * 32, inp.data_ptr(),
                                                     out.data_ptr(), cycles.data_ptr(), ITERS),
                              f"field_chain {name}")
                torch.cuda.synchronize()
            rows[name][f"{warps}_warps_per_sm"] = int(cycles.item()) / ITERS
    print(card, flush=True)
    print(json.dumps({"unit": "SM cycles per operation per warp", "iters": ITERS,
                      "ops": rows}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
