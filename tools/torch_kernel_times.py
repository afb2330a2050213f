#!/usr/bin/env python3
"""Time the port's kernels at given widths, the same way for any checkout.

    python3 tools/torch_kernel_times.py [--tree DIR] [--lanes N [N ...]] [--runs R]

Imports ``cometbft_tpu_torch`` from the checkout DIR (default: this
repository), builds its kernels there, and runs each kernel wrapper
(K1 fused ``ladder`` and bare ``straus``, K2 ``decompress``, K3
``hash_digits``) and the whole device pass (``ops.ed25519.verify_lanes``)
on N lanes tiled from 4,096 distinct signed items, made with
chip_smoke.py's seed and helpers, for each N given (default 131,072).
Each kernel is first held to its plain version (exact equality); "ms"
is the median of R single calls after a warm one, measured with CUDA
events, and "graph_ms" the device time of a call replayed from a CUDA
graph (chip_smoke.graph_ms), which leaves out the host's launch
overhead that dominates at small widths. Prints the card's name and
power limit, then one JSON line per width.

To compare two commits like for like, unpack one with ``git archive``
into a git-ignored directory and run this script once per tree in one
session on the card, alternating: parent, change, change, parent.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(ROOT))
    ap.add_argument("--lanes", type=int, nargs="+", default=[131072])
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args(argv)
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.ops.ed25519 import verify_lanes

    smoke.check(Path(kernels.__file__).resolve().is_relative_to(tree),
                f"imported {kernels.__file__}, not from {tree}")
    dev = torch.device("cuda", 0)
    card = smoke.smi("name,power.limit")
    kernels.build_all(force=True)

    rng = np.random.default_rng(smoke.SEED)
    distinct = smoke.signed_items(rng, smoke.N_DISTINCT)
    print(card, flush=True)
    for lanes in args.lanes:
        items = [distinct[i % len(distinct)] for i in range(lanes)]
        x = smoke.kernel_inputs(items, dev)
        run = lambda: verify_lanes(x["msgs"], x["lens"], x["pr"], x["ss"])  # noqa: E731
        smoke.check(bool(run().all()), "a valid signature failed")
        calls = smoke.stage_calls(x)
        errs = smoke.compare(calls)
        ms, graph_ms = {}, {}
        for name, f in [("device", run)] + [(k, f) for k, (f, _) in calls.items()]:
            f()
            ms[name] = smoke.median_ms(f, args.runs)
            graph_ms[name] = smoke.graph_ms(f)
        print(json.dumps({"tree": str(tree), "lanes": lanes, "runs": args.runs,
                          "ms": ms, "graph_ms": graph_ms, "max_abs_err": errs}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
