"""The control and the planted faults of a cell, on the card, at the cell's size.

    python3 bftbench/control.py --workload <cell> --fault <name> --seeds 1,2,3 --seconds 5

Runs the cell once a seed in one process, with the fault of
``faults.py`` planted just before the window (``--fault none``: the
program as it is), and prints one JSON line a run: the seed, the fault,
``correct`` and each number compared with its limit. The benchmark's
own runs never plant a fault.
"""

import argparse
import json
import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from bftbench import faults, run  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", required=True, choices=["none", *faults.FAULTS])
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        undo = []

        def fault():
            if args.fault != "none":
                undo.append(faults.plant(args.fault))

        try:
            line = run.run_cell(args.workload, seed, args.seconds, False, fault=fault)
        finally:
            for u in undo:
                u()
        print(json.dumps({"seed": seed, "fault": args.fault, "correct": line["correct"],
                          "attempted": line["attempted"], "failed": line["failed"],
                          "metrics": {k: v["value"] for k, v in line["metrics"].items()},
                          "checks": line["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    os._exit(code)
