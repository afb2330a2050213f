"""Tiny sizes of the two cells for CPU runs, and a helper that runs one."""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

LIGHT = dict(validators=12, epoch=50, shift=4, chain_height=500, sessions=40, workers=4, heights=8,
             height_range=[250, 500], clients=2, forged=1)
CATCHUP = dict(validators=6, chain_height=40, txs_per_block=4, forge_at=25, warm_blocks=10,
               verify_heights=3, readback_heights=4)
TINY = {"lightstorm.hub180": LIGHT, "catchup.osmosis150": CATCHUP}
SEED = 2**31 + 4242

# The light storm's entries: kept out of BENCHMARK.json while its runs
# spread past any bound the benchmark may set (PERF.md, Open questions);
# the tests add them to the benchmark they run.
_L = ["lightstorm.hub180"]
_LIGHT_METRICS = [  # name, unit, better, source, layer
    ("device.idle_share.light", "%", "lower", "device_trace", "card"),
    ("kernels.verify_roofline.light", "%", "higher", "device_trace", "kernels K1-K3 (csrc/*.cu)"),
    ("light.cache_hit_share", "%", "higher", "program_counter", "light serving plane (light/serving.py)"),
    ("light.jobs_per_dispatch", "jobs", "higher", "program_counter", "light serving plane (light/serving.py)"),
    ("light.verify_us_per_lane", "us", "lower", "program_span", "commit checks (types/validation.py)"),
    ("pack.us_per_lane.light", "us", "lower", "program_counter", "host packing and copy (ops/ed25519.py)"),
    ("sched.lanes_per_dispatch.light", "lanes", "higher", "program_counter", "scheduler (crypto/scheduler.py)"),
]
LIGHT_ENTRIES = {
    "configs": [{"name": "hub180", "source": "https://github.com/cosmos/gaia (cosmoshub-4: x/staking params "
                 "max_validators = 180, set by governance; ed25519 consensus keys)",
                 "file": "bftbench/configs/hub180.json", "reduced": ["chain_height"], "why": "a test"}],
    "workloads": [{"name": _L[0], "config": "hub180", "traffic": "lightstorm", "chips": 1, "why": "a test"}],
    "end_to_end": [{"name": "light_headers_per_s", "unit": "headers/s", "better": "higher", "source": "host_clock",
                    "workloads": _L},
                   {"name": "light_p95_ms", "unit": "ms", "better": "lower", "source": "host_clock", "workloads": _L}],
    "per_layer": [{"name": n, "unit": u, "better": b, "source": s, "layer": layer, "moves": "light_headers_per_s",
                   "workloads": _L} for n, u, b, s, layer in _LIGHT_METRICS],
}


def bench() -> dict:
    """BENCHMARK.json with the light storm's entries added."""
    from bftbench import core

    out = core.load_benchmark()
    return {k: v + LIGHT_ENTRIES.get(k, []) if isinstance(v, list) else v for k, v in out.items()}


def run_tiny(cell, seconds=1.5, fault=None, seed=SEED, trace=False, extra=None):
    from bftbench import faults, run

    undo = []

    def plant():
        if fault is not None:
            undo.append(faults.plant(fault))

    try:
        return run.run_cell(cell, seed, seconds, trace, device="cpu", overrides={**TINY[cell], **(extra or {})},
                            fault=plant, ref_workers=0, bench=bench())
    finally:
        for u in undo:
            u()
