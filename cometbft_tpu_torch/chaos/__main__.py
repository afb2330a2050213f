"""CLI: one seeded chaos run, or the scenario-factory matrix.

    python -m cometbft_tpu_torch.chaos --seed 1337 [--nodes 4]
        [--schedule sched.json] [--byzantine N] [--json out.json]
    python -m cometbft_tpu_torch.chaos matrix --seed 1337 --count 5
    python -m cometbft_tpu_torch.chaos soak --heights 10000 --step 50

Exit code 0 when every invariant holds, 1 on any violation (the
report — seed, fault trace, per-link decisions — prints either way),
2 on a span-budget breach only. With --byzantine the run is EXPECTED
to be flagged: exit codes invert so CI can assert the checker
actually fires. The ``matrix`` subcommand generates + runs seeded
workload x network x lifecycle scenarios (chaos/generator.py,
docs/CHAOS.md "Scenario factory").

A copy of the JAX package's ``chaos/__main__.py``. ``--device`` (default
``cuda``) is where every node checks its signatures; without a GPU the
command exits 1 unless given ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import tempfile

from .net import run_schedule
from .schedule import FaultSchedule, default_schedule


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] == "matrix":
        from .matrix import matrix_main

        return matrix_main(argv[1:])
    if argv and argv[0] == "soak":
        from .soak import soak_main

        return soak_main(argv[1:])
    ap = argparse.ArgumentParser(prog="python -m cometbft_tpu_torch.chaos")
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--schedule", help="fault schedule JSON file")
    ap.add_argument(
        "--byzantine",
        type=int,
        default=None,
        metavar="N",
        help="inject a commit corruption at node N (detection check: "
        "exit 0 iff the agreement checker FLAGS the run)",
    )
    ap.add_argument("--liveness-bound", type=float, default=60.0)
    ap.add_argument("--json", help="write the report as JSON here")
    ap.add_argument(
        "--budget",
        nargs="?",
        const="",
        default=None,
        metavar="FILE",
        help="evaluate span budgets over the run's trace rings "
        "(default file tools/span_budgets.toml); any breach dumps "
        "traces and exits 2",
    )
    ap.add_argument(
        "--expect-stall",
        action="store_true",
        help="flight-recorder check: exit 0 iff a loop stall was "
        "captured whose snapshot contains the injected chaos_stall "
        "frame (pair with a schedule carrying a stall event)",
    )
    ap.add_argument(
        "--expect-lock-inversion",
        action="store_true",
        help="sanitizer check: exit 0 iff the runtime concurrency "
        "sanitizer reported the scheduled lock_inversion's ABBA "
        "cycle AND the foreign-thread affinity touch (pair with a "
        "schedule carrying a lock_inversion event)",
    )
    ap.add_argument(
        "--expect-scaling-violation",
        action="store_true",
        help="scaling-probe check: exit 0 iff the committee-scaling "
        "probe flagged the planted quadratic site over its exponent "
        "budget (pair with a schedule carrying a scaling_probe "
        "event with inject_quadratic)",
    )
    ap.add_argument(
        "--trace-dump",
        metavar="DIR",
        help="export every node's trace ring here (JSONL per node + "
        "Perfetto trace.json); without it violated runs still dump "
        "to a fresh temp directory",
    )
    ap.add_argument(
        "--light-storm",
        type=int,
        default=0,
        metavar="N",
        help="after the fault schedule settles, drive N light-client "
        "serving sessions against a live node through the shared "
        "serving plane (light/serving.py) — served blocks are "
        "hash-asserted against the node's store and the "
        "light.serve.request spans land in its ring (budget-gated "
        "with --budget)",
    )
    ap.add_argument(
        "--subscriber-storm",
        type=int,
        default=0,
        metavar="N",
        help="after the fault schedule settles, open N websocket "
        "subscribers against a live node's RPC and require every one "
        "to receive consecutive NewBlock events store-verified on "
        "the node — zero sheds, one serialization per event "
        "(rpc/fanout.py; budget-gated with --budget via the "
        "fanout.deliver span)",
    )
    ap.add_argument(
        "--fleet",
        type=int,
        default=0,
        metavar="N",
        help="attach an in-process serving fleet of N follower "
        "replicas behind a SessionRouter for the whole run "
        "(cometbft_tpu_torch/fleet, docs/FLEET.md): routed subscriber "
        "sessions stream commits throughout, a scheduled "
        "replica_kill strands them mid-stream, and the run asserts "
        "lossless failover (zero lost commits) + lag-shed isolation "
        "(a replica_kill in the schedule implies --fleet 3)",
    )
    ap.add_argument(
        "--fastpath",
        action="store_true",
        help="run every node with the live-consensus fast path "
        "(WAL group commit + vote micro-batching + pipelined "
        "finalize, docs/PERF.md) under a 2ms slow-disk fsync model",
    )
    ap.add_argument(
        "--device",
        default="cuda",
        help="where the nodes check signatures: cuda (the default; "
        "fails without a GPU) or cpu",
    )
    args = ap.parse_args(argv)
    from .matrix import _cli_device

    device = _cli_device(args.device)
    if device is None:
        return 1

    if args.schedule:
        with open(args.schedule) as f:
            schedule = FaultSchedule.from_json(f.read())
    else:
        schedule = default_schedule(byzantine_node=args.byzantine)

    budget_file = None
    if args.budget is not None:
        from ..obs.budget import default_budget_file

        budget_file = args.budget or default_budget_file()

    config_hook = None
    if args.fastpath:
        from ..consensus import wal as walmod
        from .matrix import fastpath_config_hook

        config_hook = fastpath_config_hook
        walmod.set_fsync_model(0.002)
    try:
        with tempfile.TemporaryDirectory(prefix="chaos_") as tmp:
            report = asyncio.run(
                run_schedule(
                    schedule,
                    seed=args.seed,
                    base_dir=tmp,
                    n_nodes=args.nodes,
                    liveness_bound_s=args.liveness_bound,
                    trace_dir=args.trace_dump,
                    budget_file=budget_file,
                    config_hook=config_hook,
                    light_storm=args.light_storm,
                    subscriber_storm=args.subscriber_storm,
                    fleet=args.fleet,
                    device=device,
                )
            )
    finally:
        if args.fastpath:
            from ..consensus import wal as walmod

            walmod.set_fsync_model(0.0)
    print(report.format())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                {
                    "seed": report.seed,
                    "ok": report.ok,
                    "violations": report.violations,
                    "trace": report.trace,
                    "final_heights": report.final_heights,
                    "link_decisions": report.link_decisions,
                    "wal_checks": report.wal_checks,
                    "trace_files": report.trace_files,
                    "schedule": json.loads(report.schedule_json),
                    "stall_records": report.stall_records,
                    "budget_verdicts": report.budget_verdicts,
                    "profile_file": report.profile_file,
                    "workload": report.workload,
                    "shutdown_stalls": report.shutdown_stalls,
                    "proposers": report.proposers,
                    "light_storm": report.light_storm,
                    "subscriber_storm": report.subscriber_storm,
                    "fleet": report.fleet,
                    "sanitizer_findings": report.sanitizer_findings,
                },
                f,
                indent=2,
            )
    if args.expect_stall:
        caught = any(
            any("chaos_stall" in ln for ln in r.get("loop_stack", []))
            for r in report.stall_records
        )
        print(
            "stall flight-record:",
            "CAPTURED (chaos_stall frame in snapshot)"
            if caught
            else "MISSED",
        )
        if not caught:
            return 1
    if args.expect_lock_inversion:
        from ..analysis.runtime import injected_finding

        # only the INJECTED findings count as detection (a real,
        # un-injected cycle elsewhere must not mask a missed
        # injection — same filter run_schedule applies)
        kinds = {
            f.get("kind")
            for f in report.sanitizer_findings
            if injected_finding(f)
        }
        caught = {"lock-order-cycle", "loop-affinity"} <= kinds
        print(
            "sanitizer lock-inversion:",
            "DETECTED (ABBA cycle + foreign-thread touch reported)"
            if caught
            else f"MISSED (got {sorted(kinds)})",
        )
        if not caught:
            return 1
    if args.expect_scaling_violation:
        # only the INJECTED site counts as detection (same filter as
        # the sanitizer check: a real breach elsewhere must not mask
        # a probe that missed its own plant)
        hits = [
            r
            for r in report.scaling_results
            if r.get("injected") and not r.get("ok")
        ]
        print(
            "scaling-probe quadratic plant:",
            f"DETECTED (exponent {hits[0].get('exponent')} over "
            f"budget {hits[0].get('budget')})"
            if hits
            else "MISSED",
        )
        if not hits:
            return 1
    if args.byzantine is not None:
        detected = any("agreement" in v for v in report.violations)
        print(
            "byzantine detection:",
            "DETECTED" if detected else "MISSED",
        )
        return 0 if detected else 1
    if not report.ok:
        return 1
    if not report.budget_ok:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())
