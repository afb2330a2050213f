"""Matrix runner: execute generated scenarios, gate on invariants +
span budgets, print the replay seed line per scenario.

    python -m cometbft_tpu_torch.chaos matrix --seed 1337 --count 5

Exit codes: 0 all scenarios invariant- and budget-clean, 1 any
invariant violation, 2 budget breaches only. Every scenario prints
its seed line FIRST, so a wedged/violated run's replay handle is
already on screen; ``--only I`` replays exactly scenario I.

A copy of the JAX package's ``chaos/matrix.py``; ``run_scenario`` and
``run_matrix`` take ``device`` for every node of every scenario, and the
CLI ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

from ..utils.log import get_logger
from .generator import ScenarioSpec, generate_matrix
from .net import ChaosReport, run_schedule

_log = get_logger("chaos.matrix")


@dataclass
class ScenarioResult:
    spec: ScenarioSpec
    report: Optional[ChaosReport] = None
    error: str = ""

    @property
    def ok(self) -> bool:
        return not self.error and self.report is not None and self.report.ok

    @property
    def budget_ok(self) -> bool:
        return self.report is None or self.report.budget_ok


@dataclass
class MatrixReport:
    master_seed: int
    results: List[ScenarioResult] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return all(r.ok for r in self.results)

    @property
    def budget_ok(self) -> bool:
        return all(r.budget_ok for r in self.results)

    @property
    def exit_code(self) -> int:
        if not self.ok:
            return 1
        if not self.budget_ok:
            return 2
        return 0

    def format_table(self) -> str:
        head = (
            f"{'scenario':<12} {'axes':<44} {'nodes':>5} "
            f"{'heights':<24} {'invariants':<11} {'budgets':<8}"
        )
        lines = [head, "-" * len(head)]
        for r in self.results:
            ax = ",".join(
                r.spec.axes[k]
                for k in ("workload", "network", "lifecycle")
            )
            if r.error:
                verdict, budget = "ERROR", "-"
                heights = r.error[:24]
            else:
                verdict = (
                    "OK" if r.report.ok
                    else f"{len(r.report.violations)} VIOLATED"
                )
                budget = "OK" if r.report.budget_ok else "BREACH"
                heights = ",".join(
                    str(h)
                    for h in r.report.final_heights.values()
                )[:24]
            lines.append(
                f"{r.spec.scenario_id:<12} {ax:<44} "
                f"{r.spec.n_nodes:>5} {heights:<24} {verdict:<11} "
                f"{budget:<8}"
            )
        return "\n".join(lines)


def fastpath_config_hook(cfg) -> None:
    """Enable the live-consensus fast path (docs/PERF.md) on every
    node of a chaos run: WAL group commit + in-round vote
    micro-batching + pipelined finalize. Used by ``matrix
    --fastpath`` so the fault matrix proves the fast path clean, not
    just fast."""
    cfg.consensus.wal_group_commit_ms = 2.0
    cfg.consensus.vote_batch_window_ms = 2.0
    cfg.consensus.finalize_pipeline = True


async def run_scenario(
    spec: ScenarioSpec,
    base_dir: str,
    budget_file: Optional[str] = None,
    trace_dir: Optional[str] = None,
    config_hook=None,
    device=None,
) -> ChaosReport:
    """One generated scenario through the standard chaos entrypoint
    (the same path hand-written schedules use — generated scenarios
    get no special treatment from the invariant checkers)."""
    return await run_schedule(
        spec.schedule,
        seed=spec.seed,
        base_dir=base_dir,
        n_nodes=spec.n_nodes,
        settle_heights=spec.settle_heights,
        liveness_bound_s=spec.liveness_bound_s,
        trace_dir=trace_dir,
        budget_file=budget_file,
        workload=spec.workload,
        config_hook=config_hook,
        device=device,
    )


async def run_matrix(
    specs: List[ScenarioSpec],
    budget_file: Optional[str] = None,
    trace_dir: Optional[str] = None,
    out_dir: Optional[str] = None,
    config_hook=None,
    device=None,
) -> MatrixReport:
    master = specs[0].master_seed if specs else 0
    matrix = MatrixReport(master_seed=master)
    for spec in specs:
        print(spec.seed_line(), flush=True)
        if out_dir:
            os.makedirs(out_dir, exist_ok=True)
            with open(
                os.path.join(
                    out_dir, f"{spec.scenario_id}.scenario.json"
                ),
                "w",
            ) as f:
                f.write(spec.to_json())
        res = ScenarioResult(spec=spec)
        matrix.results.append(res)
        sub_trace = (
            os.path.join(trace_dir, spec.scenario_id)
            if trace_dir
            else None
        )
        with tempfile.TemporaryDirectory(
            prefix=f"chaos_{spec.scenario_id}_"
        ) as tmp:
            try:
                res.report = await run_scenario(
                    spec,
                    base_dir=tmp,
                    budget_file=budget_file,
                    trace_dir=sub_trace,
                    config_hook=config_hook,
                    device=device,
                )
            except asyncio.CancelledError:
                raise
            except Exception as e:  # scenario crash != run violation
                res.error = repr(e)
                _log.error(
                    "scenario errored",
                    scenario=spec.scenario_id,
                    err=repr(e),
                )
                continue
        verdict = (
            "OK"
            if res.report.ok and res.report.budget_ok
            else "VIOLATED"
            if not res.report.ok
            else "BUDGET BREACH"
        )
        print(
            f"  -> {verdict} heights={res.report.final_heights} "
            f"workload={res.report.workload or 'none'}",
            flush=True,
        )
    return matrix


def _cli_device(name: str):
    """The resolved ``--device``, or None after printing why there is
    none (the command line then exits 1)."""
    from ..device import resolve

    try:
        return resolve(name)
    except RuntimeError as e:
        print(f"Error: {e} (on the command line: --device cpu)", file=sys.stderr)
        return None


def matrix_main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m cometbft_tpu_torch.chaos matrix",
        description=(
            "Seeded scenario matrix: generate + run workload x "
            "network x lifecycle chaos scenarios (docs/CHAOS.md "
            '"Scenario factory")'
        ),
        epilog=(
            "examples:\n"
            "  chaos matrix --seed 1337 --count 5        "
            "# the 5-scenario smoke (covers statesync_join, "
            "crash_wave, wal_torn_tail)\n"
            "  chaos matrix --seed 1337 --only 3         "
            "# replay scenario 3 byte-for-byte\n"
            "  chaos matrix --seed 7 --count 50 --profile soak  "
            "# nightly-sized soak\n"
            "  chaos matrix --seed 1337 --count 5 --list "
            "# print scenarios without running"
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    ap.add_argument("--seed", type=int, default=1337,
                    help="master seed (scenario i is a pure function "
                    "of (seed, i))")
    ap.add_argument("--count", type=int, default=5)
    ap.add_argument(
        "--only", type=int, action="append", default=None,
        metavar="I",
        help="run only scenario index I (repeatable) — the replay "
        "handle printed in every seed line",
    )
    ap.add_argument("--nodes", type=int, default=None,
                    help="override the generated committee size")
    ap.add_argument(
        "--profile", choices=("smoke", "soak"), default="smoke",
        help="soak allows larger committees (5/7 nodes)",
    )
    ap.add_argument(
        "--budget",
        nargs="?",
        const="",
        default=None,
        metavar="FILE",
        help="evaluate span budgets per scenario (default file "
        "tools/span_budgets.toml); any breach exits 2",
    )
    ap.add_argument("--out", metavar="DIR",
                    help="write each scenario's JSON spec here")
    ap.add_argument("--trace-dump", metavar="DIR",
                    help="export every scenario's trace rings under "
                    "DIR/<scenario_id>/")
    ap.add_argument("--json", help="write the matrix report here")
    ap.add_argument(
        "--fastpath", action="store_true",
        help="run every node with the live-consensus fast path on "
        "(WAL group commit + vote micro-batching + pipelined "
        "finalize, docs/PERF.md) under a 2ms slow-disk fsync model "
        "so the group seam genuinely engages — proves the fast path "
        "fault-clean, not just fast",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the nodes check signatures: cuda (the default; "
        "fails without a GPU) or cpu",
    )
    ap.add_argument(
        "--list", action="store_true",
        help="print the generated scenarios (seed lines + schedule "
        "JSON) without running them",
    )
    args = ap.parse_args(argv)

    specs = generate_matrix(
        args.seed,
        args.count,
        n_nodes=args.nodes,
        profile=args.profile,
        only=args.only,
    )
    if args.list:
        for spec in specs:
            print(spec.seed_line())
            print(spec.to_json())
        return 0
    device = _cli_device(args.device)
    if device is None:
        return 1

    budget_file = None
    if args.budget is not None:
        from ..obs.budget import default_budget_file

        budget_file = args.budget or default_budget_file()

    config_hook = None
    if args.fastpath:
        from ..consensus import wal as walmod

        config_hook = fastpath_config_hook
        # the calibrated WAL router keeps the strict path on this
        # box's ~0.1ms fsyncs; the model makes barriers sync-through-
        # disk-expensive so crashes/torn tails land INSIDE group
        # windows (restored below)
        walmod.set_fsync_model(0.002)
    try:
        matrix = asyncio.run(
            run_matrix(
                specs,
                budget_file=budget_file,
                trace_dir=args.trace_dump,
                out_dir=args.out,
                config_hook=config_hook,
                device=device,
            )
        )
    finally:
        if args.fastpath:
            walmod.set_fsync_model(0.0)
    print()
    print(matrix.format_table())
    for r in matrix.results:
        if r.report is not None and not r.report.ok:
            print()
            print(r.spec.seed_line())
            print(r.report.format())
    if args.json:
        with open(args.json, "w") as f:
            json.dump(
                {
                    "master_seed": matrix.master_seed,
                    "ok": matrix.ok,
                    "budget_ok": matrix.budget_ok,
                    "scenarios": [
                        {
                            "spec": r.spec.to_dict(),
                            "error": r.error,
                            "ok": r.ok,
                            "budget_ok": r.budget_ok,
                            "violations": (
                                r.report.violations
                                if r.report
                                else []
                            ),
                            "final_heights": (
                                r.report.final_heights
                                if r.report
                                else {}
                            ),
                            "workload": (
                                r.report.workload if r.report else {}
                            ),
                            "proposers": (
                                r.report.proposers if r.report else {}
                            ),
                            "trace": (
                                r.report.trace if r.report else []
                            ),
                        }
                        for r in matrix.results
                    ],
                },
                f,
                indent=2,
            )
    return matrix.exit_code
