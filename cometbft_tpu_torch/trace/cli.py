"""Trace CLI:

    python -m cometbft_tpu_torch.trace dump      FILE_OR_DIR...
    python -m cometbft_tpu_torch.trace convert   FILE_OR_DIR... -o trace.json
    python -m cometbft_tpu_torch.trace summarize FILE_OR_DIR... [--json]
                                           [--by-height]
    python -m cometbft_tpu_torch.trace timeline  FILE_OR_DIR... [-o out.json]
                                           [--json] [--strict]

Inputs are JSONL trace files (one event per line, as written by
trace/export.write_jsonl — a node's ring dump) or directories of
them. ``convert`` emits Chrome trace-event JSON:
open the output at https://ui.perfetto.dev or chrome://tracing.

``timeline`` is the cross-node view (docs/TRACE.md "Cross-node
timelines"): rings are rebased onto one wall-clock axis via their
``clock.anchor`` events, merged causally ordered (``-o`` writes the
merged Perfetto JSON), and the per-height commit-latency waterfall
is printed — proposal propagation, block-part gossip, time-to-2/3
prevote/precommit, verify, wal, finalize. ``--strict`` exits 3 when
any committed height lacks a complete attribution chain.

A copy of the JAX package's ``trace/cli.py``; ``summarize --budget``
reads ``tools/span_budgets.toml`` by default.
"""

from __future__ import annotations

import argparse
import json
import sys

from .export import chrome_trace, read_jsonl, write_chrome
from .summary import (
    format_by_height,
    format_summary,
    summarize,
    summarize_by_height,
)
from .timeline import (
    attribute_heights,
    format_waterfall,
    rebase,
)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cometbft_tpu_torch.trace")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p_dump = sub.add_parser(
        "dump", help="print events as JSON lines, time-ordered"
    )
    p_dump.add_argument("paths", nargs="+")

    p_conv = sub.add_parser(
        "convert", help="convert to Chrome trace JSON (Perfetto)"
    )
    p_conv.add_argument("paths", nargs="+")
    p_conv.add_argument(
        "-o", "--out", help="output file (default: stdout)"
    )

    p_sum = sub.add_parser(
        "summarize",
        help="p50/p95/p99 per span kind per node",
    )
    p_sum.add_argument("paths", nargs="+")
    p_sum.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p_sum.add_argument(
        "--budget",
        nargs="?",
        const="",
        default=None,
        metavar="FILE",
        help="evaluate span budgets (obs/budget.py; default file "
        "tools/span_budgets.toml) and exit 2 on any violation",
    )
    p_sum.add_argument(
        "--by-height",
        action="store_true",
        help="also group height-tagged spans per height "
        "(cross-node aggregate)",
    )

    p_tl = sub.add_parser(
        "timeline",
        help="cross-node causal timeline + per-height "
        "commit-latency waterfall",
    )
    p_tl.add_argument("paths", nargs="+")
    p_tl.add_argument(
        "-o",
        "--out",
        help="write the merged clock-rebased Chrome trace JSON here",
    )
    p_tl.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p_tl.add_argument(
        "--strict",
        action="store_true",
        help="exit 3 if any committed height lacks a complete "
        "attribution chain",
    )

    args = ap.parse_args(argv)
    events = read_jsonl(args.paths)
    if not events:
        print("no trace events found", file=sys.stderr)
        return 1

    if args.cmd == "dump":
        flat = [
            {"node": node, **e}
            for node, evs in events.items()
            for e in evs
        ]
        flat.sort(key=lambda e: e.get("ts_ns", 0))
        try:
            for e in flat:
                print(json.dumps(e))
        except BrokenPipeError:
            # downstream pager/head closed the pipe: a clean exit,
            # not a traceback
            sys.stderr.close()
    elif args.cmd == "timeline":
        rebased, offsets, base_wall = rebase(events)
        heights = attribute_heights(rebased)
        if args.out:
            write_chrome(args.out, rebased)
        unanchored = sorted(n for n, o in offsets.items() if o is None)
        if args.json:
            print(
                json.dumps(
                    {
                        "base_wall_ns": base_wall,
                        "offsets_ns": offsets,
                        "unanchored": unanchored,
                        "events": sum(
                            len(v) for v in rebased.values()
                        ),
                        "heights": {
                            str(h): s for h, s in heights.items()
                        },
                    },
                    indent=2,
                )
            )
        else:
            spread = [o for o in offsets.values() if o is not None]
            if spread:
                print(
                    f"clock anchors: {len(spread)}/{len(offsets)} "
                    f"rings, offset spread "
                    f"{(max(spread) - min(spread)) / 1e6:.3f}ms"
                )
            if unanchored:
                print(
                    "unanchored rings (median offset borrowed): "
                    + ", ".join(unanchored)
                )
            if args.out:
                print(
                    f"wrote {args.out}: "
                    f"{sum(len(v) for v in rebased.values())} events "
                    f"from {len(rebased)} ring(s) — load in "
                    f"ui.perfetto.dev"
                )
            print(format_waterfall(heights))
        if args.strict and (
            not heights
            or any(not s["complete"] for s in heights.values())
        ):
            return 3
    elif args.cmd == "convert":
        if args.out:
            write_chrome(args.out, events)
            n = sum(len(v) for v in events.values())
            print(
                f"wrote {args.out}: {n} events from "
                f"{len(events)} node(s) — load in ui.perfetto.dev"
            )
        else:
            json.dump(chrome_trace(events), sys.stdout)
            print()
    else:  # summarize
        s = summarize(events)
        by_height = (
            summarize_by_height(events) if args.by_height else None
        )
        verdicts = None
        if args.budget is not None:
            # late import: the budget engine pulls tomllib; plain
            # summarize must keep working without it
            from ..obs.budget import (
                budgets_ok,
                default_budget_file,
                evaluate_budgets,
                format_verdicts,
                load_budgets,
            )

            budget_path = args.budget or default_budget_file()
            budgets = load_budgets(budget_path)
            verdicts = evaluate_budgets(s, budgets)
        if args.json:
            doc = dict(s)
            if verdicts is not None or by_height is not None:
                doc = {"summary": s}
                if by_height is not None:
                    doc["by_height"] = {
                        str(h): v for h, v in by_height.items()
                    }
                if verdicts is not None:
                    doc["budget_verdicts"] = verdicts
            print(json.dumps(doc, indent=2))
        else:
            print(format_summary(s))
            if by_height is not None:
                print()
                print(format_by_height(by_height))
            if verdicts is not None:
                print()
                print(format_verdicts(verdicts))
        if verdicts is not None and not budgets_ok(verdicts):
            return 2
    return 0
