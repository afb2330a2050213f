"""bftlint CLI.

    python -m cometbft_tpu_torch.analysis [paths...]

Exit codes: 0 clean (baselined violations allowed), 1 new violations
(or stale baseline under --fail-on-stale), 2 usage/internal error.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List, Optional

from . import baseline as baseline_mod
from .engine import REPO_ROOT, run
from .registry import all_project_rules, all_rules

# the port's own baseline; tools/bftlint_baseline.json is the JAX
# package's
DEFAULT_BASELINE = Path(__file__).resolve().parent / "bftlint_baseline.json"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m cometbft_tpu_torch.analysis",
        description="bftlint: async-safety + torch hot-path static "
        "analysis for cometbft_tpu_torch",
    )
    p.add_argument(
        "paths", nargs="*", default=[str(REPO_ROOT / "cometbft_tpu_torch")],
        help="files or directories to scan (default: cometbft_tpu_torch)",
    )
    p.add_argument(
        "--baseline", default=str(DEFAULT_BASELINE),
        help="baseline file of pre-existing violations "
        f"(default: {DEFAULT_BASELINE})",
    )
    p.add_argument(
        "--no-baseline", action="store_true",
        help="report every violation, ignoring the baseline",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite the baseline to the current violation set",
    )
    p.add_argument(
        "--fail-on-stale", action="store_true",
        help="exit 1 when baseline entries no longer match anything",
    )
    p.add_argument(
        "--format", choices=("text", "json"), default="text",
    )
    p.add_argument(
        "--json", action="store_true",
        help="shorthand for --format json: machine-readable findings "
        "carrying rule, file, line, the interprocedural call chain "
        "and the domain-inference trace",
    )
    p.add_argument(
        "--changed-only", action="store_true",
        help="report findings only in files listed by `git diff "
        "--name-only HEAD` (staged + unstaged). The WHOLE project "
        "graph is still built — an interprocedural finding in a "
        "changed file can ride a chain through unchanged ones — "
        "only the report is scoped",
    )
    p.add_argument(
        "--list-rules", action="store_true",
        help="print the rule table and exit",
    )
    p.add_argument(
        "--timings", action="store_true",
        help="print per-rule wall time (the interprocedural pass's "
        "cost must stay visible as the tree grows)",
    )
    return p


def _git_changed_files() -> set:
    """Repo-root-relative posix paths from ``git diff --name-only
    HEAD`` (staged + unstaged in one list) plus untracked .py files —
    the dev-loop scope for --changed-only."""
    import subprocess

    changed: set = set()
    for cmd in (
        ["git", "diff", "--name-only", "HEAD"],
        ["git", "ls-files", "--others", "--exclude-standard"],
    ):
        try:
            res = subprocess.run(
                cmd, cwd=str(REPO_ROOT), capture_output=True,
                text=True, timeout=30,
            )
        except (OSError, subprocess.TimeoutExpired):
            continue
        if res.returncode == 0:
            changed.update(
                ln.strip() for ln in res.stdout.splitlines() if ln.strip()
            )
    return changed


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    if args.json:
        args.format = "json"
    out = sys.stdout

    if args.list_rules:
        for r in all_rules():
            print(f"{r.rule_id}  {r.name}\n    {r.doc}", file=out)
        for pr in all_project_rules():
            print(
                f"{pr.rule_id}* {pr.name} (interprocedural)\n"
                f"    {pr.doc}",
                file=out,
            )
        return 0

    timings = {} if args.timings else None
    try:
        findings = run(args.paths, timings=timings)
    except FileNotFoundError as e:
        print(f"bftlint: {e}", file=sys.stderr)
        return 2
    if timings:
        total = sum(timings.values())
        print("bftlint rule timings (wall):", file=out)
        for name, secs in sorted(
            timings.items(), key=lambda kv: -kv[1]
        ):
            print(f"  {name:<18} {secs * 1e3:9.1f} ms", file=out)
        print(f"  {'total':<18} {total * 1e3:9.1f} ms", file=out)

    if args.update_baseline:
        entries = baseline_mod.build(findings)
        Path(args.baseline).parent.mkdir(parents=True, exist_ok=True)
        baseline_mod.save(args.baseline, entries)
        n = sum(sum(r.values()) for r in entries.values())
        print(
            f"bftlint: baseline written to {args.baseline} "
            f"({n} violations across {len(entries)} files)",
            file=out,
        )
        return 0

    stale: List[baseline_mod.StaleEntry] = []
    if not args.no_baseline:
        try:
            bl = (
                baseline_mod.load(args.baseline)
                if Path(args.baseline).exists()
                else {}
            )
        except (ValueError, OSError, json.JSONDecodeError) as e:
            print(f"bftlint: bad baseline: {e}", file=sys.stderr)
            return 2
        findings, stale = baseline_mod.apply(findings, bl)

    if args.changed_only:
        # scope the REPORT, not the analysis: the project graph above
        # covered everything, so chains through unchanged files still
        # resolved — this only drops findings outside the diff
        changed = _git_changed_files()
        findings = [f for f in findings if f.path in changed]
        stale = [s for s in stale if s.path in changed]

    if args.format == "json":
        json.dump(
            {
                "findings": [f.to_json() for f in findings],
                "stale_baseline": [s._asdict() for s in stale],
            },
            out, indent=1,
        )
        out.write("\n")
    else:
        for f in findings:
            print(f.render(), file=out)
        for s in stale:
            print(s.render(), file=out)
        if findings:
            print(
                f"bftlint: {len(findings)} new violation(s)", file=out
            )
        else:
            print("bftlint: clean", file=out)

    if findings:
        return 1
    if stale and args.fail_on_stale:
        return 1
    return 0
