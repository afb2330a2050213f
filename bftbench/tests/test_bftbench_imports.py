"""Nothing the benchmark runs is JAX or the JAX package: by its sources'
imports, and by ``sys.modules`` after a tiny CPU run."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from bftbench import core

BENCH = Path(__file__).resolve().parents[1]


def _top(name: str) -> str:
    return name.split(".", 1)[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    found = {}
    for path in BENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
                names = [node.module]
            else:
                continue
            bad = {_top(n) for n in names} & set(core.FORBIDDEN)
            if bad:
                found[str(path.relative_to(BENCH))] = sorted(bad)
    assert not found
    # the port's name begins with the JAX package's: whole names are compared
    assert _top("cometbft_tpu_torch.light") not in core.FORBIDDEN


def test_no_run_file_reads_the_jax_records():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        text = path.read_text()
        for name in ("bench.py", "BENCH_", "chip_smoke"):
            if name in text:
                # only as a provenance note in a docstring or comment
                tree = ast.parse(text)
                strings = [n.value for n in ast.walk(tree) if isinstance(n, ast.Constant) and isinstance(n.value, str)]
                assert not any(name in s and ("open(" in s or s.endswith(".json")) for s in strings), path


def test_sys_modules_after_a_tiny_run_hold_no_jax():
    code = (
        "import sys, json\n"
        f"sys.path.insert(0, {str(BENCH / 'tests')!r})\n"
        "import torch; torch.set_num_threads(1)\n"
        "from tiny import run_tiny\n"
        "line = run_tiny('catchup.osmosis150', seconds=1.0)\n"
        "print(json.dumps({'correct': line['correct'], 'modules': sorted({m.split('.', 1)[0] for m in sys.modules})}))\n"
    )
    p = subprocess.run([sys.executable, "-c", code], cwd=BENCH.parent, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"]
    assert "cometbft_tpu_torch" in out["modules"]
    assert not set(out["modules"]) & set(core.FORBIDDEN)
