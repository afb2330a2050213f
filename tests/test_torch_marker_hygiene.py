"""Marker interplay over the port's tests: the two cases of
``tests/test_marker_hygiene.py``, over the ``test_torch_*`` files.

Tier-1 runs ``-m 'not slow'``, which replaces pytest.ini's ``-m "not
tpu"`` default, so a port test marked ``tpu`` but not ``slow`` would
join the fast lane. Contract: every tpu-marked port test is also
slow-marked, i.e. ``-m "tpu and not slow"`` collects nothing among
them.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

from torch_hard_limit import hard_limit  # noqa: F401

TESTS_DIR = Path(__file__).resolve().parent
REPO_ROOT = TESTS_DIR.parent
PORT_TESTS = sorted(TESTS_DIR.glob("test_torch_*.py"))


def test_static_every_tpu_marker_rides_with_slow():
    assert len(PORT_TESTS) > 80
    offenders = []
    for path in PORT_TESTS:
        src = path.read_text(encoding="utf-8")
        if "mark.tpu" not in src:
            continue
        for m in re.finditer(r"^pytestmark\s*=\s*(.+)$", src, re.M):
            if "mark.tpu" in m.group(1) and "mark.slow" not in m.group(1):
                offenders.append(f"{path.name}: {m.group(0).strip()}")
        if "mark.slow" not in src:
            offenders.append(f"{path.name}: tpu without any slow mark")
    assert not offenders, f"tpu-marked port tests missing the slow marker: {offenders}"


def test_no_tpu_test_collected_under_not_slow():
    proc = subprocess.run(
        [sys.executable, "-m", "pytest", *map(str, PORT_TESTS), "--collect-only", "-q",
         "-m", "tpu and not slow", "-p", "no:cacheprovider", "-p", "no:randomly",
         "--continue-on-collection-errors"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=280,
        env={**os.environ, "JAX_PLATFORMS": "cpu"},
    )
    selected = [ln for ln in proc.stdout.splitlines() if "::" in ln and " " not in ln.strip()]
    assert selected == [], f"tpu tests leaked into the fast lane: {selected}"
    assert re.search(r"^(\d+)(?:/\d+)? tests? collected", proc.stdout, re.M) is None, proc.stdout[-2000:]
    assert "deselected" in proc.stdout, proc.stdout[-2000:]
