"""The port's multi-process dryrun (``parallel/dryrun.py``), held to what
``tests/test_dryrun.py`` pins for the JAX one.

1. the kernel-leg budget fits the dryrun's window (<= 120 s) and the
   whole dryrun's cap is the JAX test's 240 s;
2. the dryrun, as a user runs it (``python -m
   cometbft_tpu_torch.parallel.dryrun 4``: four gloo ranks on the CPU,
   each verifying its slice with the kernels' plain versions, the
   tally summed by ``all_reduce``), finishes under that cap with rank
   0's checks against the oracle passed;
3. ranks that outlive their budget fail the dryrun, and every process
   it started has ended when it raises.
"""

import os
import subprocess
import sys
import time

import pytest

from cometbft_tpu_torch.parallel import dryrun
from torch_hard_limit import hard_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_default_kernel_budget_fits_the_dryrun_window():
    assert dryrun.DEFAULT_KERNEL_BUDGET_S <= 120
    assert dryrun.DRYRUN_WALL_CAP_S == 240


def test_dryrun_flow_completes_under_wall_cap():
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [sys.executable, "-m", "cometbft_tpu_torch.parallel.dryrun", "4"],
            cwd=REPO, capture_output=True, text=True, timeout=dryrun.DRYRUN_WALL_CAP_S,
        )
    except subprocess.TimeoutExpired:
        pytest.fail(f"dryrun exceeded the {dryrun.DRYRUN_WALL_CAP_S}s wall cap")
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    line = next(ln for ln in proc.stdout.splitlines() if ln.startswith("dryrun_multichip OK"))
    assert "mesh=4 lanes=8 tally=70/80 quorum=True" in line, line
    assert "kernel_leg=sharded-plain(gloo)" in line, line
    assert time.perf_counter() - t0 < dryrun.DRYRUN_WALL_CAP_S


def test_ranks_past_their_budget_fail_the_dryrun(monkeypatch):
    started = []
    real = subprocess.Popen

    def record(*a, **kw):
        p = real(*a, **kw)
        started.append(p)
        return p

    monkeypatch.setattr(dryrun.subprocess, "Popen", record)
    monkeypatch.setattr(dryrun, "DEFAULT_KERNEL_BUDGET_S", 0.2)
    with pytest.raises(RuntimeError, match="budget"):
        dryrun.dryrun_multichip(2)
    assert len(started) == 2
    assert all(p.poll() is not None for p in started)


def test_one_rank_is_no_dryrun():
    with pytest.raises(ValueError):
        dryrun.dryrun_multichip(1)
