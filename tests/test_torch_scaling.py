"""The port's committee-scaling probe (``analysis/scaling.py``) held to
the JAX package's: the seven probe cases of ``tests/test_complexity.py``
with the JAX brackets, and its chaos e2e case (a scheduled
``scaling_probe`` with a planted quadratic under a live 4-node net of
the port's chaos harness, ``device="cpu"``; ``slow`` as in the JAX
suite).

The real sites drive the port's own ``VoteSet``, commit checks,
``PeerVoteCursor`` and ``FanoutHub``; the fitted exponents stay in the
linear class the JAX package's do, and both probes read the same
``tools/scaling_budgets.toml``. The synthetic sites' brackets are the
JAX ones (generous: only a wrong complexity class should fail).
"""

import asyncio
from pathlib import Path

import pytest

from cometbft_tpu.analysis import scaling as jscaling
from cometbft_tpu_torch.analysis import scaling
from torch_hard_limit import hard_limit  # noqa: F401

REPO_ROOT = Path(__file__).resolve().parent.parent


def test_fit_exponent_exact_powers():
    sizes = (4, 16, 64, 128)
    for s in (scaling, jscaling):
        assert s.fit_exponent(sizes, [7.0] * 4) == pytest.approx(0.0)
        assert s.fit_exponent(sizes, [3.0 * n for n in sizes]) == pytest.approx(1.0)
        assert s.fit_exponent(sizes, [0.5 * n * n for n in sizes]) == pytest.approx(2.0)
    walls = [1e-6 * n ** 1.3 for n in sizes]
    assert scaling.fit_exponent(sizes, walls) == jscaling.fit_exponent(sizes, walls)


def test_synthetic_sites_bracket_their_exponents():
    """Generous brackets: timing noise must never fail tier-1, only a
    wrong complexity CLASS should."""
    sites = {
        "o1": scaling.synthetic_site(0.0, unit=400),
        "on": scaling.synthetic_site(1.0, unit=60),
        "on2": scaling.synthetic_site(2.0, unit=8),
    }
    res = {r.site: r for r in scaling.run_probe(sites=sites, sizes=(4, 16, 48), min_wall_s=0.004)}
    assert res["o1"].exponent < 0.5, res["o1"]
    assert 0.5 < res["on"].exponent < 1.5, res["on"]
    assert res["on2"].exponent > 1.6, res["on2"]


def test_real_sites_fit_finite_sublinearish_exponents():
    """The four real sites, driven through the port's planes, stay in
    the linear class at small sizes (the JAX tier-1 class boundary of
    1.6; phase 19c of chip_smoke.py gates the 1.2 budgets at full
    sizes)."""
    res = scaling.run_probe(sizes=(4, 16, 48), min_wall_s=0.004)
    assert {r.site for r in res} == {"vote_add", "commit_assembly", "gossip_pick", "fanout_publish"}
    assert {r.site for r in res} == set(jscaling.site_names())
    for r in res:
        assert r.exponent < 1.6, scaling.format_results(res)


def test_injected_quadratic_site_is_flagged_and_drained():
    out = scaling.probe_for_chaos(inject_quadratic=True)
    assert out["injected"] == "chaos.injected_quadratic"
    assert "chaos.injected_quadratic" in out["breaches"]
    drained = scaling.drain_chaos_results()
    planted = [r for r in drained if r.injected]
    assert planted and not planted[0].ok
    assert scaling.injected_result(planted[0])
    assert scaling.injected_result(planted[0].as_dict())
    # drain empties: each run's results are folded exactly once
    assert scaling.drain_chaos_results() == []


def test_budget_file_loads_and_covers_every_real_site():
    budgets = scaling.load_exponent_budgets()
    assert budgets == jscaling.load_exponent_budgets()
    for site in scaling.site_names():
        assert site in budgets, f"{site} missing a scaling budget"
        assert 1.0 <= budgets[site] <= scaling.DEFAULT_EXPONENT_BUDGET


def test_minimal_toml_fallback_parses_the_shipped_budgets():
    """The port reads the budgets with tomllib only (its Python always
    has it); what it reads equals what the JAX package's fallback
    reader, for a Python without a TOML reader, makes of the file."""
    text = (REPO_ROOT / "tools" / "scaling_budgets.toml").read_text()
    parsed = jscaling._parse_budget_toml_minimal(text)
    assert parsed == {s: {"max_exponent": b} for s, b in scaling.load_exponent_budgets().items()}


def test_synthetic_exponents_stable_across_repeats():
    """The brackets hold across repeated fits (catching a calibration
    bug that only shows under sustained timing jitter); the JAX
    package runs this case in its slow lane."""
    for _ in range(3):
        test_synthetic_sites_bracket_their_exponents()


@pytest.mark.slow
def test_chaos_scaling_probe_e2e_flags_injected_quadratic(tmp_path):
    """Chaos e2e: a scheduled scaling_probe with inject_quadratic runs
    mid-schedule under a live 4-node net; the report must carry the
    planted site OVER budget without turning it into a violation."""
    from cometbft_tpu_torch.chaos.net import run_schedule
    from cometbft_tpu_torch.chaos.schedule import FaultEvent, FaultSchedule

    async def main():
        schedule = FaultSchedule(
            [
                FaultEvent("scaling_probe", at_height=2, inject_quadratic=True),
                FaultEvent("crash", at_height=3, node=1),
                FaultEvent("restart", after_s=0.5, node=1),
            ]
        )
        report = await run_schedule(schedule, seed=1337, base_dir=str(tmp_path), device="cpu")
        planted = [r for r in report.scaling_results if r["injected"] and not r["ok"]]
        assert planted, report.scaling_results
        assert not any("scaling_probe injected" in v for v in report.violations), report.violations

    asyncio.run(asyncio.wait_for(main(), 300))
