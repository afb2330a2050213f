"""Self-healing connectivity under the port's chaos plane: the two
cases of ``tests/test_chaos_reconnect.py`` on ``cometbft_tpu_torch``
(``device="cpu"``).

1. ``reconnect_storm`` nemesis: repeated partition/heal cycles +
   targeted pong-timeout conn kills — the compound that used to
   exhaust the finite reconnect budget and permanently isolate a
   healed minority. With the plane, every heal must reconverge
   (liveness holds) inside the ``p2p.reconnect`` span budget.
2. The UN-PINNED matrix compound: partition x statesync_join x
   valset_churn — a seeded scenario that the generator previously
   forced to a clean network — runs invariant- AND budget-clean, with
   the mid-load joiner (and every validator) reaching the committed
   head: zero permanently-isolated nodes.
"""

import asyncio
from pathlib import Path

import torch

from cometbft_tpu_torch.chaos import (
    FaultEvent,
    FaultSchedule,
    generate_scenario,
    run_scenario,
    run_schedule,
)
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

REPO_ROOT = Path(__file__).resolve().parents[1]
BUDGETS = str(REPO_ROOT / "tools" / "span_budgets.toml")

SEED = 1337
# scenario index of master seed 1337 whose axes are
# partition x statesync_join (lifecycle cycle: index % 5 == 1); the
# assertion below keeps this pin honest if the generator changes
PARTITION_JOIN_INDEX = 11


def run(coro, timeout=300):
    async def main():
        try:
            return await asyncio.wait_for(coro, timeout)
        finally:
            import sys

            cur = asyncio.current_task()
            for t in asyncio.all_tasks():
                if t is not cur:
                    print("LEFTOVER TASK:", t, file=sys.stderr)

    return asyncio.run(main())


def test_reconnect_storm_schedule_heals(tmp_path):
    """Two partition/heal cycles with injected pong-timeout conn
    kills on the victim: the net must keep agreement, the victim must
    rejoin after every heal (liveness), and reconnect convergence
    must hold the p2p.reconnect span budget."""
    schedule = FaultSchedule(
        [
            FaultEvent(
                "reconnect_storm", at_height=2, node=1,
                cycles=2, hold_s=1.0, gap_s=0.8,
            ),
            # a conn_kill on a HEALED net: pure pong-timeout deaths,
            # no partition — reconnect must be near-immediate
            FaultEvent("conn_kill", at_height=4, node=2),
        ]
    )

    async def main():
        return await run_schedule(
            schedule,
            seed=4242,
            base_dir=str(tmp_path),
            budget_file=BUDGETS,
            device="cpu",
        )

    report = run(main())
    assert report.ok, report.format()
    assert report.budget_ok, report.format()
    assert report.conns_killed >= 4, report.conns_killed
    # the storm + kill really exercised the plane: the trace carries
    # both events
    actions = [t["action"] for t in report.trace]
    assert actions == ["reconnect_storm", "conn_kill"]


def test_unpinned_partition_statesync_join_churn_scenario(tmp_path):
    """The acceptance compound (previously pinned out of the matrix):
    a seeded partition x statesync_join x valset_churn scenario runs
    invariant-clean AND budget-clean — after the final heal every
    node, including the mid-load joiner, reaches the committed head
    (the liveness checker holds ALL running nodes to the settle
    target, so a single isolated node fails the run)."""
    spec = generate_scenario(SEED, PARTITION_JOIN_INDEX)
    assert spec.axes["lifecycle"] == "statesync_join"
    assert spec.axes["network"] == "partition", (
        "generator draw moved; re-pin PARTITION_JOIN_INDEX to an "
        f"index with partition x statesync_join (got {spec.axes})"
    )
    assert any(
        e.action == "valset_churn" for e in spec.schedule.events
    ), "statesync_join lifecycle must carry the churn leg"

    async def main():
        return await run_scenario(
            spec, base_dir=str(tmp_path), budget_file=BUDGETS, device="cpu"
        )

    report = run(main())
    assert report.ok, report.format()
    assert report.budget_ok, report.format()
    # the joiner exists and really committed
    joiners = [n for n in report.final_heights if n.startswith("j")]
    assert joiners, report.final_heights
    head = max(report.final_heights.values())
    for name, h in report.final_heights.items():
        # zero permanently-isolated nodes: everyone (validators AND
        # the joiner) holds a committed prefix near the head — the
        # in-run liveness gate already required every running node to
        # pass the settle target, this asserts nobody fell off after
        assert h > 0, (name, report.final_heights)
    assert head >= 11  # the join really happened mid-load
