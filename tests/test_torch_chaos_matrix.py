"""The port's scenario factory (``cometbft_tpu_torch/chaos/generator.py``,
``matrix.py``, ``workload.py``) held to the JAX package's: the 12 cases
of ``tests/test_chaos_matrix.py`` on the port (``device="cpu"``, the
command line with ``--device cpu``; the 50-scenario soak keeps its
``slow`` mark), and ``generate_matrix`` compared with the JAX one.

1. Generation determinism: scenario i of master seed S is a pure
   function of (S, i) — identical JSON across calls, independent of
   --count, with the lifecycle-coverage guarantee any 5-window needs,
   and byte-equal to the JAX package's.
2. The tier-1 smoke: ``chaos matrix --seed 1337 --count 5`` runs five
   distinct generated scenarios — covering statesync_join,
   crash_wave and wal_torn_tail — invariant-clean and budget-clean,
   with torn-tail recovery proven through the matrix replay path.
3. Same-seed run determinism: two runs of one generated scenario
   produce identical schedule JSON, identical fault traces and the
   same structural outcome (committed-prefix proposers, violations).
4. An INJECTED violation replays byte-for-byte from the scenario's
   seed (the printed seed line's contract).
5. Workload plane units: spec round-trip + deterministic tx streams.
"""

import asyncio
import json

import pytest
import torch

from cometbft_tpu import chaos as jchaos
from cometbft_tpu_torch.chaos import (
    LIFECYCLES,
    FaultEvent,
    WorkloadSpec,
    generate_matrix,
    generate_scenario,
    run_scenario,
)
from cometbft_tpu_torch.chaos.generator import ScenarioSpec
from cometbft_tpu_torch.chaos.matrix import matrix_main
from cometbft_tpu_torch.chaos.workload import WorkloadDriver
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

SEED = 1337


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --- 1. generation determinism + coverage -------------------------------


def test_generation_is_pure_function_of_seed_and_index():
    for i in range(8):
        a = generate_scenario(SEED, i)
        b = generate_scenario(SEED, i)
        assert a.to_json() == b.to_json()
        assert a.schedule.to_json() == b.schedule.to_json()
        assert a.seed == b.seed
    # independent of count: scenario 2 is the same whether generated
    # alone or inside any matrix
    alone = generate_matrix(SEED, 5, only=[2])[0]
    in_matrix = generate_matrix(SEED, 5)[2]
    assert alone.to_json() == in_matrix.to_json()
    # and equal to the JAX package's, byte for byte
    assert [s.to_json() for s in generate_matrix(SEED, 8)] == [
        s.to_json() for s in jchaos.generate_matrix(SEED, 8)
    ]
    # different indexes / seeds really differ
    assert (
        generate_scenario(SEED, 0).schedule.to_json()
        != generate_scenario(SEED, 5).schedule.to_json()
        or generate_scenario(SEED, 0).seed
        != generate_scenario(SEED, 5).seed
    )
    assert (
        generate_scenario(SEED, 1).seed
        != generate_scenario(SEED + 1, 1).seed
    )


def test_any_five_window_covers_every_lifecycle():
    for start in (0, 3, 17):
        specs = generate_matrix(SEED, 0, only=list(range(start, start + 5)))
        lifecycles = {s.axes["lifecycle"] for s in specs}
        assert lifecycles == set(LIFECYCLES), (start, lifecycles)


def test_seed_line_carries_generation_inputs():
    """The replay line must regenerate the IDENTICAL scenario: the
    soak profile consumes an extra committee-size draw and an
    explicit --nodes override skips it, so both must ride the line."""
    soak = generate_scenario(7, 9, profile="soak")
    assert "--profile soak" in soak.seed_line()
    # replaying with exactly the line's flags reproduces the schedule
    again = generate_scenario(7, 9, profile="soak")
    assert again.to_json() == soak.to_json()
    forced = generate_scenario(7, 9, n_nodes=5, profile="soak")
    assert "--nodes 5" in forced.seed_line()
    smoke = generate_scenario(7, 9)
    assert "--profile" not in smoke.seed_line()
    assert "--nodes" not in smoke.seed_line()


def test_schedule_roundtrip_keeps_explicit_none_over_nonnone_default():
    """An archived schedule must replay with identical semantics:
    crash_wave restart_after_s=None means "stay down" and must NOT
    round-trip back to the default 1.0 ("restart after 1s")."""
    from cometbft_tpu_torch.chaos import FaultSchedule

    sched = FaultSchedule(
        [
            FaultEvent(
                "crash_wave", at_height=1, nodes=[1],
                restart_after_s=None,
            )
        ]
    )
    again = FaultSchedule.from_json(sched.to_json())
    assert again == sched
    assert again.events[0].restart_after_s is None
    # fields still at their defaults stay out of the JSON
    assert "stagger_s" not in json.loads(sched.to_json())[0]


def test_scenario_spec_json_roundtrip():
    spec = generate_scenario(SEED, 2)
    again = ScenarioSpec.from_json(spec.to_json())
    assert again.to_json() == spec.to_json()
    assert again.schedule == spec.schedule
    assert again.workload == spec.workload
    assert again.axes == spec.axes


# --- 2. the tier-1 smoke matrix (the acceptance run) --------------------


def test_smoke_matrix_five_scenarios_invariant_and_budget_clean(
    tmp_path, capsys
):
    """``python -m cometbft_tpu_torch.chaos matrix --seed 1337 --count 5``:
    five distinct scenarios covering at least statesync_join,
    crash_wave and wal_torn_tail, all invariant- AND budget-clean,
    each preceded by its replay seed line."""
    out_json = tmp_path / "matrix.json"
    rc = matrix_main(
        [
            "--seed", str(SEED), "--count", "5", "--budget",
            "--json", str(out_json), "--device", "cpu",
        ]
    )
    printed = capsys.readouterr().out
    assert rc == 0, printed
    with open(out_json) as f:
        matrix = json.load(f)
    assert matrix["ok"] and matrix["budget_ok"]
    scenarios = matrix["scenarios"]
    assert len(scenarios) == 5
    lifecycles = {
        s["spec"]["axes"]["lifecycle"] for s in scenarios
    }
    assert {"statesync_join", "crash_wave", "wal_torn_tail"} <= lifecycles
    # five DISTINCT scenarios
    assert len({json.dumps(s["spec"]["schedule"]) for s in scenarios}) == 5
    for s in scenarios:
        assert s["ok"] and not s["violations"], s
        # every scenario committed and carries its structural
        # fingerprint + a real workload
        assert s["final_heights"] and s["proposers"]
        assert s["workload"].get("submitted", 0) > 0
        # the seed line (the replay handle) was printed
        sid = s["spec"]["scenario_id"]
        idx = s["spec"]["index"]
        assert (
            f"SCENARIO {sid}" in printed
            and f"--seed {SEED} --only {idx}" in printed
        )
    # the statesync scenario really grew the net by a joiner
    ss = next(
        s for s in scenarios
        if s["spec"]["axes"]["lifecycle"] == "statesync_join"
    )
    joiners = [n for n in ss["final_heights"] if n.startswith("j")]
    assert joiners and all(
        ss["final_heights"][j] > 0 for j in joiners
    ), ss["final_heights"]
    # torn-tail recovery went through the matrix replay path: the
    # wal_torn_tail event executed (torn bytes appended) and the
    # restarted node passed the WAL-replay (no-amnesia) checks
    tt = next(
        s for s in scenarios
        if s["spec"]["axes"]["lifecycle"] == "wal_torn_tail"
    )
    torn = [
        t for t in tt["trace"] if t["action"] == "wal_torn_tail"
    ]
    assert torn and torn[0]["torn_bytes"] > 0, tt["trace"]


# --- 3. same-seed structural determinism --------------------------------


def test_same_seed_scenario_runs_reproduce_structure(tmp_path):
    """Two runs of one generated scenario: identical schedule JSON,
    identical fault trace (all seeded draws included), no violations,
    and the same proposer at every height of the common committed
    prefix WHILE the two runs' commit-round histories agree (wall
    time decides how FAR each run gets — and, on a contended box,
    whether a round whose proposer is mid-crash/restart times out,
    which shifts rotation for every later height; proposer selection
    itself is a pure function of the valset + round history, so the
    matched-round prefix must reproduce exactly)."""
    spec1 = generate_scenario(SEED, 4)
    spec2 = generate_scenario(SEED, 4)
    assert spec1.schedule.to_json() == spec2.schedule.to_json()

    async def one(spec, sub):
        return await run_scenario(spec, base_dir=str(tmp_path / sub), device="cpu")

    r1 = run(one(spec1, "a"))
    r2 = run(one(spec2, "b"))
    assert r1.ok, r1.format()
    assert r2.ok, r2.format()
    assert r1.trace == r2.trace, "same seed must reproduce the trace"
    common = sorted(set(r1.proposers) & set(r2.proposers))
    assert common, (r1.proposers, r2.proposers)
    matched = []
    for h in common:
        if r1.rounds.get(h) != r2.rounds.get(h):
            break  # round histories diverged: rotation forks here
        matched.append(h)
    assert matched, (common, r1.rounds, r2.rounds)
    for h in matched:
        assert r1.proposers[h] == r2.proposers[h], (
            h, r1.proposers[h], r2.proposers[h],
        )


def test_injected_violation_replays_byte_for_byte(tmp_path):
    """The seed-line contract under failure: the same generated
    scenario with an injected byzantine commit corruption must be
    FLAGGED in both runs, with identical fault traces (tamper bytes
    included — they come from the seeded master rng)."""
    def spec_with_byzantine():
        spec = generate_scenario(SEED, 0)
        spec.schedule.events.append(
            FaultEvent("byzantine", at_height=4, node=2)
        )
        return spec

    async def one(sub):
        return await run_scenario(
            spec_with_byzantine(), base_dir=str(tmp_path / sub), device="cpu"
        )

    r1 = run(one("a"))
    r2 = run(one("b"))
    for r in (r1, r2):
        assert not r.ok
        assert any("agreement" in v for v in r.violations), r.violations
    byz1 = [t for t in r1.trace if t["action"] == "byzantine"]
    byz2 = [t for t in r2.trace if t["action"] == "byzantine"]
    assert byz1 and byz1[0]["tamper"] == byz2[0]["tamper"]
    assert r1.trace == r2.trace


# --- 4. workload plane units --------------------------------------------


def test_workload_spec_roundtrip_and_validation():
    spec = WorkloadSpec("bursty", burst_txs=16, burst_gap_s=0.1)
    again = WorkloadSpec.from_dict(json.loads(json.dumps(spec.to_dict())))
    assert again == spec
    with pytest.raises(ValueError):
        WorkloadSpec("weird")
    with pytest.raises(ValueError):
        WorkloadSpec("sustained", tx_bytes=4)


def test_workload_tx_stream_is_deterministic():
    d1 = WorkloadDriver(WorkloadSpec("sustained", tx_bytes=64), seed=99)
    d2 = WorkloadDriver(WorkloadSpec("sustained", tx_bytes=64), seed=99)
    s1 = [d1._next_tx() for _ in range(50)]
    s2 = [d2._next_tx() for _ in range(50)]
    assert s1 == s2
    assert all(len(t) >= 64 for t in s1)
    assert len(set(s1)) == 50  # unique keys, no mempool dup rejects
    d3 = WorkloadDriver(WorkloadSpec("sustained", tx_bytes=64), seed=98)
    assert [d3._next_tx() for _ in range(50)] != s1


# --- fast-path slice ---------------------------------------------------


def test_fastpath_matrix_slice_invariant_and_budget_clean(
    tmp_path, capsys
):
    """``chaos matrix --fastpath``: the live-consensus fast path (WAL
    group commit + in-round vote micro-batching + pipelined finalize,
    docs/PERF.md) under the seeded fault matrix, beneath the 2ms
    slow-disk fsync model so the calibrated group seam genuinely
    engages — gated on the SAME invariants and span budgets as the
    plain smoke. Proves the fast path fault-clean, not just fast."""
    from cometbft_tpu_torch.consensus import wal as walmod

    out_json = tmp_path / "fastpath.json"
    rc = matrix_main(
        [
            "--seed", str(SEED), "--count", "2", "--fastpath",
            "--budget", "--json", str(out_json), "--device", "cpu",
        ]
    )
    printed = capsys.readouterr().out
    assert rc == 0, printed
    # the model must be restored no matter what the run did
    assert walmod._FSYNC_MODEL_S == 0.0
    with open(out_json) as f:
        matrix = json.load(f)
    assert matrix["ok"] and matrix["budget_ok"]
    assert len(matrix["scenarios"]) == 2
    for s in matrix["scenarios"]:
        assert s["ok"] and not s["violations"], s
        assert s["final_heights"]


# --- 5. nightly-sized soak (slow marker) --------------------------------


@pytest.mark.slow
def test_soak_matrix_fifty_scenarios(tmp_path):
    """A 50+-scenario seeded soak, every violation replayable from its
    printed seed line (here: none expected)."""
    out_json = tmp_path / "soak.json"
    rc = matrix_main(
        [
            "--seed", "20260804", "--count", "50", "--budget",
            "--profile", "soak", "--json", str(out_json), "--device", "cpu",
        ]
    )
    with open(out_json) as f:
        matrix = json.load(f)
    failed = [
        s["spec"]["scenario_id"]
        for s in matrix["scenarios"]
        if not s["ok"]
    ]
    assert rc == 0 and not failed, failed
