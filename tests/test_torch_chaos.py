"""The port's chaos harness (``cometbft_tpu_torch/chaos/``) held to the
JAX package's: the 12 cases of ``tests/test_chaos.py`` on the port
(``device="cpu"``; the soak keeps its ``slow`` mark), and what a seed
fixes compared across the packages:

- the link plane's per-link decision streams (drop, delay, reorder,
  duplicate, partition, and the composed point fuzzer) equal the JAX
  table's for the same seed;
- a ``FaultSchedule``'s JSON is byte-equal to the JAX one's;
- a ``WorkloadSpec``'s tx stream is byte-equal to the JAX driver's;
- ``default_schedule(byzantine_node=2)`` is flagged by both packages,
  with equal nemesis traces (the tamper bytes come from the seeded
  master rng).
"""

import asyncio
import json

import pytest
import torch

from cometbft_tpu import chaos as jchaos
from cometbft_tpu.chaos import links as jlinks
from cometbft_tpu.chaos import workload as jworkload
from cometbft_tpu.p2p.fuzz import FuzzConnConfig as JFuzzConnConfig
from cometbft_tpu_torch.chaos import (
    FaultEvent,
    FaultSchedule,
    LinkState,
    LinkTable,
    default_schedule,
    generate_scenario,
    run_schedule,
)
from cometbft_tpu_torch.chaos.links import DROP_PARTITION, PASS
from cometbft_tpu_torch.chaos.workload import WorkloadDriver, WorkloadSpec
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)


def run(coro, timeout=300):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class FakeConn:
    """Minimal SecretConnection surface recording the wire."""

    def __init__(self):
        self.wire = []
        self.closed = False

    async def write_msg(self, data: bytes) -> int:
        self.wire.append(bytes(data))
        return len(data)

    async def read_chunk(self) -> bytes:
        return b""

    def close(self) -> None:
        self.closed = True


async def _drive(table, n: int, src="a", dst="b"):
    conn = table.wrap(FakeConn(), src, dst)
    for i in range(n):
        await conn.write_msg(bytes([i & 0xFF]) * 8)
    return conn


# --- link plane units ---------------------------------------------------


def test_link_decisions_deterministic_per_seed():
    async def main():
        logs = []
        for _ in range(2):
            t = LinkTable(42, default=LinkState(loss=0.3, duplicate=0.2))
            await _drive(t, 200)
            logs.append(t.decision_log("a", "b"))
        t2 = LinkTable(43, default=LinkState(loss=0.3, duplicate=0.2))
        await _drive(t2, 200)
        assert logs[0] == logs[1], "same seed must replay identically"
        assert logs[0] != t2.decision_log("a", "b"), "different seed should diverge"
        jt = jlinks.LinkTable(42, default=jlinks.LinkState(loss=0.3, duplicate=0.2))
        await _drive(jt, 200)
        assert logs[0] == jt.decision_log("a", "b")

    run(main())


def test_link_rng_survives_reconnect():
    """A redialed connection continues the SAME per-link decision
    stream: decisions are indexed by link op count, not connection."""

    async def main():
        t1 = LinkTable(7, default=LinkState(loss=0.5))
        await _drive(t1, 100)
        one = t1.decision_log("a", "b")

        t2 = LinkTable(7, default=LinkState(loss=0.5))
        await _drive(t2, 60)  # first connection
        await _drive(t2, 40)  # reconnect, same link
        assert t2.decision_log("a", "b") == one

    run(main())


def test_partition_blackholes_then_heals():
    async def main():
        t = LinkTable(1)
        inner = FakeConn()
        conn = t.wrap(inner, "a", "b")
        await conn.write_msg(b"before")
        t.partition([["a"], ["b"]])
        assert not t.allow_dial("a", "b")
        await conn.write_msg(b"during")
        t.heal()
        assert t.allow_dial("a", "b")
        await conn.write_msg(b"after")
        assert inner.wire == [b"before", b"after"]
        assert t.decision_log("a", "b") == PASS + DROP_PARTITION + PASS

    run(main())


def test_partition_groups_directional_consistency():
    t = LinkTable(1)
    ids = ["w", "x", "y", "z"]
    t.partition([["w", "x"], ["y", "z"]])
    assert t.allow_dial("w", "x") and t.allow_dial("y", "z")
    for a in ("w", "x"):
        for b in ("y", "z"):
            assert not t.allow_dial(a, b)
            assert not t.allow_dial(b, a)
    # re-partition differently: intra-group links come back up
    t.partition([["w", "y"], ["x", "z"]])
    assert t.allow_dial("w", "y") and not t.allow_dial("w", "x")
    t.heal()
    for a in ids:
        for b in ids:
            if a != b:
                assert t.allow_dial(a, b)


def test_reorder_swaps_and_duplicate_duplicates():
    async def main():
        # reorder=1.0: every write is held then flushed after the next
        t = LinkTable(3, default=LinkState(reorder=1.0))
        inner = FakeConn()
        conn = t.wrap(inner, "a", "b")
        await conn.write_msg(b"m1")  # held
        await conn.write_msg(b"m2")  # m2 delivered, then m1
        assert inner.wire == [b"m2", b"m1"]
        # close drops a pending hold-back (degrades to loss)
        await conn.write_msg(b"m3")
        conn.close()
        assert inner.wire == [b"m2", b"m1"] and inner.closed

        t2 = LinkTable(3, default=LinkState(duplicate=1.0))
        inner2 = FakeConn()
        conn2 = t2.wrap(inner2, "a", "b")
        await conn2.write_msg(b"d1")
        assert inner2.wire == [b"d1", b"d1"]

    run(main())


async def _latency_draws(table_cls, state_cls) -> list:
    real_sleep = asyncio.sleep
    t = table_cls(11, default=state_cls(latency_s=0.001, jitter_s=0.002))
    conn = t.wrap(FakeConn(), "a", "b")
    got = []

    async def spy(d):
        got.append(round(d, 9))
        await real_sleep(0)

    asyncio.sleep = spy
    try:
        for _ in range(50):
            await conn.write_msg(b"x")
    finally:
        asyncio.sleep = real_sleep
    return got


def test_latency_draws_deterministic():
    async def main():
        delays = [await _latency_draws(LinkTable, LinkState) for _ in range(2)]
        assert delays[0] == delays[1]
        assert all(0.001 <= d <= 0.003 for d in delays[0])
        assert delays[0] == await _latency_draws(jlinks.LinkTable, jlinks.LinkState)

    run(main())


def test_fuzz_composes_with_link_plane():
    """The point fuzzer (p2p/fuzz.py) layers under the link plane,
    sharing the link's deterministic stream."""
    from cometbft_tpu_torch.p2p.fuzz import FuzzConnConfig

    async def main():
        counts = []
        for table_cls, cfg_cls in ((LinkTable, FuzzConnConfig),) * 2 + ((jlinks.LinkTable, JFuzzConnConfig),):
            cfg = cfg_cls(enable=True, prob_drop_rw=0.5)
            t = table_cls(5, fuzz_config=cfg)
            inner = FakeConn()
            conn = t.wrap(inner, "a", "b")
            for _ in range(100):
                await conn.write_msg(b"z")
            counts.append(len(inner.wire))
        assert counts[0] == counts[1] == counts[2]
        assert 10 < counts[0] < 90  # fuzzer actually dropped some

    run(main())


LINK_CASES = {
    "loss": {"loss": 0.3},
    "duplicate": {"duplicate": 0.4},
    "reorder": {"reorder": 0.3},
    "mixed": {"loss": 0.1, "duplicate": 0.1, "reorder": 0.1, "latency_s": 0.0005, "jitter_s": 0.001},
}


@pytest.mark.parametrize("case", sorted(LINK_CASES))
def test_link_decision_streams_equal_jax(case):
    """For one seed, every directed link's decision stream (and what
    reaches the wire) equals the JAX table's, across a partition and a
    heal mid-stream."""

    async def drive(table_cls, state_cls):
        t = table_cls(2024, default=state_cls(**LINK_CASES[case]))
        wires = {}
        for src, dst in (("a", "b"), ("b", "a"), ("a", "c")):
            inner = FakeConn()
            conn = t.wrap(inner, src, dst)
            for i in range(120):
                if i == 40:
                    t.partition([["a"], ["b", "c"]])
                if i == 60:
                    t.heal()
                await conn.write_msg(b"%s%d" % (src.encode(), i))
            wires[(src, dst)] = (t.decision_log(src, dst), inner.wire)
        return wires, t.decision_counts()

    async def main():
        port = await drive(LinkTable, LinkState)
        jax = await drive(jlinks.LinkTable, jlinks.LinkState)
        assert port == jax

    run(main())


# --- schedule -----------------------------------------------------------


def test_schedule_json_roundtrip_and_validation():
    sched = default_schedule(byzantine_node=2)
    again = FaultSchedule.from_json(sched.to_json())
    assert again == sched
    assert json.loads(sched.to_json())[0]["action"] == "partition"

    with pytest.raises(ValueError):
        FaultEvent("explode", at_height=1)
    with pytest.raises(ValueError):
        FaultEvent("heal")  # no trigger
    with pytest.raises(ValueError):
        FaultEvent("heal", at_height=1, after_s=1.0)  # two triggers
    with pytest.raises(ValueError):
        FaultEvent("crash", at_height=1)  # no node
    with pytest.raises(ValueError):
        FaultEvent("set_link", at_height=1, src=0)  # missing dst/link
    with pytest.raises(ValueError):
        FaultEvent("partition", at_height=1)  # no groups


SCHEDULES = {
    "default": lambda m: m.default_schedule(),
    "byzantine": lambda m: m.default_schedule(byzantine_node=2),
    "generated-0": lambda m: m.generate_scenario(1337, 0).schedule,
    "generated-1": lambda m: m.generate_scenario(1337, 1).schedule,
    "generated-2": lambda m: m.generate_scenario(1337, 2).schedule,
    "explicit-none": lambda m: m.FaultSchedule(
        [m.FaultEvent("crash_wave", at_height=1, nodes=[1], restart_after_s=None),
         m.FaultEvent("verify_storm", at_height=2, storm_s=0.5),
         m.FaultEvent("scaling_probe", at_height=3, inject_quadratic=True),
         m.FaultEvent("replica_kill", after_s=0.5)]
    ),
}


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_fault_schedule_json_byte_equal_to_jax(name):
    import cometbft_tpu_torch.chaos as pchaos

    port = SCHEDULES[name](pchaos)
    jax = SCHEDULES[name](jchaos)
    assert port.to_json() == jax.to_json()
    # and each package reads the other's archive
    assert FaultSchedule.from_json(jax.to_json()) == port
    assert jchaos.FaultSchedule.from_json(port.to_json()) == jax


@pytest.mark.parametrize(
    "spec",
    [
        {"pattern": "sustained", "tx_bytes": 64},
        {"pattern": "bursty", "burst_txs": 32, "burst_gap_s": 0.3},
        {"pattern": "sustained", "tps": 10.0, "tx_bytes": 512},
    ],
    ids=["sustained", "bursty", "large_tx"],
)
def test_workload_tx_stream_equal_to_jax(spec):
    for seed in (1, 99, 1337):
        port = WorkloadDriver(WorkloadSpec(**spec), seed=seed)
        jax = jworkload.WorkloadDriver(jworkload.WorkloadSpec(**spec), seed=seed)
        assert [port._next_tx() for _ in range(80)] == [jax._next_tx() for _ in range(80)]
        assert port.spec.to_json() == jax.spec.to_json()


# --- the acceptance scenarios (real 4-node nets) ------------------------


def test_partition_heal_crash_schedule_invariants_and_reproducibility(
    tmp_path,
):
    """Seeded partition/heal + crash/restart run passes agreement,
    liveness and WAL-replay checks — and a second run with the same
    seed reproduces the identical fault trace."""

    async def main():
        r1 = await run_schedule(default_schedule(), seed=42, base_dir=str(tmp_path / "a"), device="cpu")
        assert r1.ok, r1.format()
        assert r1.wal_checks == 1  # the crash/restart was verified
        assert [t["action"] for t in r1.trace] == [
            "partition", "heal", "crash", "restart",
        ]
        # every surviving node marched past the schedule
        assert all(h >= 5 for h in r1.final_heights.values())
        # the partition actually dropped traffic
        assert any(c.get("P", 0) > 0 for c in r1.link_decisions.values())

        r2 = await run_schedule(default_schedule(), seed=42, base_dir=str(tmp_path / "b"), device="cpu")
        assert r2.ok, r2.format()
        assert r2.trace == r1.trace, "same seed must reproduce the trace"

    run(main())


def test_byzantine_commit_corruption_is_detected(tmp_path):
    """The same schedule plus an injected byzantine commit corruption
    MUST be flagged as an agreement violation — this validates the
    checker itself (a checker that cannot flag an injected fork proves
    nothing)."""

    async def main():
        report = await run_schedule(
            default_schedule(byzantine_node=2), seed=42, base_dir=str(tmp_path), device="cpu"
        )
        assert not report.ok
        assert any("agreement" in v for v in report.violations), report.violations
        byz = [t for t in report.trace if t["action"] == "byzantine"]
        assert byz and byz[0]["node"] == "n2" and byz[0]["tamper"]

    run(main())


def test_byzantine_schedule_flagged_by_both_packages(tmp_path):
    """``default_schedule(byzantine_node=2)`` under one seed: both
    packages' agreement checkers flag it, and the two nemesis traces
    are equal (node names, partition groups, tamper bytes)."""

    async def main():
        port = await run_schedule(
            default_schedule(byzantine_node=2), seed=1337, base_dir=str(tmp_path / "port"), device="cpu"
        )
        jax = await jchaos.run_schedule(
            jchaos.default_schedule(byzantine_node=2), seed=1337, base_dir=str(tmp_path / "jax")
        )
        for report in (port, jax):
            assert not report.ok
            assert any("agreement" in v for v in report.violations), report.violations
        assert port.trace == jax.trace
        assert port.schedule_json == jax.schedule_json

    run(main())


def test_dead_network_is_a_liveness_violation_not_a_hang(tmp_path):
    """A schedule that crashes every node must terminate with a
    liveness violation — not hang on an unreachable at_height trigger,
    and not vacuously pass the liveness check over zero nodes."""

    async def main():
        schedule = FaultSchedule(
            [FaultEvent("crash", at_height=1, node=i) for i in range(4)]
            # unreachable on a dead net: must be flagged, not waited on
            + [FaultEvent("heal", at_height=99)]
        )
        report = await run_schedule(
            schedule, seed=13, base_dir=str(tmp_path), liveness_bound_s=5.0, device="cpu"
        )
        assert not report.ok
        assert any("liveness" in v for v in report.violations), report.violations
        # the report still carries the replay contract
        assert [t["action"] for t in report.trace] == ["crash"] * 4

    run(main(), timeout=120)


@pytest.mark.slow
def test_chaos_soak_lossy_links_and_split_brain(tmp_path):
    """Longer soak: message loss + latency on every link, a 2-2 split
    (halts the chain — healed on a time trigger), a second crash cycle.
    Invariants must still hold."""

    async def main():
        schedule = FaultSchedule(
            [
                FaultEvent(
                    "set_link",
                    at_height=1,
                    src=0,
                    dst=3,
                    link={"loss": 0.1, "latency_s": 0.005, "jitter_s": 0.01},
                ),
                FaultEvent("partition", at_height=3, groups=[[0, 1], [2, 3]]),
                FaultEvent("heal", after_s=3.0),
                FaultEvent("crash", at_height=5, node=3),
                FaultEvent("restart", after_s=1.0, node=3),
                FaultEvent("crash", after_s=1.0, node=0),
                FaultEvent("restart", after_s=1.0, node=0),
            ]
        )
        report = await run_schedule(
            schedule, seed=77, base_dir=str(tmp_path), liveness_bound_s=120.0, device="cpu"
        )
        assert report.ok, report.format()
        assert report.wal_checks == 2

    run(main(), timeout=600)


def test_generated_scenario_json_equal_to_jax():
    """The scenario factory is a pure function of (seed, index) in
    both packages, and the two agree byte for byte (smoke and soak
    profiles, a forced committee size)."""
    for seed in (1337, 7, 20260804):
        for i in range(12):
            assert generate_scenario(seed, i).to_json() == jchaos.generate_scenario(seed, i).to_json()
    for kw in ({"profile": "soak"}, {"n_nodes": 5, "profile": "soak"}):
        for i in range(10):
            assert (
                generate_scenario(7, i, **kw).to_json()
                == jchaos.generate_scenario(7, i, **kw).to_json()
            )
