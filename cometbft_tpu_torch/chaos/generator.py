"""Scenario factory: seeded workload × network × lifecycle chaos
matrix (docs/CHAOS.md "Scenario factory").

A copy of the JAX package's ``chaos/generator.py``: for one master
seed the scenarios' JSON is byte-equal to the JAX package's (the seed
line names this package's CLI).

From ONE master seed the generator composes whole scenarios along
three axes:

- **workload** (chaos/workload.py): sustained vs bursty tx storms
  through the mempool's ingest plane, large-tx storms, live valset churn;
- **network** (chaos/links.py): majority partitions, asymmetric
  per-link loss, latency+jitter storms over the seeded link plane;
- **lifecycle**: crash/restart waves, adaptive-sync catchup under
  traffic, ``statesync_join`` of a fresh node mid-load, WAL
  torn-tail corruption across restart.

Determinism is the whole point: scenario ``i`` of master seed ``S``
is a pure function of ``(S, i)`` — independent of ``--count`` and of
every other scenario — so the single printed seed line

    SCENARIO m<S>-<i> ... replay: python -m cometbft_tpu_torch.chaos matrix
        --seed <S> --only <i>

replays the exact schedule JSON, workload spec and per-link decision
streams byte-for-byte. The lifecycle axis cycles deterministically
(index mod len(LIFECYCLES)), so ANY window of >= 5 consecutive
indexes covers crash_wave, statesync_join, wal_torn_tail,
adaptive_catchup and the canonical crash/restart+churn shape — the
coverage guarantee the 5-scenario smoke matrix relies on.

Every generated scenario is expected invariant-clean AND
budget-clean (tools/span_budgets.toml): the matrix runner evaluates
the BFT invariant checkers and the per-scenario p95/p99 span budgets
over each run's trace rings, exactly like a hand-written schedule.
"""

from __future__ import annotations

import json
import random
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .schedule import FaultEvent, FaultSchedule
from .workload import WorkloadSpec

# lifecycle axis, cycled by index: any 5 consecutive indexes cover
# all of it (the smoke-matrix coverage guarantee)
LIFECYCLES = (
    "crash_wave",
    "statesync_join",
    "wal_torn_tail",
    "adaptive_catchup",
    "crash_restart",
)
WORKLOADS = ("sustained", "sustained_heavy", "bursty", "large_tx")
NETWORKS = (
    "clean", "partition", "asym_loss", "jitter_storm",
    "reconnect_storm",
)


@dataclass
class ScenarioSpec:
    """One fully-described, replayable scenario."""

    master_seed: int
    index: int
    seed: int  # derived run seed (LinkTable + nemesis draws)
    n_nodes: int
    axes: Dict[str, str]
    workload: WorkloadSpec
    schedule: FaultSchedule
    liveness_bound_s: float = 90.0
    settle_heights: int = 2
    notes: List[str] = field(default_factory=list)
    # generation inputs the replay line must carry: the soak profile
    # consumes an extra committee-size rng draw and an explicit
    # --nodes override skips it, so omitting either from the seed
    # line would regenerate a DIFFERENT scenario
    profile: str = "smoke"
    forced_nodes: Optional[int] = None

    @property
    def scenario_id(self) -> str:
        return f"m{self.master_seed}-{self.index}"

    def seed_line(self) -> str:
        """The single line that replays this scenario byte-for-byte."""
        ax = ",".join(
            f"{k}:{self.axes[k]}"
            for k in ("workload", "network", "lifecycle")
        )
        replay = (
            f"python -m cometbft_tpu_torch.chaos matrix "
            f"--seed {self.master_seed} --only {self.index}"
        )
        if self.profile != "smoke":
            replay += f" --profile {self.profile}"
        if self.forced_nodes is not None:
            replay += f" --nodes {self.forced_nodes}"
        return (
            f"SCENARIO {self.scenario_id} seed={self.seed} "
            f"nodes={self.n_nodes} axes=[{ax}] replay: " + replay
        )

    def to_dict(self) -> dict:
        return {
            "scenario_id": self.scenario_id,
            "master_seed": self.master_seed,
            "index": self.index,
            "seed": self.seed,
            "n_nodes": self.n_nodes,
            "axes": dict(self.axes),
            "workload": self.workload.to_dict(),
            "schedule": json.loads(self.schedule.to_json()),
            "liveness_bound_s": self.liveness_bound_s,
            "settle_heights": self.settle_heights,
            "notes": list(self.notes),
            "profile": self.profile,
            "forced_nodes": self.forced_nodes,
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=2)

    @classmethod
    def from_json(cls, raw: str) -> "ScenarioSpec":
        d = json.loads(raw)
        return cls(
            master_seed=d["master_seed"],
            index=d["index"],
            seed=d["seed"],
            n_nodes=d["n_nodes"],
            axes=d["axes"],
            workload=WorkloadSpec.from_dict(d["workload"]),
            schedule=FaultSchedule.from_json(
                json.dumps(d["schedule"])
            ),
            liveness_bound_s=d.get("liveness_bound_s", 90.0),
            settle_heights=d.get("settle_heights", 2),
            notes=d.get("notes", []),
            profile=d.get("profile", "smoke"),
            forced_nodes=d.get("forced_nodes"),
        )


# --- axis builders ------------------------------------------------------


def _workload_for(kind: str, rng: random.Random) -> WorkloadSpec:
    if kind == "sustained":
        return WorkloadSpec("sustained", tps=20.0)
    if kind == "sustained_heavy":
        return WorkloadSpec("sustained", tps=60.0)
    if kind == "bursty":
        return WorkloadSpec(
            "bursty",
            burst_txs=rng.choice([32, 64]),
            burst_gap_s=rng.choice([0.3, 0.6]),
        )
    # large_tx: sustained trickle of fat txs (gossip framing + WAL
    # record sizes), rate kept low so bytes dominate
    return WorkloadSpec("sustained", tps=10.0, tx_bytes=512)


def _network_events(
    kind: str, rng: random.Random, n_nodes: int
) -> List[FaultEvent]:
    if kind == "partition":
        # majority keeps committing; heal is height-triggered
        minority = rng.randrange(n_nodes)
        majority = [i for i in range(n_nodes) if i != minority]
        return [
            FaultEvent(
                "partition", at_height=2,
                groups=[majority, [minority]],
            ),
            FaultEvent("heal", at_height=4),
        ]
    if kind == "asym_loss":
        # one-way loss on one seeded link, cleared later: progress
        # continues (gossip retransmits), the decision stream records
        src = rng.randrange(n_nodes)
        dst = (src + 1 + rng.randrange(n_nodes - 1)) % n_nodes
        return [
            FaultEvent(
                "set_link", at_height=2, src=src, dst=dst,
                link={"loss": 0.15}, symmetric=False,
            ),
            FaultEvent(
                "set_link", at_height=5, src=src, dst=dst,
                link={"loss": 0.0}, symmetric=False,
            ),
        ]
    if kind == "reconnect_storm":
        # repeated partition/heal cycles + pong-timeout conn kills on
        # one victim: the exact compound that used to exhaust the
        # finite reconnect budget and permanently isolate a healed
        # minority. The self-healing plane (p2p/reconnect.py) must
        # re-converge after every heal, inside the p2p.reconnect span
        # budget.
        victim = rng.randrange(n_nodes)
        return [
            FaultEvent(
                "reconnect_storm", at_height=2, node=victim,
                cycles=2, hold_s=1.2, gap_s=0.8,
            )
        ]
    if kind == "jitter_storm":
        # latency+jitter on two symmetric links, calmed later; stays
        # well under the propose timeout so rounds keep closing
        a = rng.randrange(n_nodes)
        b = (a + 1) % n_nodes
        c = (a + 2) % n_nodes
        return [
            FaultEvent(
                "set_link", at_height=2, src=a, dst=b,
                link={"latency_s": 0.02, "jitter_s": 0.06},
            ),
            FaultEvent(
                "set_link", at_height=2, src=b, dst=c,
                link={"latency_s": 0.01, "jitter_s": 0.05},
            ),
            FaultEvent(
                "set_link", at_height=6, src=a, dst=b,
                link={"latency_s": 0.0, "jitter_s": 0.0},
            ),
            FaultEvent(
                "set_link", at_height=6, src=b, dst=c,
                link={"latency_s": 0.0, "jitter_s": 0.0},
            ),
        ]
    return []  # clean


def _lifecycle_events(
    kind: str, rng: random.Random, n_nodes: int, after_height: int
) -> List[FaultEvent]:
    h = after_height
    if kind == "crash_wave":
        # wave of 2 (quorum parks while both are down, restarts heal
        # it); larger committees lose a real minority
        wave_n = 2 if n_nodes <= 4 else max(2, (n_nodes - 1) // 3)
        members = rng.sample(range(n_nodes), wave_n)
        return [
            FaultEvent(
                "crash_wave", at_height=h, nodes=members,
                stagger_s=0.2, restart_after_s=1.0,
            )
        ]
    if kind == "statesync_join":
        # join needs a source snapshot (kvstore snapshots every 10
        # heights): trigger past height 11. A valset-churn leg rides
        # ahead of the join so the un-pinned compound
        # (partition x statesync_join x churn) exercises joining into
        # a net whose validator set changed mid-run.
        churn_target = rng.randrange(n_nodes)
        return [
            FaultEvent("valset_churn", at_height=h, node=churn_target),
            FaultEvent("statesync_join", at_height=max(h + 1, 11)),
        ]
    if kind == "wal_torn_tail":
        victim = rng.randrange(n_nodes)
        return [
            FaultEvent("wal_torn_tail", at_height=h, node=victim),
            # a SECOND crash/restart of the same node proves records
            # appended after the repaired tail survive (no amnesia
            # one crash later)
            FaultEvent("crash", at_height=h + 2, node=victim),
            FaultEvent("restart", after_s=0.5, node=victim),
        ]
    if kind == "adaptive_catchup":
        # one node stays down long enough to fall behind, then
        # rejoins via blocksync adaptive sync while txs keep flowing
        victim = rng.randrange(n_nodes)
        return [
            FaultEvent(
                "crash_wave", at_height=h, nodes=[victim],
                stagger_s=0.0, restart_after_s=2.5, blocksync=True,
            )
        ]
    # crash_restart: canonical single crash/restart + live valset
    # churn (the workload-axis churn leg rides here so any 5-window
    # also exercises a valset change)
    victim = rng.randrange(n_nodes)
    churn_target = rng.randrange(n_nodes)
    return [
        FaultEvent("valset_churn", at_height=h, node=churn_target),
        FaultEvent("crash", at_height=h + 1, node=victim),
        FaultEvent("restart", after_s=0.5, node=victim),
    ]


# --- generation ---------------------------------------------------------


def generate_scenario(
    master_seed: int,
    index: int,
    n_nodes: Optional[int] = None,
    profile: str = "smoke",
) -> ScenarioSpec:
    """Scenario ``index`` of master seed ``master_seed`` — a pure
    function of its arguments (module doc)."""
    rng = random.Random(f"scenario|{master_seed}|{index}")
    lifecycle = LIFECYCLES[index % len(LIFECYCLES)]
    workload_kind = WORKLOADS[rng.randrange(len(WORKLOADS))]
    network_kind = NETWORKS[rng.randrange(len(NETWORKS))]
    forced_nodes = n_nodes
    if n_nodes is None:
        # larger committees only in the soak profile (and never for
        # statesync_join, which already runs extra RPC servers): the
        # smoke matrix must stay cheap enough for tier-1
        if profile == "soak" and lifecycle != "statesync_join":
            n_nodes = rng.choice([4, 4, 5, 7])
        else:
            n_nodes = 4
    # NOTE: statesync_join used to PIN the network axis to "clean" —
    # the finite-attempts reconnect gave a partitioned/conn-killed
    # minority no reliable way back, so join-under-faults starved.
    # The self-healing plane (p2p/reconnect.py: never-give-up budgeted
    # redial + incarnation-safe dialing) removed the hole, so
    # partition x statesync_join x churn now runs un-pinned; the
    # longer horizon is absorbed by the liveness bound below.

    events = _network_events(network_kind, rng, n_nodes)
    last_net_h = max(
        [e.at_height for e in events if e.at_height is not None],
        default=2,
    )
    events += _lifecycle_events(
        lifecycle, rng, n_nodes, after_height=last_net_h + 1
    )
    workload = _workload_for(workload_kind, rng)

    liveness = 90.0
    if lifecycle == "statesync_join":
        liveness = 120.0  # the join itself waits through discovery
        if network_kind != "clean":
            # un-pinned compound (join under network faults): the
            # faulted horizon is longer — heal-then-catch-up rides on
            # top of snapshot discovery
            liveness = 150.0
    return ScenarioSpec(
        master_seed=master_seed,
        index=index,
        seed=_derive_seed(master_seed, index),
        n_nodes=n_nodes,
        axes={
            "workload": workload_kind,
            "network": network_kind,
            "lifecycle": lifecycle,
        },
        workload=workload,
        schedule=FaultSchedule(events),
        liveness_bound_s=liveness,
        profile=profile,
        forced_nodes=forced_nodes,
    )


def _derive_seed(master_seed: int, index: int) -> int:
    """Stable sub-seed: decouples the run's decision streams from the
    master rng so scenario i never depends on scenarios < i."""
    return random.Random(f"seed|{master_seed}|{index}").getrandbits(31)


def generate_matrix(
    master_seed: int,
    count: int,
    n_nodes: Optional[int] = None,
    profile: str = "smoke",
    only: Optional[List[int]] = None,
) -> List[ScenarioSpec]:
    idxs = list(range(count)) if not only else sorted(set(only))
    return [
        generate_scenario(master_seed, i, n_nodes=n_nodes, profile=profile)
        for i in idxs
    ]
