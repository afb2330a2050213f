"""Declarative fault schedules for the nemesis scheduler.

A copy of the JAX package's ``chaos/schedule.py``: for the same
events the JSON is byte-equal to the JAX package's.

A schedule is an ordered list of FaultEvents. Events execute strictly
in order; each one waits for its trigger first:

- ``at_height=N`` — fire once the network's max committed height
  (over running nodes) reaches N. Use for events downstream of
  progress (a majority-side partition keeps committing, so its heal
  can be height-triggered).
- ``after_s=T`` — fire T seconds after the previous event executed
  (or after run start for the first event). Use when the trigger side
  cannot make progress (e.g. healing a 2-2 split that halts the
  chain).

Actions (mirroring the e2e runner's perturbations, but in-process,
deterministic and fast):

====================  =================================================
``partition``         ``groups=[[0,1],[2,3]]`` node-index groups; links
                      across groups go down (silent blackhole)
``heal``              all links back up
``set_link``          ``src``/``dst`` node indexes + ``link`` dict of
                      LinkState fields (loss, latency_s, jitter_s,
                      duplicate, reorder, up); ``symmetric`` (default
                      True) applies both directions
``crash``             ``node=i``: in-process power cut (Node.kill)
``restart``           ``node=i``: rebuild from the same home dir —
                      recovery runs WAL replay + ABCI handshake replay
``stall``             ``duration_s=T``: block the (shared in-process)
                      event loop with a synchronous callback for T
                      seconds — the loop-stall the obs watchdog's
                      flight recorder must catch mid-flight
                      (docs/OBS.md; the snapshot must contain
                      ``chaos_stall``)
``byzantine``         ``node=i``: corrupt the node's NEXT commit (its
                      stored block ID at that height is rewritten with
                      seeded tamper bytes). This simulates the
                      observable effect of a byzantine commit so the
                      AGREEMENT CHECKER ITSELF is validated — a
                      checker that cannot flag an injected fork proves
                      nothing (the same discipline Jepsen applies to
                      its checkers).
``crash_wave``        ``nodes=[i,...]``: power-cut the listed nodes in
                      order, ``stagger_s`` apart; after
                      ``restart_after_s`` restart them in the same
                      order (same stagger). ``blocksync=True`` rebuilds
                      the wave's nodes with blocksync + adaptive sync
                      enabled, so recovery exercises adaptive-sync
                      catchup under traffic instead of consensus
                      catch-up gossip.
``statesync_join``    a FRESH non-validator node joins mid-run by
                      statesync: snapshot discovery over p2p,
                      light-verified restore against the RPC of two
                      running nodes (``via=[i,j]``; defaults to the
                      first two running), then blocksync follows the
                      tail. Requires the net to run with RPC enabled
                      (run_schedule switches it on automatically when
                      the schedule contains this action) and a source
                      app snapshot (kvstore snapshots every 10
                      heights — trigger at height >= 11).
``valset_churn``      churn the validator set under load: submit a
                      power-change tx for validator ``node``'s key
                      (new power drawn from the MASTER rng in
                      [power_min, power_max], or pass ``power``
                      explicitly). Changes the valset hash + proposer
                      rotation live without adding absent signers.
``wal_torn_tail``     ``node=i``: power-cut the node (if running),
                      append seeded garbage (``garbage`` bytes, drawn
                      from the MASTER rng) to its consensus WAL head —
                      the torn partial record a real power cut leaves —
                      then restart it. Recovery must repair the tail
                      (consensus/wal.py truncate_corrupt_tail) and
                      extend the committed prefix unchanged.
``conn_kill``         ``node=i``: kill up to ``count`` (default: all)
                      of the node's live connections via pong-timeout
                      injection (MConnection.inject_error) — the conn
                      death a silent blackhole eventually produces,
                      without waiting out ping_interval+pong_timeout.
                      Persistent-peer reconnect (p2p/reconnect.py)
                      must heal every kill.
``lock_inversion``    deliberately exercise the runtime concurrency
                      sanitizer (analysis/runtime.py, docs/LINT.md
                      "Runtime sanitizer"): acquire two
                      sanitizer-wrapped locks in A-B then B-A order
                      (a deterministic ABBA inversion — the
                      lock-order graph records ORDER, not
                      contention) and touch a tagged loop-affine
                      probe from a foreign thread. The run asserts
                      the sanitizer REPORTS both (a sanitizer that
                      cannot flag an injected inversion proves
                      nothing — the same checker-validation
                      discipline as ``byzantine``); the injected
                      findings themselves are expected, not
                      violations.
``reconnect_storm``   ``node=i``: ``cycles`` repetitions of
                      {partition the victim off, pong-timeout-kill its
                      conns, hold ``hold_s``, heal, wait ``gap_s``} —
                      the compound that used to exhaust the finite
                      reconnect budget and permanently isolate a
                      healed minority. The self-healing plane must
                      re-converge after every heal (gated by the
                      ``p2p.reconnect`` span budget).
``scaling_probe``     run the committee-scaling exponent probe
                      (analysis/scaling.py, docs/LINT.md "Complexity
                      rules") mid-schedule in a worker thread: the
                      flagged hot-path sites are driven at small
                      committee sizes and their log-log exponents
                      judged against tools/scaling_budgets.toml. An
                      un-injected budget breach is a VIOLATION;
                      with ``inject_quadratic=True`` a deliberate
                      O(n^2) site (``chaos.``-prefixed, like
                      lock_inversion's probe locks) is planted and
                      the run asserts the probe FLAGS it — the same
                      checker-validation discipline.
``verify_storm``      run the unified-verify-scheduler storm
                      (chaos/verify_storm.py) in a worker thread: a
                      light-session storm + a blocksync-style
                      catch-up storm + a synthetic live-wave feeder,
                      all through the ONE process-wide scheduler the
                      net's own consensus is verifying on. Verdict
                      parity (bad signatures included) is asserted on
                      every ticket, the live class's p95 wall is
                      gated on ``live_budget_ms`` (the
                      crypto.sched.dispatch budget), and the catch-up
                      lane must keep completing tickets for the whole
                      ``storm_s`` — a starved lane, a breached live
                      budget, or a diverged verdict is a VIOLATION.
``crash_mid_prune``   ``node=i``: abort a retention reconcile pass
                      after ``abort_after`` bounded batches (drawn
                      from the MASTER rng when unset — the crash
                      lands at a seeded batch boundary), power-cut
                      the node, restart it and run one resume pass.
                      Every batch commits its deletes + base-marker
                      advance atomically (store/retention.py), so
                      the partial pass must read as a consistent
                      less-pruned store, the restart must pass the
                      WAL-replay checker, and the resume must finish
                      the same targets idempotently. Requires the
                      lifecycle storage knobs — run_schedule auto-
                      sets them when this action is scheduled.
``snapshot_during_prune`` ``node=i``: park a reconcile pass
                      mid-batch, then serve the node's newest
                      on-disk snapshot chunk-by-chunk under the
                      in-flight-serve pin while the pass is live;
                      the reassembled blob must hash-verify and the
                      snapshot must not rotate away while pinned
                      (the serve-floor contract). Trigger past the
                      app's snapshot cadence (kvstore: height >=
                      11). Auto-sets the storage knobs like
                      ``crash_mid_prune``.
``replica_kill``      kill one serving-fleet follower replica
                      mid-stream (``replica=i``, or a seeded draw
                      from the MASTER rng when unset). Requires the
                      net to run with a fleet attached
                      (``run_schedule(..., fleet=N)``); the
                      SessionRouter must fail the dead replica's
                      sessions over to the survivors with ZERO lost
                      commits — every resumed subscriber's stream is
                      store-verified gap-free — and lag shedding must
                      stay isolated to the killed replica's own
                      clients (docs/FLEET.md).
====================  =================================================

Schedules round-trip through JSON so failing runs can be archived and
replayed byte-for-byte alongside their seed.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional

ACTIONS = (
    "partition", "heal", "set_link", "crash", "restart", "byzantine",
    "stall", "crash_wave", "statesync_join", "valset_churn",
    "wal_torn_tail", "conn_kill", "reconnect_storm", "lock_inversion",
    "scaling_probe", "crash_mid_prune", "snapshot_during_prune",
    "verify_storm", "replica_kill",
)


@dataclass
class FaultEvent:
    action: str
    at_height: Optional[int] = None
    after_s: Optional[float] = None
    groups: Optional[List[List[int]]] = None  # partition
    node: Optional[int] = None  # crash / restart / byzantine
    src: Optional[int] = None  # set_link
    dst: Optional[int] = None  # set_link
    link: Optional[Dict[str, float]] = None  # set_link LinkState fields
    symmetric: bool = True  # set_link: apply both directions
    duration_s: Optional[float] = None  # stall: loop-block length
    nodes: Optional[List[int]] = None  # crash_wave members, in order
    stagger_s: float = 0.2  # crash_wave: gap between wave members
    restart_after_s: Optional[float] = 1.0  # crash_wave: None = stay down
    blocksync: bool = False  # crash_wave restart: adaptive-sync catchup
    via: Optional[List[int]] = None  # statesync_join: RPC source nodes
    power: Optional[int] = None  # valset_churn: explicit new power
    power_min: int = 5  # valset_churn: seeded draw range
    power_max: int = 15
    garbage: Optional[int] = None  # wal_torn_tail: torn bytes (seeded)
    count: Optional[int] = None  # conn_kill: conns to kill (None=all)
    cycles: int = 2  # reconnect_storm: partition/heal repetitions
    hold_s: float = 1.2  # reconnect_storm: partition hold per cycle
    gap_s: float = 0.8  # reconnect_storm: healed gap between cycles
    inject_quadratic: bool = False  # scaling_probe: plant an O(n^2) site
    abort_after: Optional[int] = None  # crash_mid_prune: batches before
    # the abort (None = seeded draw from the MASTER rng)
    storm_s: float = 1.5  # verify_storm: storm duration
    live_budget_ms: float = 2500.0  # verify_storm: live-class p95 gate
    # (the crypto.sched.dispatch budget, tools/span_budgets.toml)
    replica: Optional[int] = None  # replica_kill: fleet replica index
    # (None = seeded draw from the MASTER rng)

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(f"unknown fault action {self.action!r}")
        if (self.at_height is None) == (self.after_s is None):
            raise ValueError(
                f"{self.action}: exactly one of at_height/after_s required"
            )
        if self.action == "partition" and not self.groups:
            raise ValueError("partition: groups required")
        if self.action in (
            "crash", "restart", "byzantine", "valset_churn",
            "wal_torn_tail", "conn_kill", "reconnect_storm",
            "crash_mid_prune", "snapshot_during_prune",
        ) and self.node is None:
            raise ValueError(f"{self.action}: node required")
        if self.action == "reconnect_storm" and self.cycles < 1:
            raise ValueError("reconnect_storm: cycles >= 1 required")
        if self.action == "set_link" and (
            self.src is None or self.dst is None or not self.link
        ):
            raise ValueError("set_link: src, dst and link required")
        if self.action == "stall" and not (
            self.duration_s and self.duration_s > 0
        ):
            raise ValueError("stall: duration_s > 0 required")
        if self.action == "crash_wave" and not self.nodes:
            raise ValueError("crash_wave: nodes required")
        if self.action == "valset_churn" and not (
            0 < self.power_min <= self.power_max
        ):
            raise ValueError("valset_churn: 0 < power_min <= power_max")


@dataclass
class FaultSchedule:
    events: List[FaultEvent] = field(default_factory=list)

    def to_json(self) -> str:
        """Minimal lossless form: fields still at their dataclass
        default are dropped (from_json restores the same defaults),
        so an event's JSON carries exactly what was set — generated
        matrices stay readable. An EXPLICIT None over a non-None
        default (crash_wave restart_after_s=None = "stay down") is
        kept as JSON null: dropping it would replay with the default
        and silently change semantics."""
        defaults = {
            f.name: f.default for f in dataclasses.fields(FaultEvent)
        }
        return json.dumps(
            [
                {
                    k: v
                    for k, v in asdict(e).items()
                    if k == "action" or v != defaults.get(k)
                }
                for e in self.events
            ],
            indent=2,
        )

    @classmethod
    def from_json(cls, raw: str) -> "FaultSchedule":
        return cls([FaultEvent(**d) for d in json.loads(raw)])


def default_schedule(byzantine_node: Optional[int] = None) -> FaultSchedule:
    """The canonical 4-node smoke schedule: majority partition at h2,
    heal at h4, crash node 1 at h5, restart it shortly after. With
    ``byzantine_node`` set, a commit corruption is injected after the
    heal — a run the agreement checker MUST flag."""
    events = [
        FaultEvent("partition", at_height=2, groups=[[0, 1, 2], [3]]),
        FaultEvent("heal", at_height=4),
    ]
    if byzantine_node is not None:
        events.append(FaultEvent("byzantine", at_height=4, node=byzantine_node))
    events += [
        FaultEvent("crash", at_height=5, node=1),
        FaultEvent("restart", after_s=0.5, node=1),
    ]
    return FaultSchedule(events)
