"""ChaosNet: an N-node in-process network under a seeded fault plane.

Builds full Nodes (node/node.py) over MemoryTransport with a LinkTable
installed as the transport's link hook, runs a declarative fault
schedule through the Nemesis, and checks the BFT invariants
(chaos/invariants.py) continuously and at end-of-run. Nodes get real
home directories (sqlite stores + consensus WAL) so in-process
crash/restart recovers through the same WAL-replay + ABCI
handshake-replay path a real power cut exercises.

Entry point: ``run_schedule`` (awaitable) -> ChaosReport. On any
violation the report carries the seed, the executed fault trace and
the per-link decision counts — everything needed to replay the run.

A copy of the JAX package's ``chaos/net.py``. The net runs on one
device: ``ChaosNet`` and ``run_schedule`` take ``device`` (None is the
GPU, and raises without one) and give it to every ``Node`` (so every
vote wave, blocksync window and statesync light-provider ticket) and
to the light storm's clients and plane. The validators' keys come from
``make_genesis(n, seed=seed)``, signed through ``FilePV``s under the
net's base directory, so the committee is a function of the seed.
"""

from __future__ import annotations

import asyncio
import os
import tempfile
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..config.config import test_config
from ..device import resolve
from ..node.inprocess import make_genesis, make_privvals
from ..node.node import Node
from ..p2p import MemoryTransport, NodeInfo, NodeKey
from ..store.block_store import _hkey
from ..trace import global_tracer, write_chrome, write_jsonl
from ..types.block import BlockID
from ..trace import rebase as timeline_rebase
from ..utils.log import get_logger
from ..utils.tasks import spawn
from .invariants import (
    AgreementChecker,
    InvariantViolation,
    WALReplayChecker,
    liveness_violation,
)
from .links import LinkTable
from .nemesis import Nemesis
from .schedule import FaultSchedule

_log = get_logger("chaos")

POLL_S = 0.05


@dataclass
class ChaosNode:
    idx: int
    name: str
    node_key: NodeKey
    privval: object
    home: str
    node: Optional[Node] = None  # None while crashed
    # one tracer per incarnation (restarts build a fresh ring); kept
    # here so a crashed node's timeline survives for the dump
    tracers: List[object] = field(default_factory=list)
    # likewise one loop watchdog per incarnation: its flight records
    # (loop-stall snapshots) outlive the crash for the report
    watchdogs: List[object] = field(default_factory=list)
    # bounded-shutdown breaches (obs/shutdown.py flight records)
    # across every incarnation's stop/kill
    shutdown_stalls: List[dict] = field(default_factory=list)
    # per-node Config mutations applied on the NEXT build (restart
    # variants: adaptive-sync catchup re-enables blocksync)
    build_overrides: Dict[str, object] = field(default_factory=dict)

    @property
    def node_id(self) -> str:
        return self.node_key.node_id

    @property
    def running(self) -> bool:
        return self.node is not None


@dataclass
class ChaosReport:
    seed: int
    schedule_json: str
    trace: List[dict] = field(default_factory=list)
    violations: List[str] = field(default_factory=list)
    final_heights: Dict[str, int] = field(default_factory=dict)
    link_decisions: Dict[str, Dict[str, int]] = field(default_factory=dict)
    wal_checks: int = 0
    trace_files: List[str] = field(default_factory=list)
    # runtime health plane (obs/, docs/OBS.md)
    stall_records: List[dict] = field(default_factory=list)
    budget_verdicts: List[dict] = field(default_factory=list)
    profile_file: str = ""
    # scenario-factory planes (docs/CHAOS.md "Scenario factory")
    workload: Dict[str, object] = field(default_factory=dict)
    shutdown_stalls: List[dict] = field(default_factory=list)
    # structural fingerprint: proposer address (hex, short) per
    # committed height on the most advanced node — the same-seed
    # determinism surface (heights/proposers reproduce; wall-clock
    # latencies do not). ``rounds`` records each height's commit
    # round: proposer rotation is a pure function of (valset, height,
    # round HISTORY), and round counts are the one wall-clock-coupled
    # input (a round times out when its proposer is mid-crash/restart
    # on a contended box) — so same-seed comparisons assert proposers
    # over the prefix where the round histories still agree.
    proposers: Dict[int, str] = field(default_factory=dict)
    rounds: Dict[int, int] = field(default_factory=dict)
    # self-healing connectivity plane (docs/CHAOS.md): dials that
    # failed into the reconnect plane + injected conn kills
    dial_failures: int = 0
    conns_killed: int = 0
    # light-client serving storm against a live node (--light-storm
    # N): session/latency/cache stats, or empty when
    # the leg did not run
    light_storm: Dict[str, object] = field(default_factory=dict)
    # websocket subscriber storm against a live node's fan-out plane
    # (--subscriber-storm N): delivery/encode/shed stats
    subscriber_storm: Dict[str, object] = field(default_factory=dict)
    # serving-fleet leg (run_schedule(fleet=N) or a
    # scheduled replica_kill): per-replica status, failover/shed
    # counters and the lag-shed isolation probe verdict
    fleet: Dict[str, object] = field(default_factory=dict)
    # runtime concurrency sanitizer (analysis/runtime.py): every
    # finding the per-process sanitizer recorded during the run.
    # Un-injected findings also land in ``violations`` (the matrix
    # hunts races for free); findings from a scheduled
    # lock_inversion are EXPECTED and stay here only.
    sanitizer_findings: List[dict] = field(default_factory=list)
    # committee-scaling probe (analysis/scaling.py): every site the
    # scheduled scaling_probe fault measured, with fitted exponent
    # vs budget. Un-injected breaches also land in ``violations``;
    # a planted (``chaos.``-prefixed) quadratic site breaching is
    # EXPECTED and stays here only.
    scaling_results: List[dict] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.violations

    @property
    def budget_ok(self) -> bool:
        """Span budgets hold (vacuously true when not evaluated).
        Separate from ``ok``: a budget breach is a perf regression
        gate, not a BFT invariant violation."""
        return all(v["ok"] for v in self.budget_verdicts)

    def format(self) -> str:
        lines = [
            f"chaos run seed={self.seed}: "
            + ("OK" if self.ok else "INVARIANT VIOLATIONS"),
            f"final heights: {self.final_heights}",
            f"wal replay checks: {self.wal_checks}",
            "fault trace:",
        ]
        for t in self.trace:
            lines.append(f"  {t}")
        if self.link_decisions:
            lines.append("link decisions (P=partition-drop L=loss "
                         "2=dup R=reorder .=pass):")
            for link, counts in self.link_decisions.items():
                lines.append(f"  {link}: {counts}")
        for v in self.violations:
            lines.append(f"VIOLATION: {v}")
        for f in self.sanitizer_findings:
            lines.append(
                f"sanitizer[{f.get('kind')}]: {f.get('message')}"
            )
        for r in self.scaling_results:
            lines.append(
                f"scaling[{r.get('site')}]: exponent "
                f"{r.get('exponent')} vs budget {r.get('budget')} "
                + ("OK" if r.get("ok") else "OVER")
                + (" (injected)" if r.get("injected") else "")
            )
        if self.workload:
            lines.append(f"workload: {self.workload}")
        if self.light_storm:
            ls = self.light_storm
            lines.append(
                f"light serving storm: {ls.get('sessions')} sessions "
                f"against {ls.get('target_node')} (top height "
                f"{ls.get('top_height')}), request p50 "
                f"{ls.get('p50_ms')}ms p99 {ls.get('p99_ms')}ms, "
                f"cache {ls.get('plane', {}).get('cache', {})}"
            )
        if self.subscriber_storm:
            ss = self.subscriber_storm
            lines.append(
                f"subscriber storm: {ss.get('subscribers')} websocket "
                f"subscribers on {ss.get('target_node')} — "
                f"{ss.get('delivered')} frames from "
                f"{ss.get('encodes')} serializations, "
                f"{ss.get('dropped')} shed, parity "
                + ("OK" if ss.get("parity_ok") else "BROKEN")
            )
        if self.fleet:
            fl = self.fleet
            lp = fl.get("lag_probe") or {}
            lines.append(
                f"serving fleet: {len(fl.get('replicas', []))} "
                f"replicas, {fl.get('sessions')} sessions, "
                f"killed {fl.get('killed')}, "
                f"{fl.get('failovers')} failovers / "
                f"{fl.get('sessions_resumed')} resumed, sheds "
                f"{fl.get('sheds')}, "
                f"{fl.get('delivered_frames')} frames"
                + (
                    f"; lag probe on {lp.get('victim')}: degraded="
                    f"{lp.get('degraded')} recovered="
                    f"{lp.get('recovered')}"
                    if lp
                    else ""
                )
            )
        if self.dial_failures or self.conns_killed:
            lines.append(
                "connectivity plane: "
                f"{self.dial_failures} failed dials handed to "
                f"reconnect, {self.conns_killed} conns killed by "
                "injection"
            )
        if self.shutdown_stalls:
            lines.append(
                "bounded-shutdown breaches flight-recorded: "
                f"{len(self.shutdown_stalls)}"
            )
            for r in self.shutdown_stalls[:8]:
                lines.append(
                    f"  {r.get('node')}: stage {r.get('stage')} "
                    f"exceeded {r.get('waited_s')}s"
                )
        if self.stall_records:
            lines.append(
                f"loop stalls flight-recorded: {len(self.stall_records)}"
            )
            for r in self.stall_records[:8]:
                top = " <- ".join(r.get("loop_stack", [])[:3])
                lines.append(
                    f"  {r.get('node')}: {r.get('stalled_s')}s at {top}"
                )
        if self.budget_verdicts:
            from ..obs.budget import format_verdicts

            lines.append("span budgets (docs/OBS.md):")
            lines.extend(
                "  " + ln
                for ln in format_verdicts(self.budget_verdicts).splitlines()
            )
        if self.profile_file:
            lines.append(f"sampling profile: {self.profile_file}")
        if self.trace_files:
            lines.append("node trace rings (docs/TRACE.md):")
            for p in self.trace_files:
                lines.append(f"  {p}")
            lines.append(
                "  summarize: python -m cometbft_tpu_torch.trace summarize "
                + os.path.dirname(self.trace_files[0])
            )
        if not self.ok:
            lines.append(
                "replay: python -m cometbft_tpu_torch.chaos --seed "
                f"{self.seed} --schedule <saved schedule json>"
            )
        return "\n".join(lines)


class ChaosNet:
    def __init__(
        self,
        n_nodes: int,
        seed: int,
        base_dir: str,
        table: Optional[LinkTable] = None,
        config_hook=None,
        enable_rpc: bool = False,
        device=None,
    ):
        self.seed = seed
        self.device = resolve(device)
        self.base_dir = base_dir
        # optional Config mutator applied to every node build — chaos
        # runs can pin feature knobs (e.g. mempool.async_recheck)
        # without forking the harness
        self.config_hook = config_hook
        # statesync_join needs real RPC listeners (the light-client
        # state provider bootstraps over HTTP); everything else keeps
        # them off — invariants read stores directly
        self.enable_rpc = enable_rpc
        self.table = table or LinkTable(seed)
        self.genesis, privs = make_genesis(
            n_nodes, chain_id=f"chaos-{seed}", seed=seed
        )
        os.makedirs(base_dir, exist_ok=True)
        pvs = make_privvals(privs, root=base_dir)
        self.nodes: List[ChaosNode] = []
        for i, pv in enumerate(pvs):
            home = os.path.join(base_dir, f"n{i}")
            os.makedirs(home, exist_ok=True)
            self.nodes.append(
                ChaosNode(i, f"n{i}", NodeKey.generate(), pv, home)
            )
        self.agreement = AgreementChecker()
        self.wal_checker = WALReplayChecker()
        self._snapshots: Dict[int, Dict[int, bytes]] = {}
        self._byz_tasks: List[asyncio.Future] = []
        self.stop_guard = None
        # self-healing plane telemetry: failed dials routed to the
        # reconnect plane + conns killed by pong-timeout injection
        self.dial_failures = 0
        self.conns_killed = 0
        # serving-fleet harness (FleetHarness) attached by
        # run_schedule(fleet=N); replica_kill dispatches through it
        self.fleet_harness: Optional["FleetHarness"] = None

    # --- node lifecycle -----------------------------------------------

    def _build(self, cn: ChaosNode) -> Node:
        cfg = test_config(cn.home)
        cfg.base.moniker = cn.name
        cfg.base.db_backend = "sqlite"  # restart needs persistence
        # invariants read stores directly; the port's test_config has
        # no RPC listener, the JAX one a free port
        cfg.rpc.laddr = "tcp://127.0.0.1:0" if self.enable_rpc else ""
        cfg.blocksync.enable = False
        cfg.p2p.pex = False
        # determinism pin: the WAL group-commit router keys on
        # MEASURED fsync walls (load-dependent), but a chaos run's
        # structure must be a pure function of its seed — the seam
        # stays off here unless the run opts in (matrix --fastpath's
        # config_hook re-enables it, under the fixed fsync model)
        cfg.consensus.wal_group_commit_ms = 0.0
        if self.config_hook is not None:
            self.config_hook(cfg)
        for dotted, value in cn.build_overrides.items():
            section, field_ = dotted.split(".", 1)
            setattr(getattr(cfg, section), field_, value)
        info = NodeInfo(
            node_id=cn.node_id,
            network=self.genesis.chain_id,
            moniker=cn.name,
        )
        transport = MemoryTransport(
            cn.node_key, info, link_hook=self.table
        )
        return Node(
            cfg,
            self.genesis,
            privval=cn.privval,
            node_key=cn.node_key,
            transport=transport,
            home=cn.home,
            device=self.device,
        )

    @staticmethod
    def _track(cn: ChaosNode) -> None:
        """Keep diagnostics handles that must survive a crash."""
        cn.tracers.append(cn.node.parts.tracer)
        if cn.node.loop_watchdog is not None:
            cn.watchdogs.append(cn.node.loop_watchdog)

    async def start(self) -> None:
        for cn in self.nodes:
            cn.node = self._build(cn)
            self._track(cn)
            await cn.node.start()
        for i, a in enumerate(self.nodes):
            for b in self.nodes[i + 1 :]:
                await self._dial(a, b)
        # wait for the full mesh
        for cn in self.nodes:
            for _ in range(200):
                if cn.node.switch.num_peers() >= len(self.nodes) - 1:
                    break
                await asyncio.sleep(POLL_S)

    async def _dial(self, a: ChaosNode, b: ChaosNode) -> None:
        try:
            await a.node.dial(
                f"{b.node_id}@mem://{b.node_id}", persistent=True
            )
        except asyncio.CancelledError:
            raise
        except Exception as e:
            # partitioned/crashed target: the failed PERSISTENT dial
            # was handed to the self-healing reconnect plane inside
            # dial_peer (p2p/reconnect.py note_dial_failure) — verify
            # that handoff instead of trusting a comment, and count
            # the failure for the report. schedule() legitimately
            # no-ops when the peer is ALREADY connected (an inbound
            # conn raced this failing dial) or banned — only the
            # none-of-the-above case is a dropped retry.
            self.dial_failures += 1
            sw = a.node.switch
            if not (
                sw.reconnect.is_scheduled(b.node_id)
                or b.node_id in sw.peers
                or b.node_id in sw.banned
            ):
                raise AssertionError(
                    f"failed persistent dial {a.name}->{b.name} was "
                    "NOT scheduled on the reconnect plane"
                ) from e
            _log.debug(
                "chaos: dial failed, reconnect plane owns the retry",
                src=a.name, dst=b.name, err=repr(e),
            )

    async def crash(self, idx: int) -> None:
        cn = self.nodes[idx]
        if cn.node is None:
            return
        self._snapshots[idx] = self.wal_checker.pre_crash(cn.node)
        _log.info("chaos: crashing node", node=cn.name, height=cn.node.height)
        try:
            # bounded (ASY110): kill() is internally stage-budgeted
            # (obs/shutdown.py) — this outer bound covers the case
            # where the loop never even schedules those stages
            await asyncio.wait_for(
                cn.node.kill(),
                cn.node.config.instrumentation.shutdown_stage_budget_s
                * 9,
            )
        except asyncio.TimeoutError:
            _log.error("chaos: node kill wedged, abandoning",
                       node=cn.name)
        inner = getattr(cn.node, "shutdown_guard", None)
        if inner is not None:
            cn.shutdown_stalls.extend(inner.stalls)
        cn.node = None

    async def restart(self, idx: int) -> None:
        cn = self.nodes[idx]
        if cn.node is not None:
            return
        cn.node = self._build(cn)
        self._track(cn)
        await cn.node.start()
        # WAL-replay consistency right after recovery, before the node
        # re-joins gossip
        self.wal_checker.post_restart(
            cn.name, cn.node, self._snapshots.get(idx, {})
        )
        _log.info(
            "chaos: restarted node", node=cn.name, height=cn.node.height
        )
        for other in self.nodes:
            if other.idx != idx and other.running:
                await self._dial(cn, other)

    async def statesync_join(
        self,
        via: Optional[List[int]] = None,
        timeout_s: float = 90.0,
    ) -> str:
        """A FRESH non-validator node joins the running net through
        the full statesync path: p2p snapshot discovery, light-client
        verified restore against two running nodes' RPC, blocksync
        tail-follow. Requires ``enable_rpc=True`` at net build.

        Blocks (bounded) until the joiner's store holds its first
        blocksynced block — i.e. the snapshot restore + handoff
        really landed; the tail-follow continues in the background
        and the end-of-run liveness check holds the joiner to the
        same bar as everyone else. Raises InvariantViolation when the
        join fails or times out: a node that cannot join a healthy
        net IS a robustness failure."""
        if via:
            sources = [
                self.nodes[i] for i in via if self.nodes[i].running
            ]
        else:
            sources = [cn for cn in self.nodes if cn.running]
        sources = [
            cn for cn in sources
            if cn.node is not None and cn.node.rpc_server is not None
        ]
        if not sources:
            raise InvariantViolation(
                "statesync-join",
                "no running RPC sources (build ChaosNet with "
                "enable_rpc=True and keep a source alive)",
            )
        # trust root anchored at the source's BASE, not block 1: a
        # retention-pruned source (store/retention.py) no longer
        # holds the early heights, and a joiner bootstrapping from it
        # must trust from a height the source can actually serve
        src_store = sources[0].node.parts.block_store
        trust_h = max(1, src_store.base())
        trust = src_store.load_block(trust_h)
        if trust is None:
            raise InvariantViolation(
                "statesync-join",
                f"source has no block {trust_h} for the trust root",
            )
        idx = len(self.nodes)
        name = f"j{idx}"
        home = os.path.join(self.base_dir, name)
        os.makedirs(home, exist_ok=True)
        cn = ChaosNode(idx, name, NodeKey.generate(), None, home)
        cn.build_overrides = {
            "statesync.enable": True,
            "statesync.rpc_servers": [
                s.node.rpc_server.listen_addr for s in sources[:2]
            ],
            "statesync.trust_height": trust_h,
            "statesync.trust_hash": bytes(trust.hash()).hex(),
            # discovery exits as soon as ONE snapshot lands, so this
            # only bounds the FAILURE case — and on a contended box
            # the joiner's 4 secret-connection handshakes alone can
            # eat >10s before any peer can even answer, so a short
            # window misreads load as "no viable snapshots"
            "statesync.discovery_time_s": 45.0,
            "blocksync.enable": True,
        }
        self.nodes.append(cn)
        cn.node = self._build(cn)
        self._track(cn)
        await cn.node.start()
        for other in self.nodes:
            if other.idx != idx and other.running:
                await self._dial(cn, other)
        _log.info("chaos: statesync join started", node=name)
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout_s
        while True:
            node = cn.node
            if node is None or node.statesync_error is not None:
                err = (
                    repr(node.statesync_error) if node else "stopped"
                )
                cn.node = None  # a dead joiner must drop out of the
                # running set or end-of-run store scans hit closed fds
                raise InvariantViolation(
                    "statesync-join", f"{name} failed to join: {err}"
                )
            if node.height >= 1:
                # snapshot restored + first tail block stored; the
                # follow continues in the background
                _log.info(
                    "chaos: statesync join bootstrapped",
                    node=name,
                    height=node.height,
                    base=node.parts.block_store.base(),
                )
                return name
            if loop.time() > deadline:
                try:
                    # bounded like crash(): a wedged joiner kill must
                    # not hang the run that is reporting its failure
                    await asyncio.wait_for(
                        node.kill(),
                        node.config.instrumentation
                        .shutdown_stage_budget_s * 9,
                    )
                except asyncio.TimeoutError:
                    _log.error(
                        "chaos: joiner kill wedged, abandoning",
                        node=name,
                    )
                cn.node = None
                raise InvariantViolation(
                    "statesync-join",
                    f"{name} did not bootstrap within {timeout_s:.0f}s",
                )
            await asyncio.sleep(POLL_S)

    async def wal_torn_tail(self, idx: int, garbage: bytes) -> dict:
        """Power-cut the node (if running), append a torn tail — the
        partial record a real power cut leaves — to its consensus WAL
        head, then restart. The restart path must repair the tail
        (consensus/wal.py truncate_corrupt_tail on open) and the
        WAL-replay checker holds it to the no-amnesia bar; without
        the repair, records APPENDED after the garbage would be
        unreadable on the following restart."""
        cn = self.nodes[idx]
        was_running = cn.node is not None
        if was_running:
            await self.crash(idx)
        wal_path = os.path.join(cn.home, "cs.wal")
        appended = 0
        if os.path.exists(wal_path):
            with open(wal_path, "ab") as f:
                f.write(garbage)
            appended = len(garbage)
            _log.info(
                "chaos: tore WAL tail", node=cn.name, bytes=appended
            )
        await self.restart(idx)
        return {
            "node": cn.name,
            "torn_bytes": appended,
            "was_running": was_running,
        }

    async def crash_mid_prune(self, idx: int, abort_after: int) -> dict:
        """Abort a retention reconcile pass after ``abort_after``
        bounded batches (the in-process stand-in for the
        ``retention-prune-batch`` fail_point power cut), then crash +
        restart the node and run ONE resume pass. The crash-safety
        contract under test (store/retention.py): every committed
        batch carried its own base-marker advance, so the partial
        pass is a consistent (just less-pruned) store, the WAL-replay
        checker holds the restart to the no-amnesia bar, and the
        resume pass idempotently re-computes the same targets and
        finishes the job — no gap, no double-delete, no wedge."""
        cn = self.nodes[idx]
        if cn.node is None:
            raise InvariantViolation(
                "crash-mid-prune", f"{cn.name} is not running"
            )
        ret = cn.node.parts.retention
        if ret is None or not ret.enabled:
            raise InvariantViolation(
                "crash-mid-prune",
                f"{cn.name} has no retention plane (schedule a "
                "lifecycle run: [storage] knobs are auto-set when "
                "this action is present)",
            )

        class _PruneAborted(RuntimeError):
            pass

        calls = 0

        def hook():
            nonlocal calls
            calls += 1
            if calls > abort_after:
                raise _PruneAborted()

        ret.batch_hook = hook
        aborted = False
        try:
            try:
                await asyncio.to_thread(ret.reconcile_once)
            except _PruneAborted:
                aborted = True
        finally:
            ret.batch_hook = None
        bs = cn.node.parts.block_store
        mid_base = bs.base()
        mid_height = bs.height()
        await self.crash(idx)
        await self.restart(idx)
        node = cn.node
        ret2 = node.parts.retention
        resumed = await asyncio.to_thread(ret2.reconcile_once)
        bs2 = node.parts.block_store
        base2 = bs2.base()
        if base2 < mid_base:
            raise InvariantViolation(
                "crash-mid-prune",
                f"{cn.name} base regressed across crash/resume: "
                f"{base2} < {mid_base}",
            )
        # the retained range must be fully readable and the pruned
        # range fully gone — a half-applied delete batch would break
        # one side or the other
        probe = max(1, base2)
        if bs2.height() >= probe and bs2.load_block(probe) is None:
            raise InvariantViolation(
                "crash-mid-prune",
                f"{cn.name} block {probe} (the base) unreadable "
                "after resume",
            )
        if base2 > 1 and bs2.load_block(base2 - 1) is not None:
            raise InvariantViolation(
                "crash-mid-prune",
                f"{cn.name} block {base2 - 1} still present below "
                f"base {base2} after resume",
            )
        ti = node.parts.tx_indexer
        idx_base = ti.base_height() if ti is not None else 0
        # trace determinism (the conn_kill rule): the record carries
        # the CONFIGURED/seeded parameters only — the bases and prune
        # counts depend on how far the live network committed during
        # the crash/restart window (wall-clock), so they go to the log
        _log.info(
            "crash_mid_prune detail",
            node=cn.name,
            aborted=aborted,
            mid_base=mid_base,
            mid_height=mid_height,
            resumed_base=base2,
            index_base=idx_base,
            resumed=resumed,
        )
        return {"node": cn.name, "abort_after": abort_after}

    async def snapshot_during_prune(self, idx: int) -> dict:
        """Park a retention reconcile pass mid-batch, then serve the
        node's newest on-disk snapshot chunk-by-chunk — under the
        in-flight-serve pin — while the prune pass is live, and
        verify the reassembled blob hashes to the advertised hash.
        The floor contract under test (store/retention.py): a joiner
        mid-download must never see a snapshot rot out from under it,
        prune pass or not."""
        import hashlib as _hashlib
        import threading as _threading

        cn = self.nodes[idx]
        if cn.node is None:
            raise InvariantViolation(
                "snapshot-during-prune", f"{cn.name} is not running"
            )
        node = cn.node
        ret = node.parts.retention
        snaps_store = node.parts.snapshot_store
        if (
            ret is None
            or not ret.enabled
            or snaps_store is None
        ):
            raise InvariantViolation(
                "snapshot-during-prune",
                f"{cn.name} has no retention plane + snapshot store",
            )
        # one plain pass first so a snapshot is guaranteed held
        # (mirrors the app's newest advertised snapshot to disk)
        await asyncio.to_thread(ret.reconcile_once)
        snaps = snaps_store.list_snapshots()
        if not snaps:
            raise InvariantViolation(
                "snapshot-during-prune",
                f"{cn.name} holds no snapshot (trigger this action "
                "at a height past the app's snapshot cadence)",
            )
        newest = snaps[-1]
        parked = _threading.Event()
        release = _threading.Event()
        first = [True]

        def hook():
            if first[0]:
                first[0] = False
                parked.set()
                release.wait(timeout=10.0)

        ret.batch_hook = hook
        try:
            pass_task = asyncio.ensure_future(
                asyncio.to_thread(ret.reconcile_once)
            )
            # wait (bounded) for the pass to park mid-batch; a pass
            # with nothing left to prune never parks — the serve
            # check below still runs, just not concurrently
            parked_hit = await asyncio.to_thread(parked.wait, 5.0)

            def serve() -> bytes:
                with ret.serving(newest.height):
                    parts = []
                    for i in range(newest.chunks):
                        parts.append(
                            node.parts.proxy.snapshot
                            .load_snapshot_chunk(
                                newest.height, newest.format, i
                            )
                            or b""
                        )
                    return b"".join(parts)

            blob = await asyncio.to_thread(serve)
        finally:
            release.set()
            await pass_task
            ret.batch_hook = None
        if _hashlib.sha256(blob).digest() != newest.hash:
            raise InvariantViolation(
                "snapshot-during-prune",
                f"{cn.name} snapshot {newest.height} served during "
                "an active prune pass did not hash-verify",
            )
        if snaps_store.latest_height() < newest.height:
            raise InvariantViolation(
                "snapshot-during-prune",
                f"{cn.name} snapshot {newest.height} rotated away "
                "while pinned by an in-flight serve",
            )
        # trace determinism: snapshot height/chunk count and whether
        # the pass actually parked depend on the momentary chain
        # height (wall-clock) — log them, record only the verdict
        _log.info(
            "snapshot_during_prune detail",
            node=cn.name,
            snapshot_height=newest.height,
            chunks=newest.chunks,
            concurrent=bool(parked_hit),
        )
        return {"node": cn.name, "verified": True}

    def kill_conns(
        self,
        idx: int,
        count: Optional[int] = None,
        reason: str = "pong timeout (injected)",
    ) -> List[str]:
        """Kill up to ``count`` (None = all) of node ``idx``'s live
        connections via pong-timeout injection — the conn death a
        partition's silent blackhole eventually produces, without
        waiting out ping_interval + pong_timeout. Both ends observe
        the death (the remote reads a closed conn), so both ends'
        reconnect planes engage. Deterministic kill order (sorted
        peer id)."""
        cn = self.nodes[idx]
        if cn.node is None:
            return []
        killed: List[str] = []
        for pid in sorted(cn.node.switch.peers):
            if count is not None and len(killed) >= count:
                break
            peer = cn.node.switch.peers.get(pid)
            if peer is None:
                continue
            peer.inject_error(ConnectionError(reason))
            killed.append(pid)
        self.conns_killed += len(killed)
        _log.info(
            "chaos: injected conn kills",
            node=cn.name, killed=len(killed), reason=reason,
        )
        return killed

    def valset_churn(self, idx: int, power: int) -> dict:
        """Submit a validator power-change tx (kvstore
        ``val:<hex pubkey>!<power>``) for validator ``idx``'s key
        through the first running node's mempool — live valset churn
        without adding absent signers (the target keeps signing with
        the same key at its new power)."""
        target = self.nodes[idx]
        if target.privval is None:
            raise ValueError(f"{target.name} is not a validator")
        pub = target.privval.pub_key()
        tx = (
            b"val:" + pub.key_bytes.hex().encode()
            + b"!" + str(power).encode()
        )
        for cn in self.nodes:
            if cn.running:
                res = cn.node.parts.mempool.check_tx(tx)
                code = getattr(res, "code", 0)
                _log.info(
                    "chaos: valset churn submitted",
                    validator=target.name,
                    power=power,
                    via=cn.name,
                    code=code,
                )
                return {
                    "validator": target.name,
                    "power": power,
                    "via": cn.name,
                    "code": code,
                }
        raise InvariantViolation(
            "valset-churn", "no running node to submit through"
        )

    async def stop(self) -> None:
        """Bounded teardown (obs/shutdown.py): each node's stop runs
        under a budget sized to its staged shutdown; a node that
        wedges anyway is flight-recorded, cancelled, abandoned — and
        its store handles are force-released so the loop exits and a
        later incarnation can still reopen the home dir. This is the
        fix for the full-suite wedge class: an un-timeouted
        ``await net.stop()`` tail could previously hang the suite
        with the loop alive and store fds open."""
        from ..obs import ShutdownGuard

        for t in self._byz_tasks:
            t.cancel()
        guard = ShutdownGuard(
            tracer=global_tracer(), name="chaosnet"
        )
        self.stop_guard = guard
        for cn in self.nodes:
            node, cn.node = cn.node, None
            if node is None:
                continue
            # Node._shutdown is itself staged (~7 stages); this outer
            # budget only trips when the staged path is wedged at a
            # level its own guard cannot see (e.g. the loop never
            # schedules the stage task)
            per_stage = (
                node.config.instrumentation.shutdown_stage_budget_s
            )
            done = await guard.stage(
                f"stop.{cn.name}", node.stop(),
                budget_s=max(10.0, per_stage * 9),
            )
            inner = getattr(node, "shutdown_guard", None)
            if inner is not None:
                cn.shutdown_stalls.extend(inner.stalls)
            if not done:
                # abandoned: free the store fds regardless, bounded
                await guard.stage(
                    f"close_stores.{cn.name}",
                    asyncio.to_thread(node.parts.close_stores),
                    budget_s=5.0,
                )
        for cn in self.nodes:
            cn.shutdown_stalls.extend(
                r for r in guard.stalls
                if str(r.get("stage", "")).endswith("." + cn.name)
            )

    def shutdown_stall_records(self) -> List[dict]:
        """Every bounded-shutdown breach captured across the run
        (per-node inner stage stalls + net-level outer stalls)."""
        out: List[dict] = []
        for cn in self.nodes:
            out.extend(dict(r) for r in cn.shutdown_stalls)
        return out

    # --- byzantine commit corruption ----------------------------------

    def inject_commit_corruption(self, idx: int, tamper: bytes) -> None:
        """Rewrite the designated node's NEXT committed block ID in its
        own store — the observable footprint of a byzantine commit,
        used to prove the agreement checker actually fires."""
        cn = self.nodes[idx]

        async def corrupt():
            target_h = (cn.node.height if cn.node else 0) + 1
            while cn.node is None or cn.node.height < target_h:
                await asyncio.sleep(POLL_S)
            store = cn.node.parts.block_store
            meta = store.load_block_meta(target_h)
            meta.block_id = BlockID(
                tamper, meta.block_id.part_set_header
            )
            store.db.set(_hkey(b"H:", target_h), meta.encode())
            _log.info(
                "chaos: corrupted commit", node=cn.name, height=target_h
            )

        self._byz_tasks.append(spawn(corrupt(), name="chaos-byzantine"))

    # --- introspection -------------------------------------------------

    def fleet_size(self) -> int:
        h = self.fleet_harness
        return h.size() if h is not None else 0

    async def replica_kill(self, idx: int) -> dict:
        """Kill one fleet follower mid-stream (nemesis
        ``replica_kill``); the router's failover is judged by
        FleetHarness.finish()."""
        if self.fleet_harness is None:
            raise RuntimeError(
                "replica_kill requires a fleet: "
                "run_schedule(..., fleet=N)"
            )
        return await self.fleet_harness.replica_kill(idx)

    def running_nodes(self):
        return [
            (cn.name, cn.node) for cn in self.nodes if cn.node is not None
        ]

    def max_height(self) -> int:
        return max(
            (cn.node.height for cn in self.nodes if cn.node is not None),
            default=0,
        )

    def heights(self) -> Dict[str, int]:
        return {
            cn.name: (cn.node.height if cn.node else -1)
            for cn in self.nodes
        }

    def stall_records(self) -> List[dict]:
        """Every flight record captured by any incarnation's loop
        watchdog, time-ordered (obs/watchdog.py)."""
        out: List[dict] = []
        for cn in self.nodes:
            for wd in cn.watchdogs:
                out.extend(dict(r) for r in wd.stalls)
        out.sort(key=lambda r: r.get("ts_ns", 0))
        return out

    @staticmethod
    def _anchored(tr) -> list:
        """Ring snapshot with its monotonic→wall clock anchor
        guaranteed present: a lapped ring drops the ``clock.anchor``
        instant, but the anchor also rides ``Tracer.meta`` (recorded
        at build, node/inprocess.record_clock_anchor), so it is
        re-synthesized here — the cross-node timeline rebase must
        never lose a ring's clock alignment to ring churn."""
        events = tr.snapshot()
        mono = tr.meta.get("anchor_mono_ns")
        if (
            events
            and mono
            and not any(e["name"] == "clock.anchor" for e in events)
        ):
            events.insert(
                0,
                {
                    "seq": -1,
                    "name": "clock.anchor",
                    "ph": "i",
                    "ts_ns": mono,
                    "dur_ns": 0,
                    "tid": "main",
                    "args": {"wall_ns": tr.meta["anchor_wall_ns"]},
                },
            )
        return events

    def ring_snapshots(self) -> Dict[str, list]:
        """{label: events} over every incarnation's ring plus the
        process ring — the in-memory form dump_traces writes out and
        the span-budget evaluation reads."""
        by_node: Dict[str, list] = {}
        for cn in self.nodes:
            for gen, tr in enumerate(cn.tracers):
                events = self._anchored(tr)
                if not events:
                    continue
                label = (
                    cn.name if len(cn.tracers) == 1
                    else f"{cn.name}.{gen}"
                )
                by_node[label] = events
        proc = self._anchored(global_tracer())
        if proc:
            by_node["process"] = proc
        return by_node

    def dump_traces(self, out_dir: str) -> List[str]:
        """Write every node's trace ring (one JSONL per incarnation —
        restarts get a fresh ring, so n1 that crashed and came back
        dumps n1.0 and n1.1) plus the crypto plane's process ring and
        one merged Perfetto-loadable trace.json. Returns the files.

        Per-ring JSONL keeps raw monotonic timestamps (each carries
        its ``clock.anchor``); the MERGED trace.json is rebased via
        those anchors and stable-sorted per ring, so node timelines
        line up in Perfetto instead of landing at arbitrary
        monotonic offsets (docs/TRACE.md "Cross-node timelines")."""
        os.makedirs(out_dir, exist_ok=True)
        files: List[str] = []
        by_node = self.ring_snapshots()
        for label, events in by_node.items():
            files.append(
                write_jsonl(
                    os.path.join(out_dir, f"{label}.trace.jsonl"),
                    label,
                    events,
                )
            )
        if by_node:
            rebased, _offsets, _base = timeline_rebase(by_node)
            files.append(
                write_chrome(
                    os.path.join(out_dir, "trace.json"), rebased
                )
            )
        return files


def _run_light_storm_sync(
    net: "ChaosNet", sessions: int, seed: int, workers: int = 16
) -> dict:
    """Seeded N-session light-client serving storm against the most
    advanced LIVE node: every session opens on
    the shared LightServingPlane, requests a seeded height, and the
    served block's hash is asserted against the node's own store
    (live verdict parity). Spans land on the target node's trace ring
    so `trace timeline --strict` and the span budgets see the storm.

    Runs on a worker thread pool (the plane is the thread-facing
    seam); the caller wraps it in asyncio.to_thread."""
    import concurrent.futures
    import random as _random
    import time as _time

    from ..light import Client, LightServingPlane, TrustOptions
    from ..light.provider import StoreBackedProvider

    running = net.running_nodes()
    if not running:
        raise RuntimeError("no running node to storm")
    name, node = max(running, key=lambda t: t[1].height)
    chain_id = net.genesis.chain_id
    store = node.parts.block_store
    provider = StoreBackedProvider(
        chain_id, store, node.parts.state_store
    )
    root = provider.light_block(1)
    tracer = node.parts.tracer
    pool = [
        Client(
            chain_id,
            TrustOptions(
                period_ns=24 * 3600 * 10**9,
                height=1,
                hash=root.hash(),
            ),
            provider,
            device=net.device,
        )
        for _ in range(4)
    ]
    plane = LightServingPlane(
        pool,
        max_sessions=sessions + workers,
        max_inflight=workers,
        tracer=tracer,
        device=net.device,
    )
    top = max(2, node.height)
    rng = _random.Random(seed ^ 0x11C0)
    heights = [rng.randint(2, top) for _ in range(sessions)]
    lat_ms: List[float] = []
    lat_lock = threading.Lock()

    def one_session(sid: int) -> None:
        h = heights[sid]
        t0 = _time.monotonic()
        with plane.open_session() as s:
            lb = s.verified_block(h)
        dt = (_time.monotonic() - t0) * 1e3
        meta = store.load_block_meta(h)
        if meta is None or bytes(lb.hash()) != bytes(
            meta.block_id.hash
        ):
            raise RuntimeError(
                f"storm session {sid}: served block at {h} does not "
                "match the node's store"
            )
        with lat_lock:
            lat_ms.append(dt)

    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for f in [
            ex.submit(one_session, sid) for sid in range(sessions)
        ]:
            f.result()  # re-raise any session failure
    lat_ms.sort()

    def pct(p: float) -> float:
        return round(lat_ms[int(p * (len(lat_ms) - 1))], 3)

    return {
        "sessions": sessions,
        "workers": workers,
        "target_node": name,
        "top_height": top,
        "p50_ms": pct(0.50),
        "p99_ms": pct(0.99),
        "plane": plane.stats(),
    }


async def _run_subscriber_storm(
    net: "ChaosNet", n: int, seed: int, events_each: int = 2
) -> dict:
    """N real websocket subscribers storm the most advanced LIVE
    node's fan-out plane (rpc/fanout.py) while consensus
    keeps committing: every subscriber must receive ``events_each``
    consecutive NewBlock events whose heights exist in the node's
    store (delivery parity), zero frames may be shed (the stub
    sockets drain at network speed), and the hub must have paid ~one
    serialization per event, not per subscriber."""
    import json as _json

    import aiohttp

    running = [
        (name, node)
        for name, node in net.running_nodes()
        if getattr(node, "rpc_server", None) is not None
    ]
    if not running:
        raise RuntimeError("no running RPC node to storm")
    name, node = max(running, key=lambda t: t[1].height)
    hub = node.rpc_server.fanout
    encodes0, delivered0 = hub.encodes, hub.delivered
    dropped0 = hub.queue_stats()["dropped"]
    base = "http://" + node.rpc_server.listen_addr
    q = "tm.event='NewBlock'"
    t0 = asyncio.get_running_loop().time()
    # default connector caps 100 conns/host — websocket conns never
    # free their slot, so subscriber 101 would deadlock the storm
    connector = aiohttp.TCPConnector(limit=0)
    async with aiohttp.ClientSession(connector=connector) as sess:
        wss = []
        try:
            for i in range(n):
                ws = await sess.ws_connect(base + "/websocket")
                await ws.send_json(
                    {
                        "jsonrpc": "2.0",
                        "id": i,
                        "method": "subscribe",
                        "params": {"query": q},
                    }
                )
                wss.append(ws)

            async def collect(ws) -> list:
                heights = []
                while len(heights) < events_each:
                    msg = await asyncio.wait_for(ws.receive(), 90.0)
                    if msg.type != aiohttp.WSMsgType.TEXT:
                        raise RuntimeError(
                            f"storm socket closed early: {msg.type}"
                        )
                    body = _json.loads(msg.data)
                    if body.get("error"):
                        raise RuntimeError(
                            f"storm subscribe error: {body['error']}"
                        )
                    res = body.get("result") or {}
                    if res.get("query") == q:
                        heights.append(
                            int(
                                res["data"]["value"]["block"]["header"][
                                    "height"
                                ]
                            )
                        )
                return heights

            results = await asyncio.wait_for(
                asyncio.gather(*[collect(ws) for ws in wss]), 180.0
            )
        finally:
            for ws in wss:
                try:
                    await asyncio.wait_for(ws.close(), 5.0)
                except asyncio.CancelledError:
                    raise
                except Exception:
                    pass  # a dead socket is already closed
    wall_s = asyncio.get_running_loop().time() - t0
    parity_ok = True
    store = node.parts.block_store
    for hs in results:
        # consecutive heights, every one a block this node committed
        if [h - hs[0] for h in hs] != list(range(len(hs))):
            parity_ok = False
        for h in hs:
            if store.load_block_meta(h) is None:
                raise RuntimeError(
                    f"storm delivered height {h} missing from the "
                    f"store of {name}"
                )
    stats = hub.queue_stats()
    dropped = stats["dropped"] - dropped0
    encodes = hub.encodes - encodes0
    delivered = hub.delivered - delivered0
    if dropped:
        raise RuntimeError(
            f"subscriber storm shed {dropped} frames — the fan-out "
            "plane must deliver a draining subscriber everything"
        )
    if not parity_ok:
        raise RuntimeError(
            "subscriber storm: non-consecutive event stream delivered"
        )
    # one-pass check: ~one serialization per DISTINCT event for the
    # single query group. Bound on events, not delivered//subscriber:
    # a block committed during the sequential attach phase costs a
    # full encode while only a few subscribers are attached, which a
    # frames-per-subscriber bound misreads as per-subscriber
    # encoding. Late joiners may also split one event across group
    # membership snapshots — so bound (2x + slack), don't pin.
    distinct_events = len({h for hs in results for h in hs})
    if delivered and encodes > 4 + 2 * distinct_events:
        raise RuntimeError(
            f"fan-out paid {encodes} serializations for {delivered} "
            "frames — per-subscriber encoding crept back"
        )
    return {
        "subscribers": n,
        "events_each": events_each,
        "target_node": name,
        "encodes": encodes,
        "delivered": delivered,
        "dropped": dropped,
        "parity_ok": parity_ok,
        "wall_s": round(wall_s, 3),
    }


class _FleetSink:
    """In-process frame sink for one routed fleet session: records
    every delivered frame's height so zero-lost-commits is checkable
    as stream contiguity."""

    __slots__ = ("heights", "frames")

    def __init__(self):
        self.heights: List[int] = []
        self.frames = 0

    async def send_str(self, frame: str) -> None:
        from ..fleet.router import _HEIGHT_RE

        self.frames += 1
        m = _HEIGHT_RE.search(frame)
        if m:
            self.heights.append(int(m.group(1)))


class FleetHarness:
    """In-process serving fleet riding a chaos net (docs/FLEET.md,
    docs/CHAOS.md ``replica_kill``): N FollowerNode replicas tail a
    StreamSource pumped from the committee's most advanced store, a
    SessionRouter fronts them, and a pool of routed subscriber
    sessions streams NewBlock commits for the whole schedule — so a
    mid-schedule ``replica_kill`` strands real sessions and the
    router's failover contract (zero lost commits) is judged on their
    recorded streams. ``finish()`` also runs the lag-shed isolation
    probe: stall one survivor past max_lag_heights and assert only
    ITS clients shed, then recover it."""

    MAX_LAG = 6

    def __init__(self, net: "ChaosNet", n_replicas: int, seed: int,
                 n_sessions: int = 24):
        from ..fleet import FollowerNode, SessionRouter, StreamSource

        self.net = net
        self.source = StreamSource()
        self.replicas = [
            FollowerNode(
                f"fleet-r{i}", self.source, tracer=global_tracer()
            )
            for i in range(n_replicas)
        ]
        self.router = SessionRouter(
            self.replicas,
            store_source=self.source,
            max_lag_heights=self.MAX_LAG,
            lag_poll_s=0.05,
            tracer=global_tracer(),
        )
        self.n_sessions = n_sessions
        self.sinks: List[_FleetSink] = []
        self.sessions: List = []
        self.killed: List[str] = []
        self.violations: List[str] = []
        self._pump_task: Optional[asyncio.Future] = None
        self._fed = 0

    async def start(self) -> None:
        self._pump_task = spawn(self._pump(), name="fleet-pump")
        for r in self.replicas:
            await r.start(from_height=self.source.height())
        await self.router.start()
        for _ in range(self.n_sessions):
            sink = _FleetSink()
            sess = await self.router.subscribe(
                sink, "tm.event='NewBlock'"
            )
            self.sinks.append(sink)
            self.sessions.append(sess)

    async def _pump(self) -> None:
        """Feed the fleet source from the committee: the in-process
        stand-in for blocksync tail-follow (same blocks, same order)."""
        while True:
            try:
                running = self.net.running_nodes()
                if running:
                    _, top = max(running, key=lambda t: t[1].height)
                    store = top.parts.block_store
                    if self._fed < store.base() - 1:
                        self._fed = store.base() - 1
                    while self._fed < store.height():
                        b = store.load_block(self._fed + 1)
                        if b is None:
                            break
                        self.source.advance(b)
                        self._fed += 1
            except asyncio.CancelledError:
                raise
            except Exception:
                # a crash closed the store under the reader; the next
                # pass re-reads from a survivor
                pass
            await asyncio.sleep(POLL_S)

    def size(self) -> int:
        return len(self.replicas)

    async def replica_kill(self, idx: int) -> dict:
        r = self.replicas[idx % len(self.replicas)]
        stranded = sum(
            1
            for rep in self.router._sessions.values()
            if rep is r
        )
        await r.kill()
        self.killed.append(r.name)
        return {"replica": r.name, "stranded_sessions": stranded}

    async def _wait(self, pred, timeout_s: float) -> bool:
        deadline = asyncio.get_running_loop().time() + timeout_s
        while not pred():
            if asyncio.get_running_loop().time() >= deadline:
                return False
            await asyncio.sleep(POLL_S)
        return True

    async def finish(self) -> dict:
        """Judge the fleet contract and return the report section."""
        v = self.violations
        # failover must have re-homed every stranded session off the
        # dead replicas (or shed it honestly — counted)
        dead = [r for r in self.replicas if not r.alive]
        ok = await self._wait(
            lambda: not any(
                rep in dead for rep in self.router._sessions.values()
            ),
            10.0,
        )
        if not ok:
            v.append(
                "fleet: sessions still mapped to a dead replica "
                "after failover window"
            )
        if self.killed:
            if self.router.failovers == 0:
                v.append(
                    "fleet: replica_kill executed but the router "
                    "recorded no failover"
                )
            if self.router.sessions_resumed == 0:
                v.append(
                    "fleet: replica_kill stranded sessions but none "
                    "were resumed (all shed)"
                )
        # lag-shed isolation probe on a survivor with sessions —
        # requires the committee to still be committing (it is: the
        # probe runs before net.stop())
        probe: Dict[str, object] = {}
        victim = next(
            (
                r
                for r in self.replicas
                if r.alive
                and any(
                    rep is r
                    for rep in self.router._sessions.values()
                )
            ),
            None,
        )
        if victim is not None:
            others_before = [
                s
                for s, rep in self.router._sessions.items()
                if rep is not victim
            ]
            victim.stalled = True
            degraded = await self._wait(
                lambda: any(
                    r["degraded"]
                    for r in self.router.fleet_status()["replicas"]
                    if r["name"] == victim.name
                ),
                20.0,
            )
            if not degraded:
                v.append(
                    f"fleet: stalled {victim.name} past "
                    f"max_lag_heights but it was never degraded"
                )
            else:
                # isolation: every session that was on another replica
                # is untouched; the victim serves no one
                bystanders_shed = [
                    s for s in others_before if s.closed
                ]
                if bystanders_shed:
                    v.append(
                        f"fleet: lag shed closed "
                        f"{len(bystanders_shed)} sessions of OTHER "
                        f"replicas — shedding must isolate the "
                        f"stalled follower's clients"
                    )
                if victim.members() != 0:
                    v.append(
                        f"fleet: degraded {victim.name} still holds "
                        f"{victim.members()} sessions"
                    )
            victim.stalled = False
            recovered = await self._wait(
                lambda: not any(
                    r["degraded"]
                    for r in self.router.fleet_status()["replicas"]
                    if r["name"] == victim.name
                ),
                20.0,
            )
            if degraded and not recovered:
                v.append(
                    f"fleet: {victim.name} caught back up but was "
                    f"never rotated back in"
                )
            probe = {
                "victim": victim.name,
                "degraded": degraded,
                "recovered": recovered,
                "sheds_lag": self.router.sheds_lag,
            }
        # zero lost commits: every live session's recorded stream is
        # contiguous (resumed ones replayed their gap from the store)
        resumed = 0
        for sink, sess in zip(self.sinks, self.sessions):
            hs = sink.heights
            if sess.resumes:
                resumed += 1
            if sess.closed and sess.close_reason in (
                "shed_lag", "failover_shed",
            ):
                continue  # honestly shed, not silently lossy
            if hs and [h - hs[0] for h in hs] != list(
                range(len(hs))
            ):
                v.append(
                    f"fleet: session (resumes={sess.resumes}, "
                    f"reason={sess.close_reason!r}) delivered a "
                    f"non-contiguous stream — commits were lost"
                )
        if self.killed and resumed == 0:
            v.append(
                "fleet: no surviving session was resumed after "
                "replica_kill"
            )
        status = self.router.fleet_status()
        return {
            "replicas": status["replicas"],
            "killed": self.killed,
            "sessions": self.n_sessions,
            "sessions_resumed": self.router.sessions_resumed,
            "failovers": self.router.failovers,
            "sheds": status["sheds"],
            "lag_probe": probe,
            "delivered_frames": sum(s.frames for s in self.sinks),
        }

    async def stop(self) -> None:
        t, self._pump_task = self._pump_task, None
        if t is not None and not t.done():
            t.cancel()
            try:
                await asyncio.wait_for(
                    asyncio.gather(t, return_exceptions=True), 5.0
                )
            except asyncio.TimeoutError:
                pass
        # bounded teardown (ASY110): a wedged router/replica must not
        # hang the chaos run past its liveness verdict
        try:
            await asyncio.wait_for(self.router.close(), 5.0)
        except asyncio.TimeoutError:
            pass
        for r in self.replicas:
            try:
                await asyncio.wait_for(r.stop(), 5.0)
            except asyncio.TimeoutError:
                pass


async def run_schedule(
    schedule: FaultSchedule,
    seed: int,
    base_dir: str,
    n_nodes: int = 4,
    settle_heights: int = 2,
    liveness_bound_s: float = 60.0,
    fuzz_config=None,
    trace_dir: Optional[str] = None,
    config_hook=None,
    budget_file: Optional[str] = None,
    profile_hz: float = 19.0,
    workload=None,
    enable_rpc: Optional[bool] = None,
    light_storm: int = 0,
    subscriber_storm: int = 0,
    fleet: int = 0,
    device=None,
) -> ChaosReport:
    """Execute one seeded chaos run end-to-end and return its report
    (violations recorded, not raised — callers assert on report.ok).

    Trace dumps: with ``trace_dir`` set every node's trace ring is
    exported there unconditionally; without it a VIOLATED run still
    dumps the rings to a fresh persistent directory next to the seed
    + fault trace in the report — the timeline of what each node was
    doing is part of the replay contract.

    Health plane (docs/OBS.md): a low-rate sampling profiler runs for
    the whole schedule (``profile_hz``; 0 disables) and its folded
    stacks land beside any trace dump as profile.folded. With
    ``budget_file`` set, span budgets are evaluated over every ring
    at end of run; a breach dumps traces exactly like an invariant
    violation (report.budget_ok goes False, the CLI exits nonzero).

    ``device``: where every node checks its signatures (None is the
    GPU, and raises without one)."""
    table = LinkTable(seed, fuzz_config=fuzz_config)
    # lifecycle actions need the retention plane live on every node:
    # small windows, tiny batches (so an abort lands mid-pass), the
    # kvstore snapshot cadence mirrored to disk, and a background
    # interval long enough that only the nemesis drives reconciles —
    # deterministic counters per (seed, schedule)
    if any(
        e.action in ("crash_mid_prune", "snapshot_during_prune")
        for e in schedule.events
    ):
        _inner_hook = config_hook

        def config_hook(cfg, _inner=_inner_hook):  # noqa: F811
            if _inner is not None:
                _inner(cfg)
            s = cfg.storage
            s.retain_blocks = 4
            s.retain_states = 6
            s.retain_index = 4
            s.prune_batch = 2
            s.prune_interval_s = 3600.0
            s.snapshot_interval = 10
            s.snapshot_keep_recent = 2

    if fleet == 0 and any(
        e.action == "replica_kill" for e in schedule.events
    ):
        # a scheduled replica_kill implies a fleet: default to the
        # 3-replica deployment shape the action was designed against
        fleet = 3
    if enable_rpc is None:
        # the statesync joiner bootstraps over the sources' RPC, and
        # the subscriber storm needs a websocket endpoint — switch
        # the listeners on exactly when the run needs them
        enable_rpc = (
            any(e.action == "statesync_join" for e in schedule.events)
            or subscriber_storm > 0
        )
    net = ChaosNet(
        n_nodes,
        seed,
        base_dir,
        table=table,
        config_hook=config_hook,
        enable_rpc=enable_rpc,
        device=device,
    )
    report = ChaosReport(seed=seed, schedule_json=schedule.to_json())
    nemesis = Nemesis(net, schedule)
    # runtime concurrency sanitizer (analysis/runtime.py): chaos nodes
    # build with it ON (test_config); isolate this run's findings
    from ..analysis.runtime import get_sanitizer, injected_finding

    sanitizer = get_sanitizer()
    sanitizer.reset()
    inversion_scheduled = any(
        e.action == "lock_inversion" for e in schedule.events
    )
    quadratic_scheduled = any(
        e.action == "scaling_probe" and e.inject_quadratic
        for e in schedule.events
    )
    driver = None
    if workload is not None and workload.pattern != "none":
        from .workload import WorkloadDriver

        driver = WorkloadDriver(workload, seed)
    profiler = None
    if profile_hz and profile_hz > 0:
        from ..obs import SamplingProfiler

        profiler = SamplingProfiler(hz=profile_hz).start()

    stop_polling = asyncio.Event()

    async def agreement_poll():
        while not stop_polling.is_set():
            try:
                net.agreement.check(net.running_nodes())
            except asyncio.CancelledError:
                raise
            except InvariantViolation as v:
                report.violations.append(str(v))
                return
            except Exception:
                # a crash landed mid-scan and closed the node's stores
                # under the reader; the next pass re-reads (and the
                # end-of-run final_check is authoritative regardless)
                pass
            await asyncio.sleep(2 * POLL_S)

    fleet_harness = None
    try:
        await net.start()
        if fleet > 0:
            # fleet rides the run from the start so a mid-schedule
            # replica_kill strands sessions that are actually live
            fleet_harness = FleetHarness(net, fleet, seed)
            net.fleet_harness = fleet_harness
            await fleet_harness.start()
        if driver is not None:
            driver.start(net)
        poller = asyncio.create_task(agreement_poll())
        try:
            # schedule execution itself can surface violations (a
            # WAL-replay check on restart, an unreachable trigger on a
            # dead net) — they belong in the report, not a traceback
            try:
                await nemesis.run()
            except InvariantViolation as v:
                report.violations.append(str(v))
            # let pending byzantine corruptions land before judging
            if net._byz_tasks:
                await asyncio.wait(net._byz_tasks, timeout=30.0)
            # liveness: every running node must advance past the
            # post-schedule height within the bound — and SOME node
            # must be running (an empty net is the ultimate liveness
            # failure, not a vacuous pass)
            target = net.max_height() + settle_heights
            if not net.running_nodes():
                # the schedule ended with every node down; nothing can
                # restart them now, so don't burn the bound waiting
                report.violations.append(
                    str(liveness_violation(net.heights(), target, 0.0))
                )
            else:
                deadline = (
                    asyncio.get_running_loop().time() + liveness_bound_s
                )
                while asyncio.get_running_loop().time() < deadline:
                    running = net.running_nodes()
                    if running and all(
                        node.height >= target for _, node in running
                    ):
                        break
                    await asyncio.sleep(POLL_S)
                else:
                    report.violations.append(
                        str(
                            liveness_violation(
                                net.heights(), target, liveness_bound_s
                            )
                        )
                    )
            if light_storm > 0 and net.running_nodes():
                # serving-plane leg: storm a LIVE node with light
                # sessions while consensus keeps running — a session
                # failure or parity mismatch is a violation
                try:
                    report.light_storm = await asyncio.to_thread(
                        _run_light_storm_sync, net, light_storm, seed
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    report.violations.append(
                        f"light serving storm failed: {e!r}"
                    )
            if subscriber_storm > 0 and net.running_nodes():
                # fan-out plane leg: websocket subscribers
                # storm a live node while consensus keeps committing;
                # a shed, parity break or per-subscriber-encode
                # regression is a violation
                try:
                    report.subscriber_storm = await _run_subscriber_storm(
                        net, subscriber_storm, seed
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    report.violations.append(
                        f"subscriber storm failed: {e!r}"
                    )
            if fleet_harness is not None and net.running_nodes():
                # judge the fleet contract while the committee still
                # commits (the lag-shed probe needs live ingest)
                try:
                    report.fleet = await fleet_harness.finish()
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    report.violations.append(
                        f"fleet leg failed: {e!r}"
                    )
                report.violations.extend(fleet_harness.violations)
        finally:
            stop_polling.set()
            try:
                await asyncio.wait_for(poller, 5.0)
            except asyncio.TimeoutError:
                poller.cancel()
        # authoritative end-of-run agreement re-scan
        try:
            net.agreement.final_check(net.running_nodes())
        except InvariantViolation as v:
            if str(v) not in report.violations:
                report.violations.append(str(v))
    finally:
        report.final_heights = net.heights()
        try:
            # keys are regenerated per run, so the stable identity is
            # the NODE NAME (n0..nN follow sorted validator order,
            # node/inprocess.make_genesis) — that is what same-seed
            # runs must reproduce per height
            addr_to_name = {
                bytes(
                    cn.privval.pub_key().address()
                ).hex(): cn.name
                for cn in net.nodes
                if cn.privval is not None
            }
            running = net.running_nodes()
            if running:
                _, top = max(running, key=lambda t: t[1].height)
                store = top.parts.block_store
                for h in range(max(1, store.base()), top.height + 1):
                    meta = store.load_block_meta(h)
                    if meta is not None:
                        addr = bytes(
                            meta.header.proposer_address
                        ).hex()
                        report.proposers[h] = addr_to_name.get(
                            addr, addr[:12]
                        )
                    commit = store.load_block_commit(h)
                    if commit is not None:
                        report.rounds[h] = commit.round
        except Exception:
            pass  # fingerprint is best-effort diagnostics
        if driver is not None:
            await driver.stop()
            report.workload = driver.stats()
        if fleet_harness is not None:
            await fleet_harness.stop()
        await net.stop()
        if profiler is not None:
            profiler.stop()
        report.stall_records = net.stall_records()
        report.shutdown_stalls = net.shutdown_stall_records()
        report.dial_failures = net.dial_failures
        report.conns_killed = net.conns_killed
        # sanitizer findings ride the pipeline as invariant-style
        # violations: an un-injected lock-order cycle or affinity
        # breach fails the run (trace dump + seed-line replay), and a
        # scheduled lock_inversion must PROVE detection — a sanitizer
        # that cannot flag its own injection proves nothing
        report.sanitizer_findings = sanitizer.snapshot()
        for f in report.sanitizer_findings:
            if not injected_finding(f):
                report.violations.append(
                    f"sanitizer[{f.get('kind')}]: {f.get('message')}"
                )
        if inversion_scheduled:
            got = {
                f.get("kind")
                for f in report.sanitizer_findings
                if injected_finding(f)
            }
            for want in ("lock-order-cycle", "loop-affinity"):
                if want not in got:
                    report.violations.append(
                        "lock_inversion injected but the sanitizer "
                        f"reported no {want} finding"
                    )
        # scaling-probe results ride the same contract: an un-injected
        # exponent breach fails the run, and a scheduled quadratic
        # plant the probe did NOT flag also fails it
        from ..analysis.scaling import drain_chaos_results

        scaling_results = drain_chaos_results()
        report.scaling_results = [r.as_dict() for r in scaling_results]
        for r in scaling_results:
            if not r.ok and not r.injected:
                report.violations.append(
                    f"scaling[{r.site}]: exponent {r.exponent:.2f} "
                    f"over budget {r.budget:.2f}"
                )
        if quadratic_scheduled and not any(
            r.injected and not r.ok for r in scaling_results
        ):
            report.violations.append(
                "scaling_probe injected a quadratic site but the "
                "probe reported no breach for it"
            )
        if budget_file:
            # evaluated over the in-memory rings so a breach can force
            # the dump below even when no invariant tripped
            try:
                from ..obs.budget import evaluate_budgets, load_budgets
                from ..trace import summarize

                report.budget_verdicts = evaluate_budgets(
                    summarize(net.ring_snapshots()),
                    load_budgets(budget_file),
                )
            except Exception as e:
                report.violations.append(
                    f"budget evaluation failed: {e!r}"
                )
        # rings survive node stop (ChaosNode holds the tracers)
        try:
            dump_dir = trace_dir
            if dump_dir is None and (
                report.violations or not report.budget_ok
            ):
                dump_dir = tempfile.mkdtemp(
                    prefix=f"chaos_trace_{seed}_"
                )
            if dump_dir is not None:
                report.trace_files = net.dump_traces(dump_dir)
                if profiler is not None and profiler.samples:
                    report.profile_file = profiler.write_folded(
                        os.path.join(dump_dir, "profile.folded")
                    )
        except OSError:
            pass  # trace dump is best-effort diagnostics

    report.trace = nemesis.trace
    report.link_decisions = table.decision_counts()
    report.wal_checks = net.wal_checker.checks
    if not report.ok:
        # the replay contract: seed + schedule + trace on any failure
        _log.error("chaos invariants violated", seed=seed)
        print(report.format())
    return report
