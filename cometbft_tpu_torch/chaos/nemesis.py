"""Nemesis: executes a declarative fault schedule against a ChaosNet.

Events run strictly in order. Height triggers poll the network's max
committed height over running nodes; time triggers are relative to the
previous event's execution. Every executed event is appended to
``trace`` with its CONFIGURED trigger plus any seed-derived parameters
(e.g. the byzantine tamper bytes, drawn from the LinkTable's master
rng in schedule order) — so two runs with the same seed + schedule
produce byte-identical traces, and per-link message-level decisions
are separately deterministic by (seed, link, op index)
(chaos/links.py). That pair is the replay contract printed on any
invariant violation.

A copy of the JAX package's ``chaos/nemesis.py``, with every action;
``verify_storm`` submits its tickets for the net's device.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
from typing import List

from ..utils.log import get_logger
from .invariants import InvariantViolation
from .schedule import FaultEvent, FaultSchedule

_log = get_logger("chaos.nemesis")

_POLL_S = 0.05


def chaos_stall(duration_s: float) -> None:
    """Deliberately block the event loop with a synchronous callback —
    the fault the obs watchdog's flight recorder exists to catch. The
    function name is the needle: a correct flight record's loop-thread
    snapshot (and this frame inside it) must contain ``chaos_stall``.
    ``time.sleep`` releases the GIL, so the off-loop monitor threads
    observe the stall mid-flight and snapshot THIS frame."""
    time.sleep(duration_s)


class Nemesis:
    def __init__(self, net, schedule: FaultSchedule):
        self.net = net
        self.schedule = schedule
        self.trace: List[dict] = []

    async def run(self) -> None:
        for i, ev in enumerate(self.schedule.events):
            await self._wait_trigger(ev)
            record = await self._execute(ev)
            record.update(
                index=i,
                action=ev.action,
                at_height=ev.at_height,
                after_s=ev.after_s,
            )
            self.trace.append(record)
            _log.info("nemesis event", **{
                k: v for k, v in record.items() if v is not None
            })

    async def _wait_trigger(self, ev: FaultEvent) -> None:
        if ev.after_s is not None:
            await asyncio.sleep(ev.after_s)
            return
        while self.net.max_height() < ev.at_height:
            if not self.net.running_nodes():
                # a dead network can never commit: waiting would hang
                # the run forever — surface it as a liveness violation
                raise InvariantViolation(
                    "liveness",
                    f"{ev.action} trigger at_height={ev.at_height} "
                    "unreachable: no nodes running",
                )
            await asyncio.sleep(_POLL_S)

    async def _execute(self, ev: FaultEvent) -> dict:
        net = self.net
        if ev.action == "partition":
            groups = [
                [net.nodes[i].node_id for i in g] for g in ev.groups
            ]
            net.table.partition(groups)
            return {
                "groups": [
                    [net.nodes[i].name for i in g] for g in ev.groups
                ]
            }
        if ev.action == "heal":
            net.table.heal()
            return {}
        if ev.action == "set_link":
            src = net.nodes[ev.src]
            dst = net.nodes[ev.dst]
            if ev.symmetric:
                net.table.set_symmetric(
                    src.node_id, dst.node_id, **ev.link
                )
            else:
                net.table.set_link(src.node_id, dst.node_id, **ev.link)
            return {
                "src": src.name,
                "dst": dst.name,
                "link": dict(ev.link),
                "symmetric": ev.symmetric,
            }
        if ev.action == "crash":
            await net.crash(ev.node)
            return {"node": net.nodes[ev.node].name}
        if ev.action == "restart":
            await net.restart(ev.node)
            return {"node": net.nodes[ev.node].name}
        if ev.action == "stall":
            # runs ON the loop on purpose: every in-process node
            # shares it, so every node's watchdog sees the stall
            chaos_stall(ev.duration_s)
            return {"duration_s": ev.duration_s}
        if ev.action == "crash_wave":
            crashed = []
            for n in ev.nodes:
                await net.crash(n)
                crashed.append(net.nodes[n].name)
                if ev.stagger_s > 0 and n != ev.nodes[-1]:
                    await asyncio.sleep(ev.stagger_s)
            restarted = []
            if ev.restart_after_s is not None:
                await asyncio.sleep(ev.restart_after_s)
                for n in ev.nodes:
                    if ev.blocksync:
                        # adaptive-sync catchup under traffic: the
                        # rebuilt node blocksyncs the gap while its
                        # consensus state machine already runs
                        net.nodes[n].build_overrides.update(
                            {
                                "blocksync.enable": True,
                                "blocksync.adaptive_sync": True,
                            }
                        )
                    try:
                        await net.restart(n)
                    finally:
                        if ev.blocksync:
                            # scoped to THIS wave's restart: a later
                            # plain crash/restart of the same node in
                            # the schedule must not silently inherit
                            # the blocksync path
                            for k in (
                                "blocksync.enable",
                                "blocksync.adaptive_sync",
                            ):
                                net.nodes[n].build_overrides.pop(
                                    k, None
                                )
                    restarted.append(net.nodes[n].name)
                    if ev.stagger_s > 0 and n != ev.nodes[-1]:
                        await asyncio.sleep(ev.stagger_s)
            return {
                "crashed": crashed,
                "restarted": restarted,
                "blocksync": ev.blocksync,
            }
        if ev.action == "conn_kill":
            net.kill_conns(ev.node, count=ev.count)
            # trace determinism: record the victim + HOW MANY we asked
            # for, not the momentary peer set (wall-clock-dependent)
            return {
                "node": net.nodes[ev.node].name,
                "count": ev.count,
            }
        if ev.action == "reconnect_storm":
            # repeated partition/heal cycles + targeted pong-timeout
            # conn kills: the compound that used to exhaust the finite
            # reconnect budget and permanently isolate the victim —
            # the self-healing plane must re-converge after EVERY heal
            victim = ev.node
            others = [
                i for i in range(len(net.nodes)) if i != victim
            ]
            for cycle in range(ev.cycles):
                net.table.partition([
                    [net.nodes[i].node_id for i in others],
                    [net.nodes[victim].node_id],
                ])
                net.kill_conns(victim)
                await asyncio.sleep(ev.hold_s)
                net.table.heal()
                await asyncio.sleep(ev.gap_s)
            return {
                "node": net.nodes[victim].name,
                "cycles": ev.cycles,
                "hold_s": ev.hold_s,
                "gap_s": ev.gap_s,
            }
        if ev.action == "lock_inversion":
            # deterministic sanitizer exercise (analysis/runtime.py):
            # sequential ABBA + a foreign-thread affinity touch — no
            # timing race, so detection replays from the seed line
            from ..analysis.runtime import inject_lock_inversion

            return inject_lock_inversion()
        if ev.action == "scaling_probe":
            # committee-scaling exponent probe (analysis/scaling.py):
            # pure-CPU timing loops, so it runs in a worker thread —
            # blocking the loop here would trip the stall detector
            # the matrix itself polices. Results accumulate in the
            # module drain; net.py folds them into the report after
            # the run (sanitizer-findings discipline).
            from ..analysis.scaling import probe_for_chaos

            return await asyncio.to_thread(
                probe_for_chaos, ev.inject_quadratic
            )
        if ev.action == "verify_storm":
            # three-class storm through the ONE process-wide verify
            # scheduler the net's live consensus shares — worker
            # thread for the same loop-stall reason as scaling_probe
            from .verify_storm import storm_for_chaos

            return await asyncio.to_thread(
                storm_for_chaos, ev.storm_s, ev.live_budget_ms,
                net.device,
            )
        if ev.action == "statesync_join":
            name = await net.statesync_join(via=ev.via)
            return {"joined": name}
        if ev.action == "valset_churn":
            # the new power comes from the MASTER rng unless pinned:
            # schedule execution is sequential, so the draw is
            # deterministic per (seed, schedule)
            power = ev.power
            if power is None:
                power = net.table.rng.randint(
                    ev.power_min, ev.power_max
                )
            return net.valset_churn(ev.node, power)
        if ev.action == "wal_torn_tail":
            # torn bytes from the MASTER rng, same determinism rule
            n = ev.garbage or 37
            garbage = bytes(
                net.table.rng.getrandbits(8) for _ in range(n)
            )
            rec = await net.wal_torn_tail(ev.node, garbage)
            rec["garbage_sha8"] = hashlib.sha256(garbage).hexdigest()[:8]
            return rec
        if ev.action == "crash_mid_prune":
            # the abort batch index comes from the MASTER rng unless
            # pinned: schedule execution is sequential, so the crash
            # lands at a deterministic batch boundary per (seed,
            # schedule) — the byte-identical-replay contract
            abort_after = ev.abort_after
            if abort_after is None:
                abort_after = net.table.rng.randint(1, 3)
            return await net.crash_mid_prune(ev.node, abort_after)
        if ev.action == "snapshot_during_prune":
            return await net.snapshot_during_prune(ev.node)
        if ev.action == "replica_kill":
            # the victim replica comes from the MASTER rng unless
            # pinned: schedule execution is sequential, so the draw is
            # deterministic per (seed, schedule)
            idx = ev.replica
            if idx is None:
                idx = net.table.rng.randint(
                    0, max(0, net.fleet_size() - 1)
                )
            return await net.replica_kill(idx)
        if ev.action == "byzantine":
            # tamper bytes come from the MASTER rng: schedule execution
            # is sequential, so the draw is deterministic per run
            tamper = bytes(
                net.table.rng.getrandbits(8) for _ in range(32)
            )
            net.inject_commit_corruption(ev.node, tamper)
            return {
                "node": net.nodes[ev.node].name,
                "tamper": tamper.hex()[:16],
            }
        raise ValueError(f"unknown action {ev.action!r}")
