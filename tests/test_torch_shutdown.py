"""The port's bounded shutdown (obs/shutdown.py and ``Node._shutdown``)
held to the JAX package's: the cases of ``tests/test_shutdown.py``, on
the port.

1. ``ShutdownGuard``: completed stages pass, overrunning stages are
   flight-recorded and cancelled, cancel-ignoring stages are abandoned
   and later stages still run, a failing stage counts as done.
2. A node whose reactor ``stop()`` hangs (and swallows its cancel)
   still completes ``Node.stop()`` within its budget, leaves the flight
   record in its trace ring, and releases its store handles (a rebuild
   on the same home reopens them).
3. The WAL's torn-tail repair that consensus start runs.

4. The ``ChaosNet`` cases on the port's chaos harness (``device="cpu"``):
   ``ChaosNet.stop()`` with a node's reactor stop wedged stays bounded
   and surfaces the stall records, and a node whose switch stop stage
   was abandoned still closes its connections, so its next incarnation
   rejoins and the net keeps committing.
"""

import asyncio
import os

import torch

from cometbft_tpu_torch.obs.shutdown import ShutdownGuard
from cometbft_tpu_torch.trace import Tracer
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --- 1. ShutdownGuard unit behavior -------------------------------------


def test_guard_clean_stage_completes():
    async def main():
        guard = ShutdownGuard(name="t", budget_s=5.0)
        done = []

        async def ok_stage():
            done.append(1)

        assert await guard.stage("ok", ok_stage()) is True
        assert guard.clean and not guard.stalls and done == [1]

    run(main())


def test_guard_overrun_stage_is_recorded_cancelled_and_bounded():
    async def main():
        tracer = Tracer(name="t", size=256)
        guard = ShutdownGuard(tracer=tracer, name="t", budget_s=0.2)
        cancelled = []

        async def hang():
            try:
                await asyncio.sleep(60)
            except asyncio.CancelledError:
                cancelled.append(1)
                raise

        t0 = asyncio.get_running_loop().time()
        ok = await guard.stage("wedge", hang())
        elapsed = asyncio.get_running_loop().time() - t0
        assert ok is False
        assert elapsed < 5.0, "stage was not bounded"
        assert cancelled == [1], "escalation never cancelled the stage"
        # flight record captured mid-hang, with the stage task's stack
        assert len(guard.stalls) == 1
        rec = guard.stalls[0]
        assert rec["stage"] == "wedge"
        assert "hang" in rec.get("stage_stack", "")
        assert not guard.abandoned  # it honored its cancel
        names = [e["name"] for e in tracer.snapshot()]
        assert "obs.shutdown.stall" in names
        assert "obs.shutdown.tasks" in names

    run(main())


def test_guard_cancel_ignoring_stage_is_abandoned_and_later_stages_run():
    async def main():
        guard = ShutdownGuard(name="t", budget_s=0.2)
        ran_after = []
        release = asyncio.Event()

        async def ignores_cancel():
            while not release.is_set():
                try:
                    await asyncio.sleep(60)
                except asyncio.CancelledError:
                    continue  # the wedge class: swallowed cancel

        async def after():
            ran_after.append(1)

        assert await guard.stage("zombie", ignores_cancel()) is False
        assert guard.abandoned == ["zombie"]
        assert await guard.stage("after", after()) is True
        assert ran_after == [1]
        release.set()  # let the zombie die with the loop

    run(main())


def test_guard_stage_exception_is_swallowed_and_stage_counts_done():
    async def main():
        guard = ShutdownGuard(name="t", budget_s=1.0)

        async def boom():
            raise RuntimeError("already dead")

        assert await guard.stage("boom", boom()) is True
        assert guard.clean  # failing fast is not a stall

    run(main())


# --- 2. the hanging-reactor regression ----------------------------------


def _hang_reactor_stop(node, release: asyncio.Event):
    """Swap the mempool reactor's stop() for one that ignores its
    cancel until released — the injected wedge."""

    async def hanging_stop():
        while not release.is_set():
            try:
                await asyncio.sleep(60)
            except asyncio.CancelledError:
                continue

    node.mempool_reactor.stop = hanging_stop


def test_node_stop_survives_hanging_reactor_stop(tmp_path):
    """A reactor stop() that never returns (and swallows its cancel)
    must not wedge Node.stop(): shutdown completes within the staged
    budget, the breach is flight-recorded into the trace ring, and the
    store handles are released (a rebuild on the same home works)."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.p2p import MemoryTransport, NodeInfo, NodeKey

    gen, privs = make_genesis(1, chain_id="shutdown-test")
    pv = make_privvals(privs, root=str(tmp_path))[0]
    home = str(tmp_path / "n0")
    os.makedirs(home, exist_ok=True)

    def build():
        cfg = make_test_cfg(home)
        cfg.base.moniker = "n0"
        cfg.base.db_backend = "sqlite"
        cfg.blocksync.enable = False
        cfg.p2p.pex = False
        # small budgets so the test is fast; escalation still has to run
        # its full stop->cancel->abandon ladder
        cfg.instrumentation.shutdown_stage_budget_s = 0.3
        key = NodeKey.generate()
        info = NodeInfo(node_id=key.node_id, network=gen.chain_id, moniker="n0")
        return Node(cfg, gen, privval=pv, node_key=key, transport=MemoryTransport(key, info), home=home,
                    device="cpu")

    async def main():
        node = build()
        await node.start()
        for _ in range(600):
            if node.height >= 1:
                break
            await asyncio.sleep(0.05)
        assert node.height >= 1

        release = asyncio.Event()
        _hang_reactor_stop(node, release)
        t0 = asyncio.get_running_loop().time()
        await asyncio.wait_for(node.stop(), 30.0)
        elapsed = asyncio.get_running_loop().time() - t0
        # bounded: staged budget + cancel grace, nowhere near a hang
        assert elapsed < 15.0, f"stop took {elapsed:.1f}s"

        guard = node.shutdown_guard
        assert guard is not None and not guard.clean
        stages = [r["stage"] for r in guard.stalls]
        # the hang lives inside the switch stage (reactor stops run
        # under Switch.stop, each bounded at 12 s > our 0.9 s budget)
        assert "switch" in stages, stages
        names = [e["name"] for e in node.parts.tracer.snapshot()]
        assert "obs.shutdown.stall" in names
        # the hung stage was abandoned but stores were still released:
        # a rebuild on the same home must reopen every database
        release.set()
        node2 = build()
        await node2.start()
        assert node2.height >= 1  # recovered the committed chain
        await asyncio.wait_for(node2.stop(), 30.0)
        assert node2.shutdown_guard.clean

    run(main())


def test_chaosnet_stop_is_bounded_with_hanging_reactor(tmp_path):
    """The full-suite wedge regression: ChaosNet.stop() with one
    node's reactor stop() wedged completes within budget and the
    report surfaces the shutdown stall records."""
    from cometbft_tpu_torch.chaos.net import ChaosNet

    async def main():
        def hook(cfg):
            cfg.instrumentation.shutdown_stage_budget_s = 0.3

        net = ChaosNet(
            2, seed=5150, base_dir=str(tmp_path), config_hook=hook, device="cpu"
        )
        await net.start()
        release = asyncio.Event()
        try:
            for _ in range(600):
                if net.max_height() >= 1:
                    break
                await asyncio.sleep(0.05)
            _hang_reactor_stop(net.nodes[0].node, release)
        finally:
            t0 = asyncio.get_running_loop().time()
            await asyncio.wait_for(net.stop(), 60.0)
            elapsed = asyncio.get_running_loop().time() - t0
        assert elapsed < 30.0, f"net.stop took {elapsed:.1f}s"
        stalls = net.shutdown_stall_records()
        assert stalls, "breach was not flight-recorded"
        assert any(r.get("stage") == "switch" for r in stalls), stalls
        release.set()

    run(main())


def test_abandoned_switch_stage_still_kills_conns_so_restart_rejoins(
    tmp_path,
):
    """The rejoin wedge the scenario matrix surfaced: if a node's
    switch stop stage is abandoned with its conns left OPEN, peers
    keep a live zombie peer entry and dup-discard every dial from the
    node's next incarnation — it can never rejoin. The escalation
    floor (Switch.abort on an abandoned stage) must close the fds so
    peers drop the zombie and the restarted node reconnects and the
    net keeps committing."""
    from cometbft_tpu_torch.chaos.net import ChaosNet

    async def main():
        def hook(cfg):
            cfg.instrumentation.shutdown_stage_budget_s = 0.2

        net = ChaosNet(
            3, seed=616, base_dir=str(tmp_path), config_hook=hook, device="cpu"
        )
        await net.start()
        try:
            for _ in range(600):
                if net.max_height() >= 1:
                    break
                await asyncio.sleep(0.05)
            # wedge n0's whole switch stop: the stage must abandon it
            node0 = net.nodes[0].node

            async def hang():
                await asyncio.sleep(600)

            node0.switch.stop = hang
            await net.crash(0)
            stalls = net.nodes[0].shutdown_stalls
            assert any(r["stage"] == "switch" for r in stalls), stalls
            await asyncio.sleep(0.3)
            # peers must have dropped the zombie (abort closed the fds)
            for cn in net.nodes[1:]:
                assert net.nodes[0].node_id not in cn.node.switch.peers
            await net.restart(0)
            # the restarted incarnation must REJOIN: its peers accept
            # its dials and it keeps committing with the net
            n0 = net.nodes[0].node
            target = net.max_height() + 2
            for _ in range(1200):
                if n0.height >= target and n0.switch.num_peers() >= 2:
                    break
                await asyncio.sleep(0.05)
            assert n0.switch.num_peers() >= 2, "never reconnected"
            assert n0.height >= target, (
                f"wedged at {n0.height} < {target}: the zombie-conn "
                "rejoin failure"
            )
            net.agreement.final_check(net.running_nodes())
        finally:
            await asyncio.wait_for(net.stop(), 60.0)

    run(main())


# --- 3. WAL torn-tail repair (consensus/wal.py) -------------------------


def test_wal_repair_torn_tail_keeps_valid_prefix(tmp_path):
    from cometbft_tpu_torch.consensus.wal import WAL, WALMessage

    path = str(tmp_path / "cs.wal")
    w = WAL(path)
    for h in (1, 2, 3):
        w.write_sync(WALMessage(kind=6, height=h))
    w.close()
    with open(path, "ab") as f:
        f.write(b"\xde\xad\xbe\xef torn tail garbage")
    # iteration already stops at the garbage…
    assert len(list(WAL.iter_messages(path))) == 3
    # …but WITHOUT repair, appended records after it would be lost:
    removed = WAL.repair_torn_tail(path)
    assert removed > 0
    w2 = WAL(path)
    w2.write_sync(WALMessage(kind=6, height=4))
    w2.close()
    assert [m.height for m in WAL.iter_messages(path)] == [1, 2, 3, 4]
    # idempotent on a clean head
    assert WAL.repair_torn_tail(path) == 0


def test_wal_append_after_torn_tail_without_repair_loses_records(tmp_path):
    """Documents the hole the repair closes: garbage + append means the
    appended record is unreadable (this is WHY consensus start repairs
    before reopening)."""
    from cometbft_tpu_torch.consensus.wal import WAL, WALMessage

    path = str(tmp_path / "cs.wal")
    w = WAL(path)
    w.write_sync(WALMessage(kind=6, height=1))
    w.close()
    with open(path, "ab") as f:
        f.write(b"\x00garbage\xff")
    w2 = WAL(path)  # raw open, no repair
    w2.write_sync(WALMessage(kind=6, height=2))
    w2.close()
    assert [m.height for m in WAL.iter_messages(path)] == [1]
