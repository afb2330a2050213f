"""A failed device route is no verdict on evidence (ROADMAP C3).

A stand-in card: the device route pinned (floor 1) on ``device="cpu"``;
the device dispatch of every evidence ticket (the light-client attack's
``trusting`` and ``light`` commit checks) raises what the device route
can raise: a CUDA error (``RuntimeError``), a kernel's shape check
(``ValueError``) or a kernel library that does not load (``OSError``).
The scheduler resolves such a ticket with a ``DeviceRouteError``.
Every other ticket (the consensus round's) is answered on the host.

Three port validator nodes of a 4-validator chain run over TCP, and a
stub peer (``utils.chaingen.StubPeer``) sends a light-client attack on
the evidence channel while the card fails. The JAX reactor would
swallow the error and drop the evidence for good (its sender never
sends it again). Here:

- the evidence is neither pending nor refused: the receiving reactor
  keeps it for a retry, the switch counts the error and keeps the
  peer; evidence handed to a node directly (``Node.add_evidence``)
  raises the ``DeviceRouteError`` and is kept the same way;
- once the card works, both are checked again, committed, and reach
  every app as LIGHT_CLIENT_ATTACK records;
- a plain refusal from the peer is still dropped, as in the JAX
  package: not pending, not kept, no error counted, the peer kept.
"""

import asyncio

import pytest
import torch

from cometbft_tpu_torch.abci.types import MISBEHAVIOR_LIGHT_CLIENT_ATTACK
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PubKey
from cometbft_tpu_torch.crypto.scheduler import DeviceRouteError
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.ops import ed25519 as ops_ed
from cometbft_tpu_torch.utils import chaingen
from torch_hard_limit import hard_limit  # noqa: F401

CPU = "cpu"
FAULTS = [RuntimeError("CUDA error: launch failed"), ValueError("ladder: rows 16 apart expected"),
          OSError("libladder.so: cannot open shared object file")]
FAULT_IDS = ["RuntimeError", "ValueError", "OSError"]
EVIDENCE_LABELS = ("trusting", "light")


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    floor = crypto_batch._MIN_DEVICE_BATCH
    yield
    crypto_batch.set_min_device_batch(floor)
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


class _Answered:
    """A device handle that is already resolved."""

    def __init__(self, oks):
        self.oks = oks
        self.dispatch = {}

    def wait(self):
        pass

    def result(self):
        return self.oks


@pytest.fixture
def card(monkeypatch):
    """The device route pinned on a stand-in card; ``card["fault"] =
    <error>`` makes the device dispatch of every evidence ticket raise
    it."""
    real = sched_mod.VerifyScheduler._dispatch_device
    state = {"fault": None, "failed": 0}

    def dispatch(self, ticket, ed_idx, ed_items):
        if state["fault"] is not None and ticket.label in EVIDENCE_LABELS:
            state["failed"] += 1
            raise state["fault"]
        return real(self, ticket, ed_idx, ed_items)

    def answer(items, device=None, precomp=None):
        return _Answered([Ed25519PubKey(pk).verify(m, sig) for m, pk, sig in items])

    monkeypatch.setattr(sched_mod.VerifyScheduler, "_dispatch_device", dispatch)
    monkeypatch.setattr(ops_ed, "verify_batch_async", answer)
    crypto_batch.set_min_device_batch(1)
    return state


def run(coro, timeout=150):
    return asyncio.run(asyncio.wait_for(coro, timeout))


async def _wait(pred, what, timeout=60.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.02)


def _lca_at_apps(nodes, ev):
    """Every app holds a LIGHT_CLIENT_ATTACK record of each of ``ev``'s
    byzantine validators at its common height."""
    want = {(v.address, ev.common_height) for v in ev.byzantine_validators}
    return all(
        want <= {(r[2], r[4]) for r in n.parts.app.misbehavior_seen if r[1] == MISBEHAVIOR_LIGHT_CLIENT_ATTACK}
        for n in nodes
    )


@pytest.mark.parametrize("fault", FAULTS, ids=FAULT_IDS)
def test_failed_route_keeps_evidence_until_the_card_works(card, fault, tmp_path):
    gen, privs = make_genesis(4, chain_id="evidence-c3", seed=5)
    pvs = make_privvals(privs[:3], root=str(tmp_path))

    async def main():
        nodes = []
        for i, p in enumerate(pvs):
            cfg = make_test_cfg(".")
            cfg.base.moniker = f"node{i}"
            cfg.blocksync.enable = False
            nodes.append(Node(cfg, gen, privval=p, device=CPU))
        stub = chaingen.StubPeer(gen.chain_id)
        for n in nodes:
            await n.start()
        try:
            for i, a in enumerate(nodes):
                for b in nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            await _wait(lambda: all(n.height >= 3 for n in nodes), "height 3")
            target, direct = nodes[0], nodes[1]
            await stub.connect(target.listen_addr)
            await _wait(lambda: target.switch.num_peers() == 3, "the stub peer")
            # a lunatic fork signed by validators 2 and 3, and an
            # equivocation fork signed by all four, of committed heights
            lunatic = chaingen.light_attack(
                target.parts, chaingen.conflicting_block(target.parts, privs, 2, privs[2:]), 1)
            equivocation = chaingen.light_attack(
                target.parts, chaingen.conflicting_block(target.parts, privs, 3), 2)
            errors = target.parts.cs.loop_errors.count

            card["fault"] = fault
            stub.send_evidence(lunatic)
            with pytest.raises(DeviceRouteError) as exc:
                await direct.add_evidence(equivocation)
            assert exc.value.__cause__ is fault
            # the receipt and at least one retry failed
            await _wait(lambda: card["failed"] >= 3 and target.parts.cs.loop_errors.count >= errors + 2,
                        "the failed receipt and its retry")
            for n in nodes:
                assert n.parts.evpool.size() == 0
            assert target.evidence_reactor.retry_pending() == 1
            assert direct.evidence_reactor.retry_pending() == 1
            assert target.switch.num_peers() == 3  # the stub peer kept
            kept = target.parts.cs.loop_errors.kept()
            assert all(isinstance(e, DeviceRouteError) for e in kept[-2:])

            card["fault"] = None
            await _wait(lambda: _lca_at_apps(nodes, lunatic), "the lunatic fork's misbehavior at every app")
            await _wait(lambda: _lca_at_apps(nodes, equivocation), "the equivocation's misbehavior at every app")
            assert target.evidence_reactor.retry_pending() == direct.evidence_reactor.retry_pending() == 0

            # a plain refusal is dropped, as in the JAX package
            errors = target.parts.cs.loop_errors.count
            refused = chaingen.light_attack(
                target.parts, chaingen.conflicting_block(target.parts, privs, 2, privs[1:3]), 1)
            refused.total_voting_power += 1
            stub.send_evidence(refused)
            await asyncio.sleep(1.0)
            assert target.parts.evpool.size() == 0
            assert target.evidence_reactor.retry_pending() == 0
            assert target.parts.cs.loop_errors.count == errors
            assert target.switch.num_peers() == 3
            # the evidence the stub was offered is what the nodes committed
            assert {e.hash() for e in stub.evidence.received} <= {lunatic.hash(), equivocation.hash()}
        finally:
            await stub.stop()
            for n in nodes:
                await n.stop()

    run(main())


class _FailingPool:
    """A pool whose every check meets a failed verify route."""

    async def add_evidence_awaited(self, ev):
        raise DeviceRouteError("verify route failed (2 lanes)")


def test_retry_list_is_bounded_and_deduplicated(monkeypatch):
    """Evidence kept for a retry is held once by hash, and only up to
    ``MAX_RETRY_BYTES`` of encoded evidence; past it, the piece is
    counted in ``retry_overflow`` and not kept."""
    from cometbft_tpu_torch.evidence import reactor as ev_reactor

    gen, privs = make_genesis(4, chain_id="evidence-c3-bound", seed=6)
    src = chaingen.make_chain(gen, privs, 3, device=CPU)
    lunatic = chaingen.light_attack(src, chaingen.conflicting_block(src, privs, 2, privs[2:]), 1)
    equivocation = chaingen.light_attack(src, chaingen.conflicting_block(src, privs, 3), 2)
    monkeypatch.setattr(ev_reactor, "MAX_RETRY_BYTES", len(lunatic.encode()))
    r = ev_reactor.EvidenceReactor(_FailingPool())

    async def offer(ev):
        with pytest.raises(DeviceRouteError):
            await r.add_evidence(ev)

    for ev in (lunatic, lunatic, equivocation):
        run(offer(ev))
    assert r.retry_pending() == 1 and r.retry_overflow == 1


class _HeldScheduler(sched_mod.VerifyScheduler):
    """A card that answers only when told: every ticket is held until
    ``release`` resolves the held ones with host verdicts."""

    def __init__(self):
        super().__init__()
        self.held = []
        self.submitted = 0

    def submit(self, items, priority=sched_mod.PRIORITY_CATCHUP, label="", device=None, backend=None):
        ticket = sched_mod.VerifyTicket(list(items), priority, label, device)
        self.held.append(ticket)
        self.submitted += 1
        return ticket

    def release(self):
        held, self.held = self.held, []
        for ticket in held:
            ticket.oks = [Ed25519PubKey(pk.key_bytes).verify(m, sig) for pk, m, sig in ticket.items]
            self._finish(ticket)


def test_received_evidence_is_checked_off_the_loop(monkeypatch):
    """A light-client attack received while its tickets wait on the
    card: ``receive`` returns at once, the loop keeps running, a second
    copy is not checked twice, and the evidence is pending once the
    tickets resolve. Past ``MAX_CHECKS`` checks at once, received
    evidence waits on the retry list. A check whose ticket never
    resolves is cancelled by ``stop`` and leaves nothing waiting."""
    from cometbft_tpu_torch.evidence import reactor as ev_reactor

    monkeypatch.setattr(ev_reactor, "MAX_CHECKS", 1)

    gen, privs = make_genesis(4, chain_id="evidence-off-loop", seed=7)
    src = chaingen.make_chain(gen, privs, 3, device=CPU)
    lunatic = chaingen.light_attack(src, chaingen.conflicting_block(src, privs, 2, privs[2:]), 1)
    equivocation = chaingen.light_attack(src, chaingen.conflicting_block(src, privs, 3), 2)
    lunatic_b = chaingen.light_attack(src, chaingen.conflicting_block(src, privs, 3, privs[2:]), 2)
    card = _HeldScheduler()
    sched_mod.set_scheduler(card)

    async def main():
        r = ev_reactor.EvidenceReactor(src.evpool)
        r.receive(ev_reactor.EVIDENCE_CHANNEL, None, lunatic.encode())
        r.receive(ev_reactor.EVIDENCE_CHANNEL, None, lunatic.encode())
        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for _ in range(10):
            await asyncio.sleep(0.01)
        assert loop.time() - t0 < 5.0
        assert card.submitted == 1 and src.evpool.size() == 0  # the trusting ticket waits

        def answered():
            card.release()
            return src.evpool.size() == 1

        await _wait(answered, "the lunatic fork pending")
        assert card.submitted == 2  # the trusting and the light ticket, once
        assert not r._checking

        r.receive(ev_reactor.EVIDENCE_CHANNEL, None, equivocation.encode())
        await _wait(lambda: card.submitted == 3, "the equivocation's first ticket")
        r.receive(ev_reactor.EVIDENCE_CHANNEL, None, lunatic_b.encode())
        assert len(r._checking) == 1 and r.retry_pending() == 1
        await r.stop()
        assert not r._checking and src.evpool.size() == 1
        await asyncio.sleep(0.05)  # the cancelled check ends without a verdict
        assert src.evpool.size() == 1

    run(main())
