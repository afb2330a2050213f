"""Byzantine validators against port nodes, on the CPU
(``tests/test_byzantine.py`` ported; reference
consensus/byzantine_test.go:38 TestByzantinePrevoteEquivocation and
test/e2e/runner/evidence.go).

- ``test_prevote_equivocation_slashed_end_to_end``, ported whole: a
  validator's key equivocates prevotes into a port node's consensus
  reactor over TCP; the duplicate-vote evidence forms in that node's
  pool, gossips on channel 0x38, lands in a committed block and
  reaches every app as Misbehavior with the offender's power.
- ``test_lca_evidence_internal_consistency_enforced``, ported whole: a
  genuine commit under a fabricated header, and a common height ahead
  of the conflicting block, are refused.
- ``test_light_client_attack_slashed_end_to_end`` without RPC: the
  witness's provider hands the light client's evidence to its node in
  process (``Node.add_evidence``), where the JAX test posts it over
  HTTP; the rest runs as there, the evidence verified, gossiped,
  committed and delivered as LIGHT_CLIENT_ATTACK records with both
  attackers' powers.
- A mixed net of two JAX nodes and two port nodes: a JAX node's
  duplicate-vote evidence and a port node's light-client-attack
  evidence are each committed, every node stores the same block at
  every height and every app keeps the same misbehavior records; a
  fifth (port) node then joins by blocksync over TCP through the
  evidence blocks to the same blocks and records.
"""

import asyncio
import os
import time

import pytest
import torch

from cometbft_tpu.config.config import test_config as jtest_config
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.evidence import types as jev
from cometbft_tpu.node.node import Node as JNode
from cometbft_tpu.privval.file_pv import FilePV as JFilePV
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu_torch.abci.types import MISBEHAVIOR_DUPLICATE_VOTE, MISBEHAVIOR_LIGHT_CLIENT_ATTACK
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.consensus.reactor import VOTE_CHANNEL, encode_vote_msg
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.evidence.pool import EvidenceError
from cometbft_tpu_torch.evidence.types import DuplicateVoteEvidence
from cometbft_tpu_torch.light import Client, StoreBackedProvider, TrustOptions
from cometbft_tpu_torch.light.detector import DivergenceError
from cometbft_tpu_torch.light.types import LightBlock
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.utils import chaingen
from torch_hard_limit import hard_limit  # noqa: F401

CPU = "cpu"


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def run(coro, timeout=180):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _mk_node(gen, pv_, i):
    cfg = make_test_cfg(".")
    cfg.base.moniker = f"node{i}"
    cfg.blocksync.enable = False
    return Node(cfg, gen, privval=pv_, device=CPU)


async def _connect_all(nodes):
    for i, a in enumerate(nodes):
        for b in nodes[i + 1:]:
            await a.dial(b.listen_addr)
    for n in nodes:
        for _ in range(200):
            if n.switch.num_peers() >= len(nodes) - 1:
                break
            await asyncio.sleep(0.05)


async def _wait(pred, timeout, what):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if pred():
            return
        await asyncio.sleep(0.05)
    raise TimeoutError(what)


def _records(n, kind, addr):
    return [r for r in n.parts.app.misbehavior_seen if r[1] == kind and r[2] == addr]


def _evidence_blocks(node):
    return [h for h in range(1, node.height + 1)
            if (b := node.parts.block_store.load_block(h)) is not None and b.evidence]


def test_prevote_equivocation_slashed_end_to_end(tmp_path):
    gen, privs = make_genesis(4, chain_id="byz-chain")
    pvs = make_privvals(privs[:3], root=str(tmp_path))
    byz = privs[3]  # its node never runs; the key equivocates
    byz_addr = byz.pub_key().address()

    async def main():
        nodes = [_mk_node(gen, pvs[i], i) for i in range(3)]
        for n in nodes:
            await n.start()
        try:
            await _connect_all(nodes)
            await _wait(lambda: all(n.height >= 1 for n in nodes), 60, "height 1")
            target = nodes[0]
            byz_idx, byz_val = gen.validator_set().get_by_address(byz_addr)
            assert byz_idx >= 0
            peer = next(iter(target.switch.peers.values()))
            reactor = target.switch.reactor("consensus")
            # the round may move between reading it and delivery: inject
            # at the then-current height and round until the conflict
            # registers
            for _ in range(100):
                if target.parts.evpool.pending_evidence(1 << 20):
                    break
                rs = target.parts.cs.rs
                for v in chaingen.equivocating_votes(byz, byz_idx, gen.chain_id, rs.height, rs.round):
                    reactor.receive(VOTE_CHANNEL, peer, encode_vote_msg(v))
                await asyncio.sleep(0.1)
            else:
                raise TimeoutError("evidence never formed")
            await _wait(lambda: all(n.parts.evpool.pending_evidence(1 << 20)
                                    or _records(n, MISBEHAVIOR_DUPLICATE_VOTE, byz_addr) for n in nodes),
                        30, "evidence gossip")
            await _wait(lambda: all(_records(n, MISBEHAVIOR_DUPLICATE_VOTE, byz_addr) for n in nodes),
                        60, "misbehavior at apps")
            for n in nodes:
                assert _records(n, MISBEHAVIOR_DUPLICATE_VOTE, byz_addr)[0][3] == byz_val.voting_power
            assert _evidence_blocks(nodes[0]), "evidence never landed in a committed block"
        finally:
            for n in nodes:
                await n.stop()

    run(main())


def test_lca_evidence_internal_consistency_enforced():
    """A genuine commit (real >2/3 signatures over the real block) under
    a fabricated header is refused (reference evidence ValidateBasic ->
    LightBlock.ValidateBasic, types/evidence.go:385): accepting it
    would prove an attack by the honest signers. So is a common height
    above the conflicting block's."""
    import dataclasses

    from cometbft_tpu_torch.evidence.types import LightClientAttackEvidence

    gen, privs = make_genesis(4, chain_id="lca-forge")
    src = chaingen.make_chain(gen, privs, 8, device=CPU)
    evpool = src.evpool
    real = src.block_store.load_block(5)
    real_commit = src.block_store.load_seen_commit(5)
    vs = src.state_store.load_validators(5)

    lb = LightBlock(header=dataclasses.replace(real.header, app_hash=b"\x55" * 32),
                    commit=real_commit, validator_set=vs)
    ev = LightClientAttackEvidence(conflicting_block=lb, common_height=4,
                                   total_voting_power=vs.total_voting_power(), timestamp_ns=time.time_ns())
    ev.byzantine_validators = ev.byzantine_from(src.state_store.load_validators(4))
    with pytest.raises(EvidenceError, match="invalid conflicting"):
        evpool.add_evidence(ev)

    real_lb = LightBlock(header=real.header, commit=real_commit, validator_set=vs)
    ev2 = LightClientAttackEvidence(conflicting_block=real_lb, common_height=7,
                                    total_voting_power=vs.total_voting_power(), timestamp_ns=time.time_ns())
    with pytest.raises(EvidenceError):
        evpool.add_evidence(ev2)


def test_light_client_attack_slashed_end_to_end(tmp_path):
    """Two of four validators (half the power: enough for a lunatic fork
    to pass non-adjacent trusting verification) sign a forged header
    with a claimed set of the two. A light client whose primary serves
    the fork verifies it, finds the divergence against an honest
    witness and reports evidence with the derived byzantine set to the
    witness, whose node verifies, gossips and commits it; every app
    records LIGHT_CLIENT_ATTACK with both attackers' powers (reference
    light/detector.go:98, evidence/verify.go:124-136)."""
    gen, privs = make_genesis(4, chain_id="byz-lca")
    pvs = make_privvals(privs[:3], root=str(tmp_path))
    byz = [privs[2], privs[3]]  # privs[3]'s node never runs
    byz_addrs = {p.pub_key().address() for p in byz}
    attack_h = 3

    async def main():
        nodes = [_mk_node(gen, pvs[i], i) for i in range(3)]
        for n in nodes:
            await n.start()
        try:
            await _connect_all(nodes)
            await _wait(lambda: all(n.height >= 4 for n in nodes), 90, "height 4")
            forged = chaingen.conflicting_block(nodes[0].parts, privs, attack_h, byz)
            honest0 = StoreBackedProvider(gen.chain_id, nodes[0].parts.block_store, nodes[0].parts.state_store)

            class ForgingPrimary(StoreBackedProvider):
                """Honest until asked for the attack height."""

                def light_block(self, height):
                    return forged if height == attack_h else honest0.light_block(height)

            handed = []

            class Witness(StoreBackedProvider):
                """Node 1's stores; evidence goes to node 1 in process."""

                def report_evidence(self, ev):
                    super().report_evidence(ev)
                    handed.append(asyncio.ensure_future(nodes[1].add_evidence(ev)))

            p1 = nodes[1].parts
            primary = ForgingPrimary(gen.chain_id, p1.block_store, p1.state_store)
            witness = Witness(gen.chain_id, p1.block_store, p1.state_store)
            trust = nodes[0].parts.block_store.load_block(1)
            lc = Client(gen.chain_id, TrustOptions(period_ns=3600 * 10**9, height=1, hash=trust.hash()),
                        primary, witnesses=[witness], device=CPU)
            with pytest.raises(DivergenceError) as exc:
                lc.verify_light_block_at_height(attack_h)
            ev = exc.value.evidence
            assert bytes(ev.conflicting_block.hash()) == bytes(forged.header.hash())
            assert {v.address for v in ev.byzantine_validators} == byz_addrs
            assert [e.hash() for e in witness.reported] == [ev.hash()]
            await asyncio.gather(*handed)

            def lca_at_apps():
                return all(all(_records(n, MISBEHAVIOR_LIGHT_CLIENT_ATTACK, a) for a in byz_addrs) for n in nodes)

            await _wait(lambda: any(n.parts.evpool.pending_evidence(1 << 20) for n in nodes) or lca_at_apps(),
                        30, "evidence at nodes")
            await _wait(lca_at_apps, 60, "LCA misbehavior at apps")
            vs = gen.validator_set()
            for n in nodes:
                for a in byz_addrs:
                    assert _records(n, MISBEHAVIOR_LIGHT_CLIENT_ATTACK, a)[0][3] == vs.get_by_address(a)[1].voting_power
            assert _evidence_blocks(nodes[0]), "LCA evidence never landed in a committed block"
            assert all(n.evidence_reactor.retry_pending() == 0 for n in nodes)
        finally:
            for n in nodes:
                await n.stop()

    run(main())


# --- a mixed net --------------------------------------------------------------


def _jax_privvals(privs, root):
    out = []
    for i, p in enumerate(privs):
        d = os.path.join(root, f"jpv{i}")
        os.makedirs(d)
        pv_ = JFilePV(JPriv.from_seed(p.seed), os.path.join(d, "key.json"), os.path.join(d, "state.json"))
        pv_.save_key()
        pv_.save_state()
        out.append(pv_)
    return out


def test_mixed_net_commits_evidence_from_either_package(tmp_path):
    """Two port nodes and two JAX nodes, one 4-validator net over TCP.
    Evidence handed to a JAX node's pool (a duplicate vote by
    validator 3, a JAX node's key) is gossiped to the port nodes and
    committed, and the port nodes follow the chain through that block;
    a lunatic fork of a committed height signed by validators 2 and 3,
    handed to a port node, is committed by the JAX nodes too."""
    gen, privs = make_genesis(4, chain_id="mixed-evidence", seed=13)
    jgen = JGenesisDoc.from_json(gen.to_json())
    ppvs = make_privvals(privs[:2], root=str(tmp_path))
    jpvs = _jax_privvals(privs[2:], str(tmp_path))
    vs = gen.validator_set()

    def jcfg(i):
        c = jtest_config(".")
        c.base.moniker = f"jax{i}"
        c.blocksync.enable = False
        c.p2p.laddr = "tcp://127.0.0.1:0"
        c.p2p.pex = False
        c.rpc.laddr = ""
        return c

    async def main():
        nodes = [_mk_node(gen, p, i) for i, p in enumerate(ppvs)]
        nodes += [JNode(jcfg(i), jgen, privval=p) for i, p in enumerate(jpvs)]
        for n in nodes:
            await n.start()
        try:
            await _connect_all(nodes)
            assert all(n.switch.num_peers() == 3 for n in nodes)
            await _wait(lambda: all(n.height >= 3 for n in nodes), 60, "height 3")

            # a JAX node's evidence
            a, b = chaingen.equivocating_votes(privs[3], vs.get_by_address(privs[3].pub_key().address())[0],
                                               gen.chain_id, 2, 0)
            dup = DuplicateVoteEvidence.from_votes(a, b, 10, vs.total_voting_power(), time.time_ns())
            nodes[2].parts.evpool.add_evidence(jev.decode_evidence(dup.encode()))
            addr3 = privs[3].pub_key().address()
            await _wait(lambda: all(_records(n, MISBEHAVIOR_DUPLICATE_VOTE, addr3) for n in nodes),
                        60, "the JAX node's evidence at every app")

            # a port node's evidence
            fork = chaingen.conflicting_block(nodes[0].parts, privs, 2, privs[2:])
            lca = chaingen.light_attack(nodes[0].parts, fork, 1)
            await nodes[0].add_evidence(lca)
            byz = {p.pub_key().address() for p in privs[2:]}
            await _wait(lambda: all(all(_records(n, MISBEHAVIOR_LIGHT_CLIENT_ATTACK, x) for x in byz) for n in nodes),
                        60, "the port node's evidence at every app")

            top = min(n.height for n in nodes)
            for h in range(1, top + 1):
                assert len({n.block_id_hash_at(h) for n in nodes}) == 1, h
            assert len({tuple(r for r in n.parts.app.misbehavior_seen if r[0] <= top) for n in nodes}) == 1
            carried = _evidence_blocks(nodes[0])
            assert carried and carried == _evidence_blocks(nodes[2])
            assert all(n.parts.cs.loop_errors.count == 0 for n in nodes[:2])

            # a port node joins by blocksync over TCP through the
            # evidence blocks
            cfg = make_test_cfg(".")
            cfg.base.moniker = "joiner"
            joiner = Node(cfg, gen, device=CPU)
            nodes.append(joiner)
            await joiner.start()
            for n in nodes[:4]:
                await joiner.dial(n.listen_addr)
            await _wait(lambda: joiner.height >= top, 60, "the joiner at the net's height")
            assert all(joiner.block_id_hash_at(h) == nodes[0].block_id_hash_at(h) for h in range(1, top + 1))
            seen = [r for r in joiner.parts.app.misbehavior_seen if r[0] <= top]
            assert seen == [r for r in nodes[0].parts.app.misbehavior_seen if r[0] <= top]
            assert {r[0] for r in seen} == set(carried) - {h for h in carried if h > top}
        finally:
            for n in nodes:
                await n.stop()

    run(main(), timeout=200)
