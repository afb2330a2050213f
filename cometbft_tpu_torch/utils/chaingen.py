"""Chain generator: a valid chain built directly, without consensus.

A copy of the JAX package's ``utils/chaingen.py``. Each block is made
by the node's executor, signed by every validator's key (precommits
over the canonical sign bytes) and applied through the executor, so
the product is a valid chain that replay can take. ``StorePeerClient``
serves a node's stored blocks as a blocksync peer;
``TamperingPeerClient`` adds a tx to one height's block.
``RotatingLightProvider`` mints light blocks on demand over validator
sets that rotate by epoch, the shape of BASELINE config 4's bisection
(the JAX package's ``bench.py::bench_bisect``). ``ValidatorStubs``
plays a chain's validators against a node's consensus state machine
(reference consensus/common_test.go ``validatorStub`` and
``signAddVotes``): a test harness, not a feature of the node.
``StubPeer`` carries the stubs' messages to a node over the wire: a
p2p switch with a harness reactor on the consensus channels, which
sends each message encoded by the consensus reactor's own codec.
``conflicting_block``, ``light_attack`` and ``equivocating_votes``
make the Byzantine side's evidence: a fork of a committed height
signed by some of its validators, the light-client-attack evidence
against it, and two conflicting votes by one key.
"""

from __future__ import annotations

import asyncio
import dataclasses
import struct
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..config.config import P2PConfig
from ..evidence.reactor import EVIDENCE_CHANNEL, EvidenceReactor
from ..evidence.types import LightClientAttackEvidence, decode_evidence
from ..consensus.reactor import (
    DATA_CHANNEL,
    MSG_HAS_VOTE,
    VOTE_CHANNEL,
    ConsensusReactor,
    encode_block_part_msg,
    encode_proposal_msg,
    encode_vote_msg,
)
from ..light.provider import Provider
from ..light.types import LightBlock
from ..node.inprocess import NodeParts, build_node
from ..p2p import NodeInfo, NodeKey, Reactor, Switch, TCPTransport
from ..types.block import BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig, Header, PartSetHeader
from ..types.genesis import GenesisDoc
from ..types.validator_set import Validator, ValidatorSet
from ..types.part_set import Part, PartSet
from ..types.vote import PRECOMMIT, PREVOTE, Proposal, Vote
from ..types.vote_set import VoteSet
from ..utils import codec

# the stubs' blocks are this far apart in time, as make_chain's
STUB_STEP_NS = 1_000_000_000
# play_height's deadline for one height, and how often it looks
PLAY_TIMEOUT_S = 60.0
PLAY_POLL_S = 0.0005


def make_chain(
    genesis: GenesisDoc,
    privs,
    n_blocks: int,
    txs_per_block: int = 1,
    node: Optional[NodeParts] = None,
    device=None,
) -> NodeParts:
    """A NodeParts whose stores hold ``n_blocks`` more blocks; a new
    node on ``device`` unless ``node`` is given."""
    node = node or build_node(genesis, device=device)
    state = node.state_store.load()
    chain_id = state.chain_id
    # block times strictly increasing and in the past: 1 s a block when
    # the genesis backdate allows it, else a shorter step that still
    # ends 60 s before now
    now = time.time_ns()
    margin_ns = 60 * 1_000_000_000
    t = state.last_block_time_ns or (now - margin_ns - (n_blocks + 1) * 1_000_000_000)
    step_ns = 1_000_000_000
    if t + (n_blocks + 1) * step_ns > now - margin_ns:
        step_ns = max(1, (now - margin_ns - t) // (n_blocks + 1))
    addr_to_priv = {p.pub_key().address(): p for p in privs}
    for h in range(state.last_block_height + 1, state.last_block_height + 1 + n_blocks):
        proposer = state.validators.get_proposer()
        last_commit = node.block_store.load_seen_commit(h - 1) if h > state.initial_height else None
        for i in range(txs_per_block):
            node.mempool.check_tx(b"h%d_%d=v%d" % (h, i, h))
        t += step_ns
        block, parts = node.block_exec.create_proposal_block(
            h, state, last_commit, proposer.address, time_ns=t
        )
        bid = BlockID(block.hash(), parts.header)
        sigs = []
        for i, val in enumerate(state.validators.validators):
            vote = Vote(
                type_=PRECOMMIT,
                height=h,
                round=0,
                block_id=bid,
                timestamp_ns=t,
                validator_address=val.address,
                validator_index=i,
            )
            sigs.append(
                CommitSig(
                    block_id_flag=BLOCK_ID_FLAG_COMMIT,
                    validator_address=val.address,
                    timestamp_ns=t,
                    signature=addr_to_priv[val.address].sign(vote.sign_bytes(chain_id)),
                )
            )
        commit = Commit(height=h, round=0, block_id=bid, signatures=sigs)
        node.block_store.save_block(block, parts, commit)
        state = node.block_exec.apply_verified_block(state, bid, block)
    node.state = state
    return node


class StorePeerClient:
    """A blocksync peer serving a node's stored blocks (the in-memory
    stand-in for a network peer)."""

    def __init__(self, node: NodeParts, delay_s: float = 0.0):
        self.node = node
        self.delay_s = delay_s

    @property
    def base(self) -> int:
        return self.node.block_store.base()

    @property
    def height(self) -> int:
        return self.node.block_store.height()

    async def request_block(self, height: int):
        if self.delay_s:
            await asyncio.sleep(self.delay_s)
        blk = self.node.block_store.load_block(height)
        if blk is not None:
            # the extended commit travels beside the block, as on the wire
            ec = self.node.block_store.load_extended_commit(height)
            if ec:
                blk._ec_bytes = ec
        return blk


class TamperingPeerClient(StorePeerClient):
    """Serves a corrupted block at one height (bad-peer testing)."""

    def __init__(self, node, bad_height: int):
        super().__init__(node)
        self.bad_height = bad_height

    async def request_block(self, height: int):
        blk = await super().request_block(height)
        if blk is not None and height == self.bad_height:
            blk.data.txs = list(blk.data.txs) + [b"evil=1"]
            blk.data._hash = None
            if hasattr(blk, "_raw_bytes"):  # decoded objects are immutable
                del blk._raw_bytes
        return blk


# the app hash a conflicting block's header claims
FORK_APP_HASH = b"\x66" * 32


def conflicting_block(node: NodeParts, privs, height: int, signers=None) -> LightBlock:
    """A block that conflicts with ``node``'s committed block at
    ``height``: its header with ``FORK_APP_HASH``, under a commit
    for it. ``signers=None``: every validator of the height signs, with
    the height's own set (an equivocation fork); else the keys in
    ``signers`` sign and the header claims a set of just them, at
    their powers (a lunatic fork). ``privs``: the keys, raw."""
    real = node.block_store.load_block(height).header
    vals = node.state_store.load_validators(height)
    if signers is not None:
        chosen = {p.pub_key().address() for p in signers}
        vals = ValidatorSet([v for v in vals.validators if v.address in chosen])
    header = dataclasses.replace(
        real, app_hash=FORK_APP_HASH, validators_hash=vals.hash(), next_validators_hash=vals.hash()
    )
    bid = BlockID(header.hash(), PartSetHeader(1, header.hash()))
    by_addr = {p.pub_key().address(): p for p in privs}
    sigs = []
    for i, val in enumerate(vals.validators):
        vote = Vote(
            type_=PRECOMMIT, height=height, round=0, block_id=bid,
            timestamp_ns=header.time_ns, validator_address=val.address, validator_index=i,
        )
        sigs.append(
            CommitSig(
                block_id_flag=BLOCK_ID_FLAG_COMMIT,
                validator_address=val.address,
                timestamp_ns=header.time_ns,
                signature=by_addr[val.address].sign(vote.sign_bytes(header.chain_id)),
            )
        )
    return LightBlock(header, Commit(height=height, round=0, block_id=bid, signatures=sigs), vals)


def light_attack(node: NodeParts, block: LightBlock, common_height: int,
                 timestamp_ns: int = 0) -> LightClientAttackEvidence:
    """Light-client-attack evidence against ``block`` from
    ``common_height``, with the byzantine set and total power derived
    from ``node``'s validator set at that height, as the light
    client's detector builds it."""
    common = node.state_store.load_validators(common_height)
    ev = LightClientAttackEvidence(
        conflicting_block=block,
        common_height=common_height,
        total_voting_power=common.total_voting_power(),
        timestamp_ns=timestamp_ns or block.header.time_ns,
    )
    ev.byzantine_validators = ev.byzantine_from(common)
    return ev


def equivocating_votes(priv, index: int, chain_id: str, height: int, round_: int,
                       time_ns: int = 0) -> Tuple[Vote, Vote]:
    """Two prevotes by ``priv`` (the validator at ``index``) for the
    same height and round but two made-up blocks, each signed: an
    equivocation, not a forgery."""
    votes = []
    for tag in (b"\xaa", b"\xbb"):
        v = Vote(
            type_=PREVOTE, height=height, round=round_,
            block_id=BlockID(tag * 32, PartSetHeader(1, tag * 32)),
            timestamp_ns=time_ns or time.time_ns(),
            validator_address=priv.pub_key().address(), validator_index=index,
        )
        v.signature = priv.sign(v.sign_bytes(chain_id))
        votes.append(v)
    return votes[0], votes[1]


class RotatingLightProvider(Provider):
    """Mints a signed light block at any height on demand (the
    reference's light bench shape, light/client_benchmark_test.go:
    bisection checks commits and validator-set hashes between hops,
    not the hash chain). The set signing height h is the ``n_vals``
    keys ``keys[e * shift : e * shift + n_vals]`` of epoch ``e = h //
    epoch``, each of power 10; header h's time is ``t0_ns + h`` s.

    Adversaries for refusal checks: ``forge_at`` heights carry one
    signature (the first lane) with a byte flipped; ``app_hash`` set
    makes a fork that is valid in itself (the same signers over other
    headers). ``fetched`` lists the heights served, in order."""

    def __init__(self, chain_id, keys, n_vals, epoch, shift, t0_ns, forge_at=(), app_hash=b""):
        self.chain_id = chain_id
        self.keys = list(keys)
        self.n_vals, self.epoch, self.shift = n_vals, epoch, shift
        self.t0_ns = t0_ns
        self.forge_at = set(forge_at)
        self.app_hash = app_hash
        self.fetched: list = []
        self.reported: list = []
        self._sets: dict = {}
        self._by_addr = {k.pub_key().address(): k for k in self.keys}

    def vals_at(self, height: int) -> ValidatorSet:
        e = height // self.epoch
        if e not in self._sets:
            window = self.keys[e * self.shift : e * self.shift + self.n_vals]
            self._sets[e] = ValidatorSet([Validator(k.pub_key(), 10) for k in window])
        return self._sets[e]

    def light_block(self, height: int) -> LightBlock:
        self.fetched.append(height)
        vals = self.vals_at(height)
        header = Header(
            chain_id=self.chain_id,
            height=height,
            time_ns=self.t0_ns + height * 1_000_000_000,
            validators_hash=vals.hash(),
            next_validators_hash=self.vals_at(height + 1).hash(),
            app_hash=self.app_hash,
        )
        bid = BlockID(header.hash(), PartSetHeader(1, header.hash()))
        sigs = []
        for i, val in enumerate(vals.validators):
            vote = Vote(
                type_=PRECOMMIT,
                height=height,
                round=0,
                block_id=bid,
                timestamp_ns=header.time_ns,
                validator_address=val.address,
                validator_index=i,
            )
            sig = self._by_addr[val.address].sign(vote.sign_bytes(self.chain_id))
            if i == 0 and height in self.forge_at:
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            sigs.append(
                CommitSig(
                    block_id_flag=BLOCK_ID_FLAG_COMMIT,
                    validator_address=val.address,
                    timestamp_ns=header.time_ns,
                    signature=sig,
                )
            )
        return LightBlock(header, Commit(height=height, round=0, block_id=bid, signatures=sigs), vals)

    def report_evidence(self, ev) -> None:
        self.reported.append(ev)


@dataclass
class StubHeight:
    """What the stubs send for one height: the proposal (signed by the
    round's proposer), its block parts, a prevote and a precommit from
    every validator (``forged`` lanes of the precommits carry a
    corrupted signature), and the block the proposal names."""

    height: int
    round: int
    proposal: Proposal
    parts: List[Part]
    prevotes: List[Vote]
    precommits: List[Vote]
    block: object
    part_set: PartSet
    forged: tuple = ()


class ValidatorStubs:
    """Every validator of ``shadow``'s chain, with their keys: the
    stubs extend the shadow chain one height at a time. ``messages(h)``
    makes height h's block on the shadow node's executor from its
    state (its mempool's txs included), the proposal and its parts,
    and the votes, each validator signing with its own key (vote
    extensions, the kvstore's ``ext|h|`` content, when the chain has
    them on); ``finish(m)`` commits the block on the shadow with the
    commit the stubs' own valid precommits make (a forged lane is
    absent), so the next height's LastCommit is the stubs' view.
    ``play_height`` feeds one height to a node's state machine and
    waits for it to store the block."""

    def __init__(self, shadow: NodeParts, privs):
        self.shadow = shadow
        self.by_addr = {p.pub_key().address(): p for p in privs}

    @property
    def chain_id(self) -> str:
        return self.shadow.state.chain_id

    def messages(self, height: int, round_: int = 0, forge=()) -> StubHeight:
        state = self.shadow.state
        if height != state.last_block_height + 1:
            raise ValueError(f"the shadow chain is at {state.last_block_height}, not {height - 1}")
        vals = state.validators.copy()
        if round_:
            vals.increment_proposer_priority(round_)
        proposer = vals.get_proposer()
        last_commit = (
            self.shadow.block_store.load_seen_commit(height - 1)
            if height > state.initial_height
            else None
        )
        ec = None
        if height > state.initial_height and state.consensus_params.vote_extensions_enabled(height - 1):
            raw = self.shadow.block_store.load_extended_commit(height - 1)
            ec = codec.decode_extended_commit(raw) if raw else None
        t = (state.last_block_time_ns or time.time_ns()) + STUB_STEP_NS
        block, parts = self.shadow.block_exec.create_proposal_block(
            height, state, last_commit, proposer.address, time_ns=t, extended_commit=ec
        )
        bid = BlockID(block.hash(), parts.header)
        prop = Proposal(height=height, round=round_, pol_round=-1, block_id=bid, timestamp_ns=t)
        prop.signature = self.by_addr[proposer.address].sign(prop.sign_bytes(self.chain_id))
        ext_on = state.consensus_params.vote_extensions_enabled(height)
        prevotes = self._votes(PREVOTE, height, round_, bid, t, False, ())
        precommits = self._votes(PRECOMMIT, height, round_, bid, t, ext_on, forge)
        return StubHeight(
            height=height,
            round=round_,
            proposal=prop,
            parts=[parts.get_part(i) for i in range(parts.header.total)],
            prevotes=prevotes,
            precommits=precommits,
            block=block,
            part_set=parts,
            forged=tuple(forge),
        )

    def _votes(self, type_, height, round_, bid, t, ext_on, forge) -> List[Vote]:
        out = []
        for i, val in enumerate(self.shadow.state.validators.validators):
            key = self.by_addr[val.address]
            v = Vote(
                type_=type_,
                height=height,
                round=round_,
                block_id=bid,
                timestamp_ns=t,
                validator_address=val.address,
                validator_index=i,
            )
            v.signature = key.sign(v.sign_bytes(self.chain_id))
            if ext_on:
                v.extension = b"ext|%d|" % height + bid.hash[:8]
                v.extension_signature = key.sign(v.extension_sign_bytes(self.chain_id))
            if i in forge:
                v.signature = bytes([v.signature[0] ^ 1]) + v.signature[1:]
            out.append(v)
        return out

    def finish(self, m: StubHeight):
        """Commit ``m``'s block on the shadow chain; returns the commit."""
        state = self.shadow.state
        vs = VoteSet(self.chain_id, m.height, m.round, PRECOMMIT, state.validators, verify_signatures=False)
        for i, v in enumerate(m.precommits):
            if i not in m.forged:
                vs.add_vote(v)
        commit = vs.make_commit()
        if state.consensus_params.vote_extensions_enabled(m.height):
            self.shadow.block_store.save_extended_commit(
                m.height, codec.encode_extended_commit(vs.make_extended_commit())
            )
        self.shadow.block_store.save_block(m.block, m.part_set, commit)
        self.shadow.state = self.shadow.block_exec.apply_verified_block(
            state, commit.block_id, m.block
        )
        return commit

    async def play_height(
        self,
        cs,
        m: StubHeight,
        deliver: Optional[Callable] = None,
    ) -> dict:
        """Feed ``m`` to the state machine ``cs`` (started, at height
        ``m.height``) as peer messages: the proposal and its parts, then
        the prevotes once the block is complete, then the precommits
        once every prevote is in; wait until ``cs`` stores the block.
        ``deliver(kind, obj)`` enqueues one message (default: the
        port's message types, from peer ``"stubs"``). Returns walls in
        seconds, from the proposal's delivery: ``prevotes_in``,
        ``stored``; and ``queued`` before it."""
        from ..consensus.state import BlockPartMessage, ProposalMessage, VoteMessage

        if deliver is None:

            def deliver(kind, obj):
                payload = {
                    "proposal": lambda: ProposalMessage(obj),
                    "block_part": lambda: BlockPartMessage(m.height, m.round, obj),
                    "vote": lambda: VoteMessage(obj),
                }[kind]()
                cs.enqueue_nowait(kind, payload, "stubs")

        loop = asyncio.get_running_loop()
        deadline = loop.time() + PLAY_TIMEOUT_S

        async def until(cond, what):
            while not cond():
                if loop.time() > deadline:
                    raise TimeoutError(f"height {m.height}: {what}")
                await asyncio.sleep(PLAY_POLL_S)

        t_q = time.perf_counter()
        await until(lambda: cs.rs.height == m.height and int(cs.rs.step) >= 3, "propose step")
        t0 = time.perf_counter()
        deliver("proposal", m.proposal)
        for part in m.parts:
            deliver("block_part", part)
        await until(lambda: cs.rs.proposal_block is not None, "the proposal's block")
        for v in m.prevotes:
            deliver("vote", v)
        n = len(m.prevotes)

        def prevotes_in():
            if cs.rs.height != m.height:
                return True
            return sum(v is not None for v in cs.rs.votes.prevotes(m.round).votes) == n

        await until(prevotes_in, "the prevote wave")
        t1 = time.perf_counter()
        for v in m.precommits:
            deliver("vote", v)
        await until(lambda: cs.block_store.height() >= m.height, "the block stored")
        t2 = time.perf_counter()
        return {"queued": t0 - t_q, "prevotes_in": t1 - t0, "stored": t2 - t0}


class StubConsensusReactor(Reactor):
    """The harness side of the consensus channels (0x20-0x22): claims
    them with the consensus reactor's descriptors, counts what the
    node sends back (its round steps, HasVote acknowledgements and vote
    relays) and answers nothing."""

    name = "consensus"
    get_channels = ConsensusReactor.get_channels

    def __init__(self) -> None:
        super().__init__()
        self.received: dict = {}  # message type byte -> count
        self.has_votes: set = set()  # (height, round, type, index) acknowledged

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        if not msg:
            return
        self.received[msg[0]] = self.received.get(msg[0], 0) + 1
        if msg[0] == MSG_HAS_VOTE:
            self.has_votes.add(struct.unpack(">qiBi", msg[1:]))


class StubEvidenceReactor(Reactor):
    """The harness side of the evidence channel (0x38): keeps every
    piece of evidence the node gossips to it, decoded, and checks
    nothing."""

    name = "evidence"
    get_channels = EvidenceReactor.get_channels

    def __init__(self) -> None:
        super().__init__()
        self.received: list = []

    def receive(self, chan_id: int, peer, msg: bytes) -> None:
        self.received.append(decode_evidence(msg))


class StubPeer:
    """The validator stubs as a peer on the wire (reference
    consensus/common_test.go ``validatorStub``, over p2p instead of
    straight into the state machine): a ``Switch`` on a TCP transport
    whose only reactor is a ``StubConsensusReactor``. ``connect(addr)``
    dials the node; ``deliver_for(m)`` is a ``play_height`` deliverer
    that sends height ``m``'s proposal and parts on the data channel
    and its votes on the vote channel, encoded by the consensus
    reactor's ``encode_proposal_msg``, ``encode_block_part_msg`` and
    ``encode_vote_msg``; ``send_votes`` re-sends votes, as a real
    peer's gossip routine re-sends the ones the node has not
    acknowledged. A ``StubEvidenceReactor`` holds the evidence channel:
    ``send_evidence`` sends a piece of evidence as a peer's evidence
    reactor does. ``switcher`` is the stack the stub speaks: ``"tcp"``,
    the p2p ``Switch`` over MConnection, or ``"lp2p"``, an
    ``lp2p.Lp2pSwitch`` (one mux stream a channel) for a node with
    ``p2p.use_libp2p_equivalent``; either at a node's default rates.
    With a ``tracer`` the stub stamps what it sends (origin ``stubs``)
    and records its send instants there, as a tracing node's switch
    does, so a node's ring can attribute the stubs' heights."""

    def __init__(self, chain_id: str, switcher: str = "tcp", tracer=None):
        self.node_key = NodeKey.generate()
        self.node_info = NodeInfo(node_id=self.node_key.node_id, network=chain_id, moniker="stubs")
        # a node's rates ([p2p] send_rate / recv_rate): MConnection's
        # own defaults are ten times lower, and the node's vote relays
        # back to the stub would pace the stub at them
        p2p = P2PConfig()
        transport = TCPTransport(self.node_key, self.node_info)
        if switcher == "lp2p":
            from ..lp2p import Lp2pSwitch

            # the stub's reactors only count: they take messages
            # inline, not through a worker pool
            self.switch = Lp2pSwitch(
                transport, self.node_info, use_autopool=False,
                send_rate=p2p.send_rate, recv_rate=p2p.recv_rate,
            )
        elif switcher == "tcp":
            self.switch = Switch(
                transport,
                self.node_info,
                mconn_config={
                    "send_rate": p2p.send_rate,
                    "recv_rate": p2p.recv_rate,
                    "flush_throttle_s": p2p.flush_throttle_ms / 1000.0,
                },
            )
        else:
            raise ValueError(f"unknown switcher {switcher!r}")
        if tracer is not None:
            self.switch.enable_stamping(tracer, "stubs")
        self.reactor = StubConsensusReactor()
        self.switch.add_reactor("consensus", self.reactor)
        self.evidence = StubEvidenceReactor()
        self.switch.add_reactor("evidence", self.evidence)
        self.peer = None

    async def connect(self, addr: str) -> None:
        await self.switch.start()
        self.peer = await self.switch.dial_peer(addr)

    def _send(self, chan_id: int, msg: bytes, kind: str = "", height: int = 0, round_: int = -1) -> None:
        if kind:
            msg = self.switch.stamp_msg(chan_id, msg, kind, height=height, round_=round_)
        if self.peer is None or not self.peer.try_send(chan_id, msg):
            raise ConnectionError("stub peer: the node's connection refused a message")

    def deliver_for(self, m: StubHeight) -> Callable:
        def deliver(kind, obj):
            if kind == "proposal":
                self._send(DATA_CHANNEL, encode_proposal_msg(obj), "proposal", m.height, m.round)
            elif kind == "block_part":
                self._send(DATA_CHANNEL, encode_block_part_msg(m.height, m.round, obj), "block_part", m.height,
                           m.round)
            else:
                self._send(VOTE_CHANNEL, encode_vote_msg(obj), "vote", obj.height, obj.round)

        return deliver

    def send_votes(self, votes) -> None:
        for v in votes:
            self._send(VOTE_CHANNEL, encode_vote_msg(v), "vote", v.height, v.round)

    def send_evidence(self, ev) -> None:
        self._send(EVIDENCE_CHANNEL, ev.encode())

    def acknowledged(self, v: Vote) -> bool:
        """Whether the node sent a HasVote for ``v``."""
        return (v.height, v.round, v.type_, v.validator_index) in self.reactor.has_votes

    @property
    def bytes_sent(self) -> int:
        return self.peer.send_total if self.peer is not None else 0

    async def stop(self) -> None:
        await self.switch.stop()
