"""The slice as a whole: blocksync replay, port against JAX package.

One genesis (7 validators, seeded keys, a fixed genesis time) builds a
40-block chain with 2 txs a block and one ``val:`` update mid-chain,
once with each package's ``make_chain``:

- every height's encoded block, block hash, seen commit, stored
  FinalizeBlock response, and the final state are byte-identical;
- the JAX package's chain, moved into a port block store as bytes
  (JAX ``codec.encode_block`` -> port ``codec.decode_block``), replays
  through the port's ``BlockSyncReactor`` on ``device="cpu"`` to the
  same state at every height as the JAX package's own replay of it:
  app hash, results hash, validator-set hashes, last block ID, and the
  block store's height;
- with a tampering peer that served the first windows, both replays
  refetch the same heights, ban the same peer and end in the same
  state, and the store holds the honest block;
- a node rebuilt over a replayed sqlite store, its app fresh, replays
  the stored blocks through the handshake to the same app hash.

Exact equality everywhere: these are hashes and verdicts. Waits have
deadlines; the refusal scenario rests on a prefilled pool, not on
fetch timing.
"""

import asyncio

import pytest
import torch

from cometbft_tpu.blocksync.reactor import BlockSyncReactor as JReactor
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.node.inprocess import build_node as jbuild_node
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.utils import chaingen, codec
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
GENESIS_TIME_NS = 1_700_000_000_000_000_000
N_BLOCKS = 40
TXS = 2
VAL_UPDATE_AT = 20
WINDOW = 8
BAD_HEIGHT = 5


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def _val_tx(priv) -> bytes:
    return b"val:" + priv.pub_key().key_bytes.hex().encode() + b"!5"


@pytest.fixture(scope="module")
def chains():
    """(port genesis, JAX genesis, port-built chain, JAX-built chain)."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(7, chain_id="replay-parity", genesis_time_ns=GENESIS_TIME_NS, seed=11)
        newv = Ed25519PrivKey.from_seed(b"\x07" * 32)
        src = chaingen.make_chain(gen, privs, VAL_UPDATE_AT, txs_per_block=TXS, device=CPU)
        src.mempool.check_tx(_val_tx(newv))
        chaingen.make_chain(gen, privs + [newv], N_BLOCKS - VAL_UPDATE_AT, txs_per_block=TXS, node=src)

        jgen = JGenesisDoc.from_json(gen.to_json())
        jprivs = [JPriv.from_seed(p.seed) for p in privs + [newv]]
        jsrc = jchaingen.make_chain(jgen, jprivs[:-1], VAL_UPDATE_AT, txs_per_block=TXS)
        jsrc.mempool.check_tx(_val_tx(newv))
        jchaingen.make_chain(jgen, jprivs, N_BLOCKS - VAL_UPDATE_AT, txs_per_block=TXS, node=jsrc)
    finally:
        pv.set_engine(None)
        eng.close()
    return gen, jgen, src, jsrc


def _state_row(st):
    return (
        st.last_block_height,
        bytes(st.app_hash),
        bytes(st.last_results_hash),
        st.validators.hash(),
        st.next_validators.hash(),
        st.last_block_id.key(),
    )


def _record_states(node, rows):
    """Every state the node's executor produces, as a comparable row."""
    real = node.block_exec.apply_verified_block

    def wrapped(state, bid, block):
        st = real(state, bid, block)
        rows.append(_state_row(st))
        return st

    node.block_exec.apply_verified_block = wrapped


def _port_store_from_jax(gen, jsrc):
    """A port node whose block store holds the JAX package's chain,
    moved as bytes."""
    node = build_node(gen, device=CPU)
    for h in range(1, jsrc.block_store.height() + 1):
        blk = codec.decode_block(jcodec.encode_block(jsrc.block_store.load_block(h)))
        seen = codec.decode_commit(jcodec.encode_commit(jsrc.block_store.load_seen_commit(h)))
        node.block_store.save_block(blk, PartSet.from_data(blk._raw_bytes), seen)
    return node


PORT = {
    "build": lambda gen: build_node(gen, device=CPU),
    "reactor": lambda *a, **kw: BlockSyncReactor(*a, device=CPU, **kw),
    "store_peer": chaingen.StorePeerClient,
    "tamper_peer": chaingen.TamperingPeerClient,
}
JAX = {
    "build": lambda gen: jbuild_node(gen, None),
    "reactor": JReactor,
    "store_peer": jchaingen.StorePeerClient,
    "tamper_peer": jchaingen.TamperingPeerClient,
}


def _same_rows(rows, jrows):
    """Both replays applied at least every height but the last two, and
    agree on every height both applied (the caught-up check runs
    between windows, so one may stop a height short of the other)."""
    n = min(len(rows), len(jrows))
    assert n >= N_BLOCKS - 2
    assert [r[0] for r in rows[:n]] == list(range(1, n + 1))
    assert rows[:n] == jrows[:n]


def _replay(pkg, gen, src, tamper_at=None):
    """Replay ``src`` into a fresh node of ``pkg``; returns (node,
    reactor, per-height state rows, redo_request calls, banned peers).
    With ``tamper_at``, a tampering peer alone fills the pool (every
    pending height) before the honest peer joins and the loop starts,
    so which peer served which height does not depend on timing."""
    top = src.block_store.height()

    async def main():
        fresh = pkg["build"](gen)
        rows = []
        _record_states(fresh, rows)
        caught = asyncio.Event()
        reactor = pkg["reactor"](
            fresh.state,
            fresh.block_exec,
            fresh.block_store,
            on_caught_up=lambda st: caught.set(),
            verify_window=WINDOW,
        )
        pool = reactor.pool
        redos = []
        real_redo = pool.redo_request

        def redo(height, ban_peer):
            redos.append((height, ban_peer))
            real_redo(height, ban_peer)

        pool.redo_request = redo
        loop = asyncio.get_running_loop()
        if tamper_at is not None:
            pool.set_peer_range("evil", pkg["tamper_peer"](src, tamper_at), 1, top)
            want = min(pool.max_pending, top)
            deadline = loop.time() + 60
            while len(pool.blocks) < want:
                assert loop.time() < deadline, f"prefill: {len(pool.blocks)} of {want}"
                await asyncio.sleep(0.01)
            assert {peer for _, peer in pool.blocks.values()} == {"evil"}
        pool.set_peer_range("good", pkg["store_peer"](src), 1, top)
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 90)
        banned = sorted(pool.banned_peers())
        await reactor.stop()
        return fresh, reactor, rows, redos, banned

    return run(main())


def test_make_chain_is_byte_identical_to_jax(chains):
    gen, jgen, src, jsrc = chains
    assert src.block_store.height() == jsrc.block_store.height() == N_BLOCKS
    for h in range(1, N_BLOCKS + 1):
        blk, jblk = src.block_store.load_block(h), jsrc.block_store.load_block(h)
        assert codec.encode_block(blk) == jcodec.encode_block(jblk), h
        assert blk.hash() == jblk.hash()
        assert codec.encode_commit(src.block_store.load_seen_commit(h)) == jcodec.encode_commit(
            jsrc.block_store.load_seen_commit(h)
        )
        assert src.state_store.load_finalize_block_response(
            h
        ) == jsrc.state_store.load_finalize_block_response(h)
    assert _state_row(src.state) == _state_row(jsrc.state)
    assert _state_row(src.state_store.load()) == _state_row(jsrc.state_store.load())
    # the update, in block 21, adds an eighth validator from height 23
    assert src.state.validators.size() == 8
    hdr = [src.block_store.load_block(VAL_UPDATE_AT + d).header for d in (1, 2, 3)]
    assert hdr[0].validators_hash == hdr[1].validators_hash != hdr[2].validators_hash


def test_replay_of_jax_chain_matches_jax_replay(chains):
    gen, jgen, _, jsrc = chains
    ported = _port_store_from_jax(gen, jsrc)
    fresh, reactor, rows, redos, banned = _replay(PORT, gen, ported)
    jfresh, jreactor, jrows, jredos, jbanned = _replay(JAX, jgen, jsrc)
    assert reactor.loop_errors.count == 0, reactor.loop_errors
    _same_rows(rows, jrows)
    assert fresh.block_store.height() >= N_BLOCKS - 2
    assert jfresh.block_store.height() >= N_BLOCKS - 2
    assert redos == jredos == [] and banned == jbanned == []
    # the state after h is what the source's header h+1 committed to
    for height, app_hash, results_hash, vals_hash, _, _ in rows:
        hdr = jsrc.block_store.load_block(height + 1).header
        assert (app_hash, results_hash, vals_hash) == (
            hdr.app_hash,
            hdr.last_results_hash,
            hdr.validators_hash,
        )


def test_refusals_match_jax(chains):
    gen, jgen, src, jsrc = chains
    fresh, reactor, rows, redos, banned = _replay(PORT, gen, src, tamper_at=BAD_HEIGHT)
    jfresh, jreactor, jrows, jredos, jbanned = _replay(JAX, jgen, jsrc, tamper_at=BAD_HEIGHT)
    assert reactor.loop_errors.count == 0, reactor.loop_errors
    assert redos == jredos == [(BAD_HEIGHT, "evil")]
    assert banned == jbanned == ["evil"]
    _same_rows(rows, jrows)
    for h in (BAD_HEIGHT - 1, BAD_HEIGHT, BAD_HEIGHT + 1, N_BLOCKS - 2):
        assert codec.encode_block(fresh.block_store.load_block(h)) == codec.encode_block(
            src.block_store.load_block(h)
        ), h
    # departure (ROADMAP C4): the JAX package's window flush stored the
    # tampered block before refusing it; its header hash is the honest
    # one, its txs are the peer's
    jstored = jfresh.block_store.load_block(BAD_HEIGHT)
    assert jstored.hash() == jsrc.block_store.load_block(BAD_HEIGHT).hash()
    assert jstored.data.txs[-1] == b"evil=1"


def test_restart_replays_store_through_handshake(chains, tmp_path):
    """A replayed sqlite node, rebuilt with a fresh app, replays every
    stored block through the handshake and lands on the same app hash
    and state as before."""
    gen, _, src, _ = chains
    home = str(tmp_path / "node")

    async def main():
        fresh = build_node(gen, db_backend="sqlite", home=home, device=CPU)
        caught = asyncio.Event()
        reactor = BlockSyncReactor(
            fresh.state,
            fresh.block_exec,
            fresh.block_store,
            on_caught_up=lambda st: caught.set(),
            verify_window=WINDOW,
            device=CPU,
        )
        reactor.pool.set_peer_range(
            "src", chaingen.StorePeerClient(src), 1, src.block_store.height()
        )
        await reactor.start()
        await asyncio.wait_for(caught.wait(), 90)
        await reactor.stop()
        return fresh

    fresh = run(main())
    before = _state_row(fresh.state_store.load())
    app_hash = fresh.app.app_hash
    fresh.close_stores()
    again = build_node(gen, db_backend="sqlite", home=home, device=CPU)
    try:
        assert again.app.height == again.block_store.height() == before[0]
        assert again.app.app_hash == app_hash
        assert _state_row(again.state) == before
    finally:
        again.close_stores()
