"""Storage round trips, the local ABCI client and the kvstore app on the
port, held to the JAX package's (``tests/test_store_abci.py``).

The five cases the port's modules cover (the codec, the block store
with its pruning, the state store, the kvstore app's lifecycle and its
snapshots) run on both packages from the same inputs: validator keys
from ``np.random.default_rng`` seeds, the same blocks, votes, states
and txs. Each checks the reference's assertions on each package, and
every encoding, hash, app hash and snapshot chunk must be equal across
the two, byte for byte. (The reference file's evidence codec case is
ported in ``test_torch_evidence_blocks.py``.)
"""

import time
from types import SimpleNamespace

import numpy as np
import pytest

from cometbft_tpu import types as JT
from cometbft_tpu.abci import types as jabci
from cometbft_tpu.abci.client import AppConns as JAppConns
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.models.kvstore import KVStoreApplication as JKV
from cometbft_tpu.state import state_types as jstate_types
from cometbft_tpu.state import store as jstore
from cometbft_tpu.store import BlockStore as JBlockStore
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu.utils import kv as jkv
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.abci.client import AppConns as PAppConns
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey as PPriv
from cometbft_tpu_torch.models.kvstore import KVStoreApplication as PKV
from cometbft_tpu_torch.state import state_types as pstate_types
from cometbft_tpu_torch.state import store as pstore
from cometbft_tpu_torch.store.block_store import BlockStore as PBlockStore
from cometbft_tpu_torch.types import block as pblock
from cometbft_tpu_torch.types import part_set as ppart_set
from cometbft_tpu_torch.types import validator_set as pvalset
from cometbft_tpu_torch.types import vote as pvote
from cometbft_tpu_torch.utils import codec as pcodec
from cometbft_tpu_torch.utils import kv as pkv

NOW = int(time.time() * 1e9)
CHAIN = "store-chain"

PKGS = {
    "jax": SimpleNamespace(
        T=JT, abci=jabci, AppConns=JAppConns, Priv=JPriv, KV=JKV, state_types=jstate_types,
        store=jstore, BlockStore=JBlockStore, codec=jcodec, kv=jkv,
    ),
    "port": SimpleNamespace(
        T=SimpleNamespace(
            Header=pblock.Header, Data=pblock.Data, Commit=pblock.Commit, Block=pblock.Block,
            BlockID=pblock.BlockID, PartSetHeader=pblock.PartSetHeader, Vote=pvote.Vote,
            PRECOMMIT=pvote.PRECOMMIT, PartSet=ppart_set.PartSet, Validator=pvalset.Validator,
            ValidatorSet=pvalset.ValidatorSet,
        ),
        abci=pabci, AppConns=PAppConns, Priv=PPriv, KV=PKV, state_types=pstate_types,
        store=pstore, BlockStore=PBlockStore, codec=pcodec, kv=pkv,
    ),
}


def both(scenario, *args):
    got = {name: scenario(pkg, *args) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def valset(pkg, n, seed=11, power=100):
    """(ValidatorSet, private keys), keys from default_rng(seed)."""
    rng = np.random.default_rng(seed)
    privs = [pkg.Priv.from_seed(rng.bytes(32)) for _ in range(n)]
    return pkg.T.ValidatorSet([pkg.T.Validator(p.pub_key(), power) for p in privs]), privs


def make_block(pkg, vs, height, prev_bid, app_hash=b"\x01" * 32):
    T = pkg.T
    data = T.Data(txs=[b"k%d=v%d" % (height, height)])
    last_commit = T.Commit(height - 1, 0, prev_bid, []) if height > 1 else None
    header = T.Header(
        chain_id=CHAIN, height=height, time_ns=NOW + height, last_block_id=prev_bid,
        validators_hash=vs.hash(), next_validators_hash=vs.hash(), app_hash=app_hash,
        proposer_address=vs.validators[0].address, data_hash=data.hash(),
        last_commit_hash=last_commit.hash() if last_commit else b"",
    )
    return T.Block(header=header, data=data, last_commit=last_commit)


def test_codec_roundtrips():
    def scenario(pkg):
        T, codec = pkg.T, pkg.codec
        vs, privs = valset(pkg, 4)
        blk = make_block(pkg, vs, 1, T.BlockID())
        enc = codec.encode_block(blk)
        dec = codec.decode_block(enc)
        assert dec.hash() == blk.hash() and dec.data.txs == blk.data.txs
        v = T.Vote(
            type_=T.PRECOMMIT, height=5, round=2,
            block_id=T.BlockID(b"\x02" * 32, T.PartSetHeader(3, b"\x03" * 32)),
            timestamp_ns=NOW, validator_address=privs[0].pub_key().address(),
            validator_index=0, signature=b"\x05" * 64,
        )
        v2 = codec.decode_vote(codec.encode_vote(v))
        assert v2 == v and v2.sign_bytes(CHAIN) == v.sign_bytes(CHAIN)
        # the set's order, proposer and priorities survive the trip
        vs.increment_proposer_priority(3)
        venc = codec.encode_validator_set(vs)
        vs2 = codec.decode_validator_set(venc)
        assert [x.address for x in vs2.validators] == [x.address for x in vs.validators]
        assert vs2.proposer.address == vs.proposer.address and vs2.hash() == vs.hash()
        assert [x.proposer_priority for x in vs2.validators] == [x.proposer_priority for x in vs.validators]
        return enc, codec.encode_vote(v), v.sign_bytes(CHAIN), venc

    both(scenario)


def test_block_store_save_load(tmp_path):
    def scenario(pkg, root):
        T, codec = pkg.T, pkg.codec
        db = pkg.kv.SqliteKV(str(root / f"blocks-{id(pkg)}.db"))
        bs = pkg.BlockStore(db)
        vs, _ = valset(pkg, 4)
        prev = T.BlockID()
        blocks = []
        for h in (1, 2, 3):
            blk = make_block(pkg, vs, h, prev)
            ps = T.PartSet.from_data(codec.encode_block(blk))
            bs.save_block(blk, ps, T.Commit(h, 0, T.BlockID(blk.hash(), ps.header), []))
            prev = T.BlockID(blk.hash(), ps.header)
            blocks.append(blk)
        assert (bs.height(), bs.base()) == (3, 1)
        assert bs.load_block(2).hash() == blocks[1].hash()
        assert bs.load_block_by_hash(blocks[0].hash()).height == 1
        assert bs.load_block_meta(3).header.height == 3
        assert bs.load_seen_commit(3).height == 3
        assert bs.load_block_commit(1).height == 1  # came with block 2
        # a non-contiguous save is refused
        blk5 = make_block(pkg, vs, 5, prev)
        ps5 = T.PartSet.from_data(codec.encode_block(blk5))
        with pytest.raises(ValueError):
            bs.save_block(blk5, ps5, T.Commit(5, 0, T.BlockID(), []))
        rows = sorted(db.iter_prefix(b""))
        # reopened from disk, then pruned
        bs2 = pkg.BlockStore(db)
        assert bs2.height() == 3 and bs2.load_block(1).hash() == blocks[0].hash()
        assert bs2.prune_blocks(3) == 2
        assert bs2.base() == 3 and bs2.load_block(1) is None
        pruned = sorted(db.iter_prefix(b""))
        db.close()
        return rows, pruned

    both(scenario, tmp_path)


def test_state_store_roundtrip():
    def scenario(pkg):
        T, st_mod = pkg.T, pkg.store
        vs, _ = valset(pkg, 3)
        st = pkg.state_types.State(
            chain_id=CHAIN, initial_height=1, last_block_height=7,
            last_block_id=T.BlockID(b"\x09" * 32, T.PartSetHeader(1, b"\x0a" * 32)),
            last_block_time_ns=NOW, validators=vs, next_validators=vs.copy(),
            last_validators=vs.copy(), consensus_params=pkg.state_types.ConsensusParams(),
            app_hash=b"\x0b" * 32, last_results_hash=b"\x0c" * 32,
        )
        enc = st_mod.encode_state(st)
        dec = st_mod.decode_state(enc)
        assert dec.chain_id == CHAIN and dec.last_block_height == 7
        assert dec.validators.hash() == vs.hash() and dec.app_hash == st.app_hash
        db = pkg.kv.MemKV()
        store = st_mod.Store(db)
        store.save(st)
        assert store.load().last_block_height == 7
        assert store.load_validators(9).hash() == vs.hash()
        return enc, sorted(db.iter_prefix(b""))

    both(scenario)


def test_kvstore_app_lifecycle():
    def scenario(pkg):
        abci = pkg.abci
        app = pkg.KV()
        conns = pkg.AppConns.local(app)
        assert conns.query.info(abci.RequestInfo()).last_block_height == 0
        conns.consensus.init_chain(abci.RequestInitChain(chain_id=CHAIN))
        assert conns.mempool.check_tx(abci.RequestCheckTx(tx=b"a=1")).is_ok()
        assert not conns.mempool.check_tx(abci.RequestCheckTx(tx=b"junk")).is_ok()
        resp = conns.consensus.finalize_block(abci.RequestFinalizeBlock(txs=[b"a=1", b"b=2"], height=1))
        assert all(r.is_ok() for r in resp.tx_results)
        conns.consensus.commit()
        assert conns.query.query(abci.RequestQuery(data=b"a")).value == b"1"
        assert app.height == 1
        # determinism: the same txs give the same app hash
        app2 = pkg.KV()
        app2.init_chain(abci.RequestInitChain(chain_id=CHAIN))
        r2 = app2.finalize_block(abci.RequestFinalizeBlock(txs=[b"a=1", b"b=2"], height=1))
        assert r2.app_hash == resp.app_hash
        return resp.app_hash

    both(scenario)


def test_kvstore_snapshots():
    """Snapshots every 10 heights, restored chunk by chunk into a fresh
    app; the port's snapshots and chunks equal the JAX app's, and each
    package's app restores from the other's chunks."""

    def grow(pkg):
        app = pkg.KV()
        app.init_chain(pkg.abci.RequestInitChain(chain_id=CHAIN))
        for h in range(1, 11):
            app.finalize_block(pkg.abci.RequestFinalizeBlock(txs=[b"k%d=v%d" % (h, h)], height=h))
            app.commit()
        return app

    apps = {name: grow(pkg) for name, pkg in PKGS.items()}

    def scenario(pkg, source):
        app = apps[source]
        snaps = app.list_snapshots()
        assert snaps and snaps[-1].height == 10
        app2 = pkg.KV()
        s = snaps[-1]
        app2.offer_snapshot(pkg.abci.Snapshot(s.height, s.format, s.chunks, s.hash, s.metadata),
                            app.app_hash)
        chunks = [app.load_snapshot_chunk(s.height, 1, c) for c in range(s.chunks)]
        for c, chunk in enumerate(chunks):
            assert app2.apply_snapshot_chunk(c, chunk, "peer").result == pkg.abci.APPLY_CHUNK_ACCEPT
        assert app2.app_hash == app.app_hash and app2.height == 10
        return [(x.height, x.format, x.chunks, x.hash, x.metadata) for x in snaps], chunks, app2.app_hash

    assert both(scenario, "jax") == both(scenario, "port")
