"""Evidence, votes and light blocks carry across the two packages.

The same objects are built in each package from one set of seeded
keys, then encoded; each encoding must equal the other's byte for byte
and decode in the other package to the same hash:

- ``encode_vote`` / ``decode_vote`` (with an extension);
- ``DuplicateVoteEvidence`` and ``LightClientAttackEvidence``
  (``encode``, ``hash``, ``decode_evidence``);
- ``byzantine_from`` on a diverging witness's chain, a fork of one
  genesis with other transactions;
- a light block written by one package's ``DBLightStore`` record codec
  is read by the other's, and a store file written by one package
  opens in the other (the carry-across of trusted state).
"""

import time

import pytest
import torch

from cometbft_tpu import types as JT
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu.evidence import types as jev
from cometbft_tpu.light import provider as jprovider
from cometbft_tpu.light import store as jstore
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu.utils import kv as jkv
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.evidence import types as ev
from cometbft_tpu_torch.light import provider as pprovider
from cometbft_tpu_torch.light import store as pstore
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.types.block import BlockID, PartSetHeader
from cometbft_tpu_torch.types.vote import PRECOMMIT, PREVOTE, Vote
from cometbft_tpu_torch.utils import chaingen, codec, kv

torch.set_num_threads(1)

CPU = "cpu"


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


@pytest.fixture(scope="module")
def chains():
    """A 6-validator chain of 10 blocks and a fork of it (two txs a
    block), in each package from one genesis."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(6, chain_id="evidence-chain", seed=21,
                                  genesis_time_ns=time.time_ns() - 3_600_000_000_000)
        jgen = JGenesisDoc.from_json(gen.to_json())
        jprivs = [JPriv.from_seed(p.seed) for p in privs]
        out = {
            "port": [gen, privs, chaingen.make_chain(gen, privs, 10, device=CPU),
                     chaingen.make_chain(gen, privs, 10, txs_per_block=2, device=CPU)],
            "jax": [jgen, jprivs, jchaingen.make_chain(jgen, jprivs, 10),
                    jchaingen.make_chain(jgen, jprivs, 10, txs_per_block=2)],
        }
    finally:
        pv.set_engine(None)
        eng.close()
    return out


def _light(pkg_provider, gen, node, height):
    return pkg_provider.StoreBackedProvider(gen.chain_id, node.block_store,
                                            node.state_store).light_block(height)


def _votes(privs, chain_id, mk_vote, mk_bid):
    """Two conflicting precommits by validator 0 at height 7, signed."""
    addr = privs[0].pub_key().address()
    out = []
    for fill in (b"\x01", b"\x02"):
        bid = mk_bid(fill * 32, 1, fill * 32)
        v = mk_vote(type_=PRECOMMIT, height=7, round=1, block_id=bid, timestamp_ns=1_700_000_000_123,
                    validator_address=addr, validator_index=0, extension=b"ext" + fill)
        v.signature = privs[0].sign(v.sign_bytes(chain_id))
        out.append(v)
    return out


def _port_bid(h, total, psh):
    return BlockID(h, PartSetHeader(total, psh))


def _jax_bid(h, total, psh):
    return JT.BlockID(h, JT.PartSetHeader(total, psh))


def test_vote_codec_both_ways(chains):
    gen, privs = chains["port"][:2]
    jgen, jprivs = chains["jax"][:2]
    for v, jv in zip(_votes(privs, gen.chain_id, Vote, _port_bid),
                     _votes(jprivs, jgen.chain_id, JT.Vote, _jax_bid)):
        b, jb = codec.encode_vote(v), jcodec.encode_vote(jv)
        assert b == jb
        assert codec.decode_vote(jb) == v
        assert jcodec.encode_vote(jcodec.decode_vote(b)) == b
        assert v.sign_bytes(gen.chain_id) == jv.sign_bytes(jgen.chain_id)
        v.validate_basic()
        assert v.verify(gen.chain_id, privs[0].pub_key())
        assert not v.verify(gen.chain_id, privs[1].pub_key())
        assert not v.is_nil() and v.key() == (PRECOMMIT, 7, 1, v.block_id.key())
    bad = Vote(PREVOTE + 7, 1, 0, BlockID(), 0, b"a" * 20, 0, b"s")
    with pytest.raises(ValueError, match="invalid vote type"):
        bad.validate_basic()


def test_duplicate_vote_evidence_both_ways(chains):
    gen, privs = chains["port"][:2]
    jgen, jprivs = chains["jax"][:2]
    a, b = _votes(privs, gen.chain_id, Vote, _port_bid)
    ja, jb = _votes(jprivs, jgen.chain_id, JT.Vote, _jax_bid)
    e = ev.DuplicateVoteEvidence.from_votes(b, a, 10, 60, 1_700_000_001_000)
    je = jev.DuplicateVoteEvidence.from_votes(jb, ja, 10, 60, 1_700_000_001_000)
    assert e.encode() == je.encode() and e.hash() == je.hash()
    e.validate_basic()
    assert e.height() == 7 and e.addresses() == [privs[0].pub_key().address()]
    back = ev.decode_evidence(je.encode())
    assert back == e and back.hash() == je.hash()
    assert jev.decode_evidence(e.encode()).hash() == e.hash()
    with pytest.raises(ValueError, match="canonical order"):
        ev.DuplicateVoteEvidence(a, a).validate_basic()


def test_light_client_attack_evidence_and_byzantine_set_both_ways(chains):
    gen, privs, src, fork = chains["port"]
    jgen, jprivs, jsrc, jfork = chains["jax"]
    common = _light(pprovider, gen, src, 4)
    jcommon = _light(jprovider, jgen, jsrc, 4)
    conflicting = _light(pprovider, gen, fork, 8)
    jconflicting = _light(jprovider, jgen, jfork, 8)
    assert conflicting.hash() != _light(pprovider, gen, src, 8).hash()
    e = ev.LightClientAttackEvidence(conflicting, 4, total_voting_power=60,
                                     timestamp_ns=1_700_000_002_000)
    je = jev.LightClientAttackEvidence(jconflicting, 4, total_voting_power=60,
                                       timestamp_ns=1_700_000_002_000)
    e.byzantine_validators = e.byzantine_from(common.validator_set)
    je.byzantine_validators = je.byzantine_from(jcommon.validator_set)
    # every validator signed the fork and sits in the common set
    assert [v.address for v in e.byzantine_validators] == [v.address for v in je.byzantine_validators]
    assert len(e.byzantine_validators) == 6
    assert e.encode() == je.encode() and e.hash() == je.hash()
    e.validate_basic()
    back = ev.decode_evidence(je.encode())
    assert back.hash() == e.hash() and back.conflicting_block.hash() == conflicting.hash()
    assert jev.decode_evidence(e.encode()).hash() == e.hash()
    with pytest.raises(ValueError, match="unknown evidence type"):
        ev.decode_evidence(b"\x08\x09")


def test_light_block_records_both_ways(chains, tmp_path):
    gen, privs, src, _ = chains["port"]
    jgen, jprivs, jsrc, _ = chains["jax"]
    for h in (1, 5, 10):
        lb, jlb = _light(pprovider, gen, src, h), _light(jprovider, jgen, jsrc, h)
        rec, jrec = pstore._encode_light_block(lb), jstore._encode_light_block(jlb)
        assert rec == jrec
        assert pstore._decode_light_block(jrec).hash() == jlb.hash()
        assert jstore._decode_light_block(rec).hash() == lb.hash()
    # a store file written by the JAX package opens in the port
    path = str(tmp_path / "jax-light.db")
    jdb = jkv.open_kv("sqlite", path)
    js = jstore.DBLightStore(jdb, jgen.chain_id)
    for h in (2, 6, 9):
        js.save(_light(jprovider, jgen, jsrc, h))
    jdb.close()
    db = kv.open_kv("sqlite", path)
    ps = pstore.DBLightStore(db, gen.chain_id)
    assert sorted(ps._by_height) == [2, 6, 9]
    assert ps.latest().hash() == _light(pprovider, gen, src, 9).hash()
    # and the reverse: the port's saves, pruned, read by the JAX package
    ps.save(_light(pprovider, gen, src, 10))
    ps.prune(2)
    db.close()
    jdb = jkv.open_kv("sqlite", path)
    js = jstore.DBLightStore(jdb, jgen.chain_id)
    assert sorted(js._by_height) == [9, 10]
    assert js.latest().hash() == _light(jprovider, jgen, jsrc, 10).hash()
    jdb.close()
