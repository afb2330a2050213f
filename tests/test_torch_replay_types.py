"""The replay slice's data types against the JAX package's.

Ported from the JAX package's ``tests/test_types.py``: weighted
proposer rotation, the valset hash on an update, the part-set round
trip, merkle proofs, header-hash sensitivity. Held against the JAX
package on seeded inputs: merkle roots at every size up to 70, a
validator set's hash and proposer sequence through updates, each
codec's bytes both ways, ``ConsensusParams`` and ``GenesisDoc`` JSON.
Exact equality.
"""

import hashlib

import numpy as np
import pytest

from cometbft_tpu import types as JT
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.state.state_types import ConsensusParams as JParams
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.state.state_types import ConsensusParams
from cometbft_tpu_torch.types import block as B
from cometbft_tpu_torch.types.part_set import Part, PartSet
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet
from cometbft_tpu_torch.utils import codec

CHAIN = "test-chain"
NOW = 1_700_000_000_000_000_000


def _privs(n, seed=3):
    rng = np.random.default_rng(seed)
    return [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(n)]


def _pair(privs, powers):
    """The same validator set in both packages."""
    vs = ValidatorSet([Validator(p.pub_key(), w) for p, w in zip(privs, powers)])
    jvs = JT.ValidatorSet(
        [JT.Validator(jkeys.Ed25519PubKey(p.pub_key().key_bytes), w) for p, w in zip(privs, powers)]
    )
    return vs, jvs


def test_proposer_rotation_weighted():
    privs = _privs(3)
    vs = ValidatorSet([Validator(p.pub_key(), w) for p, w in zip(privs, (3, 1, 1))])
    heavy = vs.validators[0].address
    seen = []
    work = vs.copy()
    for _ in range(5):
        work.increment_proposer_priority(1)
        seen.append(work.get_proposer().address)
    assert seen.count(heavy) == 3


def test_valset_hash_changes_with_update():
    privs = _privs(4)
    vs = ValidatorSet([Validator(p.pub_key(), 100) for p in privs])
    h1 = vs.hash()
    vs2 = vs.copy()
    vs2.update_with_change_set([Validator(privs[0].pub_key(), 555)])
    assert vs2.hash() != h1
    assert vs.hash() == h1  # the copy shares nothing mutable
    _, v = vs2.get_by_address(privs[0].pub_key().address())
    assert v.voting_power == 555
    vs3 = vs2.copy()
    vs3.update_with_change_set([Validator(privs[1].pub_key(), 0)])
    assert vs3.size() == 3


def test_part_set_roundtrip():
    data = bytes(range(256)) * 1000  # 256 KB -> 4 parts
    ps = PartSet.from_data(data)
    assert ps.header.total == 4
    ps2 = PartSet(ps.header)
    for i in reversed(range(4)):
        assert ps2.add_part(ps.get_part(i))
    assert not ps2.add_part(ps.get_part(0))  # a duplicate
    assert ps2.is_complete()
    assert ps2.assemble() == data
    p = ps.get_part(0)
    ps3 = PartSet(ps.header)
    with pytest.raises(ValueError):
        ps3.add_part(Part(0, b"x" + p.bytes_[1:], p.proof))
    jps = JT.PartSet.from_data(data)
    assert (jps.header.total, jps.header.hash) == (ps.header.total, ps.header.hash)


def test_merkle_proofs():
    items = [b"a", b"b", b"c", b"d", b"e"]
    root, proofs = merkle.proofs_from_byte_slices(items)
    assert root == merkle.hash_from_byte_slices(items)
    for i, item in enumerate(items):
        assert proofs[i].verify(root, item)
        assert not proofs[i].verify(root, item + b"!")


def test_merkle_roots_and_proofs_match_jax():
    rng = np.random.default_rng(5)
    for n in range(71):
        items = [rng.bytes(int(rng.integers(0, 40))) for _ in range(n)]
        root = merkle.hash_from_byte_slices(items)
        assert root == jmerkle.hash_from_byte_slices(items), n
        if n:
            r, proofs = merkle.proofs_from_byte_slices(items)
            jr, jproofs = jmerkle.proofs_from_byte_slices(items)
            assert r == jr == root
            assert [(p.leaf_hash, p.aunts) for p in proofs] == [
                (p.leaf_hash, p.aunts) for p in jproofs
            ]


def test_header_hash_sensitivity():
    vs = ValidatorSet([Validator(p.pub_key(), 10) for p in _privs(2)])
    kw = dict(
        chain_id=CHAIN,
        time_ns=NOW,
        validators_hash=vs.hash(),
        next_validators_hash=vs.hash(),
        proposer_address=vs.validators[0].address,
    )
    h, h2 = B.Header(height=9, **kw), B.Header(height=10, **kw)
    assert h.hash() != h2.hash()
    assert B.Header(height=9).hash() is None  # no validators hash


def test_valset_hash_and_rotation_match_jax():
    privs = _privs(9, seed=8)
    powers = [int(w) for w in np.random.default_rng(8).integers(1, 50, 9)]
    vs, jvs = _pair(privs[:7], powers[:7])
    newcomers = privs[7:]
    for step in range(40):
        if step == 10:  # add two, change one
            ch = [(newcomers[0], 30), (newcomers[1], 5), (privs[0], 77)]
        elif step == 25:  # remove one
            ch = [(privs[1], 0)]
        else:
            ch = []
        if ch:
            vs.update_with_change_set([Validator(p.pub_key(), w) for p, w in ch])
            jvs.update_with_change_set(
                [JT.Validator(jkeys.Ed25519PubKey(p.pub_key().key_bytes), w) for p, w in ch]
            )
        vs.increment_proposer_priority(1 + step % 3)
        jvs.increment_proposer_priority(1 + step % 3)
        assert vs.hash() == jvs.hash()
        assert vs.get_proposer().address == jvs.get_proposer().address
        assert [v.proposer_priority for v in vs.validators] == [
            v.proposer_priority for v in jvs.validators
        ]
        assert codec.encode_validator_set(vs) == jcodec.encode_validator_set(jvs)
    back = codec.decode_validator_set(jcodec.encode_validator_set(jvs))
    assert back.hash() == jvs.hash() and back.get_proposer().address == jvs.get_proposer().address


def _block_pair():
    """A signed block with a last commit, in both packages' types."""
    privs = _privs(4, seed=9)
    vs, _ = _pair(privs, [10] * 4)
    bid = B.BlockID(hashlib.sha256(b"b").digest(), B.PartSetHeader(2, hashlib.sha256(b"p").digest()))
    sigs = [
        B.CommitSig(B.BLOCK_ID_FLAG_COMMIT, v.address, NOW + i, bytes([i]) * 64)
        for i, v in enumerate(vs.validators)
    ]
    sigs[2] = B.CommitSig.absent()
    commit = B.Commit(4, 1, bid, sigs)
    data = B.Data([b"k=v", b"x=y"])
    header = B.Header(
        chain_id=CHAIN,
        height=5,
        time_ns=NOW,
        last_block_id=bid,
        last_commit_hash=commit.hash(),
        data_hash=data.hash(),
        validators_hash=vs.hash(),
        next_validators_hash=vs.hash(),
        consensus_hash=ConsensusParams().hash(),
        app_hash=b"\x01" * 32,
        last_results_hash=b"\x02" * 32,
        evidence_hash=merkle.hash_from_byte_slices([]),
        proposer_address=vs.validators[0].address,
    )
    return B.Block(header, data, last_commit=commit)


def test_codec_matches_jax_both_ways():
    blk = _block_pair()
    blk.validate_basic()
    raw = codec.encode_block(blk)
    jblk = jcodec.decode_block(raw)
    assert jcodec.encode_block(jblk) == raw
    assert jblk.hash() == blk.hash()
    assert jblk.last_commit.hash() == blk.last_commit.hash()
    assert jblk.data.hash() == blk.data.hash()
    back = codec.decode_block(jcodec.encode_block(jblk))
    assert codec.encode_block(back) == raw and back.hash() == blk.hash()
    assert codec.encode_header(blk.header) == jcodec.encode_header(jblk.header)
    c = blk.last_commit
    assert codec.encode_commit(c) == jcodec.encode_commit(jblk.last_commit)
    assert codec.decode_commit(codec.encode_commit(c)).signatures == c.signatures
    assert codec.decode_block_id(c.block_id.encode()) == c.block_id
    ec = B.ExtendedCommit(
        4, 1, c.block_id,
        [B.ExtendedCommitSig(s.block_id_flag, s.validator_address, s.timestamp_ns, s.signature,
                             b"ext" if s.for_block() else b"", b"\x05" * 64 if s.for_block() else b"")
         for s in c.signatures],
    )
    eb = codec.encode_extended_commit(ec)
    assert jcodec.encode_extended_commit(jcodec.decode_extended_commit(eb)) == eb
    assert codec.decode_extended_commit(eb) == ec


def test_block_validate_basic_catches_body_changes():
    blk = _block_pair()
    blk.data = B.Data(blk.data.txs + [b"evil=1"])
    with pytest.raises(ValueError, match="DataHash"):
        blk.validate_basic()
    blk = _block_pair()
    sigs = list(blk.last_commit.signatures)
    sigs[0] = B.CommitSig.absent()  # the commit hash covers the signatures
    blk.last_commit = B.Commit(4, 1, blk.last_commit.block_id, sigs)
    with pytest.raises(ValueError, match="LastCommitHash"):
        blk.validate_basic()


def test_params_and_genesis_json_match_jax():
    p = ConsensusParams()
    p.block.max_bytes = 123456
    p.abci.vote_extensions_enable_height = 7
    jp = JParams.from_dict(p.to_dict())
    assert jp.encode() == p.encode() and jp.hash() == p.hash()
    assert ConsensusParams.decode(p.encode()) == p
    assert p.vote_extensions_enabled(7) and not p.vote_extensions_enabled(6)
    gen, privs = make_genesis(5, chain_id="g", genesis_time_ns=NOW, seed=4)
    jgen = JGenesisDoc.from_json(gen.to_json())
    assert jgen.to_json() == gen.to_json()
    assert jgen.validator_set().hash() == gen.validator_set().hash()
    st, jst = gen.make_genesis_state(), jgen.make_genesis_state()
    assert (st.validators.hash(), st.consensus_params.hash(), st.last_block_time_ns) == (
        jst.validators.hash(), jst.consensus_params.hash(), jst.last_block_time_ns
    )
    # make_genesis returns the keys in validator-set order
    assert [p.pub_key().address() for p in privs] == [v.address for v in gen.validator_set().validators]
