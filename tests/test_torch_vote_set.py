"""The vote set (types/vote_set.py) against the JAX package's.

The three vote-set cases of ``tests/test_types.py`` (quorum, a bad
signature, conflicting votes), each run on the port's ``VoteSet`` and
on the JAX package's with the same seeded keys and votes: the same
verdicts and the same majority.
"""

import time

import numpy as np
import pytest

from cometbft_tpu import types as JT
from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.types import ErrVoteConflictingVotes, VoteSet
from cometbft_tpu_torch.types.block import BlockID, PartSetHeader
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet
from cometbft_tpu_torch.types.vote import PREVOTE, Vote

CHAIN = "test-chain"
NOW = int(time.time() * 1e9)
N_VALS = 7


def make_block_id(tag: bytes = b"block", pkg=None) -> BlockID:
    import hashlib

    h = hashlib.sha256(tag).digest()
    p = hashlib.sha256(tag + b"p").digest()
    if pkg == "jax":
        return JT.BlockID(h, JT.PartSetHeader(1, p))
    return BlockID(h, PartSetHeader(1, p))


@pytest.fixture(scope="module")
def valset():
    """(port set, port keys, JAX set, JAX keys), keys in set order."""
    rng = np.random.default_rng(81)
    seeds = [rng.bytes(32) for _ in range(N_VALS)]
    privs = [Ed25519PrivKey.from_seed(s) for s in seeds]
    vs = ValidatorSet([Validator(p.pub_key(), 10) for p in privs])
    order = {v.address: i for i, v in enumerate(vs.validators)}
    privs.sort(key=lambda p: order[p.pub_key().address()])
    jprivs = [JPriv.from_seed(p.seed) for p in privs]
    jvs = JT.ValidatorSet([JT.Validator(p.pub_key(), 10) for p in jprivs])
    assert jvs.hash() == vs.hash()
    return vs, privs, jvs, jprivs


def _vote(pkg, priv, i, bid, sig=None):
    cls = JT.Vote if pkg == "jax" else Vote
    v = cls(
        type_=PREVOTE,
        height=5,
        round=0,
        block_id=bid,
        timestamp_ns=NOW,
        validator_address=priv.pub_key().address(),
        validator_index=i,
    )
    v.signature = sig if sig is not None else priv.sign(v.sign_bytes(CHAIN))
    return v


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_vote_set_quorum(valset, pkg):
    vs, privs, jvs, jprivs = valset
    if pkg == "jax":
        vs, privs, votes = jvs, jprivs, JT.VoteSet(CHAIN, 5, 0, JT.PREVOTE, jvs)
    else:
        votes = VoteSet(CHAIN, 5, 0, PREVOTE, vs)
    bid = make_block_id(pkg=pkg)
    for i, priv in enumerate(privs):
        assert votes.add_vote(_vote(pkg, priv, i, bid))
        assert votes.has_two_thirds_majority() == ((i + 1) * 3 > len(privs) * 2)
    assert votes.two_thirds_majority().key() == bid.key()
    assert votes.has_all()


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_vote_set_rejects_bad_sig(valset, pkg):
    vs, privs, jvs, jprivs = valset
    if pkg == "jax":
        privs, votes = jprivs, JT.VoteSet(CHAIN, 5, 0, JT.PREVOTE, jvs)
    else:
        votes = VoteSet(CHAIN, 5, 0, PREVOTE, vs)
    v = _vote(pkg, privs[0], 0, make_block_id(pkg=pkg), sig=b"\x01" * 64)
    with pytest.raises(ValueError):
        votes.add_vote(v)
    assert votes.get_vote(0) is None and votes.sum == 0


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_vote_set_conflicting_votes_evidence(valset, pkg):
    vs, privs, jvs, jprivs = valset
    if pkg == "jax":
        privs, votes, err = jprivs, JT.VoteSet(CHAIN, 5, 0, JT.PREVOTE, jvs), JT.ErrVoteConflictingVotes
    else:
        votes, err = VoteSet(CHAIN, 5, 0, PREVOTE, vs), ErrVoteConflictingVotes
    a = _vote(pkg, privs[0], 0, make_block_id(b"a", pkg))
    b = _vote(pkg, privs[0], 0, make_block_id(b"b", pkg))
    assert votes.add_vote(a)
    with pytest.raises(err) as e:
        votes.add_vote(b)
    assert e.value.existing is a and e.value.new is b
    # a duplicate is not a conflict
    assert votes.add_vote(a) is False
