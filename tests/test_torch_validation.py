"""The slice as a whole: commit verification, port vs JAX package.

One seed builds a 150-validator set and a 32-height window of commits
as both JAX-package and port objects, signed once. Then: the sign
bytes are byte-identical; ``verify_commits_coalesced`` returns the
same error list in both packages (the port on ``device="cpu"``, the
JAX package on its test backend) with one tampered signature, one
absent-heavy commit under 2/3 and nil votes; and ``verify_commit`` /
``verify_commit_light`` give the same outcome.
"""

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.types import block as jB
from cometbft_tpu.types import canonical as jC
from cometbft_tpu.types import validation as jV
from cometbft_tpu.types import validator_set as jVS
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.types import block as B
from cometbft_tpu_torch.types import canonical as C
from cometbft_tpu_torch.types import validation as V
from cometbft_tpu_torch.types.signature_cache import SignatureCache
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

# the plain versions run many small torch ops: one intra-op thread per
# test process, so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

CHAIN = "torch-port-chain"
N_VALS, N_HEIGHTS = 150, 32
TAMPER, UNDER, NIL = 5, 20, 9


def _window():
    rng = np.random.default_rng(1234)
    privs = [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(N_VALS)]
    powers = [int(p) for p in rng.integers(50, 150, N_VALS)]
    vals = ValidatorSet([Validator(p.pub_key(), w) for p, w in zip(privs, powers)])
    jvals = jVS.ValidatorSet(
        [jVS.Validator(jkeys.Ed25519PubKey(p.pub_key().key_bytes), w)
         for p, w in zip(privs, powers)]
    )
    assert [v.address for v in vals.validators] == [v.address for v in jvals.validators]
    by_addr = {p.pub_key().address(): p for p in privs}
    ordered = [by_addr[v.address] for v in vals.validators]
    ours, theirs, sign_bytes = [], [], []
    for h in range(1, N_HEIGHTS + 1):
        hsh, psh = rng.bytes(32), rng.bytes(32)
        bid, jbid = B.BlockID(hsh, B.PartSetHeader(1, psh)), jB.BlockID(hsh, jB.PartSetHeader(1, psh))
        sigs, jsigs = [], []
        tallied = 0
        for i, (v, p) in enumerate(zip(vals.validators, ordered)):
            if h == UNDER and tallied * 3 > vals.total_voting_power() * 3 // 2:
                sigs.append(B.CommitSig.absent())
                jsigs.append(jB.CommitSig.absent())
                continue
            nil = h == NIL and i % 7 == 0
            flag = B.BLOCK_ID_FLAG_NIL if nil else B.BLOCK_ID_FLAG_COMMIT
            ts = 1_700_000_000_000_000_000 + h * 10**9 + i % 4
            sb = C.vote_sign_bytes(CHAIN, C.PRECOMMIT_TYPE, h, 0, B.NIL_BLOCK_ID if nil else bid, ts)
            jsb = jC.vote_sign_bytes(CHAIN, jC.PRECOMMIT_TYPE, h, 0, jB.NIL_BLOCK_ID if nil else jbid, ts)
            sign_bytes.append((sb, jsb))
            sig = p.sign(sb)
            if h == TAMPER and i == 11:
                sig = bytes([sig[0] ^ 1]) + sig[1:]
            if not nil:
                tallied += v.voting_power
            sigs.append(B.CommitSig(flag, v.address, ts, sig))
            jsigs.append(jB.CommitSig(flag, v.address, ts, sig))
        ours.append((vals, bid, h, B.Commit(h, 0, bid, sigs)))
        theirs.append((jvals, jbid, h, jB.Commit(h, 0, jbid, jsigs)))
    return ours, theirs, sign_bytes


@pytest.fixture(scope="module")
def window():
    return _window()


def _outcome(errs):
    return [None if e is None else (type(e).__name__, str(e)) for e in errs]


def test_sign_bytes_identical(window):
    _, _, sign_bytes = window
    assert len(sign_bytes) > N_VALS * (N_HEIGHTS - 1)
    assert all(a == b for a, b in sign_bytes)


@pytest.mark.parametrize("light", [True, False], ids=["light", "full"])
def test_coalesced_errors_match_jax(window, light):
    ours, theirs, _ = window
    got = _outcome(V.verify_commits_coalesced(CHAIN, ours, light=light, device="cpu"))
    want = _outcome(jV.verify_commits_coalesced(CHAIN, theirs, light=light))
    assert got == want
    assert got[TAMPER - 1] == (
        "ErrInvalidSignature", f"invalid signature for validator 11 at height {TAMPER}"
    )
    assert got[UNDER - 1][0] == "ErrNotEnoughVotingPower"
    assert [g for i, g in enumerate(got) if i not in (TAMPER - 1, UNDER - 1)] == [None] * 30


def _single(fn, *args, **kw):
    try:
        fn(*args, **kw)
    except Exception as e:  # the outcome is the error's class and text
        return (type(e).__name__, str(e))
    return None


@pytest.mark.parametrize("h", [1, TAMPER, UNDER, NIL])
def test_verify_commit_and_light_match_jax(window, h):
    ours, theirs, _ = window
    vals, bid, _, commit = ours[h - 1]
    jvals, jbid, _, jcommit = theirs[h - 1]
    for port_fn, jax_fn in (
        (V.verify_commit, jV.verify_commit),
        (V.verify_commit_light, jV.verify_commit_light),
    ):
        got = _single(port_fn, CHAIN, vals, bid, h, commit, device="cpu")
        assert got == _single(jax_fn, CHAIN, jvals, jbid, h, jcommit)
    assert _single(V.verify_commit, CHAIN, vals, bid, h + 1, commit, device="cpu") == (
        "CommitVerifyError", f"height {h + 1} != commit height {h}"
    )


def test_signature_cache_skips_verified_lanes(window):
    ours, _, _ = window
    vals, bid, h, commit = ours[0]
    cache = SignatureCache()
    V.verify_commit(CHAIN, vals, bid, h, commit, cache=cache, device="cpu")
    assert len(cache) == N_VALS
    V.verify_commit(CHAIN, vals, bid, h, commit, cache=cache, device="cpu")
    assert cache.hits == N_VALS
