"""The slice as a whole: commit verification, port vs JAX package.

One seed builds a 150-validator set and a 32-height window of commits
as both JAX-package and port objects, signed once. Then: the sign
bytes are byte-identical; ``verify_commits_coalesced`` returns the
same error list in both packages (the port on ``device="cpu"``, the
JAX package on its test backend) with one tampered signature, one
absent-heavy commit under 2/3 and nil votes; and ``verify_commit`` /
``verify_commit_light`` give the same outcome. Trusting verification
(1/3, 2/3, a double vote, a trust level out of range), mixed light and
trusting jobs through ``verify_commit_jobs_coalesced`` and
``verify_extended_commit`` (valid, a missing extension signature,
extension data on a nil lane, a bad extension signature) give the JAX
package's outcome, error class and text under every priority class.
Every check goes through the port's verify scheduler: unforced, the
host route on the CPU; the window and the single commits also with the
device route pinned (floor 1), which packs the lanes, runs the
kernels' plain versions and merges the verdicts by lane index.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import scheduler as jsched
from cometbft_tpu.types import block as jB
from cometbft_tpu.types import canonical as jC
from cometbft_tpu.types import validation as jV
from cometbft_tpu.types import validator_set as jVS
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.types import block as B
from cometbft_tpu_torch.types import canonical as C
from cometbft_tpu_torch.types import validation as V
from cometbft_tpu_torch.types.signature_cache import SignatureCache
from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet
from torch_hard_limit import hard_limit  # noqa: F401

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
    return ours, theirs, sign_bytes, ordered


@pytest.fixture(scope="module")
def window():
    return _window()


@pytest.fixture(autouse=True)
def host_plane():
    """A two-worker host engine per test; the port's and the JAX
    package's shared schedulers are closed after it."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    jsched.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


PRIORITIES = [V.PRIORITY_LIVE, V.PRIORITY_LIGHT, V.PRIORITY_CATCHUP]


@pytest.fixture(params=["host", "device"])
def route(request):
    """The unforced route (the host plane, on the CPU) or the device
    route pinned by the floor at 1; the floor is restored after."""
    floor = crypto_batch._MIN_DEVICE_BATCH
    if request.param == "device":
        crypto_batch.set_min_device_batch(1)
    yield request.param
    crypto_batch.set_min_device_batch(floor)


def _outcome(errs):
    return [None if e is None else (type(e).__name__, str(e)) for e in errs]


def test_sign_bytes_identical(window):
    _, _, sign_bytes, _ = window
    assert len(sign_bytes) > N_VALS * (N_HEIGHTS - 1)
    assert all(a == b for a, b in sign_bytes)


@pytest.mark.parametrize("light", [True, False], ids=["light", "full"])
def test_coalesced_errors_match_jax(window, light, route):
    ours, theirs, _, _ = window
    got = _outcome(V.verify_commits_coalesced(CHAIN, ours, light=light, device="cpu"))
    assert crypto_batch.LAST_ROUTE["path"] == route
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
def test_verify_commit_and_light_match_jax(window, h, route):
    ours, theirs, _, _ = window
    vals, bid, _, commit = ours[h - 1]
    jvals, jbid, _, jcommit = theirs[h - 1]
    for port_fn, jax_fn in (
        (V.verify_commit, jV.verify_commit),
        (V.verify_commit_light, jV.verify_commit_light),
    ):
        got = _single(port_fn, CHAIN, vals, bid, h, commit, device="cpu")
        assert crypto_batch.LAST_ROUTE["path"] == route
        assert got == _single(jax_fn, CHAIN, jvals, jbid, h, jcommit)
    assert _single(V.verify_commit, CHAIN, vals, bid, h + 1, commit, device="cpu") == (
        "CommitVerifyError", f"height {h + 1} != commit height {h}"
    )


def test_signature_cache_skips_verified_lanes(window):
    ours, _, _, _ = window
    vals, bid, h, commit = ours[0]
    cache = SignatureCache()
    V.verify_commit(CHAIN, vals, bid, h, commit, cache=cache, device="cpu")
    assert len(cache) == N_VALS
    V.verify_commit(CHAIN, vals, bid, h, commit, cache=cache, device="cpu")
    assert cache.hits == N_VALS


# --- trusting, mixed jobs, extended commits -----------------------------


def _jax_commit(commit, sigs=None):
    """The JAX package's twin of a port commit (same signatures)."""
    sigs = commit.signatures if sigs is None else sigs
    bid = commit.block_id
    jbid = jB.BlockID(bid.hash, jB.PartSetHeader(bid.part_set_header.total,
                                                  bid.part_set_header.hash))
    return jB.Commit(commit.height, commit.round, jbid,
                     [jB.CommitSig(c.block_id_flag, c.validator_address, c.timestamp_ns,
                                   c.signature) for c in sigs])


def _double_vote(commit):
    """The first signature twice: a double vote from one validator."""
    sigs = [commit.signatures[0]] + list(commit.signatures)
    return B.Commit(commit.height, commit.round, commit.block_id, sigs)


TRUSTING = [
    (h, tl) for h in (1, TAMPER, UNDER, NIL) for tl in (Fraction(1, 3), Fraction(2, 3))
] + [("double", Fraction(1, 3)), (1, Fraction(1, 4)), (1, Fraction(4, 3))]


@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("h,trust", TRUSTING, ids=lambda v: str(v))
def test_trusting_matches_jax(window, h, trust, priority):
    ours, theirs, _, _ = window
    if h == "double":
        vals, commit = ours[0][0], _double_vote(ours[0][3])
        jvals, jcommit = theirs[0][0], _jax_commit(commit)
    else:
        vals, commit = ours[h - 1][0], ours[h - 1][3]
        jvals, jcommit = theirs[h - 1][0], theirs[h - 1][3]
    got = _single(V.verify_commit_light_trusting, CHAIN, vals, commit, trust,
                  priority=priority, device="cpu")
    want = _single(jV.verify_commit_light_trusting, CHAIN, jvals, jcommit, trust,
                   priority=priority)
    assert got == want
    if h == "double":
        assert got == ("CommitVerifyError", "double vote from same validator")
    elif trust.numerator * 3 < trust.denominator or trust > 1:
        assert got == ("CommitVerifyError", "trust level must be in [1/3, 1]")
    elif h == TAMPER:
        assert got == ("ErrInvalidSignature", "invalid signature in trusted commit")


@pytest.mark.parametrize("priority", PRIORITIES)
def test_jobs_coalesced_matches_jax(window, priority):
    ours, theirs, _, _ = window
    jobs, jjobs = [], []
    for h in (1, TAMPER, UNDER, NIL, 2):
        vals, bid, _, commit = ours[h - 1]
        jvals, jbid, _, jcommit = theirs[h - 1]
        jobs += [("light", vals, bid, h, commit), ("trusting", vals, commit, Fraction(1, 3))]
        jjobs += [("light", jvals, jbid, h, jcommit), ("trusting", jvals, jcommit, Fraction(1, 3))]
    vals, bid, _, commit = ours[0]
    jvals, jbid, _, jcommit = theirs[0]
    jobs += [("light", vals, bid, 7, commit), ("trusting", vals, _double_vote(commit), Fraction(2, 3)),
             ("bogus",)]
    jjobs += [("light", jvals, jbid, 7, jcommit),
              ("trusting", jvals, _jax_commit(_double_vote(commit)), Fraction(2, 3)), ("bogus",)]
    got = _outcome(V.verify_commit_jobs_coalesced(CHAIN, jobs, priority=priority, device="cpu"))
    want = _outcome(jV.verify_commit_jobs_coalesced(CHAIN, jjobs, priority=priority))
    assert got == want
    assert got[2] == ("ErrInvalidSignature", "invalid signature for validator 11")
    assert got[3] == ("ErrInvalidSignature", "invalid signature in trusted commit")
    assert got[4][0] == "ErrNotEnoughVotingPower"
    assert got[-1] == ("CommitVerifyError", "unknown job kind 'bogus'")


EXTENDED = ["valid", "missing_ext_sig", "ext_on_nil", "bad_ext_sig", "unbound"]


def _extended(window, case):
    """An extended commit for a height, in both packages."""
    ours, theirs, _, privs = window
    h = NIL if case == "ext_on_nil" else 1
    vals, bid, _, commit = ours[h - 1]
    ext_sigs, jext_sigs = [], []
    for i, cs in enumerate(commit.signatures):
        ext, esig = b"", b""
        if cs.for_block():
            ext = b"ext-%d" % i
            esig = privs[i].sign(C.vote_extension_sign_bytes(CHAIN, h, commit.round, ext))
            if case == "bad_ext_sig" and i == 3:
                esig = bytes([esig[0] ^ 1]) + esig[1:]
            if case == "missing_ext_sig" and i == 30:
                esig = b""
        elif case == "ext_on_nil" and i == 14:
            ext = b"attacker bytes"
        fields = (cs.block_id_flag, cs.validator_address, cs.timestamp_ns, cs.signature, ext, esig)
        ext_sigs.append(B.ExtendedCommitSig(*fields))
        jext_sigs.append(jB.ExtendedCommitSig(*fields))
    jbid = theirs[h - 1][1]
    ec = B.ExtendedCommit(h, commit.round, bid, ext_sigs)
    jec = jB.ExtendedCommit(h, commit.round, jbid, jext_sigs)
    bound = h + 1 if case == "unbound" else h
    return vals, theirs[h - 1][0], bid.hash, bound, ec, jec


@pytest.mark.parametrize("priority", PRIORITIES)
@pytest.mark.parametrize("case", EXTENDED)
def test_extended_commit_matches_jax(window, case, priority):
    vals, jvals, block_hash, h, ec, jec = _extended(window, case)
    assert C.vote_extension_sign_bytes(CHAIN, 5, 1, b"e") == jC.vote_extension_sign_bytes(
        CHAIN, 5, 1, b"e")
    got = _single(V.verify_extended_commit, CHAIN, vals, block_hash, h, ec,
                  priority=priority, device="cpu")
    want = _single(jV.verify_extended_commit, CHAIN, jvals, block_hash, h, jec,
                   priority=priority)
    assert got == want
    assert got == {
        "valid": None,
        "missing_ext_sig": ("CommitVerifyError", "commit sig 30 missing extension signature"),
        "ext_on_nil": ("CommitVerifyError", "sig 14: extension data on non-commit lane"),
        "bad_ext_sig": ("CommitVerifyError", "invalid extension signature"),
        "unbound": ("CommitVerifyError", "extended commit does not bind to block"),
    }[case]
