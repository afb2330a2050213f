"""The port's native wire codec (``native/wirecodec.cpp``) against its
portable twin and the JAX package.

The seven cases of ``tests/test_wirecodec_native.py`` on the port: the
native commit encode and decode, SHA-256, merkle fold and varints must
be byte-identical to the port's Python paths AND to the JAX package's
output on the same inputs, which a seeded numpy generator makes. Two
more hold ``Commit.hash`` and the state blob (``state/store.py``'s
priority vectors through ``varints``) on port objects to the same
three-way equality. Tolerance: exact bytes throughout. Skips when the
extension cannot build (no compiler).
"""

import hashlib
from contextlib import contextmanager

import numpy as np
import pytest

from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.state import store as jstore
from cometbft_tpu.types import block as JB
from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc
from cometbft_tpu.utils import codec as jcodec
from cometbft_tpu.utils import proto as jproto
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.node.inprocess import make_genesis
from cometbft_tpu_torch.state import store
from cometbft_tpu_torch.types import block as B
from cometbft_tpu_torch.utils import codec, proto, wirecodec

nat = wirecodec.LANE.wait()
pytestmark = pytest.mark.skipif(nat is None, reason=f"native wirecodec: {wirecodec.LANE.reason}")


@contextmanager
def portable():
    """The port's Python paths only, for the body of the block."""
    wirecodec.LANE.force_portable()
    try:
        yield
    finally:
        wirecodec.LANE.restore()


def _sig_rows(rng, n):
    rows = []
    for _ in range(n):
        rows.append((
            int(rng.choice([1, 2, 3])),
            rng.bytes(20) if rng.random() > 0.15 else b"",
            int(rng.integers(0, 2**62)),
            rng.bytes(64) if rng.random() > 0.15 else b"",
        ))
    return rows


def _commits(rng, n_sigs):
    """The same commit as a port object and as a JAX object."""
    height, round_ = int(rng.integers(1, 2**45)), int(rng.integers(0, 10))
    bid, psh = rng.bytes(32), rng.bytes(32)
    rows = _sig_rows(rng, n_sigs)
    port = B.Commit(height, round_, B.BlockID(bid, B.PartSetHeader(3, psh)),
                    [B.CommitSig(*r) for r in rows])
    jax = JB.Commit(height, round_, JB.BlockID(bid, JB.PartSetHeader(3, psh)),
                    [JB.CommitSig(*r) for r in rows])
    return port, jax


def _sig_tuples(c):
    return [(s.block_id_flag, s.validator_address, s.timestamp_ns, s.signature) for s in c.signatures]


def _decoded(decode, b):
    try:
        c = decode(b)
    except ValueError:
        return ("err",)
    return ("ok", c.height, c.round, c.block_id.key(), _sig_tuples(c))


def test_encode_byte_identical_and_roundtrip():
    rng = np.random.default_rng(7)
    for _ in range(40):
        c, jc = _commits(rng, int(rng.integers(0, 180)))
        enc = codec.encode_commit(c)
        with portable():
            assert codec.encode_commit(c) == enc
            back_py = codec.decode_commit(enc)
        assert jcodec.encode_commit(jc) == enc
        back = codec.decode_commit(enc)
        for d in (back, back_py):
            assert (d.height, d.round, d.block_id, d.signatures) == (c.height, c.round, c.block_id,
                                                                     c.signatures)


def test_native_decode_defers_to_python_on_malformed():
    """Truncated or garbage bytes raise ValueError with and without the
    extension, as in the JAX package."""
    rng = np.random.default_rng(8)
    c, _ = _commits(rng, 5)
    enc = codec.encode_commit(c)
    for bad in (enc[:-3], b"\xff" * 10, enc + b"\x07"):
        with pytest.raises(ValueError):
            codec.decode_commit(bad)
        with portable(), pytest.raises(ValueError):
            codec.decode_commit(bad)
        with pytest.raises(ValueError):
            jcodec.decode_commit(bad)


def test_adversarial_inputs_agree_with_python():
    """Crafted bytes that reach the native reader's overflow paths
    either fail in every path or decode to the same values."""
    vectors = [
        bytes([0x22]) + b"\xff" * 9 + b"\x01",  # field 4, length 2^64-1
        bytes([0x08]) + b"\x80" * 9 + b"\x03",  # 10-byte varint height
        bytes([0x08]) + b"\x80" * 10 + b"\x01",  # 11-byte varint
        proto.field_message(4, proto.field_message(3, proto.field_varint(1, 2**62))),
    ]
    for i, b in enumerate(vectors):
        got = _decoded(codec.decode_commit, b)
        with portable():
            py = _decoded(codec.decode_commit, b)
        assert got == py, i
        assert _decoded(jcodec.decode_commit, b) == py, i


def _fold(leaves):
    """The RFC 6962 root, computed inline."""
    if not leaves:
        return hashlib.sha256(b"").digest()
    stack = []
    for it in leaves:
        h, s = hashlib.sha256(b"\x00" + it).digest(), 1
        while stack and stack[-1][1] == s:
            h, s = hashlib.sha256(b"\x01" + stack.pop()[0] + h).digest(), s * 2
        stack.append((h, s))
    h, _ = stack.pop()
    while stack:
        h = hashlib.sha256(b"\x01" + stack.pop()[0] + h).digest()
    return h


def test_merkle_root_matches_python():
    rng = np.random.default_rng(9)
    for _ in range(60):
        leaves = [rng.bytes(int(rng.integers(0, 300))) for _ in range(int(rng.integers(0, 40)))]
        want = _fold(leaves)
        assert nat.merkle_root(leaves) == want
        assert merkle.hash_from_byte_slices(leaves) == want
        with portable():
            assert merkle.hash_from_byte_slices(leaves) == want
        assert jmerkle.hash_from_byte_slices(leaves) == want


def test_native_sha256_edge_lengths():
    rng = np.random.default_rng(10)
    for ln in (0, 1, 55, 56, 57, 63, 64, 65, 127, 128, 4096):
        b = rng.bytes(ln)
        assert nat.merkle_root([b]) == hashlib.sha256(b"\x00" + b).digest() == merkle.leaf_hash(b), ln
        assert nat.sha256_many([b]) == [hashlib.sha256(b).digest()], ln


def test_varints_byte_identical():
    rng = np.random.default_rng(11)
    for _ in range(50):
        nums = [int(x) for x in rng.integers(-(2**63), 2**63 - 1, size=int(rng.integers(0, 60)),
                                             endpoint=True)]
        want = b"".join(proto.varint(x) for x in nums)
        assert nat.varints(nums) == want == b"".join(jproto.varint(x) for x in nums)


def test_commit_hash_native_equals_python():
    rng = np.random.default_rng(12)
    for _ in range(20):
        c, jc = _commits(rng, int(rng.integers(0, 160)))
        want = merkle.hash_from_byte_slices([cs.encode() for cs in c.signatures])
        assert nat.commit_merkle_root(c.signatures) == want
        assert c.hash() == want
        with portable():
            c._hash = None
            assert c.hash() == want
        assert jc.hash() == want


@pytest.mark.parametrize("n_vals", [1, 4, 150])
def test_state_blob_native_equals_portable_and_jax(n_vals):
    """``encode_state`` of one state, its priorities drawn from a seed:
    the native varints, the port's Python varints and the JAX package
    give the same bytes, and the blob decodes to the same priorities."""
    rng = np.random.default_rng(13 + n_vals)
    gen, _ = make_genesis(n_vals, chain_id="blob", genesis_time_ns=1_700_000_000_000_000_000)
    jgen = JGenesisDoc.from_json(gen.to_json())
    st, jst = gen.make_genesis_state(), jgen.make_genesis_state()
    for vs, jvs in ((st.validators, jst.validators), (st.next_validators, jst.next_validators),
                    (st.last_validators, jst.last_validators)):
        if vs is None or not vs.validators:
            continue
        prios = [int(x) for x in rng.integers(-(2**62), 2**62, size=len(vs.validators))]
        for v, jv, p in zip(vs.validators, jvs.validators, prios):
            v.proposer_priority = jv.proposer_priority = p
    blob = store.encode_state(st)
    with portable():
        assert store.encode_state(st) == blob
    assert jstore.encode_state(jst) == blob
    back = store.decode_state(blob)
    assert [v.proposer_priority for v in back.validators.validators] == \
        [v.proposer_priority for v in st.validators.validators]
