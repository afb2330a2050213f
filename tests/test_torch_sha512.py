"""Port per-lane SHA-512 and the K3 stage vs hashlib and the JAX package.

Lengths span all four message buckets of ops/ed25519.MSG_CAPS
(47/175/431/943), including each bucket's edges and the 111/112-byte
padding boundary. Exact equality of digests and window digits.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import fe25519 as jfe
from cometbft_tpu.ops import sc25519 as jsc
from cometbft_tpu.ops import sha512 as jsha
from cometbft_tpu_torch.ops import ed25519 as ed
from cometbft_tpu_torch.ops import sc25519 as sc
from cometbft_tpu_torch.ops import sha512 as sha

# the plain versions run many small torch ops: one intra-op thread per
# test process, so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

LENGTHS = [0, 1, 47, 48, 111, 112, 127, 128, 175, 176, 239, 431, 432, 943]


@pytest.fixture
def compact():
    jfe.set_compact(True)
    try:
        yield
    finally:
        jfe.set_compact(None)


def _msgs(seed=11):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in LENGTHS]


def _pack(msgs, cap):
    data = np.zeros((cap, len(msgs)), np.uint8)
    lens = np.zeros(len(msgs), np.int32)
    for i, m in enumerate(msgs):
        data[: len(m), i] = np.frombuffer(m, np.uint8)
        lens[i] = len(m)
    return data, lens


def test_sha512_matches_hashlib_and_jax():
    msgs = _msgs()
    cap = max(LENGTHS)
    data, lens = _pack(msgs, cap)
    got = sha.sha512(torch.tensor(data), torch.tensor(lens), cap).numpy()
    for i, m in enumerate(msgs):
        assert bytes(got[:, i]) == hashlib.sha512(m).digest(), LENGTHS[i]
    want = np.asarray(jsha.sha512(jnp.asarray(data), jnp.asarray(lens), cap))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("cap", ed.MSG_CAPS)
def test_hash_digits_matches_jax_stages(compact, cap):
    """K3's plain version against the JAX stages of _verify_core:
    sha512(R || A || M) -> reduce_512 -> neg_mod_L -> digits4, plus
    digits4(s) and lt_L(s)."""
    rng = np.random.default_rng(cap)
    msgs = [m[:cap] for m in _msgs(cap)]
    n = len(msgs)
    data, lens = _pack(msgs, cap)
    pks = rng.integers(0, 256, (32, n), dtype=np.uint8)
    rs = rng.integers(0, 256, (32, n), dtype=np.uint8)
    ss = rng.integers(0, 256, (32, n), dtype=np.uint8)
    for i, v in enumerate((sc.L - 1, sc.L, sc.L + 1, 0)):
        ss[:, i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
    ds, dh, ok_s = sc.hash_digits(
        *(torch.tensor(a) for a in (data, lens, pks, rs, ss))
    )
    hin = jnp.concatenate([jnp.asarray(rs), jnp.asarray(pks), jnp.asarray(data)])
    digest = jsha.sha512(hin, jnp.asarray(lens) + 64, cap + 64)
    for i, m in enumerate(msgs):
        want = hashlib.sha512(bytes(rs[:, i]) + bytes(pks[:, i]) + m).digest()
        assert bytes(np.asarray(digest)[:, i]) == want
    h = jsc.reduce_512(jsc.hash_bytes_to_limbs(digest))
    s = jfe.from_bytes_256(jnp.asarray(ss))
    assert np.array_equal(dh.numpy(), np.asarray(jsc.digits4(jsc.neg_mod_L(h))))
    assert np.array_equal(ds.numpy(), np.asarray(jsc.digits4(s)))
    assert ok_s.tolist() == np.asarray(jsc.lt_L(s)).tolist()
    assert ok_s.tolist()[:4] == [True, False, False, True]
