"""Port decompression and ladder vs the JAX package (compact mode).

``decompress_plain`` (kernel K2's plain version) against JAX
``curve25519.decompress`` on valid keys, non-canonical y >= p, x = 0
with the sign bit set, non-squares and small-order points; then
``straus_plain`` (K1's plain version) against JAX ``ed25519._straus``
on the same digits and the same A, carried across with
``fe25519.limbs_from_jax``. X, Y and Z are compared mod p: the two
packages evaluate the same formulas, so the projective coordinates
agree exactly, not just up to scale.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import curve25519 as jcurve
from cometbft_tpu.ops import ed25519 as jed
from cometbft_tpu.ops import fe25519 as jfe
from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.ops import curve25519 as curve
from cometbft_tpu_torch.ops import fe25519 as fe
from cometbft_tpu_torch.ops import ladder

# the plain versions run many small torch ops: one intra-op thread per
# test process, so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

P = fe.P


@pytest.fixture
def compact():
    jfe.set_compact(True)
    try:
        yield
    finally:
        jfe.set_compact(None)


def _torsion_encodings(rng):
    """Encodings of points of small order: [L]Q kills Q's prime-order
    part and leaves its torsion component."""
    out = []
    while len(out) < 3:
        q = ref.point_decompress(rng.bytes(32))
        if q is None:
            continue
        t = ref.point_mul(ref.L, q)
        if not ref.point_equal(t, ref.IDENTITY):
            out.append(ref.point_compress(t))
    return out


def _encodings():
    rng = np.random.default_rng(21)
    encs = [
        ref.point_compress(ref.IDENTITY),
        (P - 1).to_bytes(32, "little"),          # order 2
        (P + 1).to_bytes(32, "little"),          # y >= p
        P.to_bytes(32, "little"),                # y = p
        (2**255 - 1).to_bytes(32, "little"),     # top of the range
        (1 << 255).to_bytes(32, "little"),       # x = 0 with sign bit
        ((1 << 255) | 1).to_bytes(32, "little"),
        (2).to_bytes(32, "little"),              # not on the curve
    ]
    encs += _torsion_encodings(rng)
    encs += [ref.public_from_seed(bytes([i]) * 32) for i in range(5)]
    encs += [rng.bytes(32) for _ in range(16 - len(encs))]
    return encs


def _bytes(encs):
    return np.stack([np.frombuffer(e, np.uint8) for e in encs], 1)


def _ints_port(pt):
    a = pt.numpy()
    return [[fe.from_limbs(a[k, :, i]) for k in range(a.shape[0])] for i in range(a.shape[2])]


def _ints_jax(pt):
    a = np.stack([np.asarray(jfe.stack(c)) for c in pt if c is not None])
    return [[jfe.from_limbs(a[k, :, i]) for k in range(a.shape[0])] for i in range(a.shape[2])]


def test_decompress_matches_jax_and_ref(compact):
    encs = _encodings()
    b = _bytes(encs)
    pt, ok = curve.decompress(torch.tensor(b))
    jpt, jok = jax.jit(jcurve.decompress)(jnp.asarray(b))
    assert ok.tolist() == np.asarray(jok).tolist()
    assert _ints_port(pt) == _ints_jax(jpt)
    for i, e in enumerate(encs):
        want = ref.point_decompress(e)
        assert ok[i].item() == (want is not None), i
        if want is not None:
            x, y, _, t = _ints_port(pt)[i]
            assert (x, y, t) == (want[0], want[1], want[3]), i
    assert not ok[7] and ok[:7].all()


def test_straus_matches_jax(compact):
    n = 8
    rng = np.random.default_rng(5)
    encs = [ref.public_from_seed(bytes([i + 1]) * 32) for i in range(n - 2)]
    encs += [(P - 1).to_bytes(32, "little"), ref.point_compress(ref.IDENTITY)]
    jA, jok = jax.jit(jcurve.decompress)(jnp.asarray(_bytes(encs)))
    assert np.asarray(jok).all()
    # carry the JAX points across in the port's limb form
    stacked = np.stack([np.asarray(jfe.stack(c)) for c in jA])  # (4, 20, n)
    A = torch.tensor(fe.limbs_from_jax(stacked, axis=1).astype(np.int32))
    ds = rng.integers(0, 16, (64, n), dtype=np.uint8)
    dh = rng.integers(0, 16, (64, n), dtype=np.uint8)
    got = ladder.straus_plain(torch.tensor(ds), torch.tensor(dh), A)
    want = jax.jit(lambda a, b, p: jed._straus(a, b, p, (n,))[:3])(
        jnp.asarray(ds, jnp.int32), jnp.asarray(dh, jnp.int32), jA
    )
    assert _ints_port(got) == _ints_jax(want)
