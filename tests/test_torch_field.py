"""Port field and scalar ops vs Python ints and the JAX compact ops.

The port's radix-2^25.5 field (cometbft_tpu_torch/ops/fe25519.py) and
21-bit scalar limbs (ops/sc25519.py) against big-int arithmetic and
against the JAX package's compact-mode ops on the same inputs. All of
it is integer arithmetic: the tolerance is exact equality of canonical
values (mod p, mod L), and of the window digits themselves.
"""

import random
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.ops import curve25519 as jcurve
from cometbft_tpu.ops import ed25519 as jed
from cometbft_tpu.ops import fe25519 as jfe
from cometbft_tpu.ops import sc25519 as jsc
from cometbft_tpu_torch.ops import curve25519 as curve
from cometbft_tpu_torch.ops import ed25519 as ed
from cometbft_tpu_torch.ops import fe25519 as fe
from cometbft_tpu_torch.ops import sc25519 as sc
from cometbft_tpu_torch.ops import sha512 as sha

# the plain versions run many small torch ops: one intra-op thread per
# test process, so parallel test workers do not oversubscribe the cores
torch.set_num_threads(1)

P = fe.P
L = sc.L
CSRC = Path(__file__).resolve().parent.parent / "cometbft_tpu_torch" / "csrc"


@pytest.fixture
def compact():
    jfe.set_compact(True)
    try:
        yield
    finally:
        jfe.set_compact(None)


def _vals(n, seed=99):
    rng = random.Random(seed)
    vals = [0, 1, 2, P - 1, P - 2, P, P + 1, 2 * P - 1, (1 << 255) - 1]
    while len(vals) < n:
        vals.append(rng.randrange(0, 1 << 256))
    return vals[:n]


def _port(vals):
    return torch.tensor(np.stack([fe.to_limbs(v) for v in vals], 1))


def _jax(vals):
    return jfe.unstack(jnp.asarray(np.stack([jfe.to_limbs(v) for v in vals], 1)))


def _port_ints(t):
    a = t.numpy()
    return [fe.from_limbs(a[:, i]) for i in range(a.shape[1])]


def _jax_ints(x):
    a = np.asarray(jfe.stack(x))
    return [jfe.from_limbs(a[:, i]) for i in range(a.shape[1])]


@pytest.mark.parametrize("op", ["mul", "square", "add", "sub", "neg"])
def test_field_ops_match_ints_and_jax(compact, op):
    va, vb = _vals(24), list(reversed(_vals(24, seed=7)))
    ints = {
        "mul": [x * y for x, y in zip(va, vb)],
        "square": [x * x for x in va],
        "add": [x + y for x, y in zip(va, vb)],
        "sub": [x - y for x, y in zip(va, vb)],
        "neg": [-x for x in va],
    }[op]
    args_p = (_port(va), _port(vb))[: 1 if op in ("square", "neg") else 2]
    args_j = (_jax(va), _jax(vb))[: 1 if op in ("square", "neg") else 2]
    got = _port_ints(getattr(fe, op)(*args_p))
    assert got == [v % P for v in ints]
    assert got == _jax_ints(getattr(jfe, op)(*args_j))


def test_pow2523_canonical_parity_is_zero(compact):
    va = _vals(12)
    x = _port(va)
    got = _port_ints(fe.pow2523(x))
    assert got == [pow(v, (P - 5) // 8, P) for v in va]
    assert got == _jax_ints(jfe.pow2523(_jax(va)))
    can = fe.canonical(x).numpy()
    for i, v in enumerate(va):
        assert sum(int(can[k, i]) << fe.OFFSETS[k] for k in range(10)) == v % P
    assert fe.parity(x).tolist() == [(v % P) & 1 for v in va]
    assert fe.parity(x).tolist() == np.asarray(jfe.parity(_jax(va))).tolist()
    assert fe.is_zero(x).tolist() == [v % P == 0 for v in va]


def test_from_bytes_255_matches_jax(compact):
    vals = _vals(16)
    b = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals], 1)
    y, sign = fe.from_bytes_255(torch.tensor(b))
    jy, jsign = jfe.from_bytes_255(jnp.asarray(b))
    assert _port_ints(y) == _jax_ints(jy)
    assert sign.tolist() == np.asarray(jsign).tolist()
    assert _port_ints(y) == [(v & ((1 << 255) - 1)) % P for v in vals]


def _digest_bytes(vals):
    return np.stack([np.frombuffer(v.to_bytes(64, "little"), np.uint8) for v in vals], 1)


def test_reduce_512_neg_digits_match_ints_and_jax(compact):
    rng = random.Random(3)
    vals = [0, 1, L - 1, L, L + 1, 2 * L, (1 << 512) - 1, L << 259, 1 << 252]
    vals += [rng.randrange(1 << 512) for _ in range(23)]
    b = _digest_bytes(vals)
    h = sc.reduce_512(sc.hash_bytes_to_limbs(torch.tensor(b)))
    assert [sc.from_limbs(h[:, i].numpy()) for i in range(len(vals))] == [v % L for v in vals]
    hneg = sc.neg_mod_L(h)
    assert [sc.from_limbs(hneg[:, i].numpy()) for i in range(len(vals))] == [
        L - v % L for v in vals
    ]
    jh = jsc.reduce_512(jsc.hash_bytes_to_limbs(jnp.asarray(b)))
    jneg = jsc.neg_mod_L(jh)
    assert np.array_equal(sc.digits4(h).numpy(), np.asarray(jsc.digits4(jh)))
    assert np.array_equal(sc.digits4(hneg).numpy(), np.asarray(jsc.digits4(jneg)))


def test_lt_L_and_scalar_digits_match_jax(compact):
    rng = random.Random(4)
    vals = [0, 1, L - 1, L, L + 1, (1 << 256) - 1, 1 << 252]
    vals += [rng.randrange(1 << 256) for _ in range(9)]
    b = np.stack([np.frombuffer(v.to_bytes(32, "little"), np.uint8) for v in vals], 1)
    s = sc.scalar_from_bytes(torch.tensor(b))
    js = jfe.from_bytes_256(jnp.asarray(b))
    assert sc.lt_L(s).tolist() == [v < L for v in vals]
    assert sc.lt_L(s).tolist() == np.asarray(jsc.lt_L(js)).tolist()
    assert np.array_equal(sc.digits4(s).numpy(), np.asarray(jsc.digits4(js)))


def test_limbs_from_jax_carries_tables_and_keys():
    assert np.array_equal(
        fe.limbs_from_jax(jcurve.base_window_table()), curve.base_window_table()
    )
    from cometbft_tpu_torch.crypto import ref_ed25519 as ref

    for seed in (b"\x01" * 32, b"\x02" * 32):
        pk = ref.public_from_seed(seed)
        ours = ed._expand_pubkey(pk)
        assert np.array_equal(fe.limbs_from_jax(jed._expand_pubkey(pk)), ours)
    # non-canonical input (limbs summing past p) reduces mod p
    arr = np.full((20,), 8191, np.int32)
    want = sum(8191 << (13 * i) for i in range(20)) % P
    assert fe.from_limbs(fe.limbs_from_jax(arr)) == want


def _cu_ints(name, text):
    body = re.search(name + r"\(\)\s*\{\s*return Fe\{\{([^}]*)\}\}", text).group(1)
    return [int(v) for v in body.split(",")]


def test_csrc_constants_match_python():
    """The CUDA sources spell some constants out; hold them to Python."""
    hdr = (CSRC / "fe25519.cuh").read_text()
    for name, val in (("fe_d", curve.D), ("fe_d2", curve.D2), ("fe_sqrtm1", curve.SQRT_M1)):
        assert _cu_ints(name, hdr) == [int(v) for v in fe.to_limbs(val)], name
    hd = (CSRC / "hash_digits.cu").read_text()

    def words(name):
        body = re.search(name + r" = \{([^}]*)\}", hd).group(1)
        return [int(x, 16) for x in re.findall(r"0x([0-9a-f]{16})ULL", body)]

    assert words(r"SHA_K\[80\]") == sha.K64 and words(r"H\[8\]") == sha.H64
    assert words(r"Lw\[4\]") == [(sc.L >> (64 * i)) % 2**64 for i in range(4)]
    ls = re.search(r"Ls\[13\] = \{([^}]*)\}", hd).group(1)
    assert [int(v) for v in ls.replace("\n", " ").split(",")] == list(sc.L_LIMBS)
    folds = [int(v) for v in re.findall(r"s\[k\] \* (\d+)", hd)]
    assert folds == [abs(v) for v in sc._FOLD]
    signs = re.findall(r"s\[k - \d+\] ([+-])= s\[k\]", hd)
    assert signs == ["+" if v > 0 else "-" for v in sc._FOLD]
    assert [(1 << 27) - 38] + [
        (1 << 26) - 2 if i % 2 else (1 << 27) - 2 for i in range(1, 10)
    ] == list(fe.TWO_P)
