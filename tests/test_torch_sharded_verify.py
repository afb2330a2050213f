"""The port's multi-device lanes against the JAX package's and the oracle.

``parallel/sharded_verify.py`` and the sharded dispatch of
``ops/ed25519.verify_batch_async``, on a mesh of eight CPU entries (the
stand-in for the JAX suite's eight virtual CPU devices): each entry
runs the kernels' plain versions on its slice.

- The shape of ``tests/test_sharded_verify.py``'s default-lane case: 24
  lanes with bad lanes {2, 9}, sharded over the eight entries; the
  verdicts equal ``ref_ed25519.verify_zip215``'s and the JAX package's
  sharded verify on its 8-device CPU mesh, and ``LAST_DISPATCH``
  records the sharding as the JAX dispatch does. Its ``lanes`` differ
  by design: the JAX dispatch pads to a power-of-two compile bucket
  (128 here), the port only to a multiple of the mesh.
- ``parallel/mesh.mesh_for``, the one rule for which devices a
  dispatch splits over; a dispatch on one device is unsharded.
- ``make_sharded_core`` equals the unsharded ``verify_lanes`` in each
  mode, on a lane count that needs padding.
- ``make_quorum_reducer`` on ``tests/test_dryrun.py``'s inputs gives
  the JAX reducer's ``(quorum, tally, ok_lanes)`` on the JAX package's
  8-device CPU mesh, and refuses a total power of 2^31 as it does.
"""

import numpy as np
import pytest
import torch

from cometbft_tpu_torch.crypto import ref_ed25519 as ref
from cometbft_tpu_torch.ops import ed25519 as ed
from cometbft_tpu_torch.parallel.mesh import DATA_AXIS, make_mesh, mesh_for
from cometbft_tpu_torch.parallel.sharded_verify import make_quorum_reducer, make_sharded_core

torch.set_num_threads(1)

CPU8 = [torch.device("cpu")] * 8


def signed_items(n, bad, seed=3):
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        sk = rng.bytes(32)
        pk = ref.public_from_seed(sk)
        m = bytes(rng.bytes(23))
        sig = ref.sign(sk, m)
        if i in bad:
            sig = sig[:32] + bytes([sig[32] ^ 1]) + sig[33:]
        items.append((m, pk, sig))
    return items


def test_verify_batch_shards_over_all_devices():
    bad = {2, 9}
    items = signed_items(24, bad)
    mesh = make_mesh(devices=CPU8)
    got = ed.verify_batch(items, device=mesh)
    d = ed.LAST_DISPATCH
    assert d["sharded"] is True
    assert d["n_devices"] == len(mesh) == 8
    assert d["lanes"] % 8 == 0
    want = [ref.verify_zip215(pk, m, sig) for m, pk, sig in items]
    assert want == [i not in bad for i in range(24)]
    assert list(got) == want


def test_sharded_dispatch_matches_jax_on_8_device_mesh():
    import jax

    from cometbft_tpu.ops import ed25519 as jed

    assert len(jax.devices()) == 8
    bad = {2, 9}
    items = signed_items(24, bad)
    got = ed.verify_batch(items, device=make_mesh(devices=CPU8))
    d = dict(ed.LAST_DISPATCH)
    jgot = jed.verify_batch(items)
    jd = jed.LAST_DISPATCH
    assert list(got) == list(jgot) == [i not in bad for i in range(24)]
    assert (d["sharded"], d["n_devices"]) == (jd["sharded"], jd["n_devices"]) == (True, 8)
    assert d["lanes"] == 24 and jd["lanes"] == jed._pad_n(24) == 128
    assert d["lanes"] % 8 == jd["lanes"] % 8 == 0


def test_mesh_for_is_the_one_sharding_rule(monkeypatch):
    cpu = torch.device("cpu")
    assert mesh_for("cpu") == [cpu]
    assert mesh_for(CPU8) == CPU8
    assert mesh_for((cpu,)) == [cpu]
    ed.verify_batch(signed_items(3, ()), device="cpu")
    d = ed.LAST_DISPATCH
    assert (d["sharded"], d["n_devices"], d["lanes"], d["devices"]) == (False, 1, 3, ["cpu"])
    # two cards, stood in for: a device naming no card splits over both,
    # one naming a card by index stays on it
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cards = [torch.device("cuda", 0), torch.device("cuda", 1)]
    assert mesh_for(None) == mesh_for("cuda") == cards
    assert mesh_for("cuda:1") == [cards[1]]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert mesh_for("cuda") == [torch.device("cuda")]


def test_make_mesh_needs_a_card_unless_given_devices():
    assert DATA_AXIS == "sig"
    assert make_mesh(3, devices=CPU8) == CPU8[:3]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()
    with pytest.raises(ValueError):
        make_mesh(devices=[])


@pytest.mark.parametrize("mode", ["plain", "precomp", "precomp_tuple"])
def test_sharded_core_equals_unsharded(mode):
    """21 lanes over 8 entries (padded to 24), one forged signature and
    one key that fails decompression."""
    items = signed_items(21, {4}, seed=11)
    m, _, sig = items[13]
    items[13] = (m, b"\x00" * 31 + b"\xff", sig)
    precomp = mode != "plain"
    msgs, lens, pr, ss, a_arr, bad = ed.pack(items, precomp)
    verdicts, events = make_sharded_core(make_mesh(devices=CPU8), mode)(msgs, lens, pr, ss, a_arr)
    assert len(verdicts) == 8 and all(v.shape == (3,) for v in verdicts)
    assert events == [None] * 8
    got = torch.cat(verdicts).numpy()[:21].copy()
    got[bad] = False
    n = len(items)
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    whole = ed.verify_lanes(
        to(msgs), torch.from_numpy(lens), to(pr), to(ss),
        None if a_arr is None else to(a_arr.reshape(n, -1)).view(4, 10, n),
    ).numpy().copy()
    whole[bad] = False
    want = [ref.verify_zip215(pk, m, s) for m, pk, s in items]
    assert list(got) == list(whole) == want
    assert not want[4] and not want[13]


def test_sharded_core_refuses_a_mode_it_lacks():
    with pytest.raises(ValueError, match="mode"):
        make_sharded_core(CPU8, "tuple")
    msgs, lens, pr, ss, a_arr, _ = ed.pack(signed_items(2, ()), False)
    with pytest.raises(ValueError, match="expanded keys"):
        make_sharded_core(CPU8, "precomp")(msgs, lens, pr, ss, None)


def test_quorum_reducer_matches_jax_on_8_device_mesh():
    import jax
    import jax.numpy as jnp

    from cometbft_tpu.parallel.mesh import make_mesh as jmake_mesh
    from cometbft_tpu.parallel.sharded_verify import make_quorum_reducer as jmake_quorum_reducer

    assert len(jax.devices()) >= 8
    n = 16
    ok = np.ones(n, bool)
    ok[5] = False
    powers = np.arange(1, n + 1, dtype=np.int32)
    total = int(powers.sum())
    threshold = total * 2 // 3
    jq, jt, jok = jmake_quorum_reducer(jmake_mesh(8))(
        jnp.asarray(ok), jnp.asarray(powers), jnp.int32(threshold)
    )
    quorum, tally, ok_lanes = make_quorum_reducer(make_mesh(devices=CPU8))(ok, powers, threshold)
    assert tally.dtype == torch.int32
    assert int(tally) == int(jt) == total - 6
    assert bool(quorum) == bool(jq) == ((total - 6) * 3 > total * 2)
    assert ok_lanes.tolist() == list(np.asarray(jok)) == list(ok)


def test_quorum_reducer_rejects_int32_overflow():
    from cometbft_tpu.parallel.mesh import make_mesh as jmake_mesh
    from cometbft_tpu.parallel.sharded_verify import make_quorum_reducer as jmake_quorum_reducer

    powers = np.full(8, 2**28, np.int64)  # sums past 2**31
    with pytest.raises(ValueError, match="voting power"):
        jmake_quorum_reducer(jmake_mesh(8))(np.ones(8, bool), powers, np.int32(0))
    with pytest.raises(ValueError, match="voting power"):
        make_quorum_reducer(make_mesh(devices=CPU8))(np.ones(8, bool), powers, 0)
    # just under the guard: the int32 tally is exact
    powers = np.full(8, (2**31 - 1) // 8, np.int64)
    _, tally, _ = make_quorum_reducer(make_mesh(devices=CPU8))(np.ones(8, bool), powers, 0)
    assert int(tally) == int(powers.sum())


def test_a_failing_slice_fails_the_whole_dispatch(monkeypatch):
    """No partial fallback: one slice that raises makes the dispatch
    raise, with no verdict for any lane."""
    calls = []
    real = ed.verify_lanes

    def third_fails(*args):
        calls.append(args[0].shape[1])
        if len(calls) == 3:
            raise RuntimeError("slice 2 fell over")
        return real(*args)

    monkeypatch.setattr(ed, "verify_lanes", third_fails)
    with pytest.raises(RuntimeError, match="slice 2"):
        ed.verify_batch(signed_items(8, ()), device=make_mesh(devices=CPU8))
    assert calls == [1, 1, 1]
