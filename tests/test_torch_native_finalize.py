"""The port's native finalize lane (``native/finalize.cpp``) against its
portable twin and the JAX package.

The thirteen cases of ``tests/test_native_finalize.py`` on the port: the
one pass a block (per-tx SHA-256, ``ExecTxResult`` encodings,
LastResultsHash, ABCI event encodings) and the part leaf hashes must be
byte-identical between the native pass, the port's portable pass and
the JAX package's derivations (``execution.results_hash``,
``_enc_abci_event``, ``r.encode()``, the stored response, the indexer's
rows) on blocks a seeded numpy generator makes; the loader must degrade
around a corrupt library and recover, obey ``GRAFT_NATIVE_FINALIZE=0``
and prewarm once; vecbank's vector and scalar forms and the JAX app
give one app hash. Tolerance: exact bytes throughout. Native-backed
cases skip when the extension cannot build.
"""

import hashlib
import os

import numpy as np
import pytest

from cometbft_tpu.abci import types as jabci
from cometbft_tpu.crypto import merkle as jmerkle
from cometbft_tpu.state import execution as jexecution
from cometbft_tpu.state import indexer as jindexer
from cometbft_tpu.types.part_set import PartSet as JPartSet
from cometbft_tpu.utils.kv import MemKV as JMemKV
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.crypto import merkle
from cometbft_tpu_torch.state import execution, indexer, native_finalize
from cometbft_tpu_torch.types.part_set import PartSet
from cometbft_tpu_torch.utils import native
from cometbft_tpu_torch.utils.kv import MemKV

nat = native_finalize.LANE.wait()
needs_native = pytest.mark.skipif(nat is None, reason=f"native finalize: {native_finalize.LANE.reason}")

LANE = native_finalize.LANE


# --- one block, as port objects and as JAX objects --------------------------


def _attr(rng, i):
    roll = rng.random()
    if roll < 0.2:
        return ("pair", b"bk%d" % i, b"bv%d" % i)  # a bare 2-tuple, indexed
    if roll < 0.4:
        return ("triple", "k%d" % i, "vé%d" % i, bool(rng.random() < 0.5))  # unicode
    return ("attr", "key%d" % i, "value-%d" % int(rng.integers(1000)), bool(rng.random() < 0.7))


def _event(rng):
    return (str(rng.choice(["app", "transfer", "vént", ""])),
            [_attr(rng, i) for i in range(int(rng.integers(0, 4)))])


def _result(rng, empty_events=False):
    return {
        "code": int(rng.choice([0, 0, 0, 1, 5])),
        "data": rng.bytes(int(rng.integers(0, 24))),
        "gas_wanted": int(rng.integers(0, 2**40)),
        "gas_used": int(rng.integers(0, 2**40)),
        "codespace": str(rng.choice(["", "", "bank", "cøde"])),
        "events": [] if empty_events else [_event(rng) for _ in range(int(rng.integers(0, 3)))],
    }


def _block(rng, n_txs=None):
    """(txs, results, block events) in a neutral form; every third tx
    has no events, so the stored response's index-keyed field 5 skips."""
    n = int(rng.integers(0, 9)) if n_txs is None else n_txs
    txs = [rng.bytes(int(rng.integers(0, 64))) for _ in range(n)]
    return txs, [_result(rng, i % 3 == 1) for i in range(n)], [_event(rng) for _ in range(int(rng.integers(0, 3)))]


def _objects(mod, results, events, app_hash=b"\x11" * 32):
    def attr(a):
        if a[0] == "pair":
            return (a[1], a[2])
        if a[0] == "triple":
            return (a[1], a[2], a[3])
        return mod.EventAttribute(key=a[1], value=a[2], index=a[3])

    def event(e):
        return mod.Event(type_=e[0], attributes=[attr(a) for a in e[1]])

    res = [mod.ExecTxResult(code=r["code"], data=r["data"], gas_wanted=r["gas_wanted"],
                            gas_used=r["gas_used"], codespace=r["codespace"],
                            events=[event(e) for e in r["events"]]) for r in results]
    return mod.ResponseFinalizeBlock(events=[event(e) for e in events], tx_results=res,
                                     app_hash=app_hash)


def _both(rng, n_txs=None):
    txs, results, events = _block(rng, n_txs)
    return txs, _objects(abci, results, events), _objects(jabci, results, events)


FIELDS = ("tx_hashes", "results_enc", "results_hash", "tx_events_flat", "tx_events_enc",
          "block_events_flat", "block_events_enc")


def _check_parity(txs, jresp, arts):
    """Artifacts (either pass) against the JAX package's derivations."""
    assert arts.tx_hashes == [hashlib.sha256(t).digest() for t in txs]
    assert arts.results_enc == [r.encode() for r in jresp.tx_results]
    assert arts.results_hash == jexecution.results_hash(jresp.tx_results)
    assert arts.tx_events_enc == [[jexecution._enc_abci_event(e) for e in r.events]
                                  for r in jresp.tx_results]
    assert arts.block_events_enc == [jexecution._enc_abci_event(e) for e in jresp.events]


# --- differential ------------------------------------------------------------


@needs_native
def test_native_vs_portable_byte_identical():
    rng = np.random.default_rng(20)
    for _ in range(40):
        txs, resp, jresp = _both(rng)
        a_nat = native_finalize.finalize_pass(txs, resp)
        a_py = native_finalize.finalize_pass(txs, resp, portable=True)
        assert a_nat.native and not a_py.native
        for attr in FIELDS:
            assert getattr(a_nat, attr) == getattr(a_py, attr), attr
        _check_parity(txs, jresp, a_nat)


def test_portable_pass_matches_legacy_derivations():
    rng = np.random.default_rng(21)
    for _ in range(25):
        txs, resp, jresp = _both(rng)
        arts = native_finalize.finalize_pass(txs, resp, portable=True)
        _check_parity(txs, jresp, arts)
        assert arts.results_hash == execution.results_hash(resp.tx_results)


def test_encode_finalize_response_artifacts_identical():
    """The stored response with either pass's artifacts equals the one
    made without them and the JAX package's, and decodes back (the
    index-keyed alignment of txs without events included)."""
    rng = np.random.default_rng(22)
    for portable in (True, False):
        for _ in range(20):
            txs, resp, jresp = _both(rng)
            arts = native_finalize.finalize_pass(txs, resp, portable=portable)
            with_arts = execution.encode_finalize_response(resp, arts)
            assert with_arts == execution.encode_finalize_response(resp)
            assert with_arts == jexecution.encode_finalize_response(jresp)
            back = execution.decode_finalize_response(with_arts)
            assert [r.encode() for r in back.tx_results] == [r.encode() for r in resp.tx_results]
            assert [[native_finalize.encode_event_flat(fe) for fe in native_finalize.flatten_events(r.events)]
                    for r in back.tx_results] == arts.tx_events_enc


def test_enc_tx_result_precomputed_events_identical():
    rng = np.random.default_rng(23)
    for _ in range(20):
        _, results, _ = _block(rng, 1)
        r = _objects(abci, results, []).tx_results[0]
        jr = _objects(jabci, results, []).tx_results[0]
        enc = native_finalize.encode_events_flat(native_finalize.flatten_events(r.events))
        assert indexer._enc_tx_result(r, enc) == indexer._enc_tx_result(r) == jindexer._enc_tx_result(jr)


def test_indexer_rows_with_precomputed_forms_identical():
    rng = np.random.default_rng(24)
    txi, bi = indexer.TxIndexer(MemKV()), indexer.BlockIndexer(MemKV())
    jtxi, jbi = jindexer.TxIndexer(JMemKV()), jindexer.BlockIndexer(JMemKV())
    for _ in range(15):
        txs, resp, jresp = _both(rng, 4)
        arts = native_finalize.finalize_pass(txs, resp)
        for i, tx in enumerate(txs):
            plain = txi.tx_sets(7, i, tx, resp.tx_results[i])
            pre = txi.tx_sets(7, i, tx, resp.tx_results[i], tx_hash=arts.tx_hashes[i],
                              events_flat=arts.tx_events_flat[i], events_enc=arts.tx_events_enc[i])
            assert plain == pre == jtxi.tx_sets(7, i, tx, jresp.tx_results[i])
        assert bi.block_sets(7, resp.events) == bi.block_sets(
            7, resp.events, events_flat=arts.block_events_flat) == jbi.block_sets(7, jresp.events)


def test_flatten_events_single_pass_form():
    rng = np.random.default_rng(25)
    _, _, events = _block(rng, 0)
    events += [_event(rng) for _ in range(6)]
    evs = _objects(abci, [], events).events
    jevs = _objects(jabci, [], events).events
    flat = native_finalize.flatten_events(evs)
    want = [jexecution._enc_abci_event(e) for e in jevs]
    assert [native_finalize.encode_event_flat(fe) for fe in flat] == want
    assert native_finalize.encode_events_flat(flat) == want


# --- part hashing ------------------------------------------------------------


@needs_native
def test_part_leaf_hashes_native_parity():
    rng = np.random.default_rng(26)
    chunks = [rng.bytes(n) for n in (0, 1, 100, 65536, 7)]
    assert native_finalize.part_leaf_hashes(chunks) == [merkle.leaf_hash(c) for c in chunks] == \
        [jmerkle.leaf_hash(c) for c in chunks]


def test_proofs_from_leaf_hashes_identical():
    rng = np.random.default_rng(27)
    for n in (1, 2, 3, 5, 8, 13):
        items = [rng.bytes(50) for _ in range(n)]
        r1, p1 = merkle.proofs_from_byte_slices(items)
        r2, p2 = merkle.proofs_from_leaf_hashes([merkle.leaf_hash(it) for it in items])
        jr, jp = jmerkle.proofs_from_byte_slices(items)
        assert r1 == r2 == jr == merkle.hash_from_byte_slices(items)
        assert p1 == p2
        assert [(p.total, p.index, p.leaf_hash, p.aunts) for p in p2] == \
            [(p.total, p.index, p.leaf_hash, p.aunts) for p in jp]
        for i, p in enumerate(p2):
            assert p.verify(r2, items[i])


def test_partset_from_data_matches_python_proofs(monkeypatch):
    """``PartSet.from_data`` gives the same header and proofs with the
    native leaf hasher, without it, and in the JAX package."""
    rng = np.random.default_rng(28)
    data = rng.bytes(3 * 65536 + 123)
    ps_nat = PartSet.from_data(data)
    monkeypatch.setattr(LANE, "_mod", None)
    monkeypatch.setattr(LANE, "_tried", True)
    ps_py = PartSet.from_data(data)
    jps = JPartSet.from_data(data)
    assert ps_nat.header == ps_py.header
    assert (ps_nat.header.total, ps_nat.header.hash) == (jps.header.total, jps.header.hash)
    for a, b, j in zip(ps_nat.parts, ps_py.parts, jps.parts):
        assert (a.index, a.bytes_, a.proof) == (b.index, b.bytes_, b.proof)
        assert (a.proof.aunts, a.proof.leaf_hash) == (j.proof.aunts, j.proof.leaf_hash)


# --- the loader: a corrupt library, the gate, prewarm ------------------------


def _fresh_loader(monkeypatch, path):
    monkeypatch.setattr(LANE, "path", path)
    monkeypatch.setattr(LANE, "_mod", None)
    monkeypatch.setattr(LANE, "_tried", False)


def test_corrupt_build_artifact_degrades_then_recovers(tmp_path, monkeypatch):
    """A garbage library left by a killed build (newer than its source,
    so the loader takes it as is) leaves the lane unloaded: module() is
    None once, the reason names the load, and the pass runs portable
    with the same bytes. With the library gone, a prewarm rebuilds it
    and the lane comes back."""
    rng = np.random.default_rng(29)
    so = tmp_path / "_finalize.so"
    so.write_bytes(b"\x7fELFgarbage-not-a-real-object")
    t = os.path.getmtime(native.source("finalize")) + 60
    os.utime(so, (t, t))
    _fresh_loader(monkeypatch, so)
    assert native_finalize.module() is None
    assert LANE._tried and LANE.reason.startswith("load failed")
    txs, resp, jresp = _both(rng, 3)
    arts = native_finalize.finalize_pass(txs, resp)
    assert not arts.native
    _check_parity(txs, jresp, arts)
    if nat is None:
        return  # no compiler: nothing to recover with
    so.unlink()
    _fresh_loader(monkeypatch, so)
    th = native_finalize.prewarm()
    assert th is not None
    th.join(120)
    assert native_finalize.module() is not None and so.exists()
    a_nat = native_finalize.finalize_pass(txs, resp)
    assert a_nat.native
    assert (a_nat.results_hash, a_nat.results_enc) == (arts.results_hash, arts.results_enc)


def test_env_gate_disables_native(tmp_path, monkeypatch):
    rng = np.random.default_rng(30)
    monkeypatch.setenv("GRAFT_NATIVE_FINALIZE", "0")
    _fresh_loader(monkeypatch, tmp_path / "_finalize.so")
    assert native_finalize.module() is None
    assert LANE.reason == "disabled: GRAFT_NATIVE_FINALIZE=0"
    assert not (tmp_path / "_finalize.so").exists()
    txs, resp, jresp = _both(rng, 2)
    arts = native_finalize.finalize_pass(txs, resp)
    assert not arts.native
    _check_parity(txs, jresp, arts)


def test_prewarm_is_idempotent_once_tried(monkeypatch):
    monkeypatch.setattr(LANE, "_tried", True)
    assert native_finalize.prewarm() is None


# --- vecbank -----------------------------------------------------------------


def test_vecbank_scalar_vs_vector_digest_identical():
    """The vector form, the scalar form and the JAX package's app agree
    on every block's app hash and codes, wraparound included."""
    from cometbft_tpu.models.vecbank import VecBankApplication as JVecBank
    from cometbft_tpu_torch.models.vecbank import VecBankApplication, make_transfer

    rng = np.random.default_rng(31)
    vec = VecBankApplication(n_accounts=512)
    ser = VecBankApplication(n_accounts=512, scalar=True)
    jax = JVecBank(n_accounts=512)
    assert vec.app_hash == ser.app_hash == jax.app_hash
    for h in range(1, 8):
        txs = [make_transfer(int(s), int(d), int(a))
               for s, d, a in rng.integers(0, [512, 512, 1000], size=(64, 3))]
        txs.append(b"bogus")  # not 16 bytes
        txs.append(make_transfer(9999, 0, 5))  # no such account
        ra = vec.finalize_block(abci.RequestFinalizeBlock(txs=txs, height=h))
        rb = ser.finalize_block(abci.RequestFinalizeBlock(txs=txs, height=h))
        rj = jax.finalize_block(jabci.RequestFinalizeBlock(txs=txs, height=h))
        assert ra.app_hash == rb.app_hash == rj.app_hash
        assert [t.code for t in ra.tx_results] == [t.code for t in rb.tx_results] == \
            [t.code for t in rj.tx_results]
        for app in (vec, ser, jax):
            app.commit()
    assert vec.height == ser.height == 7
    big = make_transfer(1, 2, (1 << 64) - 3)  # wraps mod 2^64
    for app, mod in ((vec, abci), (ser, abci), (jax, jabci)):
        app.finalize_block(mod.RequestFinalizeBlock(txs=[big, big], height=8))
        app.commit()
    assert vec.app_hash == ser.app_hash == jax.app_hash
