"""The port's verify scheduler against the JAX package's.

Ports the cases of ``tests/test_verify_scheduler.py`` that need neither
a mesh nor chaos: serial-equivalent verdicts, empty tickets, every
class, priority clamping, a custom backend, live preemption at a chunk
boundary, aging promotion, catch-up under a live flood, the queue
stats, the dispatch span and the stats hook. Beside them: the same
items through the JAX scheduler give the same verdicts, the forced
device route runs the kernels' plain versions, and a device route that
fails raises from ``result()`` with no host verdict filled in.

Everything runs on the CPU: the host route, or the forced device route
at <= 16 lanes. Each test gets its own scheduler and host engine, both
closed after it.
"""

import threading
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import parallel_verify as jpv
from cometbft_tpu.crypto import scheduler as jsched
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.batch import CpuBatchVerifier
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey, Secp256k1PrivKey
from cometbft_tpu_torch.crypto.scheduler import (
    PRIORITY_CATCHUP,
    PRIORITY_LIGHT,
    PRIORITY_LIVE,
    VerifyScheduler,
    VerifyTicket,
)
from cometbft_tpu_torch.ops import ed25519 as ops_ed

torch.set_num_threads(1)

CPU = torch.device("cpu")
_RNG = np.random.default_rng(404)
_ED_SEEDS = [_RNG.bytes(32) for _ in range(8)]
_SECP_DS = [int.from_bytes(_RNG.bytes(31), "big") + 1 for _ in range(2)]
_ED_KEYS = [Ed25519PrivKey.from_seed(s) for s in _ED_SEEDS]
_SECP_KEYS = [Secp256k1PrivKey(d) for d in _SECP_DS]
_PUBS = {id(k): k.pub_key() for k in _ED_KEYS + _SECP_KEYS}


def make_items(n, bad=(), mixed=False):
    items = []
    for i in range(n):
        if mixed and i % 5 == 4:
            sk = _SECP_KEYS[i % len(_SECP_KEYS)]
        else:
            sk = _ED_KEYS[i % len(_ED_KEYS)]
        msg = b"sched-lane-%d" % i
        sig = sk.sign(msg)
        if i in bad:
            sig = b"\x00" * len(sig)
        items.append((_PUBS[id(sk)], msg, sig))
    return items


def jax_items(items):
    """The same lanes as JAX-package key objects."""
    out = []
    for pk, msg, sig in items:
        cls = jkeys.Ed25519PubKey if pk.type_ == "ed25519" else jkeys.Secp256k1PubKey
        out.append((cls(pk.key_bytes), msg, sig))
    return out


def serial_verdicts(items):
    v = CpuBatchVerifier()
    for pk, msg, sig in items:
        v.add(pk, msg, sig)
    return v.verify()


@pytest.fixture(autouse=True)
def host_plane():
    """A two-worker host engine per test, closed after it, and no
    scheduler left behind."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield eng
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


@pytest.fixture
def sched():
    s = VerifyScheduler()
    yield s
    s.close()
    assert s._thread is None or not s._thread.is_alive()


@pytest.fixture
def restore_routing():
    old_backend = crypto_batch.default_backend()
    old_floor = crypto_batch._MIN_DEVICE_BATCH
    yield
    crypto_batch.set_default_backend(old_backend)
    crypto_batch.set_min_device_batch(old_floor)


@pytest.fixture
def cpu_backend(restore_routing):
    crypto_batch.set_default_backend("cpu")


# --- verdict parity ------------------------------------------------------


@pytest.mark.parametrize("backend", ["cpu", "cpu-parallel", "cuda"])
def test_serial_equivalence_differential(sched, restore_routing, backend):
    crypto_batch.set_default_backend(backend)
    items = make_items(40, bad={3, 17, 39}, mixed=True)
    want_all, want = serial_verdicts(items)
    ticket = sched.submit(items, priority=PRIORITY_LIVE, label="diff", device=CPU)
    got_all, got = ticket.result(timeout=60)
    assert got == want
    assert got_all == want_all
    assert ticket.backend == backend
    assert ticket.wall() is not None and ticket.wall() >= 0


def test_same_verdicts_as_jax_scheduler(sched, cpu_backend):
    items = make_items(30, bad={0, 11, 29}, mixed=True)
    jitems = jax_items(items)
    assert [s for _, _, s in items] == [s for _, _, s in jitems]
    old = jbatch.default_backend()
    jbatch.set_default_backend("cpu")
    jeng = jpv.ParallelVerifyEngine(workers=2)
    jpv.set_engine(jeng)
    js = jsched.VerifyScheduler()
    try:
        want = js.submit(jitems, priority=jsched.PRIORITY_LIVE).result(timeout=60)
    finally:
        js.close()
        jpv.set_engine(None)
        jeng.close()
        jbatch.set_default_backend(old)
    got = sched.submit(items, priority=PRIORITY_LIVE, device=CPU).result(timeout=60)
    assert got == want
    assert [i for i, ok in enumerate(got[1]) if not ok] == [0, 11, 29]


def test_empty_submit_matches_batch_verifier(sched, cpu_backend):
    t = sched.submit([], priority=PRIORITY_LIGHT, device=CPU)
    assert t.done()
    assert t.result(timeout=1) == (False, [])


def test_all_classes_same_verdicts(sched, cpu_backend):
    items = make_items(12, bad={5})
    want = serial_verdicts(items)
    tickets = [
        sched.submit(items, priority=p, label=f"cls-{p}", device=CPU)
        for p in (PRIORITY_LIVE, PRIORITY_LIGHT, PRIORITY_CATCHUP)
    ]
    for t in tickets:
        assert t.result(timeout=60) == want


def test_priority_clamped(sched, cpu_backend):
    items = make_items(2)
    t = sched.submit(items, priority=99, device=CPU)
    assert t.priority == PRIORITY_CATCHUP
    t.result(timeout=30)
    t2 = sched.submit(items, priority=-5, device=CPU)
    assert t2.priority == PRIORITY_LIVE
    t2.result(timeout=30)
    t3 = sched.submit(items, priority=None, device=CPU)
    assert t3.priority == PRIORITY_CATCHUP
    t3.result(timeout=30)


def test_custom_backend_passthrough(sched, restore_routing):
    """A registered backend keeps its semantics: the scheduler builds
    it on the ticket's device and resolves the whole ticket through it."""
    built = []

    class Recording(CpuBatchVerifier):
        def __init__(self, device):
            super().__init__()
            self.device = device
            built.append(self)

    crypto_batch.register_backend("unit-test-backend", Recording)
    try:
        crypto_batch.set_default_backend("unit-test-backend")
        items = make_items(6, bad={2})
        want = serial_verdicts(items)
        t = sched.submit(items, priority=PRIORITY_LIVE, device=CPU)
        assert t.result(timeout=30) == want
        assert t.backend == "unit-test-backend"
        assert len(built) == 1 and len(built[0]) == 6
        assert built[0].device == CPU
    finally:
        crypto_batch.set_default_backend("cpu")
        with crypto_batch._lock:
            crypto_batch._BACKENDS.pop("unit-test-backend", None)


# --- the device route ----------------------------------------------------


def test_forced_device_route_runs_the_plain_kernels(sched, restore_routing):
    """Floor 1 on device="cpu": the ed25519 lanes go through
    ops.ed25519 (the kernels' plain versions), the secp256k1 lanes
    verify on the host, verdicts re-interleave exactly."""
    crypto_batch.set_default_backend("cuda")
    crypto_batch.set_min_device_batch(1)
    items = make_items(15, bad={2, 9}, mixed=True)
    want = serial_verdicts(items)
    t = sched.submit(items, priority=PRIORITY_LIVE, device=CPU)
    assert t.result(timeout=120) == want
    assert sched.device_dispatches == 1 and sched.host_chunks == 0
    assert crypto_batch.LAST_ROUTE["path"] == "device"
    assert crypto_batch.LAST_ROUTE["n"] == 12


def test_unforced_cpu_device_routes_to_host(sched, restore_routing, monkeypatch):
    """Unforced routing on device="cpu" sends the lanes to the host
    plane even when the calibration says the device wins."""
    crypto_batch.set_default_backend("cuda")
    crypto_batch.set_min_device_batch(2)
    monkeypatch.setattr(crypto_batch, "calibration", crypto_batch._Calibration())
    assert crypto_batch.calibration.device_wins(10_000)

    def boom(*a, **k):  # pragma: no cover - must never be reached
        raise AssertionError("the host route must not touch the device")

    monkeypatch.setattr(ops_ed, "verify_batch_async", boom)
    items = make_items(10, bad={4})
    assert sched.submit(items, device=CPU).result(timeout=30) == serial_verdicts(items)
    assert sched.device_dispatches == 0 and sched.host_chunks >= 1
    assert crypto_batch.LAST_ROUTE["path"] == "host"


def test_concurrent_dispatches_keep_their_own_records():
    """Each dispatch handle carries its own record (lanes, bucket,
    launches); threads dispatching at once do not share one."""
    items = [(msg, pk.key_bytes, sig) for pk, msg, sig in make_items(16, bad={3})]
    widths = (5, 9, 16, 12)
    handles = {}

    def run(n):
        handles[n] = ops_ed.verify_batch_async(items[:n], device=CPU)

    threads = [threading.Thread(target=run, args=(n,)) for n in widths]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    for n in widths:
        h = handles[n]
        assert h.dispatch["lanes"] == n and h.dispatch["cap"] == 47
        assert h.dispatch["launches"] == {"ladder": 0, "decompress": 0, "hash_digits": 0}
        assert list(h.result()) == [i != 3 for i in range(n)]
    assert ops_ed.LAST_DISPATCH in [handles[n].dispatch for n in widths]


class _FailingHandle:
    """A dispatch whose readiness fails (a device fault)."""

    def wait(self):
        raise RuntimeError("CUDA error: an illegal memory access")

    def result(self):  # pragma: no cover - never reached
        raise AssertionError("result() after a failed wait")


@pytest.mark.parametrize("where", ["dispatch", "readiness"])
def test_device_failure_raises_and_fills_no_host_verdict(
    sched, restore_routing, monkeypatch, where
):
    """The port's departure from the JAX package: a failed device route
    resolves the ticket with the exception; no lane gets a host
    verdict in its place, and ``degraded`` counts it."""
    crypto_batch.set_default_backend("cuda")
    crypto_batch.set_min_device_batch(1)
    host_calls = []
    monkeypatch.setattr(
        pv, "_verify_chunk", lambda items, tier="?": host_calls.append(len(items))
    )

    def fake_async(ed_items, device=None):
        if where == "dispatch":
            raise RuntimeError("CUDA error: launch failed")
        return _FailingHandle()

    monkeypatch.setattr(ops_ed, "verify_batch_async", fake_async)
    items = make_items(8)
    t = sched.submit(items, priority=PRIORITY_LIVE, device=CPU)
    with pytest.raises(sched_mod.DeviceRouteError, match="CUDA error") as e:
        t.result(timeout=30)
    assert isinstance(e.value.__cause__, RuntimeError)
    assert str(e.value.__cause__).startswith("CUDA error")
    assert t.done()
    assert t.oks == [False] * 8
    assert host_calls == []
    assert sched.degraded == 1
    assert sched.host_chunks == 0
    assert sched.drain(timeout=5)
    # the scheduler keeps serving after the failure
    monkeypatch.undo()
    crypto_batch.set_default_backend("cpu")
    ok = make_items(4)
    assert sched.submit(ok, device=CPU).result(timeout=30) == serial_verdicts(ok)


# --- priority ordering / starvation guard --------------------------------


def _slow_chunks(monkeypatch, eng, delay):
    """Host chunks take a visible wall and are small, so every ticket
    splits into several and ordering is observable."""
    real = pv._verify_chunk

    def slow(items, tier):
        time.sleep(delay)
        return real(items, tier)

    monkeypatch.setattr(pv, "_verify_chunk", slow)
    monkeypatch.setattr(eng, "chunk_size", lambda n: 4)


def test_live_preempts_catchup_at_chunk_boundary(sched, cpu_backend, monkeypatch, host_plane):
    _slow_chunks(monkeypatch, host_plane, 0.01)
    catchup_items = make_items(32)
    live_items = make_items(8)
    t_catchup = sched.submit(catchup_items, priority=PRIORITY_CATCHUP, label="storm", device=CPU)
    time.sleep(0.02)  # the storm is routed and chunking
    t_live = sched.submit(live_items, priority=PRIORITY_LIVE, label="live", device=CPU)
    assert t_live.result(timeout=30) == serial_verdicts(live_items)
    assert t_catchup.result(timeout=30) == serial_verdicts(catchup_items)
    assert t_live.t_done < t_catchup.t_done


def test_aging_promotion_unit():
    """_pick_locked serves an aged lower-class ticket once every
    promote_every picks; no dispatcher involved."""
    s = VerifyScheduler(promote_after_s=0.0, promote_every=2)
    live = VerifyTicket([None] * 2, PRIORITY_LIVE, "live")
    old = VerifyTicket([None] * 2, PRIORITY_CATCHUP, "old")
    old.t_submit -= 1.0
    s._queues[PRIORITY_LIVE].append(live)
    s._queues[PRIORITY_CATCHUP].append(old)
    with s._cv:
        first = s._pick_locked()
        second = s._pick_locked()
    assert first is live
    assert second is old
    assert s.promoted == 1


def test_catchup_completes_under_sustained_live_flood(cpu_backend, monkeypatch, host_plane):
    s = VerifyScheduler(promote_after_s=0.05, promote_every=2)
    _slow_chunks(monkeypatch, host_plane, 0.002)
    stop = threading.Event()
    live_items = make_items(8)

    def flood():
        while not stop.is_set():
            s.submit(live_items, priority=PRIORITY_LIVE, label="flood", device=CPU)
            time.sleep(0.004)

    feeder = threading.Thread(target=flood, daemon=True)
    feeder.start()
    try:
        time.sleep(0.05)
        catchup = make_items(8, bad={1})
        t = s.submit(catchup, priority=PRIORITY_CATCHUP, label="starved", device=CPU)
        assert t.result(timeout=5.0) == serial_verdicts(catchup)
        assert not stop.is_set()
        assert s.promoted >= 1
    finally:
        stop.set()
        feeder.join(timeout=5)
        assert not feeder.is_alive()
        assert s.drain(timeout=30)
        s.close()


@pytest.mark.parametrize("backend", ["cpu", "cuda"])
def test_concurrent_submitters_stress(sched, restore_routing, backend):
    """More submitting threads than cores, with a tiny switch interval:
    every ticket gets its own verdicts and the lane accounting balances
    (a lost update would leave depth above 0 or a ticket unresolved)."""
    import sys

    crypto_batch.set_default_backend(backend)
    items = make_items(40, bad={6, 31})
    want = serial_verdicts(items)
    results, errors = [], []

    def submitter(k):
        try:
            for j in range(5):
                lanes = items[(k + j) % 8 :][:32]
                t = sched.submit(lanes, priority=(k + j) % 3, device=CPU)
                results.append((t.result(timeout=60), (want[0], want[1][(k + j) % 8 :][:32])))
        except Exception as e:  # pragma: no cover - reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert len(results) == 80
    for (got_all, got), (_, exp) in results:
        assert got == exp and got_all == all(exp)
    assert sched.drain(timeout=10)
    st = sched.queue_stats()
    assert st["depth"] == 0 and st["enqueued"] == 80 * 32
    assert st["live_depth"] == st["light_depth"] == st["catchup_depth"] == 0


# --- observability -------------------------------------------------------


def test_queue_stats_shape(sched, cpu_backend):
    items = make_items(6)
    sched.submit(items, priority=PRIORITY_LIVE, device=CPU).result(timeout=30)
    sched.submit(items, priority=PRIORITY_CATCHUP, device=CPU).result(timeout=30)
    st = sched.queue_stats()
    js = jsched.VerifyScheduler()
    try:
        assert set(st) == set(js.queue_stats())
    finally:
        js.close()
    assert st["depth"] == 0
    assert st["enqueued"] == 12
    assert st["high_watermark"] >= 6


def test_dispatch_span_emitted(sched, cpu_backend):
    from cometbft_tpu_torch.trace import global_tracer

    tr = global_tracer()
    events = []
    was_enabled = tr.enabled

    def obs(name, dur_ns, args):
        if name == "crypto.sched.dispatch":
            events.append((dur_ns, dict(args or {})))

    tr.enabled = True
    tr.add_observer(obs)
    try:
        items = make_items(5, bad={1})
        sched.submit(items, priority=PRIORITY_LIGHT, label="span", device=CPU).result(timeout=30)
    finally:
        tr.remove_observer(obs)
        tr.enabled = was_enabled
    assert events, "no crypto.sched.dispatch span observed"
    args = events[-1][1]
    assert args.get("cls") == "light"
    assert args.get("backend") == "cpu"
    assert args.get("lanes") == 5


def test_sched_stats_if_running_registry_contract(cpu_backend):
    old = sched_mod._SCHED
    try:
        sched_mod._SCHED = None
        assert sched_mod.sched_stats_if_running() is None
        s = VerifyScheduler()
        sched_mod._SCHED = s
        s.submit(make_items(3), priority=PRIORITY_LIVE, device=CPU).result(timeout=30)
        st = sched_mod.sched_stats_if_running()
        assert st is not None and st["enqueued"] == 3
        s.close()
    finally:
        sched_mod._SCHED = old
