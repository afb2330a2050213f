"""The port's host-vs-device calibration against the JAX package's.

Ports ``tests/test_dispatch_calibration.py``. The two ``_Calibration``
classes, started from the same seeds and fed one sample sequence, must
give identical ``flat_s`` / ``lane_s`` / ``host_s`` / crossover /
``device_wins`` / explore decisions after every sample (parametrised
over the JAX tests' scenarios). Then the routing around it, through
the verify scheduler: on ``device="cpu"`` a host-favoured calibration
keeps a batch on the host plane and the floor at 1 forces the device
route (the kernels' plain versions); an unforced dispatch on a CUDA
device (a stand-in handle here) feeds the calibration from its
readiness watcher, not from ``result()``, and a forced one does not
feed it.
"""

import time

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto.batch import _Calibration as JaxCalibration
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.batch import _Calibration
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.ops import ed25519 as ed
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = torch.device("cpu")

# sample sequences: ("device", n, wall) / ("host", n, wall) /
# ("explore", k) k should_explore() calls / ("used",) note_device_used()
SCENARIOS = {
    # two post-build dispatches on a slow link, then host samples
    "slow_link": [("device", 4800, 0.105), ("device", 4800, 0.095),
                  ("host", 150, 150 * 80e-6)],
    # a fast local device
    "local": [("device", 256, 0.004), ("device", 256, 0.0045),
              ("host", 150, 150 * 80e-6)],
    # a wait that did not block, then a real dispatch
    "wall_floor": [("device", 150, 3e-5), ("device", 150, 0.004)],
    # build walls never enter the EWMA
    "build_walls": [("device", 4800, 180.0), ("device", 4800, 2.0),
                    ("device", 4800, 0.02)],
    # a poisoned estimate, healed by exploration
    "explore_heal": [("device", 4800, 0.1), ("device", 4800, 3.0),
                     ("explore", 256), ("device", 4800, 0.11),
                     ("explore", 256), ("device", 4800, 0.11),
                     ("explore", 300), ("device", 4800, 0.11), ("used",),
                     ("explore", 3)],
    # the host plane's walls move host_s both ways
    "host_drift": [("host", 4740, 0.03), ("host", 32768, 0.15),
                   ("host", 150, 0.004), ("device", 4740, 0.017)],
}


def _state(c, widths=(1, 64, 150, 4740, 32768, 131072)):
    return (c.flat_s, c.lane_s, c.host_s, c.device_samples, c.crossover(),
            tuple(c.device_wins(n) for n in widths))


@pytest.mark.parametrize("seeds", ["jax", "port"])
@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_same_samples_same_decisions_as_jax(name, seeds):
    jc, pc = JaxCalibration(), _Calibration()
    src = jc if seeds == "jax" else pc
    for c in (jc, pc):
        c.host_s, c.lane_s, c.flat_s = src.host_s, src.lane_s, src.flat_s
    assert _state(pc) == _state(jc)
    for step in SCENARIOS[name]:
        if step[0] == "device":
            jc.observe_device(*step[1:]), pc.observe_device(*step[1:])
        elif step[0] == "host":
            jc.observe_host(*step[1:]), pc.observe_host(*step[1:])
        elif step[0] == "explore":
            got = [pc.should_explore() for _ in range(step[1])]
            assert got == [jc.should_explore() for _ in range(step[1])]
        else:
            jc.note_device_used(), pc.note_device_used()
        assert _state(pc) == _state(jc), step


def test_slow_link_moves_crossover_past_commit_sizes():
    c = _Calibration()
    c.observe_device(4800, 0.105)
    c.observe_device(4800, 0.095)
    c.observe_host(150, 150 * 80e-6)
    assert not c.device_wins(150)
    assert not c.device_wins(64)
    assert 500 < c.crossover() < 3000


def test_exploration_heals_poisoned_flat_cost():
    c = _Calibration()
    c.observe_device(4800, 0.01)
    c.observe_device(4800, 3.0)
    assert not c.device_wins(4800)
    explored = [c.should_explore() for _ in range(c.EXPLORE_EVERY)]
    assert explored.count(True) == 1 and explored[-1] is True
    cycles = 0
    while not c.device_wins(4800):
        cycles += 1
        assert cycles <= 10, "exploration failed to heal the estimate"
        while not c.should_explore():
            pass
        c.observe_device(4800, 0.011)
    c.note_device_used()
    assert not c.should_explore()


# --- routing on device="cpu" ----------------------------------------------


def _signed(n, tag):
    rng = np.random.default_rng(n)
    privs = [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(n)]
    return [(p.pub_key(), b"%s|%d" % (tag, i), p.sign(b"%s|%d" % (tag, i)))
            for i, p in enumerate(privs)]


@pytest.fixture
def routing(monkeypatch):
    """A fresh calibration, the cuda backend, the floor restored, and a
    two-worker host engine closed after the test."""
    monkeypatch.setattr(crypto_batch, "calibration", _Calibration())
    old = crypto_batch.default_backend()
    old_min = crypto_batch._MIN_DEVICE_BATCH
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    crypto_batch.set_default_backend("cuda")
    yield crypto_batch.calibration
    sched_mod.set_scheduler(None)
    crypto_batch.set_min_device_batch(old_min)
    crypto_batch.set_default_backend(old)
    pv.set_engine(None)
    eng.close()


def test_routing_uses_calibration(routing):
    routing.observe_device(4800, 0.1)
    routing.observe_device(4800, 0.1)
    crypto_batch.set_min_device_batch(64)
    v = crypto_batch.create_batch_verifier(device=CPU)
    for it in _signed(100, b"route"):
        v.add(*it)
    ok, verdicts = v.verify()
    assert ok and all(verdicts)
    assert crypto_batch.LAST_ROUTE["path"] == "host"
    assert crypto_batch.LAST_ROUTE["n"] == 100
    assert crypto_batch.LAST_ROUTE["crossover"] > 100


def test_force_min_batch_1_bypasses_calibration(routing, monkeypatch):
    routing.observe_device(4800, 0.5)  # the device looks awful
    calls = {}

    def fake_verify_batch_async(items, device=None):
        calls["n"], calls["device"] = len(items), device
        return _FakeHandle(len(items))

    monkeypatch.setattr(ed, "verify_batch_async", fake_verify_batch_async)
    crypto_batch.set_min_device_batch(1)
    v = crypto_batch.create_batch_verifier(device=CPU)
    p = Ed25519PrivKey.from_seed(bytes(range(32)))
    v.add(p.pub_key(), b"m", p.sign(b"m"))
    ok, _ = v.verify()
    assert ok and calls == {"n": 1, "device": CPU}
    assert crypto_batch.LAST_ROUTE["path"] == "device"


def test_forced_route_runs_the_plain_kernels(routing):
    crypto_batch.set_min_device_batch(1)
    items = _signed(12, b"plain")
    items[4] = (items[4][0], items[4][1], bytes(64))
    v = crypto_batch.create_batch_verifier(device=CPU)
    for it in items:
        v.add(*it)
    ok, verdicts = v.verify_async().result()
    assert not ok and verdicts == [i != 4 for i in range(12)]
    assert crypto_batch.LAST_ROUTE["path"] == "device"


class _FakeHandle:
    """A dispatch that is ready ~2 ms after it was made."""

    def __init__(self, n):
        self.n = n

    def wait(self):
        time.sleep(0.002)
        return self

    def result(self):
        return [True] * self.n


def _wait_samples(cal, n):
    deadline = time.time() + 2.0
    while cal.device_samples < n and time.time() < deadline:
        time.sleep(0.005)


CARD = torch.device("cuda")


@pytest.fixture
def fake_card(monkeypatch):
    """A CUDA device object that resolves without a GPU, and a dispatch
    that returns a stand-in handle: routing and the watcher see a card,
    nothing touches one."""
    def resolve(device=None):
        return CARD if device is None else torch.device(device)

    monkeypatch.setattr(crypto_batch, "resolve", resolve)
    monkeypatch.setattr(sched_mod, "resolve", resolve)
    monkeypatch.setattr(ed, "verify_batch_async", lambda items, device=None: _FakeHandle(len(items)))


def test_async_seam_feeds_calibration(routing, fake_card):
    v = crypto_batch.create_batch_verifier(device=CARD)
    for it in _signed(150, b"async"):
        v.add(*it)
    ok, verdicts = v.verify_async().result()
    assert ok and len(verdicts) == 150
    assert crypto_batch.LAST_ROUTE["path"] == "device"
    _wait_samples(routing, 1)
    assert routing.device_samples == 1, "the readiness watcher never fed the EWMA"


@pytest.mark.parametrize("device", ["cuda", "cpu"])
def test_forced_dispatch_does_not_feed_calibration(routing, fake_card, device):
    """The floor at 1 pins the device route: its walls (the plain
    versions' on the CPU) must not move the crossover that unforced
    tickets route by."""
    crypto_batch.set_min_device_batch(1)
    flat = routing.flat_s
    ticket = sched_mod.scheduler().submit(_signed(150, b"forced"), device=torch.device(device))
    ok, _ = ticket.result(timeout=30)
    assert ok and crypto_batch.LAST_ROUTE["path"] == "device"
    # the watcher observes before it resolves the ticket
    assert routing.device_samples == 0 and routing.flat_s == flat


def test_result_time_overlap_does_not_poison_flat_cost(routing, fake_card):
    v = crypto_batch.create_batch_verifier(device=CARD)
    for it in _signed(150, b"late"):
        v.add(*it)
    pending = v.verify_async()
    _wait_samples(routing, 1)
    assert routing.device_samples == 1
    flat = routing.flat_s
    time.sleep(0.2)  # the caller overlaps host work before resolving
    pending.result()
    assert routing.device_samples == 1
    assert routing.flat_s == flat


def test_slow_device_side_host_work_pushes_windows_to_the_host_plane(routing, fake_card,
                                                                     monkeypatch):
    """The device sample is the wall from just before the dispatch (the
    host's packing and copies included) to the card's event, as in the
    JAX package: a dispatch whose host side is slow (a loaded or slow
    host, 150 ms here) raises flat_s, and the next catch-up window of
    the same width goes to the host plane."""
    def slow_dispatch(items, device=None):
        time.sleep(0.15)  # the host side of the device route
        return _FakeHandle(len(items))

    monkeypatch.setattr(ed, "verify_batch_async", slow_dispatch)
    sched = sched_mod.VerifyScheduler()
    sched_mod.set_scheduler(sched)
    try:
        window = _signed(400, b"window")
        first = sched.submit(window, device=CARD, priority=sched_mod.PRIORITY_CATCHUP)
        assert first.result(timeout=30)[0]
        assert crypto_batch.LAST_ROUTE["path"] == "device"
        _wait_samples(routing, 1)
        assert routing.device_samples == 1 and routing.flat_s > 0.05
        assert not routing.device_wins(len(window))
        second = sched.submit(window, device=CARD, priority=sched_mod.PRIORITY_CATCHUP)
        assert second.result(timeout=30)[0]
        assert crypto_batch.LAST_ROUTE["path"] == "host"
        stats = sched.stats()
        assert stats["device_dispatches"] == 1 and stats["host_chunks"] >= 1
    finally:
        sched_mod.set_scheduler(None)
        sched.close()
