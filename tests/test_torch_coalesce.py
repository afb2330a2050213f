"""The port's vote coalescer against the JAX package's.

One vote wave (20 votes, one corrupted) submitted within the window
becomes ONE ``PRIORITY_LIVE`` ticket on the scheduler, and its
per-vote verdicts equal the serial ones and the JAX package's
``CoalescingVerifier`` on the same wave. A cached signature resolves
without a dispatch. When the dispatch fails, every future of the wave
gets the exception (the port does not re-verify the wave on the host).
"""

import asyncio

import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import batch as jbatch
from cometbft_tpu.crypto import keys as jkeys
from cometbft_tpu.crypto import parallel_verify as jpv
from cometbft_tpu.crypto import scheduler as jsched
from cometbft_tpu.crypto.coalesce import CoalescingVerifier as JaxCoalescingVerifier
from cometbft_tpu_torch.crypto import batch as crypto_batch
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.crypto.coalesce import CoalescingVerifier
from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
from cometbft_tpu_torch.types.signature_cache import SignatureCache

torch.set_num_threads(1)

CPU = torch.device("cpu")


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def _wave(n=20, bad=7):
    rng = np.random.default_rng(77)
    out = []
    for i in range(n):
        p = Ed25519PrivKey.from_seed(rng.bytes(32))
        msg = b"vote-%d" % i
        sig = p.sign(msg)
        if i == bad:
            sig = sig[:-1] + bytes([sig[-1] ^ 1])
        out.append((p.pub_key(), msg, sig))
    return out


@pytest.fixture
def plane():
    """A scheduler that records its tickets and a two-worker engine,
    both closed after the test."""
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    s = sched_mod.VerifyScheduler()
    tickets = []
    submit = s.submit

    def recording(items, priority=sched_mod.PRIORITY_CATCHUP, label="", device=None):
        t = submit(items, priority=priority, label=label, device=device)
        tickets.append(t)
        return t

    s.submit = recording
    sched_mod.set_scheduler(s)
    yield tickets
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def test_one_wave_is_one_live_ticket_with_serial_verdicts(plane):
    wave = _wave()

    async def port():
        v = CoalescingVerifier(window_s=0.01, device=CPU)
        oks = await asyncio.gather(*(v.submit(*it) for it in wave))
        return v, oks

    v, oks = run(port())
    assert v.dispatches == 1
    assert len(plane) == 1
    assert plane[0].priority == sched_mod.PRIORITY_LIVE
    assert plane[0].label == "vote-wave" and len(plane[0].items) == len(wave)
    assert oks == [pk.verify(m, s) for pk, m, s in wave]
    assert [i for i, ok in enumerate(oks) if not ok] == [7]

    async def jax():
        v = JaxCoalescingVerifier(window_s=0.01)
        return await asyncio.gather(
            *(v.submit(jkeys.Ed25519PubKey(pk.key_bytes), m, s) for pk, m, s in wave)
        )

    old = jbatch.default_backend()
    jbatch.set_default_backend("cpu")
    jeng = jpv.ParallelVerifyEngine(workers=2)
    jpv.set_engine(jeng)
    js = jsched.VerifyScheduler()
    jsched.set_scheduler(js)
    try:
        assert run(jax()) == oks
    finally:
        jsched.set_scheduler(None)
        jpv.set_engine(None)
        jeng.close()
        jbatch.set_default_backend(old)


def test_cache_short_circuits_resubmit(plane):
    pk, msg, sig = _wave(1, bad=-1)[0]

    async def main():
        v = CoalescingVerifier(cache=SignatureCache(), window_s=0.005, device=CPU)
        assert await v.submit(pk, msg, sig) is True
        assert await v.submit(pk, msg, sig) is True
        return v

    v = run(main())
    assert v.dispatches == 1 and v.cache_hits == 1 and len(plane) == 1


def test_dispatch_failure_reaches_every_future(plane, monkeypatch):
    old = crypto_batch.default_backend()
    old_min = crypto_batch._MIN_DEVICE_BATCH
    crypto_batch.set_default_backend("cuda")
    crypto_batch.set_min_device_batch(1)
    from cometbft_tpu_torch.ops import ed25519 as ops_ed

    def boom(items, device=None):
        raise RuntimeError("CUDA error: launch failed")

    monkeypatch.setattr(ops_ed, "verify_batch_async", boom)
    wave = _wave(6)

    async def main():
        v = CoalescingVerifier(window_s=0.005, device=CPU)
        return await asyncio.gather(*(v.submit(*it) for it in wave), return_exceptions=True)

    try:
        got = run(main())
    finally:
        crypto_batch.set_min_device_batch(old_min)
        crypto_batch.set_default_backend(old)
    assert len(got) == 6
    assert all(isinstance(e, RuntimeError) and "CUDA error" in str(e) for e in got)
    assert len(plane) == 1 and plane[0].oks == [False] * 6
