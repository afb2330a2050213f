"""The port's mempool ingest plane (cometbft_tpu_torch.mempool), on the
CPU: the 26 cases of the JAX package's tests/test_mempool_ingest.py.

- The keyed ``TxCache`` and one hash a tx on the serial path;
- batched CheckTx with verdicts equal to the serial path's, intra-batch
  duplicates of app-rejected txs, one ABCI call a batch, the per-tx
  fallback for an app connection without the batch call, ``notify``
  and ``txs_available`` once a batch;
- the gossip batch codec and its interop with single raw txs;
- the asynchronous post-commit recheck: verdicts applied in the
  background with reap masked until they land, the stale-height guard,
  ``flush`` aborting a recheck in flight, ``update`` returning in a time
  that does not grow with the pool, and the synchronous recheck kept
  when ``async_recheck`` is off;
- the ingest queue's coalescing, overflow, failure isolation and stop;
- the reactor's non-blocking receive, batched gossip under the channel
  cap, echo suppression and its bounded fallback ``sent`` set.

- a 4-node chaos net of the port's harness (``device="cpu"``) with the
  asynchronous recheck pinned on, txs flowing through a partition and
  its heal: every node commits, agreement holds, txs commit.

One case more holds the port's batched verdicts and pool order equal
to the JAX package's on the same workload.
"""

import asyncio
import hashlib
import threading
import time

import pytest

from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import LocalClient
from cometbft_tpu_torch.mempool import codec
from cometbft_tpu_torch.mempool.ingest import IngestQueue
from cometbft_tpu_torch.mempool.mempool import (
    CListMempool,
    TxCache,
    tx_key,
    tx_keys,
)
from cometbft_tpu_torch.mempool.reactor import MEMPOOL_CHANNEL, MempoolReactor
from torch_hard_limit import hard_limit  # noqa: F401


class AcceptApp(abci.Application):
    def __init__(self):
        self.checked = 0
        self.batch_calls = 0
        self.batch_sizes = []

    def check_tx(self, req):
        self.checked += 1
        if req.tx.startswith(b"bad"):
            return abci.ResponseCheckTx(code=5, log="rejected")
        return abci.ResponseCheckTx(gas_wanted=1)

    def check_tx_batch(self, reqs):
        self.batch_calls += 1
        self.batch_sizes.append(len(reqs))
        return super().check_tx_batch(reqs)


def make_pool(app=None, **kw):
    app = app or AcceptApp()
    kw.setdefault("max_txs", 10_000)
    kw.setdefault("cache_size", 50_000)
    return CListMempool(LocalClient(app), **kw), app


# --- satellite: one hash per tx, keyed cache ---------------------------


def test_tx_keys_matches_hashlib():
    txs = [b"tx-%d" % i for i in range(64)] + [b"", b"x" * 4096]
    assert tx_keys(txs) == [hashlib.sha256(t).digest() for t in txs]
    assert tx_keys([]) == []


def test_txcache_keyed_api_and_lru():
    c = TxCache(size=2)
    k1, k2, k3 = (tx_key(b"%d" % i) for i in range(3))
    assert c.push(k1) and c.push(k2)
    assert not c.push(k1)  # dup
    assert c.has(k1)
    assert c.push(k3)  # evicts k2 (k1 was touched by the dup push)
    assert not c.has(k2) and c.has(k1) and c.has(k3)
    c.remove(k1)
    assert not c.has(k1)
    # batch push under one lock: in-batch dups reject like serial
    c2 = TxCache(size=10)
    assert c2.push_many([k1, k2, k1]) == [True, True, False]


def test_check_tx_hashes_once_per_tx(monkeypatch):
    """The serial ingest path computes the tx key exactly once (the
    seed hashed up to 3x: cache push + pool insert + log append)."""
    import cometbft_tpu_torch.mempool.mempool as mm

    calls = {"n": 0}
    real = hashlib.sha256

    def counting_sha(data=b""):
        calls["n"] += 1
        return real(data)

    monkeypatch.setattr(mm.hashlib, "sha256", counting_sha)
    mp, _ = make_pool()
    mp.check_tx(b"only-hash-me-once")
    assert calls["n"] == 1


# --- batched CheckTx ---------------------------------------------------


def _mixed_workload(n=300):
    work = []
    for i in range(n):
        work.append(b"tx-%05d" % i)
        if i % 7 == 0:
            work.append(b"bad-%05d" % i)
        if i % 11 == 0:
            work.append(work[-2])  # in-stream duplicate
    work.append(b"z" * (2 << 20))  # oversize
    return work


def test_batch_verdict_parity_with_serial():
    work = _mixed_workload()
    mp_s, _ = make_pool()
    mp_b, _ = make_pool()
    serial = [mp_s.check_tx(t) for t in work]
    batched = mp_b.check_tx_batch(work)
    assert [r.code for r in serial] == [r.code for r in batched]
    assert [r.log for r in serial] == [r.log for r in batched]
    assert list(mp_s.pool.keys()) == list(mp_b.pool.keys())


def test_batch_intra_batch_dup_of_rejected_tx_is_rechecked():
    """Serial semantics: an app-rejected tx leaves the cache, so its
    duplicate later in the SAME batch goes to the app again — not a
    cache-dup reject."""

    class FlipApp(abci.Application):
        def __init__(self):
            self.seen = {}

        def check_tx(self, req):
            n = self.seen.get(req.tx, 0)
            self.seen[req.tx] = n + 1
            # rejected on first sight, accepted on retry (stateful
            # apps exist; the batch path must preserve the retry)
            if n == 0:
                return abci.ResponseCheckTx(code=7, log="first time")
            return abci.ResponseCheckTx()

    mp_b, _ = make_pool(app=FlipApp())
    res = mp_b.check_tx_batch([b"flip", b"flip"])
    mp_s, _ = make_pool(app=FlipApp())
    ref = [mp_s.check_tx(b"flip"), mp_s.check_tx(b"flip")]
    assert [r.code for r in res] == [r.code for r in ref] == [7, 0]


def test_batch_single_abci_call_and_sender_tracking():
    mp, app = make_pool()
    txs = [b"s-%d" % i for i in range(50)]
    mp.check_tx_batch(txs, senders=["peerA"] * len(txs))
    assert app.batch_calls == 1 and app.batch_sizes == [50]
    # duplicate batch from another peer: no ABCI calls, senders merged
    mp.check_tx_batch(txs, senders=["peerB"] * len(txs))
    assert app.batch_calls == 1
    assert mp.tx_senders(tx_key(txs[0])) == {"peerA", "peerB"}


def test_batch_mempool_full_verdict_parity():
    work = [b"full-%d" % i for i in range(20)]
    mp_s, _ = make_pool(max_txs=5)
    mp_b, _ = make_pool(max_txs=5)
    serial = [mp_s.check_tx(t).log for t in work]
    batched = [r.log for r in mp_b.check_tx_batch(work)]
    assert serial == batched
    assert serial.count("mempool full") == 15


def test_proxy_without_batch_extension_falls_back_per_tx():
    class BareProxy:
        """Minimal mempool-connection proxy: no check_tx_batch."""

        def __init__(self):
            self.calls = 0

        def check_tx(self, req):
            self.calls += 1
            return abci.ResponseCheckTx()

    proxy = BareProxy()
    mp = CListMempool(proxy, max_txs=100)
    res = mp.check_tx_batch([b"f-%d" % i for i in range(10)])
    assert all(r.is_ok() for r in res)
    assert proxy.calls == 10  # automatic per-tx fallback loop
    assert mp.size() == 10


def test_notify_and_txs_available_fire_once_per_batch():
    notifies = []
    app = AcceptApp()
    mp = CListMempool(
        LocalClient(app), max_txs=100, notify=lambda: notifies.append(1)
    )
    mp.check_tx_batch([b"n-%d" % i for i in range(10)])
    assert len(notifies) == 1
    assert mp.txs_available().is_set()


# --- gossip batch codec ------------------------------------------------


def test_codec_roundtrip_and_interop():
    cases = [
        [b"a"],
        [b"a", b"b", b"c"],
        [b""] * 3,
        [b"x" * 70000, b"y"],
        [codec.MAGIC + b"tx that starts with the magic"],
    ]
    for txs in cases:
        assert codec.decode_txs(codec.encode_txs(txs)) == txs
    # single non-magic tx keeps the OLD wire form (raw bytes)
    assert codec.encode_txs([b"legacy"]) == b"legacy"
    # old peer -> new node: raw tx decodes as itself
    assert codec.decode_txs(b"raw tx bytes") == [b"raw tx bytes"]
    # old peer relaying a raw tx that happens to start with MAGIC but
    # is not a well-formed batch: delivered as a single tx, not lost
    evil = codec.MAGIC + b"\xff\xff\xff\xff\xff\xff garbage"
    assert codec.decode_txs(evil) == [evil]
    # truncated batch after the magic: same fallback
    frame = codec.encode_batch([b"aa", b"bb"])
    assert codec.decode_txs(frame[:-1]) == [frame[:-1]]
    with pytest.raises(ValueError):
        codec.encode_batch([])


# --- async recheck -----------------------------------------------------


class GatedRecheckApp(abci.Application):
    """Recheck calls block until released; new CheckTx is instant."""

    def __init__(self):
        self.gate = threading.Event()
        self.rechecked = []

    def check_tx(self, req):
        if req.type_ == abci.CHECK_TX_TYPE_RECHECK:
            assert self.gate.wait(10), "recheck gate never released"
            self.rechecked.append(req.tx)
            if req.tx.startswith(b"drop"):
                return abci.ResponseCheckTx(code=9, log="invalid now")
        return abci.ResponseCheckTx()


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if pred():
            return True
        time.sleep(0.005)
    return False


def test_async_recheck_applies_verdicts_and_unmasks():
    app = GatedRecheckApp()
    mp, _ = make_pool(app=app, async_recheck=True)
    for i in range(20):
        mp.check_tx(b"keep-%d" % i)
    mp.check_tx(b"drop-me")
    mp.lock()
    try:
        mp.update(1, [], [])
    finally:
        mp.unlock()
    # whole pool masked while the recheck is in flight
    assert mp.reap_max_bytes_max_gas(-1, -1) == []
    assert mp.recheck_pending() == 21
    app.gate.set()
    assert _wait(lambda: mp.recheck_pending() == 0)
    assert mp.size() == 20  # drop-me rechecked out
    assert len(mp.reap_max_bytes_max_gas(-1, -1)) == 20
    assert mp.txs_available().is_set()


def test_async_recheck_stale_height_guard():
    """A tx committed mid-recheck never re-enters the pool, and the
    superseded recheck's verdicts are dropped wholesale."""
    app = GatedRecheckApp()
    mp, _ = make_pool(app=app, async_recheck=True)
    victim = b"committed-mid-recheck"
    mp.check_tx(victim)
    mp.check_tx(b"drop-stale")  # would be removed by recheck 1
    mp.update(1, [], [])  # snapshot taken, recheck blocked on gate
    assert mp.recheck_pending() == 2
    # block 2 commits the victim while recheck 1 is still in flight
    mp.update(2, [victim], [abci.ResponseCheckTx()])
    assert tx_key(victim) not in mp.pool
    app.gate.set()
    # recheck 2 (for the remaining tx) applies; recheck 1 is stale
    assert _wait(lambda: mp.recheck_pending() == 0)
    assert tx_key(victim) not in mp.pool  # never re-entered
    # drop-stale was STILL removed — by recheck 2, not the stale one
    assert _wait(lambda: mp.size() == 0)


def test_async_recheck_flush_aborts_inflight():
    app = GatedRecheckApp()
    mp, _ = make_pool(app=app, async_recheck=True)
    mp.check_tx(b"drop-x")
    mp.update(1, [], [])
    mp.flush()
    assert mp.recheck_pending() == 0
    app.gate.set()
    time.sleep(0.05)  # stale recheck lands on an empty pool: no-op
    assert mp.size() == 0


def test_update_wall_time_independent_of_pool_size():
    """With async recheck, update() leaves the consensus critical
    section without touching the app: its wall time must not scale
    with the pooled tx count (the seed ran one synchronous ABCI
    round-trip per pooled tx here)."""

    class SlowRecheckApp(abci.Application):
        def check_tx(self, req):
            if req.type_ == abci.CHECK_TX_TYPE_RECHECK:
                time.sleep(0.002)  # 2ms per recheck round-trip
            return abci.ResponseCheckTx()

    def timed_update(n_txs):
        mp, _ = make_pool(app=SlowRecheckApp(), async_recheck=True)
        for i in range(n_txs):
            mp.check_tx(b"u-%d-%d" % (n_txs, i))
        mp.lock()
        try:
            t0 = time.perf_counter()
            mp.update(1, [], [])
            return time.perf_counter() - t0
        finally:
            mp.unlock()

    small, large = timed_update(25), timed_update(800)
    # a serial recheck of 800 txs at 2ms each would hold the lock for
    # >= 1.6s; the async update must return in milliseconds and stay
    # flat in pool size (generous bounds for this throttled box)
    assert large < 0.4, f"update held the lock {large:.3f}s"
    assert large < max(20 * small, 0.4), (small, large)


def test_sync_recheck_semantics_preserved():
    """async_recheck off: update still rechecks inline (one batched
    ABCI call) and prunes invalidated txs before returning."""
    app = GatedRecheckApp()
    app.gate.set()  # no blocking
    mp, _ = make_pool(app=app, async_recheck=False)
    mp.check_tx(b"keep-1")
    mp.check_tx(b"drop-1")
    mp.update(1, [], [])
    assert mp.size() == 1  # pruned inside update
    assert mp.recheck_pending() == 0
    assert len(mp.reap_max_bytes_max_gas(-1, -1)) == 1


# --- ingest queue ------------------------------------------------------


def test_ingest_queue_coalesces_and_resolves():
    async def main():
        mp, app = make_pool()
        q = IngestQueue(mp, batch_max_txs=64, batch_flush_ms=5.0)
        q.start()
        res = await asyncio.gather(
            *[q.submit(b"iq-%d" % i) for i in range(200)]
        )
        assert all(r.is_ok() for r in res)
        assert mp.size() == 200
        # coalesced: far fewer ABCI batches than txs
        assert 1 <= q.batches <= 30
        assert max(app.batch_sizes) > 1
        await q.stop()
        assert not q.running

    asyncio.run(main())


def test_ingest_queue_submit_nowait_and_overflow():
    async def main():
        mp, _ = make_pool()
        q = IngestQueue(mp, batch_max_txs=8, batch_flush_ms=1.0, max_queue=4)
        assert not q.submit_nowait(b"not-running")  # queue not started
        q.start()
        # stall the drainer so the queue genuinely fills
        accepted = sum(
            1 for i in range(64) if q.submit_nowait(b"ow-%d" % i)
        )
        assert accepted < 64 and q.dropped > 0
        await asyncio.sleep(0.1)
        assert mp.size() == accepted
        await q.stop()

    asyncio.run(main())


def test_ingest_queue_app_failure_fails_batch_not_plane():
    class BoomApp(abci.Application):
        def __init__(self):
            self.boom = True

        def check_tx(self, req):
            if self.boom:
                raise RuntimeError("app crashed")
            return abci.ResponseCheckTx()

    async def main():
        app = BoomApp()
        mp = CListMempool(LocalClient(app), max_txs=100)
        q = IngestQueue(mp, batch_max_txs=8, batch_flush_ms=1.0)
        q.start()
        res = await q.submit(b"boom-tx")
        assert res.code != 0 and "ingest failed" in res.log
        app.boom = False
        res2 = await q.submit(b"boom-tx-2")  # plane still alive
        assert res2.is_ok()
        await q.stop()

    asyncio.run(main())


# --- reactor: non-blocking receive + batched gossip --------------------


class FakePeer:
    def __init__(self, peer_id="peer-1"):
        self.peer_id = peer_id
        self.sent = []

    async def send(self, chan_id, msg):
        self.sent.append((chan_id, msg))
        return True

    def try_send(self, chan_id, msg):
        self.sent.append((chan_id, msg))
        return True


def test_receive_decodes_batches_and_stays_nonblocking():
    class SlowApp(abci.Application):
        def check_tx(self, req):
            time.sleep(0.01)  # a blocking receive would eat 10ms/tx
            return abci.ResponseCheckTx()

    async def main():
        mp = CListMempool(LocalClient(SlowApp()), max_txs=100)
        r = MempoolReactor(mp, broadcast=False, batch_flush_ms=1.0)
        await r.start()
        peer = FakePeer()
        frame = codec.encode_txs([b"g-%d" % i for i in range(20)])
        t0 = time.perf_counter()
        r.receive(MEMPOOL_CHANNEL, peer, frame)
        dt = time.perf_counter() - t0
        assert dt < 0.05, f"receive blocked for {dt:.3f}s"
        for _ in range(400):
            if mp.size() == 20:
                break
            await asyncio.sleep(0.01)
        assert mp.size() == 20
        assert mp.tx_senders(tx_key(b"g-0")) == {"peer-1"}
        await r.stop()

    asyncio.run(main())


def test_receive_without_started_ingest_degrades_to_direct():
    mp, _ = make_pool()
    r = MempoolReactor(mp, broadcast=False)
    r.receive(MEMPOOL_CHANNEL, FakePeer(), b"standalone-tx")
    assert mp.size() == 1  # processed inline, no event loop needed


def test_broadcast_routine_batches_txs():
    async def main():
        mp, _ = make_pool()
        r = MempoolReactor(
            mp, broadcast=True, gossip_batch_bytes=4096, batch_max_txs=64
        )
        peer = FakePeer("peer-b")
        mp.check_tx_batch([b"bb-%03d" % i for i in range(100)])
        r.add_peer(peer)
        for _ in range(100):
            if sum(
                len(codec.decode_txs(m)) for _, m in peer.sent
            ) >= 100:
                break
            await asyncio.sleep(0.01)
        r.remove_peer(peer, None)
        got = [
            tx for _, m in peer.sent for tx in codec.decode_txs(m)
        ]
        assert got == [b"bb-%03d" % i for i in range(100)]
        # actually coalesced: fewer messages than txs
        assert len(peer.sent) < 100
        await r.stop()

    asyncio.run(main())


def test_broadcast_frames_never_exceed_channel_cap():
    """A batch frame larger than the channel's max_msg_size kills the
    peer connection on the receiver — the routine must flush BEFORE a
    tx would push the frame past the cap, and a magic-prefixed tx too
    big for the batch-of-one escape goes out raw."""
    from cometbft_tpu_torch.mempool.reactor import MAX_FRAME_BYTES

    async def main():
        mp, _ = make_pool(max_txs=200)
        # misconfigured soft target ABOVE the hard cap: the hard cap
        # must still hold
        r = MempoolReactor(
            mp, broadcast=True,
            gossip_batch_bytes=2 * MAX_FRAME_BYTES, batch_max_txs=10_000,
        )
        peer = FakePeer("cap-peer")
        big = b"B" * (900 * 1024)
        magic_big = codec.MAGIC + b"M" * (MAX_FRAME_BYTES - 4)
        txs = [b"c-%04d" % i + b"x" * 4096 for i in range(60)]
        txs += [big, magic_big]
        mp.check_tx_batch(txs)
        r.add_peer(peer)
        want = set(txs)
        for _ in range(200):
            got = [
                tx for _, m in peer.sent for tx in codec.decode_txs(m)
            ]
            if set(got) >= want:
                break
            await asyncio.sleep(0.01)
        r.remove_peer(peer, None)
        await r.stop()
        assert set(got) >= want, len(got)
        assert all(len(m) <= MAX_FRAME_BYTES for _, m in peer.sent), [
            len(m) for _, m in peer.sent if len(m) > MAX_FRAME_BYTES
        ]

    asyncio.run(main())


def test_ingest_stop_mid_window_resolves_collected_futures():
    """stop() while the drainer holds a partially collected batch
    must resolve those futures instead of leaving RPC callers
    hanging."""

    async def main():
        mp, _ = make_pool()
        # long flush window so the first tx sits in the drainer's
        # local batch, off the queue, when stop() lands
        q = IngestQueue(mp, batch_max_txs=64, batch_flush_ms=5000.0)
        q.start()
        fut = asyncio.ensure_future(q.submit(b"stuck-in-window"))
        await asyncio.sleep(0.1)  # drainer popped it, awaiting more
        assert not fut.done()
        await q.stop()
        res = await asyncio.wait_for(fut, 2)
        assert res.code != 0 and "stopped" in res.log

    asyncio.run(main())


def test_broadcast_skips_txs_from_the_peer_itself():
    async def main():
        mp, _ = make_pool()
        r = MempoolReactor(mp, broadcast=True)
        peer = FakePeer("origin-peer")
        mp.check_tx(b"mine", sender="origin-peer")
        mp.check_tx(b"other", sender="someone-else")
        r.add_peer(peer)
        await asyncio.sleep(0.15)
        r.remove_peer(peer, None)
        got = [
            tx for _, m in peer.sent for tx in codec.decode_txs(m)
        ]
        assert got == [b"other"]
        await r.stop()

    asyncio.run(main())


def test_fallback_sent_set_is_bounded():
    """Satellite: mempools without txs_after (the legacy walk) must
    not grow the per-peer dedup set forever."""
    import cometbft_tpu_torch.mempool.reactor as reactor_mod

    class MinimalMempool:
        """No txs_after: forces the fallback path."""

        def __init__(self):
            self.txs = []

        def iter_txs(self):
            return list(self.txs)

    async def run_with_cap(cap, n_txs):
        old = reactor_mod.SENT_CACHE_SIZE
        reactor_mod.SENT_CACHE_SIZE = cap
        try:
            mp = MinimalMempool()
            r = MempoolReactor(mp, broadcast=True)
            peer = FakePeer("fb-peer")
            mp.txs = [b"fb-%04d" % i for i in range(n_txs)]
            r.add_peer(peer)
            await asyncio.sleep(0.18)  # several gossip ticks
            r.remove_peer(peer, None)
            await r.stop()
            got = [
                tx for _, m in peer.sent for tx in codec.decode_txs(m)
            ]
            return got
        finally:
            reactor_mod.SENT_CACHE_SIZE = old

    async def main():
        # cap >> pool: perfect dedup, each tx exactly once across ticks
        got = await run_with_cap(1000, 100)
        assert sorted(set(got)) == [b"fb-%04d" % i for i in range(100)]
        assert len(got) == 100
        # cap << pool: every tx still delivered, and the EVICTED keys
        # re-send on later ticks — proof the dedup set really is
        # bounded at the cap instead of growing with pool history
        got = await run_with_cap(16, 100)
        assert sorted(set(got)) == [b"fb-%04d" % i for i in range(100)]
        assert len(got) > 100

    asyncio.run(main())


# --- node-level: chaos run with async recheck --------------------------


def test_chaos_run_with_async_recheck_stays_invariant_clean(tmp_path):
    """4-node seeded chaos pass (partition + heal) with the async
    recheck plane explicitly pinned ON and txs flowing the whole
    time: every node keeps committing, the agreement invariant stays
    clean, and committed txs were really pumped through the batched
    ingest + background recheck path."""
    from cometbft_tpu_torch.chaos.net import ChaosNet

    seen_cfgs = []

    def hook(cfg):
        cfg.mempool.async_recheck = True
        seen_cfgs.append(cfg)

    async def wait_height(net, target, timeout=60.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if net.max_height() >= target:
                return
            await asyncio.sleep(0.05)
        raise AssertionError(
            f"liveness: never reached height {target}: {net.heights()}"
        )

    async def main():
        net = ChaosNet(
            4, seed=77, base_dir=str(tmp_path), config_hook=hook, device="cpu"
        )
        await net.start()
        try:
            stop_load = asyncio.Event()

            async def load():
                i = 0
                while not stop_load.is_set():
                    for _, node in net.running_nodes()[:2]:
                        node.parts.mempool.check_tx(b"chaos%06d=v" % i)
                        i += 1
                    await asyncio.sleep(0.02)

            loader = asyncio.create_task(load())
            try:
                await wait_height(net, 2)
                # majority partition (canonical smoke shape): the
                # 3-group keeps quorum and keeps committing txs while
                # the minority node is blackholed, then heals back
                ids = [cn.node_id for cn in net.nodes]
                net.table.partition([ids[:3], ids[3:]])
                await wait_height(net, net.max_height() + 2)
                net.table.heal()
                await wait_height(net, net.max_height() + 3)
            finally:
                stop_load.set()
                await loader
            net.agreement.final_check(net.running_nodes())
            # the plane was really on and really exercised
            for cn in net.nodes:
                mp = cn.node.parts.mempool
                assert mp.async_recheck
            committed = sum(
                n.parts.block_store.load_block(h).data.txs != []
                for _, n in net.running_nodes()
                for h in range(1, n.height + 1)
            )
            assert committed > 0, "no txs ever committed"
        finally:
            # the stop tail is bounded inside ChaosNet.stop (per-node
            # ShutdownGuard stages, obs/shutdown.py) — this outer
            # wait_for is the regression tripwire for the full-suite
            # wedge this test used to hit (loop alive, store fds
            # open) so a recurrence fails HERE instead of hanging CI
            await asyncio.wait_for(net.stop(), 120.0)
            assert not net.shutdown_stall_records(), (
                net.shutdown_stall_records()
            )

    asyncio.run(main())
    assert len(seen_cfgs) == 4 and all(
        c.mempool.async_recheck for c in seen_cfgs
    )



def test_batch_verdicts_and_pool_match_jax():
    from cometbft_tpu.abci import types as jabci
    from cometbft_tpu.abci.client import LocalClient as JLocalClient
    from cometbft_tpu.mempool.mempool import CListMempool as JCListMempool

    class JAcceptApp(jabci.Application):
        def check_tx(self, req):
            if req.tx.startswith(b"bad"):
                return jabci.ResponseCheckTx(code=5, log="rejected")
            return jabci.ResponseCheckTx(gas_wanted=1)

    work = _mixed_workload()
    mp, _ = make_pool(max_txs=200)
    jmp = JCListMempool(JLocalClient(JAcceptApp()), max_txs=200, cache_size=50_000)
    got = mp.check_tx_batch(work)
    want = jmp.check_tx_batch(work)
    assert [(r.code, r.log, r.gas_wanted) for r in got] == [(r.code, r.log, r.gas_wanted) for r in want]
    assert list(mp.pool) == list(jmp.pool)
    assert mp.reap_max_bytes_max_gas(1000, 50) == jmp.reap_max_bytes_max_gas(1000, 50)
