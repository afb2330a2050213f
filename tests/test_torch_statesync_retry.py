"""Statesync chunk-fetch robustness on the port, held to the JAX
package's (``tests/test_statesync_retry.py``): full-jitter retry
backoff and bans of peers that serve corrupt snapshot chunks.

Each of the seven reference cases runs on both packages' ``Syncer`` and
``ChunkQueue`` with the same inputs (the backoff's ``random.Random(7)``
included) and checks the reference's assertions on each; what the two
packages observed (peers banned, chunks applied and retried, the
queue's wanted set) must be equal, exactly. An eighth case restores real
kvstore snapshots with one corrupting peer: the port's checksumming
kvstore (``chunk_hashes=True``) bans it and restores, where the JAX
kvstore, and the port's without chunk hashes, reject the snapshot.
"""

import asyncio
import random
from types import SimpleNamespace

import pytest

from cometbft_tpu.abci import types as jabci
from cometbft_tpu.statesync import chunks as jchunks
from cometbft_tpu.statesync import syncer as jsyncer
from cometbft_tpu_torch.abci import types as pabci
from cometbft_tpu_torch.statesync import chunks as pchunks
from cometbft_tpu_torch.statesync import syncer as psyncer

PKGS = {
    "jax": SimpleNamespace(abci=jabci, ChunkQueue=jchunks.ChunkQueue, SnapshotKey=jsyncer.SnapshotKey,
                           Syncer=jsyncer.Syncer),
    "port": SimpleNamespace(abci=pabci, ChunkQueue=pchunks.ChunkQueue, SnapshotKey=psyncer.SnapshotKey,
                            Syncer=psyncer.Syncer),
}

CHUNKS = [b"chunk-%d" % i for i in range(4)]
SNAP_HASH = b"\x11" * 32


def run(coro, timeout=60):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def both(scenario):
    """The scenario's observations on each package; equal, returned once."""
    got = {name: scenario(pkg) for name, pkg in PKGS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


class _Provider:
    def app_hash(self, height):
        return b"\x22" * 32

    def state(self, height):
        return {"height": height}

    def commit(self, height):
        return {"commit": height}


def _proxy(abci):
    """The app's snapshot surface: accepts the offer; flags a chunk
    that does not match the canonical payload as RETRY (corrupt), as a
    checksumming app does."""

    class SnapshotConn:
        def __init__(self):
            self.retries, self.applied = [], []

        def offer_snapshot(self, snap, app_hash):
            return abci.ResponseOfferSnapshot(result=abci.OFFER_SNAPSHOT_ACCEPT)

        def apply_snapshot_chunk(self, index, chunk, sender):
            if chunk != CHUNKS[index]:
                self.retries.append((index, sender))
                return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_RETRY)
            self.applied.append(index)
            return abci.ResponseApplySnapshotChunk(result=abci.APPLY_CHUNK_ACCEPT)

    class QueryConn:
        def info(self, req):
            return abci.ResponseInfo(last_block_height=10, last_block_app_hash=b"\x22" * 32)

    return SimpleNamespace(snapshot=SnapshotConn(), query=QueryConn())


def _mk_syncer(pkg, request_chunk, chunk_timeout_s=5.0):
    return pkg.Syncer(
        _proxy(pkg.abci), _Provider(), request_chunk=request_chunk,
        chunk_timeout_s=chunk_timeout_s, rng=random.Random(7),
    )


def _key(pkg):
    return pkg.SnapshotKey(height=10, format=1, chunks=len(CHUNKS), hash=SNAP_HASH)


def test_corrupt_chunk_sender_is_banned_and_sync_completes():
    """One peer serves garbage for every chunk: the app's RETRY on its
    first chunk bans it, its queued chunks are discarded, and the good
    peer completes the restore."""

    def scenario(pkg):
        calls = []

        async def request_chunk(peer, height, fmt, index):
            calls.append((peer, index))
            return b"garbage" if peer == "evil" else CHUNKS[index]

        async def main():
            syncer = _mk_syncer(pkg, request_chunk)
            state, _ = await syncer._sync_one(_key(pkg), {"evil", "good"})
            assert state == {"height": 10}
            assert "evil" in syncer.banned_peers
            assert sorted(syncer.proxy.snapshot.applied) == [0, 1, 2, 3]
            # after the ban the rotation stopped asking the evil peer
            last_evil = max(i for i, c in enumerate(calls) if c[0] == "evil")
            assert any(c[0] == "good" and i > last_evil for i, c in enumerate(calls))
            return sorted(syncer.banned_peers), sorted(syncer.proxy.snapshot.applied)

        return run(main())

    assert both(scenario) == (["evil"], [0, 1, 2, 3])


def test_reject_senders_directive_bans_and_discards():
    """The app can name corrupt senders on any verdict
    (reject_senders); their queued chunks are discarded and they are
    banned from further fetches."""

    def scenario(pkg):
        q = pkg.ChunkQueue(3)
        q.add(0, b"a", "good")
        q.add(1, b"b", "shady")
        q.add(2, b"c", "shady")
        syncer = _mk_syncer(pkg, lambda *a: None)
        syncer._apply_directives(
            q,
            pkg.abci.ResponseApplySnapshotChunk(
                result=pkg.abci.APPLY_CHUNK_ACCEPT, reject_senders=["shady"], refetch_chunks=[0]
            ),
        )
        assert "shady" in syncer.banned_peers
        # shady's chunks dropped and the app-directed refetch honoured
        assert q.wanted() == {0, 1, 2}
        return sorted(syncer.banned_peers), sorted(q.wanted())

    both(scenario)


def test_all_peers_banned_rejects_snapshot_not_hangs():
    """Every peer of the snapshot serves corrupt data: the fetchers
    stop, the apply loop times out, and the attempt fails bounded."""

    def scenario(pkg):
        async def request_chunk(peer, height, fmt, index):
            return b"garbage"

        async def main():
            syncer = _mk_syncer(pkg, request_chunk, chunk_timeout_s=0.5)
            with pytest.raises(asyncio.TimeoutError):
                await syncer._sync_one(_key(pkg), {"evil1", "evil2"})
            assert syncer.banned_peers == {"evil1", "evil2"}
            return sorted(syncer.banned_peers)

        return run(main())

    both(scenario)


def test_fetch_failures_back_off_with_jitter():
    """Request failures sleep through the shared full-jitter Backoff:
    the fetch succeeds after transient failures, and the failure
    sleeps come from the seeded backoff stream, each under the cap."""

    def scenario(pkg):
        fails = {"count": 0}
        sleeps = []

        async def request_chunk(peer, height, fmt, index):
            if fails["count"] < 3:
                fails["count"] += 1
                raise ConnectionError("transient")
            return CHUNKS[index]

        async def main():
            syncer = _mk_syncer(pkg, request_chunk)
            real_sleep = asyncio.sleep

            async def spy_sleep(d):
                sleeps.append(d)
                await real_sleep(0)  # keep the test fast

            asyncio.sleep = spy_sleep
            try:
                state, _ = await syncer._sync_one(_key(pkg), {"flaky"})
            finally:
                asyncio.sleep = real_sleep
            assert state == {"height": 10}
            fail_sleeps = [s for s in sleeps if s != 0.05]
            assert len(fail_sleeps) >= 3
            assert all(0.0 <= s <= 2.0 for s in fail_sleeps)
            # the seeded stream: the same first three delays each time
            return fail_sleeps[:3]

        return run(main())

    both(scenario)


def test_chunk_queue_discard_sender():
    def scenario(pkg):
        q = pkg.ChunkQueue(4)
        q.add(0, b"a", "p1")
        q.add(1, b"b", "p2")
        q.add(2, b"c", "p1")
        dropped = q.discard_sender("p1")
        assert sorted(dropped) == [0, 2]
        assert q.wanted() == {0, 2, 3}
        assert q.discard_sender("p1") == []
        return sorted(dropped), sorted(q.wanted())

    both(scenario)


def test_sender_ban_never_rewinds_applied_chunks():
    """Chunks the app accepted survive a later ban of their sender:
    re-applying them unasked corrupts append-style restores (the
    kvstore buffers every apply call). Only an explicit app-directed
    refetch re-opens an applied chunk."""

    def scenario(pkg):
        async def main():
            q = pkg.ChunkQueue(3)
            q.add(0, b"a", "evil")
            q.add(1, b"b", "evil")
            i, _, _ = await q.next(1.0)
            assert i == 0
            q.mark_applied(0)
            # ban evil AFTER chunk 0 was applied: only the unapplied
            # chunk 1 is discarded, next_index does not rewind
            assert q.discard_sender("evil") == [1]
            assert q.next_index == 1 and 0 in q.chunks
            assert q.wanted() == {1, 2}
            # an explicit refetch directive does re-open an applied chunk
            q.discard(0)
            assert 0 not in q.applied and q.next_index == 0
            return q.next_index, sorted(q.wanted())

        return run(main())

    both(scenario)


def test_reject_senders_directive_spares_applied_chunks():
    """A response that bans a sender (reject_senders) whose earlier
    chunk was already accepted does not rewind the accepted chunk."""

    def scenario(pkg):
        q = pkg.ChunkQueue(3)
        q.add(0, b"a", "shady")
        q.add(1, b"b", "shady")
        q.mark_applied(0)
        syncer = _mk_syncer(pkg, lambda *a: None)
        syncer._apply_directives(
            q,
            pkg.abci.ResponseApplySnapshotChunk(
                result=pkg.abci.APPLY_CHUNK_ACCEPT, reject_senders=["shady"]
            ),
        )
        assert "shady" in syncer.banned_peers
        assert 0 in q.chunks and 0 in q.applied  # accepted chunk intact
        assert q.wanted() == {1, 2}  # only the unapplied one refetches
        return sorted(syncer.banned_peers), sorted(q.wanted())

    both(scenario)


def _kv_restore(pkg, app_cls, source_kw, joiner_kw, adverts):
    """Restore a real kvstore snapshot through ``sync_any``. The source
    app (``source_kw``) commits 10 heights of 20 txs; ``adverts(pkg,
    snap)`` gives the advertisements, (peer, snapshot) in the order they
    arrive; a peer named ``evil`` flips the first byte of every chunk it
    serves. Returns the outcome, the banned peers, the banned snapshots'
    metadata and whether the joiner (``joiner_kw``) reached the source's
    app hash."""

    src = app_cls(**source_kw)
    src.init_chain(pkg.abci.RequestInitChain(chain_id="ss-sum"))
    for h in range(1, 11):
        src.finalize_block(pkg.abci.RequestFinalizeBlock(
            txs=[b"k%d_%d=%s" % (h, i, b"v" * 40) for i in range(20)], height=h))
        src.commit()
    snap = src.list_snapshots()[-1]
    assert snap.chunks > 3

    async def request_chunk(peer, height, fmt, index):
        chunk = src.load_snapshot_chunk(height, fmt, index)
        return bytes([chunk[0] ^ 0xFF]) + chunk[1:] if peer == "evil" else chunk

    class Provider(_Provider):
        def app_hash(self, height):
            return src.app_hash

    joiner = app_cls(**joiner_kw)
    proxy = SimpleNamespace(snapshot=joiner, query=joiner)
    syncer = pkg.Syncer(proxy, Provider(), request_chunk=request_chunk, discovery_time_s=1.0,
                        chunk_timeout_s=1.0, rng=random.Random(7))
    for peer, ad in adverts(pkg, snap):
        syncer.pool.add(peer, ad)

    async def main():
        try:
            await syncer.sync_any()
            outcome = "restored"
        except Exception as e:  # the JAX app rejects the chunk set
            outcome = type(e).__name__
        banned = sorted(getattr(k, "metadata", b"") for k in syncer.banned_snapshots)
        return outcome, sorted(syncer.banned_peers), banned, joiner.app_hash == src.app_hash

    return run(main())


def _one_corrupting_of_three(pkg, snap):
    return [("evil", snap), ("good1", snap), ("good2", snap)]


def test_checksumming_kvstore_bans_a_corrupting_sender():
    """The port's kvstore with ``chunk_hashes=True`` lists each chunk's
    SHA-256 in its snapshots' metadata, and a joiner with the same option
    answers RETRY for a chunk that differs: the syncer bans the sender
    and restores from the honest peers (ROADMAP C12). The same corrupt
    sender against a JAX kvstore (no chunk hashes) gets the whole
    snapshot rejected at its last chunk, no one banned, and the sync
    fails for want of another snapshot."""
    from cometbft_tpu.models.kvstore import KVStoreApplication as JKV
    from cometbft_tpu_torch.models.kvstore import KVStoreApplication as PKV

    sums = {"chunk_hashes": True}
    port = _kv_restore(PKGS["port"], PKV, sums, sums, _one_corrupting_of_three)
    assert port == ("restored", ["evil"], [], True)
    jax = _kv_restore(PKGS["jax"], JKV, {}, {}, _one_corrupting_of_three)
    assert jax == ("SyncError", [], [b""], False)
    # without chunk hashes the port's app does what the JAX app does
    assert _kv_restore(PKGS["port"], PKV, {}, {}, _one_corrupting_of_three) == jax


def test_default_kvstore_reads_no_chunk_hashes():
    """Phase 14a's shape on the default kvstore: the sources' snapshots
    list chunk hashes (minted with ``chunk_hashes=True``), one of three
    sources corrupts every chunk, and the joiner runs the default app.
    It ignores the advertised metadata and gets the JAX outcome: the
    snapshot rejected at its last chunk, no one banned, the sync failed.
    The ban is a property of a joiner that opted in."""
    from cometbft_tpu.models.kvstore import KVStoreApplication as JKV
    from cometbft_tpu_torch.models.kvstore import KVStoreApplication as PKV

    port = _kv_restore(PKGS["port"], PKV, {"chunk_hashes": True}, {}, _one_corrupting_of_three)
    banned_md = port[2]
    assert port == ("SyncError", [], banned_md, False) and len(banned_md) == 1 and banned_md[0]
    jax = _kv_restore(PKGS["jax"], JKV, {}, {}, _one_corrupting_of_three)
    assert jax[0] == port[0] and jax[1] == port[1] and jax[3] == port[3]


@pytest.mark.parametrize("joiner", ["checksumming", "default"])
def test_poisoned_metadata_bans_no_honest_peer(joiner):
    """A Byzantine peer advertises the honest snapshot first, with
    made-up chunk digests in its metadata, and corrupts every chunk it
    serves. The metadata is part of the snapshot's key (as the
    reference's ``snapshot.Key()``), so its advertisement is another
    snapshot that only it serves: a checksumming joiner bans it on its
    first chunk and moves on when that snapshot times out, a default
    joiner rejects that snapshot alone; either way the honest peers stay
    unbanned and the honest snapshot restores."""
    from cometbft_tpu_torch.models.kvstore import KVStoreApplication as PKV

    def adverts(pkg, snap):
        made_up = b"\x5a" * (32 * snap.chunks)
        poisoned = pkg.abci.Snapshot(snap.height, snap.format, snap.chunks, snap.hash, made_up)
        return [("evil", poisoned), ("good1", snap), ("good2", snap)]

    sums = {"chunk_hashes": True}
    got = _kv_restore(PKGS["port"], PKV, sums, sums if joiner == "checksumming" else {}, adverts)
    if joiner == "checksumming":
        # timed out with its only peer banned: dropped, not banned
        assert got == ("restored", ["evil"], [], True)
    else:
        # the poisoned snapshot rejected at its last chunk, banned by its key
        assert got[:2] == ("restored", []) and got[3]
        assert len(got[2]) == 1 and got[2][0] == b"\x5a" * len(got[2][0]) != b""
