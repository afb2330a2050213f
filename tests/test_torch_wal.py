"""The consensus WAL (consensus/wal.py) and its group commit.

The port of ``tests/test_wal_rotation.py`` (reference
libs/autofile/group.go:65,265 + consensus/wal.go:92: size-capped head
rotation, group total cap, cross-file SearchForEndHeight, repair,
crash-mid-rotation recovery) and ``tests/test_wal_group_commit.py``
(the group-commit seam: a sync-barrier record is acked only after a
covering fsync, so a power cut never loses an acked record, and a cut
between enqueue and group fsync loses only unacked ones), each with its
JAX counterpart's checks, on the port's WAL and, for the consensus
cases, its state machine on ``device="cpu"``. That the record format is
the JAX package's, byte for byte, is ``test_torch_consensus_parity.py``'s.
"""

import asyncio
import os
import struct
import subprocess
import sys
import time

import pytest
import torch

from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.consensus.wal import (
    MSG_END_HEIGHT,
    MSG_VOTE,
    WAL,
    WALMessage,
    _group_files,
)
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import LocalNet, build_node, make_genesis, make_privvals
from cometbft_tpu_torch.types.block import NIL_BLOCK_ID, BlockID, PartSetHeader
from cometbft_tpu_torch.types.vote import PRECOMMIT, PREVOTE, Vote
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)

CPU = "cpu"
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def host_plane():
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def _write_heights(w: WAL, heights, votes_per_height=20, size=64):
    for h in heights:
        for r in range(votes_per_height):
            w.write(
                WALMessage(
                    kind=MSG_VOTE, height=h, round=0, data=b"v" * size
                )
            )
        w.write_end_height(h)


def test_rotation_and_cross_file_search(tmp_path):
    path = str(tmp_path / "wal")
    w = WAL(path, head_size_limit=1024)
    _write_heights(w, range(1, 21))
    w.close()

    files = _group_files(path)
    assert len(files) > 3, "head must have rotated several times"
    assert files[-1] == path and all(
        f.startswith(path + ".") for f in files[:-1]
    )

    msgs = list(WAL.iter_messages(path))
    # all records survive rotation, in order
    assert sum(1 for m in msgs if m.kind == MSG_END_HEIGHT) == 20
    ends = [m.height for m in msgs if m.kind == MSG_END_HEIGHT]
    assert ends == list(range(1, 21))

    # end-height markers findable across file boundaries
    for h in (1, 7, 19):
        idx = WAL.search_for_end_height(path, h)
        assert idx is not None
        assert msgs[idx - 1].kind == MSG_END_HEIGHT
        assert msgs[idx - 1].height == h
    tail = list(WAL.messages_after_end_height(path, 19))
    assert tail and tail[-1].height == 20


def test_total_size_cap_deletes_oldest(tmp_path):
    path = str(tmp_path / "wal")
    w = WAL(path, head_size_limit=1024, total_size_limit=4096)
    _write_heights(w, range(1, 31))
    w.close()
    files = _group_files(path)
    total = sum(os.path.getsize(f) for f in files)
    # cap enforced (head itself never deleted, so allow one head slack)
    assert total <= 4096 + 2048
    # the oldest heights are gone, newest survive
    msgs = list(WAL.iter_messages(path))
    ends = [m.height for m in msgs if m.kind == MSG_END_HEIGHT]
    assert ends[-1] == 30
    assert 1 not in ends


def test_truncate_corrupt_tail_cross_file(tmp_path):
    path = str(tmp_path / "wal")
    w = WAL(path, head_size_limit=1024)
    _write_heights(w, range(1, 11))
    w.close()
    files = _group_files(path)
    assert len(files) >= 3
    victim = files[1]
    keep_prefix = list(WAL._iter_file(files[0]))
    victim_msgs = list(WAL._iter_file(victim))

    # corrupt the middle of the second file
    with open(victim, "r+b") as f:
        f.seek(os.path.getsize(victim) // 2)
        f.write(b"\xff" * 8)

    # iteration stops at the corruption (later files are suspect)
    readable = list(WAL.iter_messages(path))
    assert len(readable) < len(keep_prefix) + len(victim_msgs) + 1

    n = WAL.truncate_corrupt_tail(path)
    assert n == len(readable)
    msgs = list(WAL.iter_messages(path))
    assert len(msgs) == n
    # earlier file untouched, later files removed, head recreated
    assert list(WAL._iter_file(files[0])) == keep_prefix
    remaining = _group_files(path)
    assert files[2] not in remaining
    assert path in remaining

    # group still writable after repair
    w = WAL(path, head_size_limit=1024)
    w.write_end_height(999)
    w.close()
    assert WAL.search_for_end_height(path, 999) is not None


@pytest.mark.parametrize("fail_index", [0, 1])
def test_crash_mid_rotation_recovers(tmp_path, fail_index):
    """Kill the process exactly before/after the rotation rename; the
    group must stay readable and writable on restart."""
    path = str(tmp_path / "wal")
    script = f"""
import os
os.environ["FAIL_TEST_INDEX"] = "{fail_index}"
from cometbft_tpu_torch.consensus.wal import WAL, WALMessage, MSG_VOTE
w = WAL({path!r}, head_size_limit=1024)
for h in range(1, 100):
    for r in range(20):
        w.write(WALMessage(kind=MSG_VOTE, height=h, data=b"v"*64))
    w.write_end_height(h)
raise SystemExit("fail point never hit")
"""
    proc = subprocess.run(
        [sys.executable, "-c", script],
        cwd=REPO,
        env=dict(os.environ),
        capture_output=True,
        text=True,
        timeout=60,
    )
    assert proc.returncode == 99, proc.stderr

    # whatever hit disk is readable, in order, no duplicates
    msgs = list(WAL.iter_messages(path))
    assert msgs, "pre-crash records must survive"
    ends = [m.height for m in msgs if m.kind == MSG_END_HEIGHT]
    assert ends == sorted(set(ends))

    # restart: the group accepts new writes and rotation proceeds
    w = WAL(path, head_size_limit=1024)
    _write_heights(w, range(1000, 1005))
    w.close()
    assert WAL.search_for_end_height(path, 1004) is not None


def test_record_framing_unchanged(tmp_path):
    """The on-disk record layout stays CRC32+len framed (replay
    compatibility within the group)."""
    path = str(tmp_path / "wal")
    w = WAL(path)
    w.write(WALMessage(kind=MSG_VOTE, height=1, data=b"x"))
    w.close()
    with open(path, "rb") as f:
        crc, ln = struct.unpack(">II", f.read(8))
        payload = f.read(ln)
    import zlib

    assert zlib.crc32(payload) & 0xFFFFFFFF == crc
    assert WALMessage.decode(payload).height == 1


def _msgs(path):
    return list(WAL.iter_messages(path))


def test_group_ticket_completes_after_fsync(tmp_path):
    path = str(tmp_path / "wal")
    w = WAL(path, group_commit_ms=5.0, fsync_slow_s=0.0)
    tickets = [
        w.write_group(WALMessage(kind=MSG_VOTE, height=1, round=r))
        for r in range(8)
    ]
    for t in tickets:
        assert t.wait(5.0), "group fsync never landed"
    # one coalesced fsync covered the whole burst
    assert w.group_fsyncs >= 1
    assert w.group_coalesced == 8
    assert w.group_fsyncs < 8, "barriers did not coalesce"
    w.close()
    assert len(_msgs(path)) == 8


def test_window_zero_is_strict_serial(tmp_path):
    path = str(tmp_path / "wal")
    w = WAL(path, group_commit_ms=0.0)
    t = w.write_group(WALMessage(kind=MSG_END_HEIGHT, height=1))
    # strict path: durable before write_group returns
    assert t.done()
    assert w.group_fsyncs == 0
    w.crash_close()  # power cut AFTER the ack
    assert len(_msgs(path)) == 1  # acked record survives the cut


def test_crash_between_enqueue_and_group_fsync_loses_unacked(tmp_path):
    """Power cut inside the coalescing window: the record was appended
    to the userspace buffer but never fsynced — it must vanish (like a
    reference serial WAL crash before WriteSync returned) and its
    ticket must NEVER complete (no acked-then-lost)."""
    path = str(tmp_path / "wal")
    w = WAL(path, group_commit_ms=60_000.0, fsync_slow_s=0.0)  # window >> test: no fsync
    t0 = w.write_group(WALMessage(kind=MSG_VOTE, height=1))
    w.flush_sync()  # an explicit barrier acks everything appended so far
    assert t0.done()
    t1 = w.write_group(WALMessage(kind=MSG_VOTE, height=2))
    assert not t1.done()
    w.crash_close()
    assert not t1.done(), "acked a record the cut destroyed"
    msgs = _msgs(path)
    assert [m.height for m in msgs] == [1], (
        "unacked record survived / acked record lost"
    )


def test_any_fsync_acks_pending_group_tickets(tmp_path):
    """Durability is prefix-ordered: a strict write_sync (e.g. the
    end-height marker) must complete every pending group ticket — its
    fsync covers their records too."""
    path = str(tmp_path / "wal")
    w = WAL(path, group_commit_ms=60_000.0, fsync_slow_s=0.0)
    t = w.write_group(WALMessage(kind=MSG_VOTE, height=3))
    assert not t.done()
    w.write_end_height(3)  # strict barrier
    assert t.done()
    w.crash_close()
    assert [m.kind for m in _msgs(path)] == [MSG_VOTE, MSG_END_HEIGHT]


def test_graceful_close_flushes_pending_group(tmp_path):
    path = str(tmp_path / "wal")
    w = WAL(path, group_commit_ms=60_000.0, fsync_slow_s=0.0)
    t = w.write_group(WALMessage(kind=MSG_VOTE, height=9))
    w.close()
    assert t.done()
    assert len(_msgs(path)) == 1


def test_torn_tail_repair_after_group_commit_crash(tmp_path):
    """A cut mid-append can leave a torn partial record after the last
    group fsync; repair_torn_tail must trim it exactly like the serial
    WAL's torn tail (satellite: power-cut parity)."""
    path = str(tmp_path / "wal")
    w = WAL(path, group_commit_ms=5.0, fsync_slow_s=0.0)
    t = w.write_group(WALMessage(kind=MSG_VOTE, height=1))
    assert t.wait(5.0)
    w.crash_close()
    with open(path, "ab") as f:
        f.write(b"\xde\xad\xbe\xef")  # torn partial record
    removed = WAL.repair_torn_tail(path)
    assert removed == 4
    msgs = _msgs(path)
    assert len(msgs) == 1 and msgs[0].height == 1
    # the repaired head appends cleanly again
    w2 = WAL(path, group_commit_ms=5.0, fsync_slow_s=0.0)
    t2 = w2.write_group(WALMessage(kind=MSG_VOTE, height=2))
    assert t2.wait(5.0)
    w2.close()
    assert [m.height for m in _msgs(path)] == [1, 2]


def test_rotation_under_group_commit(tmp_path):
    """Rotation's flush+rename barrier composes with the group seam:
    records never span files and every ticket still completes."""
    path = str(tmp_path / "wal")
    w = WAL(path, head_size_limit=256, group_commit_ms=5.0, fsync_slow_s=0.0)
    tickets = [
        w.write_group(
            WALMessage(kind=MSG_VOTE, height=h, data=b"x" * 64)
        )
        for h in range(1, 13)
    ]
    for t in tickets:
        assert t.wait(5.0)
    w.close()
    assert [m.height for m in _msgs(path)] == list(range(1, 13))
    assert any(
        p != path and os.path.exists(p)
        for p in [f"{path}.{i:03d}" for i in range(4)]
    ), "head never rotated"


def _run(coro, timeout=90):
    return asyncio.run(asyncio.wait_for(coro, timeout))


def test_consensus_crash_mid_group_commit_recovers(tmp_path):
    """End-to-end: a node running with group commit + pipelined
    finalize crash-closes mid-flight; a rebuilt node must replay the
    fsync'd WAL prefix (+ privval reconciliation for a lost own-vote
    tail) and resume producing blocks. The slow-disk model makes the
    calibrated router actually engage the group seam on this box."""
    from cometbft_tpu_torch.consensus import wal as walmod

    async def main():
        home = str(tmp_path)
        gen, privs = make_genesis(1)
        pvs = make_privvals(privs, root=home)

        def cfg_for():
            cfg = make_test_cfg(home)
            cfg.consensus.wal_group_commit_ms = 2.0
            cfg.consensus.finalize_pipeline = True
            cfg.base.db_backend = "sqlite"
            return cfg

        walmod.set_fsync_model(0.002)  # engage the calibrated seam
        try:
            node = build_node(
                gen, privval=pvs[0], config=cfg_for(), home=home, wal=True, device=CPU
            )
            net = LocalNet([node])
            await net.start()
            await net.wait_for_height(2, timeout=30)
            await node.cs.crash()  # power cut: buffered WAL tail lost
            node.close_stores()
            h = node.block_store.height()

            node2 = build_node(
                gen, privval=pvs[0], config=cfg_for(), home=home, wal=True, device=CPU
            )
            net2 = LocalNet([node2])
            await net2.start()
            await net2.wait_for_height(h + 2, timeout=30)
            await net2.stop()
            assert node2.block_store.height() >= h + 2
            assert node2.cs.wal.group_coalesced > 0, (
                "slow-disk model never engaged the group seam"
            )
            node2.close_stores()
        finally:
            walmod.set_fsync_model(0.0)

    _run(main())


def test_privval_rollback_when_precommitted_block_unrecoverable():
    """The group-commit recovery hole's hard case: the signer state
    holds a non-nil precommit whose block data the WAL lost (crash
    inside one group window, sole validator). Injecting it would
    wedge the node in COMMIT waiting for parts that exist nowhere;
    reconciliation must instead roll the signer back to the newest
    WAL-proven record — safe because a vote absent from the fsync'd
    WAL was provably never broadcast (externalization is gated on
    the covering fsync)."""
    import time as _time

    from cometbft_tpu_torch.privval.file_pv import STEP_PRECOMMIT

    gen, privs = make_genesis(1)
    pvs = make_privvals(privs)
    node = build_node(gen, privval=pvs[0], wal=True, device=CPU)
    cs = node.cs
    pv = pvs[0]
    # sign a precommit for a block that exists nowhere (its WAL
    # records were "lost" — we simply never write them)
    bid = BlockID(b"\x07" * 32, PartSetHeader(1, b"\x08" * 32))
    idx, _ = cs.rs.validators.get_by_address(pv.pub_key().address())
    lost = Vote(
        type_=PRECOMMIT,
        height=cs.rs.height,
        round=0,
        block_id=bid,
        timestamp_ns=_time.time_ns(),
        validator_address=pv.pub_key().address(),
        validator_index=idx,
    )
    pv.sign_vote(gen.chain_id, lost)
    assert pv.last.step == STEP_PRECOMMIT
    cs._reconcile_privval_state()
    # not injected (would wedge COMMIT), signer rolled back to the
    # WAL's knowledge (nothing): a fresh round-0 prevote for a
    # DIFFERENT block must sign cleanly now
    vs = cs.rs.votes.precommits(0)
    assert vs is None or vs.votes[idx] is None
    assert pv.last.step == 0
    fresh = Vote(
        type_=PREVOTE,
        height=cs.rs.height,
        round=0,
        block_id=BlockID(b"\x09" * 32, PartSetHeader(1, b"\x0a" * 32)),
        timestamp_ns=_time.time_ns(),
        validator_address=pv.pub_key().address(),
        validator_index=idx,
    )
    pv.sign_vote(gen.chain_id, fresh)
    assert fresh.signature


def test_vote_batch_serial_equivalence():
    """In-round batched vote verification must produce verdicts
    identical to the serial path — valid votes land, corrupted ones
    are rejected, across both configurations."""

    async def run_net(window_ms):
        gen, privs = make_genesis(4)
        nodes = []
        for pv in make_privvals(privs):
            cfg = make_test_cfg(".")
            cfg.consensus.vote_batch_window_ms = window_ms
            nodes.append(build_node(gen, privval=pv, config=cfg, device=CPU))
        net = LocalNet(nodes)
        await net.start()
        await net.wait_for_height(2, timeout=60)
        await net.stop()
        hashes = [
            nodes[0].block_store.load_block_meta(h).block_id.hash
            for h in (1, 2)
        ]
        for n in nodes[1:]:
            for i, h in enumerate((1, 2)):
                assert (
                    n.block_store.load_block_meta(h).block_id.hash
                    == hashes[i]
                )
        coalesced = sum(
            n.cs._vote_coalescer.submitted
            for n in nodes
            if n.cs._vote_coalescer is not None
        )
        return hashes, coalesced

    async def main():
        _, serial_coalesced = await run_net(0.0)
        assert serial_coalesced == 0  # window 0 = serial inline path
        _, batched_coalesced = await run_net(2.0)
        assert batched_coalesced > 0, (
            "batched run never exercised the coalescing verifier"
        )

    _run(main())


def test_prestaged_invalid_vote_dropped():
    """A corrupted-signature peer vote routed through the batch
    verifier must be dropped with the same outcome as the serial
    path's inline rejection (serial-equivalent verdicts)."""

    async def main():
        from cometbft_tpu_torch.consensus.state import VoteMessage

        gen, privs = make_genesis(2)
        pvs = make_privvals(privs)
        cfg = make_test_cfg(".")
        cfg.consensus.vote_batch_window_ms = 2.0
        node = build_node(gen, privval=pvs[0], config=cfg, device=CPU)
        net = LocalNet([node])
        await net.start()
        # forge a vote from validator 1 with a garbage signature
        addr1 = pvs[1].pub_key().address()
        idx, _ = node.cs.rs.validators.get_by_address(addr1)
        bad = Vote(
            type_=PREVOTE,
            height=node.cs.rs.height,
            round=0,
            block_id=NIL_BLOCK_ID,
            timestamp_ns=time.time_ns(),
            validator_address=addr1,
            validator_index=idx,
            signature=b"\x00" * 64,
        )
        node.cs.enqueue_nowait("vote", VoteMessage(bad), "peerX")
        await asyncio.sleep(0.3)
        vs = node.cs.rs.votes.prevotes(0)
        assert vs is None or vs.votes[idx] is None, (
            "invalid-signature vote was admitted"
        )
        await net.stop()

    _run(main())
