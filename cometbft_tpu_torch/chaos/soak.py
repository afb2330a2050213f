"""Compressed-time storage lifecycle soak (docs/STORAGE.md).

The bounded-disk claim is only as good as a long run: the retention
plane must hold disk AND RSS flat over thousands of heights while the
windows churn — sqlite pages recycle, WAL groups rotate and prune,
snapshots rotate, markers (``base`` / ``idx:base`` / ``idx:last``)
stay mutually consistent, and pruned heights answer RPC with the
structured below-base error, not a shapeless miss.

Compressed time: blocks come from the chain generator
(utils/chaingen.py — real signed commits through the real
BlockExecutor, no consensus rounds), the WAL is driven synthetically
(the generator bypasses consensus, so end-height records + rotation
are written directly — same group files, same prune leg), and
``reconcile_once`` runs on a slice cadence instead of the wall-clock
timer. 10k heights take ~a minute instead of ~3 hours.

The workload writes a BOUNDED keyspace (``k<h mod keys>=v<h>``): the
app state must plateau for the storage plateau to be attributable to
retention, not masked by state growth. Every checkpoint records disk
(recursive du of the node home) and RSS (/proc VmRSS); after the
warmup fraction — the window must saturate first — no later
checkpoint may exceed the warmup watermark by more than the allowed
factor.

A restart leg at the end rebuilds the node from the same home: the
ABCI handshake must replay ONLY the retained tail (the persisted app
restarts at its committed height — a pruned node cannot replay from
block 1), and the chain must extend cleanly afterwards.

Run it::

    python -m cometbft_tpu_torch.chaos soak --heights 10000 --step 50

Exit 0 iff every assert held; the JSON report carries the checkpoint
series either way. The tier-1 slice (tests/test_retention.py) runs a
few hundred heights; the full soak rides the ``slow`` marker and the
chaos smoke script.

A copy of the JAX package's ``chaos/soak.py``: the node and its chain
check their signatures on ``device`` (None is the GPU), and the CLI
takes ``--device`` (default ``cuda``).
"""

from __future__ import annotations

import hashlib
import os
import tempfile
from typing import List, Optional

from ..utils.log import get_logger

_log = get_logger("chaos.soak")


def _rss_bytes() -> Optional[int]:
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return None


def _soak_config(home: str):
    from ..config.config import test_config

    cfg = test_config(home)
    cfg.base.db_backend = "sqlite"
    cfg.tx_index.indexer = "kv"
    s = cfg.storage
    s.retain_blocks = 64
    s.retain_states = 64
    s.retain_index = 64
    s.prune_batch = 16
    # the soak drives reconciles on its own slice cadence — the
    # background timer must never race it mid-measurement
    s.prune_interval_s = 3600.0
    s.snapshot_interval = 20
    s.snapshot_keep_recent = 2
    return cfg


class _Violation:
    """Accumulator: the soak runs to completion and reports EVERY
    broken assert, not just the first (a plateau breach at checkpoint
    40 and a marker skew at 90 are different bugs)."""

    def __init__(self):
        self.items: List[str] = []

    def check(self, ok: bool, msg: str) -> None:
        if not ok:
            self.items.append(msg)
            _log.error("soak violation", detail=msg)


def _check_markers(v: _Violation, node, where: str) -> None:
    bs = node.block_store
    base, height = bs.base(), bs.height()
    v.check(1 <= base <= height, f"{where}: base {base} outside [1, {height}]")
    v.check(
        bs.load_block(base) is not None,
        f"{where}: block {base} (the base) unreadable",
    )
    if base > 1:
        v.check(
            bs.load_block(base - 1) is None,
            f"{where}: block {base - 1} still present below base {base}",
        )
    ti = node.tx_indexer
    if ti is not None:
        ib = ti.base_height()
        last = ti.last_indexed_height()
        v.check(
            last == height,
            f"{where}: idx:last {last} != chain height {height}",
        )
        v.check(
            ib <= last + 1,
            f"{where}: idx:base {ib} ran ahead of idx:last {last}",
        )
        if ib > 1:
            # no orphan block-event row below the marker (the block
            # indexer shares the db and the idx:base advance)
            import struct

            key = (
                b"blk:e:block.height="
                + str(ib - 1).encode()
                + b":"
                + struct.pack(">Q", ib - 1)
            )
            v.check(
                ti.db.get(key) is None,
                f"{where}: block-event row at {ib - 1} below idx:base {ib}",
            )


def _check_rpc_pruned(v: _Violation, node, chain_id: str) -> None:
    """Every pruned height must answer with the structured error."""
    from ..rpc import core
    from ..rpc.env import Environment

    base = node.block_store.base()
    if base <= 1:
        return
    env = Environment(
        chain_id=chain_id,
        block_store=node.block_store,
        state_store=node.state_store,
        tx_indexer=node.tx_indexer,
        block_indexer=node.block_indexer,
        genesis=node.genesis,
        proxy=node.proxy,
        config=node.config,
        retention=node.retention,
    )
    try:
        core.block(env, height=base - 1)
        v.check(False, f"rpc: block({base - 1}) below base {base} did not error")
    except core.RPCError as e:
        v.check(
            "pruned" in (e.data or "") and f"base={base}" in str(e),
            f"rpc: below-base error not structured: {e} data={e.data!r}",
        )
    st = core.status(env)
    got = st["sync_info"]["earliest_block_height"]
    v.check(
        got == str(base),
        f"rpc: status earliest_block_height {got} != base {base}",
    )


def _check_snapshots(v: _Violation, node, keep_recent: int) -> None:
    ss = node.snapshot_store
    snaps = ss.list_snapshots()
    v.check(bool(snaps), "snapshots: none held after warmup")
    v.check(
        len(snaps) <= keep_recent,
        f"snapshots: {len(snaps)} held > keep_recent {keep_recent}",
    )
    for s in snaps:
        blob = ss.load_blob(s.height)
        v.check(
            blob is not None and hashlib.sha256(blob).digest() == s.hash,
            f"snapshots: blob at height {s.height} does not hash-verify",
        )


def run_soak(
    seed: int = 1337,
    heights: int = 10_000,
    step: int = 50,
    keys: int = 64,
    warmup_frac: float = 0.25,
    disk_factor: float = 1.5,
    rss_factor: float = 1.5,
    home: Optional[str] = None,
    device=None,
) -> dict:
    """Drive ``heights`` blocks through a lifecycle-enabled node in
    ``step``-height slices with a reconcile per slice; returns the
    report dict (``ok``, ``violations``, checkpoint series)."""
    import shutil

    from ..consensus.wal import WAL, _group_files
    from ..device import resolve
    from ..node.inprocess import build_node, make_genesis
    from ..utils.chaingen import make_chain

    device = resolve(device)
    own_home = home is None
    home = home or tempfile.mkdtemp(prefix="soak_")
    v = _Violation()
    checkpoints: List[dict] = []
    try:
        genesis, privs = make_genesis(1, chain_id=f"soak-{seed}", seed=seed)
        cfg = _soak_config(home)
        node = build_node(
            genesis, None, config=cfg, home=home, wal=True, device=device
        )
        # synthetic WAL group: the generator bypasses consensus, so
        # the soak writes the end-height records itself — tiny head
        # limit so rotation churns and the prune leg has sealed files
        # to collect every slice
        wal = WAL(node.cs._wal_path, head_size_limit=2048)
        keep_recent = cfg.storage.snapshot_keep_recent
        warmup_end = max(1, int((heights // step) * warmup_frac))
        disk_mark = rss_mark = None

        done = 0
        while done < heights:
            n = min(step, heights - done)
            for _ in range(n):
                h = node.block_store.height() + 1
                # bounded keyspace: k0..k{keys-1} overwritten forever
                node.mempool.check_tx(b"k%d=v%d" % (h % keys, h))
                make_chain(genesis, privs, 1, txs_per_block=0, node=node, device=device)
                wal.write_end_height(h)
            done += n
            out = node.retention.reconcile_once()
            ck = {
                "height": node.block_store.height(),
                "base": node.block_store.base(),
                "index_base": node.tx_indexer.base_height(),
                "disk_bytes": node.retention.disk_bytes(),
                "rss_bytes": _rss_bytes(),
                "wal_files": len(_group_files(node.cs._wal_path)),
                "pruned": out,
            }
            checkpoints.append(ck)
            i = len(checkpoints)
            _check_markers(v, node, f"ckpt {i} (h={ck['height']})")
            if i == warmup_end:
                disk_mark, rss_mark = ck["disk_bytes"], ck["rss_bytes"]
            elif i > warmup_end:
                # the plateau contract: past warmup the window is
                # saturated — later checkpoints may wobble (sqlite
                # page recycling, allocator noise) but never trend
                v.check(
                    ck["disk_bytes"] <= disk_mark * disk_factor,
                    f"ckpt {i}: disk {ck['disk_bytes']} > "
                    f"{disk_factor}x warmup mark {disk_mark}",
                )
                if ck["rss_bytes"] and rss_mark:
                    v.check(
                        ck["rss_bytes"] <= rss_mark * rss_factor
                        + 32 * 1024 * 1024,
                        f"ckpt {i}: rss {ck['rss_bytes']} > "
                        f"{rss_factor}x warmup mark {rss_mark} + 32MB",
                    )
                v.check(
                    ck["wal_files"] <= 8,
                    f"ckpt {i}: {ck['wal_files']} WAL group files — "
                    "rotation outran the prune leg",
                )
        wal.close()

        stats = node.retention.stats()
        v.check(
            stats["pruned_blocks_total"] > 0, "no blocks were ever pruned"
        )
        v.check(
            stats["pruned_index_total"] > 0, "no index rows were ever pruned"
        )
        v.check(
            stats["pruned_wal_files"] > 0, "no WAL files were ever pruned"
        )
        _check_rpc_pruned(v, node, genesis.chain_id)
        _check_snapshots(v, node, keep_recent)

        # restart leg: same home, fresh node — the handshake must
        # replay ONLY the retained tail (persisted app height), the
        # markers must survive, and the chain must extend cleanly
        pre_base = node.block_store.base()
        pre_height = node.block_store.height()
        node.close_stores()
        try:
            node2 = build_node(
                genesis, None, config=_soak_config(home), home=home, wal=True,
                device=device,
            )
        except Exception as e:  # a replay-from-block-1 attempt lands here
            v.check(False, f"restart: rebuild from pruned home failed: {e!r}")
            node2 = None
        if node2 is not None:
            v.check(
                node2.block_store.base() == pre_base
                and node2.block_store.height() == pre_height,
                f"restart: store moved "
                f"({node2.block_store.base()},{node2.block_store.height()})"
                f" != ({pre_base},{pre_height})",
            )
            make_chain(genesis, privs, step, txs_per_block=0, node=node2, device=device)
            node2.retention.reconcile_once()
            _check_markers(v, node2, "post-restart")
            node2.close_stores()

        report = {
            "seed": seed,
            "heights": heights,
            "step": step,
            "warmup_checkpoints": warmup_end,
            "ok": not v.items,
            "violations": v.items,
            "retention": stats,
            "checkpoints": checkpoints,
        }
        return report
    finally:
        if own_home:
            shutil.rmtree(home, ignore_errors=True)


def soak_main(argv) -> int:
    import argparse
    import json

    ap = argparse.ArgumentParser(
        prog="python -m cometbft_tpu_torch.chaos soak",
        description="compressed-time storage lifecycle soak",
    )
    ap.add_argument("--seed", type=int, default=1337)
    ap.add_argument("--heights", type=int, default=10_000)
    ap.add_argument("--step", type=int, default=50)
    ap.add_argument("--keys", type=int, default=64)
    ap.add_argument("--home", help="node home (default: fresh temp dir)")
    ap.add_argument("--json", help="write the report as JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where signatures are checked: cuda (the default; "
                    "fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    from .matrix import _cli_device

    device = _cli_device(args.device)
    if device is None:
        return 1

    report = run_soak(
        seed=args.seed,
        heights=args.heights,
        step=args.step,
        keys=args.keys,
        home=args.home,
        device=device,
    )
    last = report["checkpoints"][-1] if report["checkpoints"] else {}
    print(
        f"soak seed={report['seed']}: "
        f"{'OK' if report['ok'] else 'VIOLATIONS'}"
    )
    print(
        f"  heights={report['heights']} base={last.get('base')} "
        f"disk={last.get('disk_bytes')} rss={last.get('rss_bytes')}"
    )
    for k in (
        "pruned_blocks_total",
        "pruned_index_total",
        "pruned_wal_files",
        "snapshots_taken",
        "reconciles",
    ):
        print(f"  {k}={report['retention'][k]}")
    for item in report["violations"]:
        print(f"  VIOLATION: {item}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return 0 if report["ok"] else 1
