"""Driver of nodes catching up by blocksync.

Passes follow each other without a pause: each builds a fresh joiner
(``node/inprocess.build_node`` with the default configuration and the
configuration's ``db_backend``: ``memdb`` keeps the stores in memory,
``sqlite`` puts them under TMPDIR) and runs its
``BlockSyncReactor`` against two in-process peers until it has applied
every block of the corpus it can (all but the tip, whose commit no
block carries). One peer is honest; the other serves two heights, the
second with one signature of its last commit corrupted, and is added
first so that the joiner fetches those two from it: the joiner must
refuse the forged commit and take both heights again from the honest
peer (the configuration's guarantee: every block's +2/3 commit is
verified before the block is applied). Blocks applied up to the
window's end count, an unfinished pass's included.

The corpus is minted at set-up; a first pass, cut short, warms the path.
"""

from __future__ import annotations

import asyncio
import shutil
import time

from ..gen import chain as gen
from ..gen.keys import rng_for
from ..reference import chain as ref
from ..reference import ed25519 as ref_ed
from .common import DispatchRecorder, NoRecorder, PinnedRoute, FrozenHeap, RefPool, stats_delta

HONEST, FORGER = "good", "forge"
PREFILL_S = 30.0
POLL_S = 0.002


class Pass:
    """One joiner's catch-up and what it produced."""

    def __init__(self, index: int, home):
        self.index = index
        self.home = home
        self.rows: dict = {}  # h -> (app hash, results hash, validators hash)
        self.done: list = []  # the clock at each applied block
        self.redos: list = []  # (height, the peer banned or None)
        self.loop_errors = 0
        self.t_start = time.perf_counter()
        self.block_store = None  # the joiner's, for the readback


async def _one_pass(p: Pass, corpus, forge_at: int, stop, device, tracer, db_backend: str) -> None:
    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.config.config import default_config
    from cometbft_tpu_torch.node.inprocess import build_node

    cfg = default_config(str(p.home))
    cfg.base.db_backend = db_backend
    joiner = build_node(corpus.genesis, config=cfg, home=str(p.home), device=device)
    p.block_store = joiner.block_store
    try:
        real = joiner.block_exec.apply_verified_block

        def apply(state, bid, block):
            st = real(state, bid, block)
            p.done.append(time.perf_counter())
            p.rows[st.last_block_height] = (bytes(st.app_hash), bytes(st.last_results_hash),
                                            bytes(st.validators.hash()))
            return st

        joiner.block_exec.apply_verified_block = apply
        reactor = BlockSyncReactor(joiner.state, joiner.block_exec, joiner.block_store, device=device)
        if tracer is not None:
            reactor.tracer = tracer
        pool = reactor.pool
        real_redo = pool.redo_request

        def redo(height, ban_peer):
            p.redos.append((height, ban_peer))
            real_redo(height, ban_peer)

        pool.redo_request = redo
        top = corpus.top
        pool.set_peer_range(FORGER, gen.ForgingPeerClient(corpus.source, forge_at), forge_at - 1, forge_at)
        deadline = time.perf_counter() + PREFILL_S
        while not {forge_at - 1, forge_at} <= set(pool.blocks):
            if time.perf_counter() > deadline:
                raise RuntimeError("the forging peer never served its heights")
            await asyncio.sleep(POLL_S)
        pool.set_peer_range(HONEST, gen.StorePeerClient(corpus.source), 1, top)
        await reactor.start()
        try:
            while reactor.state.last_block_height < top - 1 and not stop():
                await asyncio.sleep(POLL_S)
        finally:
            await reactor.stop()
        p.loop_errors = reactor.loop_errors.count
    finally:
        joiner.close_stores()


def run(cfg: dict, traffic: dict, seed: int, w, device, log, fault=None, ref_workers=None) -> dict:
    """Set up, run the window ``w``; the run's context, with the check to
    run once the window has closed."""
    from cometbft_tpu_torch.trace import Tracer

    n_blocks = cfg["chain_height"] + 1  # the tip's commit is no block's
    if cfg["tx_mix"] == "bench":  # the replay bench's txs
        txs = gen.bench_txs(n_blocks, cfg["txs_per_block"])
    elif cfg["tx_mix"] == "drawn":  # tx_bytes-byte txs over key_space accounts, drawn from the seed
        txs = gen.make_txs(rng_for(seed, 3), n_blocks, cfg["txs_per_block"], cfg["tx_bytes"], cfg["key_space"])
    else:
        raise ValueError(f"unknown tx_mix {cfg['tx_mix']!r}")
    db_backend = cfg["db_backend"]
    forge_at = traffic["forge_at"]
    t_mint = time.perf_counter()
    corpus = gen.make_corpus(cfg["chain_id"], cfg["validators"], cfg["power"], txs, rng_for(seed, 5), device)
    log(f"catchup: {corpus.top} blocks minted in {time.perf_counter() - t_mint:.1f} s, forged commit at "
        f"{forge_at}")
    tracer = None
    if w.trace:
        tracer = Tracer(name="bftbench")
        tracer.add_observer(w.observe)
    scratch = w.scratch
    passes: list = []
    with PinnedRoute(device) as route:
        warm = Pass(-1, scratch / "warm")
        warm_to = traffic["warm_blocks"]
        asyncio.run(_one_pass(warm, corpus, forge_at, lambda: len(warm.rows) >= warm_to, device, None,
                              db_backend))
        shutil.rmtree(warm.home, ignore_errors=True)
        log(f"catchup: warm pass applied {len(warm.rows)} blocks")
        if fault is not None:
            fault()
        before = route.stats()
        with FrozenHeap(), DispatchRecorder() if w.trace else NoRecorder() as rec:
            t0 = w.start()
            end = w.end

            def stop():
                return time.perf_counter() >= end

            while not stop():
                p = Pass(len(passes), scratch / f"joiner{len(passes)}")
                passes.append(p)
                if w.trace:
                    with w.mark("bftbench.pass"):
                        asyncio.run(_one_pass(p, corpus, forge_at, stop, device, tracer, db_backend))
                else:
                    asyncio.run(_one_pass(p, corpus, forge_at, stop, device, tracer, db_backend))
            w.stop()
        after = route.stats()
        rows = rec.rows if w.trace else []
    done = [t for p in passes for t in p.done]
    ctx = {"t0": t0, "end": t0 + w.seconds, "seconds": w.seconds, "done": done, "device": device,
           "attempted": sum(len(p.rows) for p in passes), "failed": sum(p.loop_errors for p in passes),
           "sched": stats_delta(before, after), "dispatch_rows": rows, "passes": len(passes)}
    spans: dict = {}
    for name, a, b in w.host_spans:
        if name.startswith("blocksync.window."):
            spans[name] = spans.get(name, 0) + (b - a)
    ctx["blocksync_ns"] = spans
    ctx["blocks_in_window"] = sum(1 for t in done if t0 <= t <= t0 + w.seconds)
    log("catchup: passes (blocks, seconds from start to last apply) "
        f"{[(len(p.done), round(p.done[-1] - p.t_start, 3)) for p in passes if p.done]}")
    log(f"catchup: {len(passes)} passes, {ctx['attempted']} blocks applied, {ctx['blocks_in_window']} in the "
        f"window, loop errors {ctx['failed']}, redos {[p.redos for p in passes]}")
    ctx["_check"] = lambda: check(passes, corpus, forge_at, traffic, seed, ref_workers, log, db_backend)
    ctx["_cleanup"] = lambda: _cleanup(passes, corpus)
    return ctx


def _cleanup(passes, corpus) -> None:
    for p in passes:
        shutil.rmtree(p.home, ignore_errors=True)
    corpus.source.close_stores()


def _stored(p: Pass, heights, db_backend: str) -> dict:
    """h -> (header, block ID, seen commit) as the joiner stored them:
    read from its store in memory, or from its sqlite file opened anew."""
    from cometbft_tpu_torch.store.block_store import BlockStore
    from cometbft_tpu_torch.utils import kv

    db = None if db_backend == "memdb" else kv.open_kv(db_backend, str(p.home / "blockstore.db"))
    try:
        bs = p.block_store if db is None else BlockStore(db)
        out = {}
        for h in heights:
            blk, meta, seen = bs.load_block(h), bs.load_block_meta(h), bs.load_seen_commit(h)
            out[h] = None if blk is None or meta is None or seen is None else (blk, meta.block_id, seen)
        return out
    finally:
        if db is not None:
            db.close()


def _sigs(commit) -> list:
    return [(cs.block_id_flag, bytes(cs.validator_address), cs.timestamp_ns, bytes(cs.signature))
            for cs in commit.signatures]


def _bid(b) -> tuple:
    return bytes(b.hash), b.part_set_header.total, bytes(b.part_set_header.hash)


def check(passes, corpus, forge_at, traffic, seed, ref_workers, log, db_backend) -> list:
    """Each pass's applied states, a sample of its stored blocks and
    commits, and its verdicts on the two peers, against the reference."""
    import numpy as np

    chain_id = corpus.genesis.chain_id
    power = corpus.genesis.validators[0].voting_power
    rng = rng_for(seed, 6)
    last = corpus.top - 1
    verify_heights = sorted({int(h) for h in rng.choice(np.arange(1, last + 1), size=min(
        traffic["verify_heights"], last), replace=False)} | {forge_at - 1})
    with RefPool(ref_workers) as pool:
        pks = pool.map_chunks(ref_ed.public_keys, corpus.seeds, chunk=32)
        vals = [(pk, power) for pk in pks]
        vsh = ref.validator_set_hash(vals)
        order = sorted(vals, key=lambda v: ref.address(v[0]))
        # the kvstore's states, from the input txs
        kvs = ref.KVStore()
        app0 = ref.sha256((0).to_bytes(8, "big"))
        expect = {0: (app0, b"")}  # the genesis state has no results yet
        for h in range(1, last + 1):
            expect[h] = kvs.finalize(h, corpus.txs[h - 1])
        # the commits: every signature of the sampled heights, and the
        # forged commit's lanes up to its bad one
        rows, spans = [], {}
        forged = [list(s) for s in _sigs(corpus.commits[forge_at - 1])]
        bad = gen.forged_lane(len(forged))
        sig = bytearray(forged[bad][3])
        sig[5] ^= 0x40
        forged[bad][3] = bytes(sig)
        jobs = [(h, _sigs(corpus.commits[h]), corpus.commits[h]) for h in verify_heights]
        jobs.append(("forged", [tuple(s) for s in forged], corpus.commits[forge_at - 1]))
        for key, sigs, commit in jobs:
            h = commit.height
            bid = _bid(commit.block_id)
            a = len(rows)
            shape = len(sigs) == len(order)
            for (pk, _), (flag, addr, ts, s) in zip(order, sigs):
                if flag != ref.BLOCK_ID_FLAG_COMMIT or addr != ref.address(pk):
                    shape = False
                    break
                rows.append((pk, ref.precommit_sign_bytes(chain_id, h, commit.round, bid, ts), s))
            spans[key] = (a, len(rows), shape)
        oks = pool.map_chunks(ref_ed.verify_rows, rows)
    valid = {k: shape and all(oks[a:b]) for k, (a, b, shape) in spans.items()}
    log(f"catchup reference: {len(rows)} signatures verified; sampled commits valid "
        f"{sum(v for k, v in valid.items() if k != 'forged')} of {len(valid) - 1}, forged commit valid "
        f"{valid['forged']}")
    state_bad = store_bad = verdict_bad = 0
    for key, ok in valid.items():
        # every sampled commit was applied by some pass, the forged one by none
        if ok != (key != "forged"):
            verdict_bad += 1
    canon = {h: _bid(c.block_id) for h, c in corpus.commits.items()}
    for p in passes:
        applied = sorted(p.rows)
        if applied != list(range(1, len(applied) + 1)):
            state_bad += 1
        for h in applied:
            app, res = expect[h]
            if p.rows[h] != (app, res, vsh):
                state_bad += 1
        top = applied[-1] if applied else 0
        banned = [peer for _, peer in p.redos if peer is not None]
        if HONEST in banned:
            verdict_bad += 1  # a valid block refused
        if top >= forge_at - 1 and FORGER not in banned:
            verdict_bad += 1  # the forged commit was not refused
        sample = {int(h) for h in rng.choice(np.arange(1, top + 1), size=min(traffic["readback_heights"], top),
                                             replace=False)} if top else set()
        sample |= {h for h in (forge_at - 1, forge_at, top) if 1 <= h <= top}
        stored = _stored(p, sorted(sample), db_backend)
        for h, got in stored.items():
            if got is None:
                store_bad += 1
                continue
            blk, bid, seen = got
            hd = blk.header
            fields = dict(
                version_block=hd.version_block, version_app=hd.version_app, chain_id=hd.chain_id,
                height=hd.height, time_ns=hd.time_ns, last_block_id=_bid(hd.last_block_id),
                last_commit_hash=hd.last_commit_hash, data_hash=hd.data_hash, validators_hash=hd.validators_hash,
                next_validators_hash=hd.next_validators_hash, consensus_hash=hd.consensus_hash,
                app_hash=hd.app_hash, last_results_hash=hd.last_results_hash, evidence_hash=hd.evidence_hash,
                proposer_address=hd.proposer_address)
            wrong = [name for name, ok in (
                ("header hash", ref.header_hash(fields) == canon[h][0]),
                ("block id", _bid(bid) == canon[h]),
                ("height", hd.height == h and hd.chain_id == chain_id),
                ("txs", [bytes(tx) for tx in blk.data.txs] == corpus.txs[h - 1]),
                ("data hash", hd.data_hash == ref.data_hash(corpus.txs[h - 1])),
                ("app and results hash", (hd.app_hash, hd.last_results_hash) == expect[h - 1]),
                ("validators hash", hd.validators_hash == vsh and hd.next_validators_hash == vsh),
                ("last block id", h == 1 or _bid(hd.last_block_id) == canon[h - 1]),
                ("last commit hash", h == 1 or hd.last_commit_hash == ref.commit_hash(_sigs(corpus.commits[h - 1]))),
                ("seen commit", _sigs(seen) == _sigs(corpus.commits[h]) and _bid(seen.block_id) == canon[h]),
            ) if not ok]
            if wrong:
                store_bad += 1
                if store_bad <= 4:
                    log(f"catchup: pass {p.index} stored height {h} differs from the reference: {wrong}")
    return [("state_mismatches", state_bad, 0), ("store_mismatches", store_bad, 0),
            ("verdict_mismatches", verdict_bad, 0)]
