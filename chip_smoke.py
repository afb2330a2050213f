#!/usr/bin/env python3
"""Drive the cometbft_tpu_torch port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # every phase (the full check)
    python3 chip_smoke.py --quick    # build + kernels vs plain, 500 lanes

Phases, each printing one JSON line:
1. the card (nvidia-smi name and power limit);
2. the build of every CUDA kernel from csrc/ (nvcc; registers, spills,
   stack frame and shared memory from ptxas; counts of chosen SASS
   instructions where cuobjdump is found);
3. each kernel against its plain PyTorch version on the card, exact
   equality, at 4,100 lanes with edge cases and every message bucket,
   and again at 4,101 lanes, where the last warps and blocks are
   partial and K3's rows are not 4-byte aligned (phase 6 repeats the
   comparison at the main path's own shapes);
4. the main path: a 150-validator set, a 32-height window of commits
   through types.validation.verify_commits_coalesced at catch-up
   priority (one tampered signature, one commit under 2/3, nil votes)
   and one verify_commit at live priority, both through the verify
   scheduler with the device route pinned (floor 1), lane verdicts
   against the host oracle, and every kernel's launch counter above 0
   (counters are zeroed just before and read just after);
5. bulk: ops.ed25519.verify_batch at 131,072 lanes tiled from 4,096
   distinct signed items with ~1% corrupted; median device time,
   verifies/s, per-kernel device ms (CUDA graph) and single-call ms
   (with the wrapper's host time) and launches, host packing ms, peak
   device memory, each kernel against its plain version at this
   width, and the plain/precomp crossover;
6. the kernels line: each kernel against its plain version on the
   main path's own inputs (the window's 4,740 lanes and the commit's
   150), its launches on the unforced main path (phase 7a) and on the
   pinned one (phase 4), times and bound, block size,
   registers, shared memory, stack and resident warps per SM. "ms"
   times are device times, of calls replayed from a CUDA graph;
   "call_ms" times are of calls from Python, back to back at the window
   and the commit, single at bulk, wrapper host time included.
   It is printed after phase 7:
7. dispatch, through the verify scheduler without a pinned route:
   (a) the main path as a node runs it: the window through
   verify_commits_coalesced and the commit through verify_commit, five
   times each from the calibration seeds, unforced, with the route
   each took and what the calibration learned; every window must take
   the device route and every kernel must launch (counters zeroed just
   before (a) and read just after);
   (b) the device route and the host plane, each forced, at 150, 4,740
   and 32,768 lanes, with the route the calibration picks, the walls
   (submit to resolve, host packing included) and a straight-line fit
   of the device walls (the seeds' source); (c) eight catch-up windows
   queued and then one live commit: the live wall, the catch-up drain,
   promotions, device dispatches, host chunks and degraded tickets
   (must be 0), and the live ticket must resolve before the last
   catch-up one. Every verdict against the host oracle.

8. replay, the slice's main path: a 150-validator chain of 1,025
   blocks (one tx a block, keys from a seeded generator) built with
   utils.chaingen (its build time on its own line), then replayed into
   a fresh build_node by a BlockSyncReactor on the card from a
   StorePeerClient, waited on on_caught_up with a deadline. It fails
   unless the store reaches 1,023, every height's app hash, results
   hash, validator-set hash and block hash equal the source's, the pool
   routine caught nothing, every window's dispatch took the device
   route (no host chunk, 0 degraded) and launched each kernel (counters
   zeroed just before the replay, read just after). Then a 129-block
   prefix is replayed twice with two bad peers that fill the pool first
   (a TamperingPeerClient at one height, a peer whose block carries a
   last commit with one corrupted signature among its first 100
   lanes): on the card, and with the host route forced. Both must
   refetch the same heights from the honest peer and reach the
   source's state at every height. The replay line has blocks/s,
   signatures/s, windows, pipeline_stats, the summed
   blocksync.window.prepare / verify_wait / apply / persist spans and
   each route's ticket walls (submit to resolve).

9. light bisection, BASELINE config 4 (bench.py::bench_bisect's shape):
   150 validators of power 10, a 50,000-height skip from a trust root at
   height 1, sets rotating 60 keys every 2,500 heights, headers minted
   on demand (150 host signatures a fetch) by
   utils.chaingen.RotatingLightProvider, through the port's light Client:
   (a) on the card with the device route pinned: fetched heights, hops,
   every verify ticket (label, lanes, route, wall), K1-K3 launches (49
   of each, one per ticket), cache size, trusted hash, the wall with and
   without fetching and signing; it fails unless the counts equal the
   JAX package's run of this shape (22 fetches in its order, 20 hops, 49
   tickets of 30-101 lanes, 2,199 cached signatures); (b) the same
   unforced, with the route of each ticket; (c) the same host-forced,
   equal to (a); (d) refusals on the card and host-forced: one signature
   forged at pivot 2,816, one at the target, a witness serving a fork
   valid in itself; each must refuse at the same height with the same
   error on both routes, the fork with the same attack evidence
   (timestamp aside). The kernels line adds bisect_launches and each
   kernel against its plain version on the bisection's 101- and 30-lane
   dispatches, with its device time and bound at 101 lanes.

The line before last is the card's name and power limit; the last is
{"ok": true, "device": {...}}. Any failure exits non-zero with no
result line. Needs no network; exits non-zero without a GPU or
without the rest of the repository.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

SEED = 20261016
N_CHECK = 4100  # not a multiple of 128: the last block is partial
N_RAGGED = 4101  # not a multiple of 4 or 32 either
N_BULK = 131072
N_DISTINCT = 4096
N_VALS = 150
N_HEIGHTS = 32
CROSSOVER_WIDTHS = (512, 1024, 2048, 4096, 8192, 16384, 32768, 65536, 131072)
DISPATCH_WIDTHS = (N_VALS, 4740, 32768)  # the commit, the window, bulk
DISPATCH_REPS = 5
PRIORITY_WINDOWS = 8
# phase 8: the width of BASELINE.json's replay config (150 validators);
# its depth cut from 10,000 blocks to 1,025 (1,024 applied: 32 windows
# of VERIFY_WINDOW) to fit the smoke's time
REPLAY_VALS = 150
REPLAY_BLOCKS = 1025
REFUSAL_BLOCKS = 129
TAMPER_AT = 40  # both bad heights sit in the second window
FORGE_AT = 50
REPLAY_DEADLINE_S = 600
# phase 9: BASELINE.json's bisect config (bench.py::bench_bisect): 150
# validators of power 10, a 50,000-height skip, sets rotating 60 keys
# every 2,500 heights; what the JAX package's run of it does (22
# fetches in this order, 20 hops, 49 verify tickets, 2,199 cached
# signatures)
BISECT_VALS = 150
BISECT_TARGET = 50_000
BISECT_EPOCH = 2_500
BISECT_SHIFT = 60
BISECT_FETCHED = [1, 1, 50000, 28125, 15820, 8899, 5006, 2816, 12792, 11088, 22741, 19713,
                  21416, 25769, 40429, 35046, 32018, 33721, 38073, 45812, 43456, 48167]
BISECT_HOPS = 20
BISECT_DISPATCHES = 49
BISECT_CACHE = 2199
BISECT_FORGE_PIVOT = 2816

# card peaks: HBM bytes/s from the H100 SXM data sheet; 32-bit integer
# results per clock per SM on sm_90 (IMAD, IADD, LOP, shifts: 64, the
# CUDA C++ Programming Guide's throughput table), times the SM count and
# the maximum SM clock this card reports. A 32 x 32 -> 64 product counts
# as one multiply-add at that rate: the least it could cost.
HBM_BYTES_S = 3.35e12
INT_PER_CLK_SM = 64
# 32-bit products per field operation, the least the function needs:
# a multiply has 10 x 10, a square 55 (pairs i <= j)
PRODUCTS = {"mul": 100, "sq": 55}
# field multiplies and squares per lane, counted from the formulas in csrc/
FE_OPS = {
    # table build 151 mul; 64 windows of 27 mul + 16 sq; epilogue 20 mul + 13 sq
    "ladder": {"mul": 151 + 64 * 27 + 20, "sq": 64 * 16 + 13},
    # pow2523 11 mul + 251 sq, around it 7 mul + 4 sq; the data-dependent
    # x * sqrt(-1) and x * y are not counted
    "decompress": {"mul": 18, "sq": 255},
}
# SHA-512, 32-bit instructions a 128-byte block at the least: a 64-bit
# rotate is two funnel shifts, a three-way XOR, choose or majority one
# LOP3 a half, a sum of three 64-bit words one IADD3 pair. A round: S0,
# S1 8 each, ch 2, maj 2, t1 (five terms) 4, e 2, a 2 = 28; a schedule
# word: s0, s1 8 each, its four terms 4 = 20; the feed-forward 16; the
# byte swap of the 16 message words 32
SHA_OPS_PER_BLOCK = 80 * 28 + 64 * 20 + 16 + 32
SC_OPS = 600  # reduction mod L, negation, digits: 32-bit ops per lane

REPLACES = {
    "ladder": "cometbft_tpu/ops/pallas_ladder.py:220",
    "decompress": "cometbft_tpu/ops/curve25519.py:111",
    "hash_digits": "cometbft_tpu/ops/sha512.py:168",
}
SOURCES = {
    "ladder": "cometbft_tpu_torch/csrc/ladder.cu",
    "decompress": "cometbft_tpu_torch/csrc/decompress.cu",
    "hash_digits": "cometbft_tpu_torch/csrc/hash_digits.cu",
}


def emit(phase: str, **kw) -> None:
    print(json.dumps({"phase": phase, **kw}), flush=True)


def check(cond, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def int_ops_s() -> tuple[float, dict]:
    """The card's 32-bit integer rate, and what it was computed from."""
    import torch

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(smi("clocks.max.sm").split()[0])
    rate = INT_PER_CLK_SM * sms * mhz * 1e6
    return rate, {"per_clk_sm": INT_PER_CLK_SM, "sms": sms, "max_sm_mhz": mhz,
                  "int32_ops_s": rate}


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, timed with CUDA events."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device ms per call over ``reps`` calls captured in one CUDA
    graph: the card's time alone. Called back to back from Python, a
    kernel of a few microseconds waits on the host's launch overhead
    (the wrappers' checks and allocations), which ``cuda_ms`` counts."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    g.replay()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def median_ms(fn, runs: int) -> float:
    return statistics.median(cuda_ms(fn, 1, warm=0) for _ in range(runs))


# --- data ------------------------------------------------------------------


def signed_items(rng, n):
    """n (msg, pk, sig) items, 100-120-byte messages (vote-sized),
    each signed by its own key from the port's host tier."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    out = []
    for _ in range(n):
        k = Ed25519PrivKey.from_seed(rng.bytes(32))
        m = rng.bytes(int(rng.integers(100, 121)))
        out.append((m, k.pub_key().key_bytes, k.sign(m)))
    return out


def edge_encodings():
    from cometbft_tpu_torch.crypto import ref_ed25519 as ref

    P = ref.P
    return [
        ref.point_compress(ref.IDENTITY),            # identity
        (P - 1).to_bytes(32, "little"),              # order 2 (y = -1)
        (P + 1).to_bytes(32, "little"),              # y >= p (non-canonical)
        (1 << 255).to_bytes(32, "little"),           # x = 0, sign bit set
        ((1 << 255) | 1).to_bytes(32, "little"),     # y = 1 with sign bit
        (2**255 - 1).to_bytes(32, "little"),         # top of the range
        P.to_bytes(32, "little"),                    # y = p
        (2).to_bytes(32, "little"),                  # non-square
    ]


def as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def compare(calls) -> dict:
    """Run each kernel and its plain version once on the same inputs;
    fail unless every output is equal. Returns {name: max_abs_err}."""
    import torch

    errs = {}
    for name, (f, plain) in calls.items():
        got, want = as_tuple(f()), as_tuple(plain())
        same = len(got) == len(want) and all(torch.equal(g, w) for g, w in zip(got, want))
        check(same, f"{name} != plain")
        errs[name] = max_err(got, want)
    return errs


def max_err(got, want) -> int:
    """Largest absolute difference over pairs of integer tensors."""
    return max(int((g.long() - w.long()).abs().max()) if g.numel() else 0
               for g, w in zip(got, want))


def tensor_of(rows, dev):
    import numpy as np
    import torch

    arr = np.stack([np.frombuffer(r, np.uint8) for r in rows], 1)
    return torch.from_numpy(arr.copy()).to(dev)


# --- phase 3: kernel vs plain ------------------------------------------------


def phase_kernels(dev, rng, n):
    """Each kernel against its plain version at n lanes, K3 in every
    message bucket."""
    import numpy as np
    import torch

    from cometbft_tpu_torch.ops import curve25519 as cv
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import ladder as ld
    from cometbft_tpu_torch.ops import sc25519 as sc

    res = {}
    # K2: edge encodings, valid keys, random bytes
    valid = [it[1] for it in signed_items(rng, 64)]
    encs = edge_encodings() + valid
    encs += [rng.bytes(32) for _ in range(n - len(encs))]
    b = tensor_of(encs, dev)
    pt, ok = cv.decompress(b)
    ppt, pok = cv.decompress_plain(b)
    check(torch.equal(pt, ppt) and torch.equal(ok, pok), "decompress != plain")
    res["decompress"] = {"lanes": n, "equal": True, "ok_lanes": int(ok.sum()),
                         "max_abs_err": max_err((pt, ok), (ppt, pok))}

    # K3: every message bucket, S values around L; the first and the
    # last full block of 64 lanes each hold lanes of every SHA block
    # count the bucket allows, at the count's edges (47/48, 175/176...)
    equal, err = True, 0
    end = n // 64 * 64
    for cap in ed.MSG_CAPS:
        lens = rng.integers(0, cap + 1, n).astype(np.int32)
        edges = [0, 1, cap - 1, cap] + [128 * b + d for b in range(8) for d in (47, 48)
                                        if 128 * b + d <= cap]
        lens[: len(edges)] = edges
        lens[end - len(edges): end] = edges[::-1]
        msgs = np.zeros((cap, n), np.uint8)
        for i, ln in enumerate(lens):
            msgs[:ln, i] = rng.integers(0, 256, ln, dtype=np.uint8)
        pr = torch.from_numpy(rng.integers(0, 256, (32, 2 * n), dtype=np.uint8)).to(dev)
        ssn = rng.integers(0, 256, (32, n), dtype=np.uint8)
        L = sc.L
        for i, v in enumerate((L - 1, L, L + 1, 0, 2**256 - 1)):
            ssn[:, i] = np.frombuffer(v.to_bytes(32, "little"), np.uint8)
        ss = torch.from_numpy(ssn).to(dev)
        args = (torch.from_numpy(msgs).to(dev), torch.from_numpy(lens).to(dev),
                pr[:, :n], pr[:, n:], ss)
        got = sc.hash_digits(*args)
        want = sc.hash_digits_plain(*args)
        equal &= all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(err, max_err(got, want))
    check(equal, "hash_digits != plain")
    res["hash_digits"] = {"lanes": n, "caps": list(ed.MSG_CAPS), "equal": True,
                          "max_abs_err": err}

    # K1 bare: random digits on valid A
    A = pt[..., : len(valid)].repeat(1, 1, n // len(valid) + 1)[..., :n].contiguous()
    ds = torch.from_numpy(rng.integers(0, 16, (64, n), dtype=np.uint8)).to(dev)
    dh = torch.from_numpy(rng.integers(0, 16, (64, n), dtype=np.uint8)).to(dev)
    q = ld.straus(ds, dh, A)
    q_plain = ld.straus_plain(ds, dh, A)
    check(torch.equal(q, q_plain), "straus != plain")

    # K1 fused: real signatures, some corrupted
    items = signed_items(rng, 256)
    items = [items[i % 256] for i in range(n)]
    for i in range(0, n, 37):
        m, pk, sig = items[i]
        items[i] = (m, pk, sig[:40] + bytes([sig[40] ^ 4]) + sig[41:])
    msgs, lens, prn, ssn, _, _ = ed.pack(items, False)
    to = lambda a: torch.from_numpy(a.T.copy()).to(dev)  # noqa: E731
    msgs_t, prt, sst = to(msgs), to(prn), to(ssn)
    lens_t = torch.from_numpy(lens).to(dev)
    dsv, dhv, oks = sc.hash_digits(msgs_t, lens_t, prt[:, :n], prt[:, n:], sst)
    ptv, okv = cv.decompress(prt)
    args = (dsv, dhv, ptv[..., :n], ptv[..., n:], okv[:n], okv[n:], oks)
    v = ld.verify(*args)
    v_plain = ld.verify_plain(*args)
    check(torch.equal(v, v_plain), "verify != plain")
    res["ladder"] = {"lanes": n, "straus_equal": True, "verify_equal": True,
                     "valid_lanes": int(v.sum()),
                     "max_abs_err": max(max_err([q], [q_plain]), max_err([v], [v_plain]))}
    return res


# --- phase 4: the main path -------------------------------------------------


def build_window(rng):
    """150 validators, 32 heights of commits; height 5 has one tampered
    signature, height 20 has 60 absent votes (under 2/3), height 9 has
    nil votes. Returns (chain_id, vals, privs, jobs, expected)."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.types import block as B
    from cometbft_tpu_torch.types import canonical as C
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.types.validator_set import Validator, ValidatorSet

    chain_id = "smoke-chain"
    privs = [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(N_VALS)]
    vals = ValidatorSet([Validator(p.pub_key(), 100) for p in privs])
    by_addr = {p.pub_key().address(): p for p in privs}
    privs = [by_addr[v.address] for v in vals.validators]
    jobs, expected = [], []
    for h in range(1, N_HEIGHTS + 1):
        bid = B.BlockID(rng.bytes(32), B.PartSetHeader(1, rng.bytes(32)))
        sigs = []
        for i, (v, p) in enumerate(zip(vals.validators, privs)):
            if h == 20 and i >= 90:
                sigs.append(B.CommitSig.absent())
                continue
            flag = B.BLOCK_ID_FLAG_NIL if (h == 9 and i % 10 == 0) else B.BLOCK_ID_FLAG_COMMIT
            ts = 1_700_000_000_000_000_000 + h * 1_000_000_000 + (i % 3)
            target = bid if flag == B.BLOCK_ID_FLAG_COMMIT else B.NIL_BLOCK_ID
            sb = C.vote_sign_bytes(chain_id, C.PRECOMMIT_TYPE, h, 0, target, ts)
            sig = p.sign(sb)
            if h == 5 and i == 7:
                sig = sig[:10] + bytes([sig[10] ^ 1]) + sig[11:]
            sigs.append(B.CommitSig(flag, v.address, ts, sig))
        jobs.append((vals, bid, h, B.Commit(h, 0, bid, sigs)))
        if h == 5:
            expected.append((V.ErrInvalidSignature, "invalid signature for validator 7 at height 5"))
        elif h == 20:
            expected.append((V.ErrNotEnoughVotingPower, "height 20: tallied 9000 <= 2/3"))
        else:
            expected.append(None)
    return chain_id, vals, privs, jobs, expected


def phase_main(dev, rng):
    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.ops import ladder as ld
    from cometbft_tpu_torch.types import validation as V

    chain_id, vals, privs, jobs, expected = build_window(rng)
    # warm the libraries outside the counted run
    kernels.load("ladder", ld._init), kernels.load("decompress"), kernels.load("hash_digits")
    # through the scheduler with the device route pinned (floor 1), so
    # the launch and lane checks below keep their meaning
    floor = batch._MIN_DEVICE_BATCH
    batch.set_min_device_batch(1)
    try:
        kernels.reset_counts()
        t0 = time.perf_counter()
        errs = V.verify_commits_coalesced(chain_id, jobs, light=False,
                                          priority=V.PRIORITY_CATCHUP, device=dev)
        window_dispatch = dict(ed.LAST_DISPATCH)
        _, bid1, h1, c1 = jobs[0]
        V.verify_commit(chain_id, vals, bid1, h1, c1, priority=V.PRIORITY_LIVE, device=dev)
        wall = time.perf_counter() - t0
        commit_dispatch = dict(ed.LAST_DISPATCH)
        launches = dict(kernels.LAUNCHES)
    finally:
        batch.set_min_device_batch(floor)
    got = [None if e is None else (type(e), str(e)) for e in errs]
    check(got == expected, f"window errors {got} != {expected}")
    check(all(v > 0 for v in launches.values()), f"a kernel never launched: {launches}")
    # verify_commit must also reject the tampered commit
    _, bid5, h5, c5 = jobs[4]
    try:
        V.verify_commit(chain_id, vals, bid5, h5, c5, priority=V.PRIORITY_LIVE, device=dev)
        raise AssertionError("tampered commit verified")
    except V.ErrInvalidSignature as e:
        check(str(e) == "invalid signature for validator 7", str(e))
    # lane verdicts against the host oracle
    per_commit = []
    for _, _, _, commit in jobs:
        per_commit.append([])
        for i, cs in enumerate(commit.signatures):
            if not cs.is_absent():
                pk = vals.get_by_index(i).pub_key
                per_commit[-1].append(
                    (V._commit_sign_bytes(chain_id, commit, cs), pk, cs.signature))
    items = [it for c in per_commit for it in c]
    got_v = ed.verify_batch([(m, pk.key_bytes, s) for m, pk, s in items], device=dev)
    want_v = [pk.verify(m, s) for m, pk, s in items]
    check(list(map(bool, got_v)) == want_v, "lane verdicts != host oracle")
    check(len(items) == window_dispatch["lanes"], "window lanes")
    check(len(per_commit[0]) == commit_dispatch["lanes"], "commit lanes")
    emit("main_path", lanes=window_dispatch["lanes"], mode=window_dispatch,
         commit_mode=commit_dispatch,
         errors=[None if g is None else g[1] for g in got], launches=launches,
         wall_s=wall, oracle_lanes=len(items), oracle_equal=True)
    return launches, items, per_commit[0], want_v, (chain_id, vals, jobs, expected)


# --- phase 7: dispatch (scheduler, calibrated routing, host plane) -----------


def ticket_wall(sched, lanes, priority, dev, want):
    """Submit one ticket, wait for it, check its verdicts; its wall."""
    t = sched.submit(lanes, priority=priority, label="smoke", device=dev)
    _, oks = t.result(timeout=120)
    check(oks == want, "ticket verdicts != host oracle")
    return t.wall()


def phase_dispatch(dev, window, window_lanes, commit_lanes, window_want, pinned_launches):
    """(a) the unforced main path: what routes the commits and windows
    take and what the calibration learns from them, (b) the device
    route and the host plane, each forced, at 150, 4,740 and 32,768
    lanes, (c) priority: one live commit behind eight queued catch-up
    windows. Every verdict against the oracle. Returns (a)'s launch
    counts."""
    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import native_verify as nv
    from cometbft_tpu_torch.crypto import parallel_verify as pv
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.types import validation as V

    chain_id, vals, jobs, expected = window
    _, bid1, h1, c1 = jobs[0]
    commit_want = window_want[: len(commit_lanes)]
    reps = DISPATCH_REPS
    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)
    try:
        # (a) unforced, from the seeds, through the entry points
        batch.calibration = batch._Calibration()
        seeds = batch.calibration.snapshot()
        routes = []
        kernels.reset_counts()
        for _ in range(reps):
            t0 = time.perf_counter()
            V.verify_commit(chain_id, vals, bid1, h1, c1, priority=V.PRIORITY_LIVE, device=dev)
            routes.append({"lanes": len(commit_lanes), "route": batch.LAST_ROUTE["path"],
                           "wall_s": time.perf_counter() - t0})
            t0 = time.perf_counter()
            errs = V.verify_commits_coalesced(chain_id, jobs, light=False,
                                              priority=V.PRIORITY_CATCHUP, device=dev)
            routes.append({"lanes": len(window_lanes), "route": batch.LAST_ROUTE["path"],
                           "wall_s": time.perf_counter() - t0})
            got = [None if e is None else (type(e), str(e)) for e in errs]
            check(got == expected, f"unforced window errors {got} != {expected}")
        launches = dict(kernels.LAUNCHES)
        windows = [r for r in routes if r["lanes"] == len(window_lanes)]
        check(all(r["route"] == "device" for r in windows),
              f"an unforced window left the device route: {windows}")
        check(all(v > 0 for v in launches.values()),
              f"a kernel never launched on the unforced main path: {launches}")
        learned = batch.calibration.snapshot()

        # (b) both routes, forced, at each width
        widths = []
        for n in DISPATCH_WIDTHS:
            if n == len(commit_lanes):
                lanes, want = commit_lanes, commit_want
            else:
                k = -(-n // len(window_lanes))
                lanes, want = (window_lanes * k)[:n], (window_want * k)[:n]
            row = {"lanes": n, "picked": "device" if batch.calibration.device_wins(n) else "host"}
            for route, fl in (("device", 1), ("host", 1 << 30)):
                batch.set_min_device_batch(fl)
                walls = [ticket_wall(sched, lanes, S.PRIORITY_CATCHUP, dev, want) for _ in range(reps)]
                row[route] = {"wall_s": statistics.median(walls), "walls_s": walls}
            batch.set_min_device_batch(floor)
            widths.append(row)
        dev_pts = [(r["lanes"], r["device"]["wall_s"]) for r in widths]
        mx = statistics.fmean(n for n, _ in dev_pts)
        my = statistics.fmean(w for _, w in dev_pts)
        slope = (sum((n - mx) * (w - my) for n, w in dev_pts)
                 / sum((n - mx) ** 2 for n, _ in dev_pts))
        fit = {"lane_s": slope, "flat_s": my - slope * mx,
               "host_s": widths[-1]["host"]["wall_s"] / widths[-1]["lanes"]}

        # (c) priority: eight catch-up windows queued, then a live commit
        before = sched.stats()
        t0 = time.perf_counter()
        catchup = [sched.submit(window_lanes, priority=S.PRIORITY_CATCHUP, label="catchup",
                                device=dev) for _ in range(PRIORITY_WINDOWS)]
        live = sched.submit(commit_lanes, priority=S.PRIORITY_LIVE, label="live", device=dev)
        check(live.result(timeout=120)[1] == commit_want, "live verdicts != host oracle")
        for t in catchup:
            check(t.result(timeout=300)[1] == window_want, "catch-up verdicts != host oracle")
        drain = max(t.t_done for t in catchup) - t0
        after = sched.stats()
        prio = {k: after[k] - before[k]
                for k in ("promoted", "device_dispatches", "host_chunks", "degraded")}
        prio.update(live_wall_s=live.wall(), catchup_drain_s=drain,
                    live_before_last_catchup=live.t_done < max(t.t_done for t in catchup),
                    windows=PRIORITY_WINDOWS)
        check(prio["degraded"] == 0 and sched.degraded == 0, f"degraded tickets: {prio}")
        check(prio["live_before_last_catchup"], "the live ticket resolved after every catch-up")
    finally:
        batch.set_min_device_batch(floor)
        S.set_scheduler(None)
    emit("dispatch", seeds=seeds, learned=learned, unforced=routes, widths=widths,
         fit=fit, host_plane={**pv.engine().stats(), "native": nv.module() is not None},
         priority=prio, scheduler=sched.stats(), launches=launches,
         pinned_launches=pinned_launches, oracle_equal=True)
    return launches


# --- phase 8: replay -----------------------------------------------------------


def _state_row(st) -> tuple:
    return (st.app_hash, st.last_results_hash, st.validators.hash(),
            st.next_validators.hash(), st.last_block_id.key())


def _record_states(node, rows: dict, stamp: dict | None = None) -> None:
    """rows[h] = the state after block h, as the executor produces it;
    stamp["last"] = the clock when the last block was applied."""
    real = node.block_exec.apply_verified_block

    def wrapped(state, bid, block):
        st = real(state, bid, block)
        rows[st.last_block_height] = _state_row(st)
        if stamp is not None:
            stamp["last"] = time.perf_counter()
        return st

    node.block_exec.apply_verified_block = wrapped


def _forging_peer(node, bad_height):
    """A peer whose block at ``bad_height`` carries its last commit with
    one signature corrupted, among the first 100 lanes. It serves
    bad_height - 1 too, honestly: the failed commit then names this
    peer alone, as the sender of both blocks."""
    import dataclasses

    from cometbft_tpu_torch.utils.chaingen import StorePeerClient

    class ForgingPeerClient(StorePeerClient):
        async def request_block(self, height):
            blk = await super().request_block(height)
            if blk is not None and height == bad_height:
                lc = blk.last_commit
                i = min(17, len(lc.signatures) // 2)  # a lane the light check reads
                sig = bytearray(lc.signatures[i].signature)
                sig[5] ^= 0x40
                lc.signatures[i] = dataclasses.replace(lc.signatures[i], signature=bytes(sig))
                lc._hash = None
                for o in (blk, lc):
                    if hasattr(o, "_raw_bytes"):
                        del o._raw_bytes
            return blk

    return ForgingPeerClient(node)


def replay(gen, src, dev, top, bad_peers=False):
    """Replay ``src`` up to ``top`` into a fresh node on ``dev`` through
    a BlockSyncReactor; with ``bad_peers`` a tampering and a forging
    peer fill the pool with their bad heights before the honest peer
    joins. Returns (node, reactor, rows, redos, spans, dispatches,
    tickets, wall, to_last_apply, kept): ``tickets`` is (lanes, route,
    submit-to-resolve wall) for each verify ticket, in submission
    order; ``wall`` runs from the honest peer's arrival to the caught-up
    signal (polled every second), ``to_last_apply`` to the last applied
    block; ``kept`` maps each dispatch width to the kernel items of its
    first dispatch."""
    import asyncio
    from collections import defaultdict

    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.node.inprocess import build_node
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.trace import Tracer
    from cometbft_tpu_torch.utils.chaingen import StorePeerClient, TamperingPeerClient

    fresh = build_node(gen, device=dev)
    rows: dict = {}
    stamp: dict = {}
    _record_states(fresh, rows, stamp)
    spans = defaultdict(lambda: [0, 0.0])

    def observe(name, dur_ns, args):
        spans[name][0] += 1
        spans[name][1] += dur_ns / 1e6

    tracer = Tracer(name="replay")
    tracer.add_observer(observe)
    dispatches = []
    kept: dict = {}
    real_async = ed.verify_batch_async

    def recording(items, device=None, precomp=None):
        h = real_async(items, device=device, precomp=precomp)
        dispatches.append(h.dispatch)
        kept.setdefault(len(items), list(items))
        return h

    # one dispatcher thread routes the catch-up class in submission
    # order, so the i-th routing decision is the i-th ticket's
    sched = S.scheduler()
    submitted, routes = [], []
    real_submit, real_route = sched.submit, batch.route_to_device

    def submit(items, **kw):
        t = real_submit(items, **kw)
        submitted.append(t)
        return t

    def route(n, device):
        r = real_route(n, device)
        routes.append("device" if r else "host")
        return r

    async def main():
        caught = asyncio.Event()
        reactor = BlockSyncReactor(fresh.state, fresh.block_exec, fresh.block_store,
                                   on_caught_up=lambda st: caught.set(), device=dev)
        reactor.tracer = tracer
        pool = reactor.pool
        redos = []
        real_redo = pool.redo_request

        def redo(height, ban_peer):
            redos.append((height, ban_peer))
            real_redo(height, ban_peer)

        pool.redo_request = redo
        loop = asyncio.get_running_loop()
        if bad_peers:
            pool.set_peer_range("tamper", TamperingPeerClient(src, TAMPER_AT), TAMPER_AT, TAMPER_AT)
            pool.set_peer_range("forge", _forging_peer(src, FORGE_AT), FORGE_AT - 1, FORGE_AT)
            deadline = loop.time() + 60
            while not {TAMPER_AT, FORGE_AT - 1, FORGE_AT} <= set(pool.blocks):
                check(loop.time() < deadline, "bad peers never served their heights")
                await asyncio.sleep(0.01)
        t0 = time.perf_counter()
        pool.set_peer_range("good", StorePeerClient(src), 1, top)
        await reactor.start()
        try:
            await asyncio.wait_for(caught.wait(), REPLAY_DEADLINE_S)
        finally:
            await reactor.stop()
        return reactor, redos, t0, time.perf_counter() - t0

    ed.verify_batch_async, sched.submit, batch.route_to_device = recording, submit, route
    try:
        reactor, redos, t0, wall = asyncio.run(main())
        # the stopped reactor's lookahead may still be queued: let it
        # resolve here, so its dispatch counts in this replay
        check(sched.drain(60), "the verify scheduler did not drain")
    finally:
        ed.verify_batch_async, batch.route_to_device = real_async, real_route
        del sched.submit
    tickets = [(len(t.items), r, t.wall()) for t, r in zip(submitted, routes)]
    return (fresh, reactor, rows, redos, {k: v for k, v in spans.items()}, dispatches,
            tickets, wall, stamp["last"] - t0, kept)


def ticket_walls(tickets) -> dict:
    """Per route: tickets, lanes, median and max submit-to-resolve wall."""
    out = {}
    for route in ("device", "host"):
        ws = [(n, w) for n, r, w in tickets if r == route]
        if ws:
            out[route] = {"tickets": len(ws), "lanes": [n for n, _ in ws],
                          "median_wall_s": statistics.median(w for _, w in ws),
                          "max_wall_s": max(w for _, w in ws)}
    return out


def phase_replay(dev):
    """The replay: corpus, the replay on the card, the same unforced,
    refusals on the card and on the host route. Returns the pinned
    replay's launch counts and the kernel items of two of its
    dispatches (the widest and the narrowest)."""
    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.blocksync.reactor import VERIFY_WINDOW
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
    from cometbft_tpu_torch.utils.chaingen import make_chain

    t0 = time.perf_counter()
    gen, privs = make_genesis(REPLAY_VALS, chain_id="smoke-replay", seed=SEED)
    src = build_node(gen, device=dev)
    src_rows: dict = {}
    _record_states(src, src_rows)
    make_chain(gen, privs, REPLAY_BLOCKS, node=src)
    emit("replay_corpus", validators=REPLAY_VALS, blocks=REPLAY_BLOCKS, txs_per_block=1,
         seconds=time.perf_counter() - t0)
    top = src.block_store.height()

    def same_as_source(fresh, rows, upto, what):
        check(fresh.block_store.height() >= upto, f"{what}: store at {fresh.block_store.height()}")
        check(sorted(rows) == list(range(1, max(rows) + 1)) and max(rows) >= upto,
              f"{what}: applied heights")
        bad = [h for h in rows if rows[h] != src_rows[h]]
        check(not bad, f"{what}: state differs from the source at heights {bad[:5]}")
        bad = [h for h in range(1, fresh.block_store.height() + 1)
               if fresh.block_store.load_block_meta(h).block_id != src.block_store.load_block_meta(h).block_id]
        check(not bad, f"{what}: block IDs differ at heights {bad[:5]}")

    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)
    try:
        # 8b: the replay on the card, the device route pinned by the
        # floor at 1 as in phase 4. Unforced, the calibration samples
        # the device route's wall as the JAX package does, and under the
        # apply loop that wall is mostly the dispatcher waiting for the
        # interpreter lock: 8c shows where it routes the same replay
        batch.set_min_device_batch(1)
        kernels.reset_counts()
        (fresh, reactor, rows, redos, spans, dispatches, tickets, wall, applied_s,
         kept) = replay(gen, src, dev, top)
        launches = dict(kernels.LAUNCHES)
        stats = sched.stats()
        windows = spans["blocksync.window.verify_wait"][0]
        applied = reactor.blocks_applied
        lanes = sum(d["lanes"] for d in dispatches)
        emit("replay", validators=REPLAY_VALS, blocks=top, applied=applied,
             store_height=fresh.block_store.height(), window=VERIFY_WINDOW, windows=windows,
             route="device (pinned)", to_last_apply_s=applied_s,
             blocks_per_s=applied / applied_s, signatures_per_s=lanes / applied_s,
             wall_s=wall, blocks_per_s_to_caught_up=applied / wall,
             lanes=lanes, pipeline_stats=reactor.pipeline_stats, scheduler=stats,
             launches=launches, dispatch_lanes=[d["lanes"] for d in dispatches],
             pack_ms=[round(d["pack_ms"], 3) for d in dispatches],
             ticket_walls=ticket_walls(tickets),
             spans_ms={k: v[1] for k, v in spans.items()},
             span_counts={k: v[0] for k, v in spans.items()},
             loop_errors=reactor.loop_errors.count)
        check(reactor.loop_errors.count == 0, f"the pool routine caught {reactor.loop_errors!r}")
        same_as_source(fresh, rows, top - 2, "replay")
        check(redos == [], f"honest replay refetched {redos}")
        check(stats["host_chunks"] == 0 and stats["degraded"] == 0 and sched.degraded == 0,
              f"a window left the device route: {stats}")
        check(len(dispatches) == stats["device_dispatches"] >= windows > 0,
              f"{len(dispatches)} dispatches, {windows} windows: {stats}")
        check(all(d["device"] == str(dev) and all(d["launches"][k] >= 1 for k in SOURCES)
                  for d in dispatches), "a window's dispatch skipped a kernel")
        check(all(launches[k] == sum(d["launches"][k] for d in dispatches) for k in SOURCES),
              f"launches {launches} outside the window dispatches")

        # 8c: the same replay unforced, routed by the calibration from
        # its seeds; reported, and held to the same states
        batch.set_min_device_batch(floor)
        batch.calibration = batch._Calibration()
        before = sched.stats()
        (fresh, reactor, rows, redos, spans, dispatches, tickets, wall, applied_s,
         _) = replay(gen, src, dev, top)
        after = sched.stats()
        moved = {k: after[k] - before[k] for k in ("tickets", "device_dispatches", "host_chunks",
                                                    "degraded")}
        emit("replay_unforced", applied=reactor.blocks_applied, to_last_apply_s=applied_s,
             blocks_per_s=reactor.blocks_applied / applied_s, wall_s=wall, routes=moved,
             ticket_routes="".join("d" if r == "device" else "h" for _, r, _ in tickets),
             ticket_lanes=[n for n, _, _ in tickets], learned=batch.calibration.snapshot(),
             ticket_walls=ticket_walls(tickets),
             spans_ms={k: v[1] for k, v in spans.items()},
             loop_errors=reactor.loop_errors.count)
        check(reactor.loop_errors.count == 0, f"unforced: the pool routine caught {reactor.loop_errors!r}")
        same_as_source(fresh, rows, top - 2, "unforced replay")
        check(redos == [] and moved["degraded"] == 0, f"unforced: redos {redos}, {moved}")

        # 8d: refusals with the device route pinned, 8e: the same with
        # the host route forced
        runs = {}
        for route, fl in (("device", 1), ("host", 1 << 30)):
            batch.set_min_device_batch(fl)
            before = sched.stats()
            fresh, reactor, rows, redos, spans, dispatches, tickets, wall, _, _ = replay(
                gen, src, dev, REFUSAL_BLOCKS, bad_peers=True)
            after = sched.stats()
            check(reactor.loop_errors.count == 0, f"{route}: the pool routine caught {reactor.loop_errors!r}")
            same_as_source(fresh, rows, REFUSAL_BLOCKS - 2, f"refusals ({route})")
            check(redos == [(TAMPER_AT, "tamper"), (FORGE_AT - 1, "forge")], f"{route}: redos {redos}")
            check(sorted(reactor.pool.banned_peers()) == ["forge", "tamper"],
                  f"{route}: banned {reactor.pool.banned_peers()}")
            for h in (TAMPER_AT, FORGE_AT):
                check(fresh.block_store.load_block(h).encode() == src.block_store.load_block(h).encode(),
                      f"{route}: stored block {h} is not the honest one")
            moved = {k: after[k] - before[k] for k in ("device_dispatches", "host_chunks", "degraded")}
            check(moved["degraded"] == 0, f"{route}: degraded {moved}")
            if route == "device":
                check(moved["host_chunks"] == 0 and moved["device_dispatches"] > 0, f"device: {moved}")
            else:
                check(moved["device_dispatches"] == 0 and moved["host_chunks"] > 0, f"host: {moved}")
            runs[route] = {"redos": redos, "rows": rows, "wall_s": wall, "routes": moved,
                           "ticket_walls": ticket_walls(tickets),
                           "pipeline_stats": reactor.pipeline_stats}
        check(runs["device"]["redos"] == runs["host"]["redos"],
              f"refetches differ: {runs['device']['redos']} vs {runs['host']['redos']}")
        # the caught-up check runs between windows, so a run may stop one
        # height short of the other: compare the heights both applied
        dev_rows, host_rows = runs["device"]["rows"], runs["host"]["rows"]
        common = sorted(set(dev_rows) & set(host_rows))
        check(len(common) >= REFUSAL_BLOCKS - 2 and all(dev_rows[h] == host_rows[h] for h in common),
              "host and device states differ")
        emit("replay_refusals", blocks=REFUSAL_BLOCKS, tamper_at=TAMPER_AT, forge_at=FORGE_AT,
             **{route: {k: v for k, v in r.items() if k != "rows"} for route, r in runs.items()},
             host_equals_device=True)
    finally:
        batch.set_min_device_batch(floor)
        S.set_scheduler(None)
        sched.close()
    # the kernel items of the widest window dispatch and of the narrowest
    # (the one-height tail), for phase 6
    return launches, {n: kept[n] for n in {max(kept), min(kept)}}


# --- phase 9: light bisection ----------------------------------------------------


def bisect_keys():
    """The bench's keys: 150 from default_rng(7), then the rotation
    pool from default_rng(99)."""
    import numpy as np

    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey

    rng = np.random.default_rng(7)
    keys = [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(BISECT_VALS)]
    rng = np.random.default_rng(99)
    n = (BISECT_TARGET // BISECT_EPOCH + 2) * BISECT_SHIFT
    return keys + [Ed25519PrivKey.from_seed(rng.bytes(32)) for _ in range(n)]


def bisect(dev, keys, t0_ns, forge_at=(), fork=False):
    """One run of config 4: trust height 1, verify the target through
    the port's light Client on ``dev``. Returns what it did: fetched
    heights, hops, the verify tickets (label, lanes, route, wall), the
    kernel items of the first dispatch of each width, the cache size,
    the trusted hash or the error and the height of the last block a
    hop checked, and the walls with and without fetching and signing."""
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.light import Client, TrustOptions, verifier
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.utils.chaingen import RotatingLightProvider

    fetch = {"s": 0.0}

    class Timed(RotatingLightProvider):
        def light_block(self, height):
            t = time.perf_counter()
            lb = super().light_block(height)
            fetch["s"] += time.perf_counter() - t
            return lb

    def provider(**kw):
        return Timed("bench-chain", keys, BISECT_VALS, BISECT_EPOCH, BISECT_SHIFT, t0_ns, **kw)

    primary = provider(forge_at=forge_at)
    witnesses = [provider(app_hash=b"\x0f" * 32)] if fork else []
    sched = S.scheduler()
    submitted, routes, kept, checked = [], [], {}, []
    real_submit, real_route, real_async = sched.submit, batch.route_to_device, ed.verify_batch_async
    hops = {name: getattr(verifier, name) for name in ("verify_adjacent", "verify_non_adjacent")}

    def submit(items, **kw):
        t = real_submit(items, **kw)
        submitted.append(t)
        return t

    def route(n, device):
        r = real_route(n, device)
        routes.append("device" if r else "host")
        return r

    def recording(items, device=None, precomp=None):
        kept.setdefault(len(items), list(items))
        return real_async(items, device=device, precomp=precomp)

    def hop(fn, untrusted_at):
        def checked_hop(*args, **kw):
            checked.append(args[untrusted_at].height)
            return fn(*args, **kw)
        return checked_hop

    out = {"error": None}
    sched.submit, batch.route_to_device, ed.verify_batch_async = submit, route, recording
    verifier.verify_adjacent = hop(hops["verify_adjacent"], 2)
    verifier.verify_non_adjacent = hop(hops["verify_non_adjacent"], 3)
    try:
        root = primary.light_block(1)
        t0 = time.perf_counter()
        fetch["s"] = 0.0
        client = Client("bench-chain", TrustOptions(10 * 365 * 86400 * 10**9, 1, root.hash()),
                        primary, witnesses=witnesses, device=dev)
        try:
            out["hash"] = client.verify_light_block_at_height(BISECT_TARGET).hash().hex()
        except Exception as e:  # the refusal runs: which error, where
            out["error"] = e
        wall = time.perf_counter() - t0
        check(sched.drain(60), "the verify scheduler did not drain")
    finally:
        ed.verify_batch_async, batch.route_to_device = real_async, real_route
        del sched.submit
        for name, fn in hops.items():
            setattr(verifier, name, fn)
    out.update(
        fetched=list(primary.fetched), hops=client.hops, cache=len(client.cache),
        at=checked[-1] if checked else None, client=client, kept=kept,
        tickets=[(t.label, len(t.items), r, t.wall()) for t, r in zip(submitted, routes)],
        wall_s=wall, fetch_s=fetch["s"], verify_s=wall - fetch["s"],
    )
    return out


def phase_bisect(dev):
    """Config 4 on the card with the device route pinned (9a), unforced
    (9b) and host-forced (9c), each against the JAX package's counts;
    refusals on the card and host-forced (9d). Returns the pinned run's
    launch counts and the kernel items of its widest and narrowest
    dispatches."""
    import dataclasses

    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.light.detector import DivergenceError

    keys = bisect_keys()
    # the target header 2 minutes in the past: the verifier refuses
    # headers from the future
    t0_ns = time.time_ns() - (BISECT_TARGET + 120) * 1_000_000_000
    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)

    def summary(r):
        return {"fetched": r["fetched"], "hops": r["hops"], "cache": r["cache"],
                "hash": r.get("hash"),
                "dispatches": [(label, n) for label, n, _, _ in r["tickets"]]}

    def held_to_reference(r, what):
        check(r["error"] is None, f"{what}: {r['error']!r}")
        check(r["fetched"] == BISECT_FETCHED, f"{what}: fetched {r['fetched']}")
        check(r["hops"] == BISECT_HOPS and r["cache"] == BISECT_CACHE,
              f"{what}: hops {r['hops']}, cache {r['cache']}")
        widths = [n for _, n, _, _ in r["tickets"]]
        check(len(widths) == BISECT_DISPATCHES and min(widths) == 30 and max(widths) == 101
              and {label for label, _, _, _ in r["tickets"]} == {"light", "trusting"},
              f"{what}: dispatches {[(label, n) for label, n, _, _ in r['tickets']]}")

    def line(r):
        return {"fetched": r["fetched"], "hops": r["hops"], "cache": r["cache"],
                "trusted_hash": r.get("hash"),
                "dispatches": [f"{label}:{n}" for label, n, _, _ in r["tickets"]],
                "wall_s": r["wall_s"], "fetch_s": r["fetch_s"], "verify_s": r["verify_s"],
                "ticket_walls": ticket_walls([(n, rt, w) for _, n, rt, w in r["tickets"]])}

    try:
        # 9a: on the card, the device route pinned
        batch.set_min_device_batch(1)
        before = sched.stats()
        kernels.reset_counts()
        pinned = bisect(dev, keys, t0_ns)
        launches = dict(kernels.LAUNCHES)
        after = sched.stats()
        moved = {k: after[k] - before[k] for k in ("device_dispatches", "host_chunks", "degraded")}
        held_to_reference(pinned, "pinned")
        check(moved == {"device_dispatches": BISECT_DISPATCHES, "host_chunks": 0, "degraded": 0},
              f"pinned: a ticket left the device route: {moved}")
        check(all(launches[k] == BISECT_DISPATCHES for k in SOURCES),
              f"pinned: launches {launches}, want {BISECT_DISPATCHES} of each")
        emit("bisect", target=BISECT_TARGET, validators=BISECT_VALS, epoch=BISECT_EPOCH,
             shift=BISECT_SHIFT, route="device (pinned)", launches=launches, scheduler=moved,
             **line(pinned))

        # 9b: the same, unforced, routed by the calibration from its seeds
        batch.set_min_device_batch(floor)
        batch.calibration = batch._Calibration()
        unforced = bisect(dev, keys, t0_ns)
        held_to_reference(unforced, "unforced")
        check(summary(unforced) == summary(pinned), "unforced != pinned")
        emit("bisect_unforced",
             ticket_routes="".join("d" if rt == "device" else "h" for _, _, rt, _ in unforced["tickets"]),
             learned=batch.calibration.snapshot(), **line(unforced))

        # 9c: host route forced
        batch.set_min_device_batch(1 << 30)
        host = bisect(dev, keys, t0_ns)
        held_to_reference(host, "host")
        check(summary(host) == summary(pinned), "host-forced != pinned")
        check(all(rt == "host" for _, _, rt, _ in host["tickets"]), "host-forced: a device route")
        emit("bisect_host", route="host (forced)", **line(host))

        # 9d: refusals, on the card and host-forced
        runs = {}
        for route, fl in (("device", 1), ("host", 1 << 30)):
            batch.set_min_device_batch(fl)
            row = {}
            for case, kw in (("forge_pivot", {"forge_at": (BISECT_FORGE_PIVOT,)}),
                             ("forge_target", {"forge_at": (BISECT_TARGET,)}),
                             ("fork_witness", {"fork": True})):
                r = bisect(dev, keys, t0_ns, **kw)
                e = r["error"]
                got = {"error": type(e).__name__, "message": str(e), "at": r["at"],
                       "fetched": r["fetched"], "wall_s": r["wall_s"],
                       "routes": "".join(rt[0] for _, _, rt, _ in r["tickets"])}
                if isinstance(e, DivergenceError):
                    ev = e.evidence
                    got.update(common_height=ev.common_height,
                               byzantine=len(ev.byzantine_validators),
                               evidence_hash=dataclasses.replace(ev, timestamp_ns=0).hash().hex(),
                               witnesses_left=len(r["client"].witnesses))
                row[case] = got
            runs[route] = row
        for case, want, at in (("forge_pivot", "ErrInvalidSignature", BISECT_FORGE_PIVOT),
                               ("forge_target", "ErrInvalidSignature", BISECT_TARGET),
                               ("fork_witness", "DivergenceError", BISECT_TARGET)):
            d, h = runs["device"][case], runs["host"][case]
            check(d["error"] == h["error"] == want and d["at"] == h["at"] == at,
                  f"{case}: device {d['error']} at {d['at']}, host {h['error']} at {h['at']}")
            check({k: d[k] for k in d if k not in ("wall_s", "routes")}
                  == {k: h[k] for k in h if k not in ("wall_s", "routes")},
                  f"{case}: device and host runs differ")
            check(set(d["routes"]) == {"d"} and set(h["routes"]) == {"h"}, f"{case}: routes")
        check(runs["device"]["fork_witness"]["witnesses_left"] == 0, "the diverging witness stayed")
        emit("bisect_refusals", **runs, host_equals_device=True)
    finally:
        batch.set_min_device_batch(floor)
        S.set_scheduler(None)
        sched.close()
    kept = pinned["kept"]
    return launches, {n: kept[n] for n in {max(kept), min(kept)}}


# --- timing and bounds --------------------------------------------------------


def kernel_inputs(items, dev, precomp=False):
    import torch

    from cometbft_tpu_torch.ops import ed25519 as ed

    n = len(items)
    msgs, lens, pr, ss, a_arr, bad = ed.pack(items, precomp)
    to = lambda a: torch.from_numpy(a.T.copy()).to(dev)  # noqa: E731
    a_t = None if a_arr is None else to(a_arr.reshape(n, -1)).view(4, 10, n)
    return {"msgs": to(msgs), "lens": torch.from_numpy(lens).to(dev),
            "pr": to(pr), "ss": to(ss), "a": a_t, "bad": bad, "n": n}


def stage_calls(x):
    """Per-kernel closures (kernel, plain) on prepared inputs (plain
    mode); "straus" is K1's bare entry on the same digits and keys."""
    from cometbft_tpu_torch.ops import curve25519 as cv
    from cometbft_tpu_torch.ops import ladder as ld
    from cometbft_tpu_torch.ops import sc25519 as sc

    n = x["n"]
    hd_args = (x["msgs"], x["lens"], x["pr"][:, :n], x["pr"][:, n:], x["ss"])
    ds, dh, oks = sc.hash_digits(*hd_args)
    pt, ok = cv.decompress(x["pr"])
    v_args = (ds, dh, pt[..., :n], pt[..., n:], ok[:n], ok[n:], oks)
    return {
        "hash_digits": (lambda: sc.hash_digits(*hd_args), lambda: sc.hash_digits_plain(*hd_args)),
        "decompress": (lambda: cv.decompress(x["pr"]), lambda: cv.decompress_plain(x["pr"])),
        "ladder": (lambda: ld.verify(*v_args), lambda: ld.verify_plain(*v_args)),
        "straus": (lambda: ld.straus(ds, dh, pt[..., :n]),
                   lambda: ld.straus_plain(ds, dh, pt[..., :n])),
    }


def fe_products(name) -> int:
    ops = FE_OPS[name]
    return sum(ops[k] * PRODUCTS[k] for k in PRODUCTS)


def bound(name, x, int_rate):
    """(bound_ms, bound_by) for one kernel on these inputs."""
    n = x["n"]
    if name == "ladder":
        nbytes = n * (64 + 64 + 160 + 160 + 3 + 1)
        ops = n * fe_products("ladder")
    elif name == "decompress":
        lanes = 2 * n
        nbytes = lanes * (32 + 160 + 1)
        ops = lanes * fe_products("decompress")
    else:
        cap = x["msgs"].shape[0]
        lens = x["lens"].cpu().numpy().astype(int).clip(max=cap)
        blocks = int(((64 + lens + 16) // 128 + 1).sum())
        nbytes = x["msgs"].numel() + n * (4 + 96 + 129)
        ops = blocks * SHA_OPS_PER_BLOCK + n * SC_OPS
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = ops / int_rate * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def occupancy(name) -> dict:
    """Block size, registers, shared memory and resident warps per SM
    of K1 (fused entry), K2 or K3, as the CUDA runtime reports them."""
    import ctypes

    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.ops import ladder as ld

    info = (ctypes.c_int * 6)()
    if name == "ladder":
        rc = kernels.load("ladder", ld._init).ladder_info(1, ctypes.addressof(info))
    else:
        rc = getattr(kernels.load(name), f"{name}_info")(ctypes.addressof(info))
    kernels.check(rc, f"{name} info")
    threads = info[5]
    return {"threads": threads, "registers": info[0], "smem_bytes": info[1] + info[2],
            "stack_bytes": info[3], "blocks_per_sm": info[4],
            "warps_per_sm": info[4] * threads // 32}


# --- phase 5: bulk --------------------------------------------------------------


def phase_bulk(dev, rng):
    import torch

    from cometbft_tpu_torch.crypto import ref_ed25519 as ref
    from cometbft_tpu_torch.ops import ed25519 as ed

    distinct = signed_items(rng, N_DISTINCT)
    bad_idx = set(int(i) for i in rng.choice(N_DISTINCT, N_DISTINCT // 100, replace=False))
    for i in bad_idx:
        m, pk, sig = distinct[i]
        distinct[i] = (m + b"!", pk, sig) if i % 2 else (m, pk, sig[:33] + bytes([sig[33] ^ 8]) + sig[34:])
    want_d = [i not in bad_idx for i in range(N_DISTINCT)]
    check(all(ref.verify_zip215(distinct[i][1], distinct[i][0], distinct[i][2]) == want_d[i]
              for i in list(bad_idx)[:8]), "oracle disagrees on corrupted items")
    items = [distinct[i % N_DISTINCT] for i in range(N_BULK)]
    want = [want_d[i % N_DISTINCT] for i in range(N_BULK)]

    t0 = time.perf_counter()
    got = ed.verify_batch(items, device=dev)
    e2e_s = time.perf_counter() - t0
    dispatch = dict(ed.LAST_DISPATCH)
    check(list(map(bool, got)) == want, "bulk verdicts wrong")
    check(all(v == 1 for v in dispatch["launches"].values()), f"bulk launches {dispatch}")

    x = kernel_inputs(items, dev)
    from cometbft_tpu_torch.ops.ed25519 import verify_lanes

    run = lambda: verify_lanes(x["msgs"], x["lens"], x["pr"], x["ss"])  # noqa: E731
    run()
    torch.cuda.reset_peak_memory_stats(dev)
    dev_ms = median_ms(run, 5)
    peak = torch.cuda.max_memory_allocated(dev)
    calls = stage_calls(x)
    t0 = time.perf_counter()
    errs = compare(calls)
    compare_s = time.perf_counter() - t0
    # device time of calls replayed from a CUDA graph: a single call
    # from Python also counts the wrapper's host overhead, which at this
    # width is of the order of K3's own time
    per_kernel = {k: graph_ms(f, 5) for k, (f, _) in calls.items()}
    per_call = {k: median_ms(f, 5) for k, (f, _) in calls.items()}
    emit("bulk", lanes=N_BULK, distinct=N_DISTINCT, corrupted=len(bad_idx),
         verdicts_ok=True, device_ms_median=dev_ms, verifies_per_s=N_BULK / dev_ms * 1e3,
         end_to_end_s=e2e_s, end_to_end_verifies_per_s=N_BULK / e2e_s,
         pack_ms=dispatch["pack_ms"], mode="precomp" if dispatch["precomp"] else "plain",
         kernel_ms=per_kernel, kernel_call_ms=per_call, launches=dispatch["launches"],
         peak_mem_bytes=peak,
         plain_equal=True, max_abs_err=errs, compare_s=compare_s)

    # plain/precomp crossover: device time plus host packing, per width
    rows = []
    for w in CROSSOVER_WIDTHS:
        row = {"lanes": w}
        for mode in ("plain", "precomp"):
            pc = mode == "precomp"
            t0 = time.perf_counter()
            ed.pack(items[:w], pc)
            pack_ms = (time.perf_counter() - t0) * 1e3
            xi = kernel_inputs(items[:w], dev, precomp=pc)
            f = lambda: verify_lanes(xi["msgs"], xi["lens"], xi["pr"], xi["ss"], xi["a"])  # noqa: E731
            f()
            row[mode] = {"device_ms": median_ms(f, 3), "pack_ms": pack_ms}
        rows.append(row)
    emit("crossover", rows=rows)
    return per_kernel, per_call, x, errs


def main(argv) -> int:
    quick = "--quick" in argv
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cometbft_tpu_torch import kernels

    dev = torch.device("cuda", 0)
    card = smi("name,power.limit")
    int_rate, rate_from = int_ops_s()
    emit("card", nvidia_smi=card, torch=torch.__version__, cuda=torch.version.cuda,
         int_rate=rate_from)

    t0 = time.perf_counter()
    info = kernels.build_all(force=True)
    seconds = time.perf_counter() - t0
    for name in info:
        info[name]["sass"] = kernels.sass(name)
    emit("build", seconds=seconds, kernels=info)

    rng = np.random.default_rng(SEED)
    checks = phase_kernels(dev, rng, 500 if quick else N_CHECK)
    ragged = phase_kernels(dev, rng, 501 if quick else N_RAGGED)
    torch.cuda.synchronize()
    for name, r in ragged.items():
        checks[name]["ragged"] = r
    emit("kernel_vs_plain", **checks)
    if quick:
        print(card)
        print(json.dumps({"quick": True}))
        return 0

    pinned, window_lanes, commit_lanes, window_want, window = phase_main(dev, rng)
    as_bytes = lambda its: [(m, pk.key_bytes, s) for m, pk, s in its]  # noqa: E731
    window_items, commit_items = as_bytes(window_lanes), as_bytes(commit_lanes)
    bulk_ms, bulk_call_ms, x_bulk, bulk_errs = phase_bulk(dev, rng)
    # the scheduler takes (pubkey, msg, sig) lanes
    swap = lambda its: [(pk, m, s) for m, pk, s in its]  # noqa: E731
    launches = phase_dispatch(dev, window, swap(window_lanes), swap(commit_lanes), window_want,
                              pinned)
    replay_launches, replay_items = phase_replay(dev)
    bisect_launches, bisect_items = phase_bisect(dev)

    # phase 6: each kernel against its plain version on the main paths'
    # own inputs (the window's lanes and the commit's; the replay's and
    # the bisection's widest and narrowest dispatches), timed at the
    # window, at the replay's widest and at the bisection's widest
    x = kernel_inputs(window_items, dev)
    calls = stage_calls(x)
    errs = compare(calls)
    x_commit = kernel_inputs(commit_items, dev)
    commit_calls = stage_calls(x_commit)
    commit_errs = compare(commit_calls)
    x_replay = {n: kernel_inputs(its, dev) for n, its in sorted(replay_items.items())}
    replay_calls = {n: stage_calls(xr) for n, xr in x_replay.items()}
    replay_errs = {n: compare(c) for n, c in replay_calls.items()}
    n_wide = max(x_replay)
    x_bisect = {n: kernel_inputs(its, dev) for n, its in sorted(bisect_items.items())}
    bisect_calls = {n: stage_calls(xb) for n, xb in x_bisect.items()}
    bisect_errs = {n: compare(c) for n, c in bisect_calls.items()}
    b_wide = max(x_bisect)
    emit("main_path_vs_plain", lanes=x["n"], commit_lanes=x_commit["n"],
         replay_lanes=list(x_replay), bisect_lanes=list(x_bisect), equal=True, max_abs_err=errs,
         commit_max_abs_err=commit_errs, replay_max_abs_err=replay_errs,
         bisect_max_abs_err=bisect_errs)
    rows = []
    for name in ("ladder", "decompress", "hash_digits"):
        f, plain = calls[name]
        extra = occupancy(name)
        parts = (name, "straus") if name == "ladder" else (name,)
        replay_err = max(e[k] for e in replay_errs.values() for k in parts)
        bisect_err = max(e[k] for e in bisect_errs.values() for k in parts)
        err = max(max(errs[k], commit_errs[k]) for k in parts)
        b_ms, b_by = bound(name, x, int_rate)
        bc_ms, bc_by = bound(name, x_commit, int_rate)
        br_ms, br_by = bound(name, x_replay[n_wide], int_rate)
        bs_ms, bs_by = bound(name, x_bisect[b_wide], int_rate)
        bb_ms, bb_by = bound(name, x_bulk, int_rate)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "pinned_launches": pinned[name], "replay_launches": replay_launches[name],
            "bisect_launches": bisect_launches[name],
            "max_abs_err": max(err, replay_err, bisect_err), "tolerance": 0,
            "ms": graph_ms(f), "call_ms": cuda_ms(f, 20),
            "plain_ms": cuda_ms(plain, 2, warm=0), "bound_ms": b_ms,
            "bound_by": b_by, "library_ms": None,
            "lanes": x["n"], "commit_lanes": x_commit["n"],
            "commit_ms": graph_ms(commit_calls[name][0]),
            "commit_call_ms": cuda_ms(commit_calls[name][0], 20),
            "commit_bound_ms": bc_ms, "commit_bound_by": bc_by,
            "replay_lanes": list(x_replay), "replay_max_abs_err": replay_err,
            "replay_ms": graph_ms(replay_calls[n_wide][name][0]),
            "replay_plain_ms": cuda_ms(replay_calls[n_wide][name][1], 2, warm=0),
            "replay_bound_ms": br_ms, "replay_bound_by": br_by,
            "bisect_lanes": list(x_bisect), "bisect_max_abs_err": bisect_err,
            "bisect_ms": graph_ms(bisect_calls[b_wide][name][0]),
            "bisect_plain_ms": cuda_ms(bisect_calls[b_wide][name][1], 2, warm=0),
            "bisect_bound_ms": bs_ms, "bisect_bound_by": bs_by,
            "bulk_lanes": N_BULK, "bulk_ms": bulk_ms[name], "bulk_call_ms": bulk_call_ms[name],
            "bulk_bound_ms": bb_ms, "bulk_bound_by": bb_by,
            "bulk_max_abs_err": max(bulk_errs[k] for k in parts),
            "check": checks[name], **extra,
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
