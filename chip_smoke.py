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

10. consensus, on phase 8's corpus: (a) adaptive sync: a fresh full
   node (no signer, WAL on disk, vote_batch_window_ms 2) with its
   ConsensusState started and a BlockSyncReactor feeding it as the
   block ingestor, device route pinned; every block must enter through
   ingest_verified_block, every height's state and block ID equal the
   source's, and each window's dispatch launch K1-K3 once (counters
   zeroed just before, read just after); blocks/s and the span split
   (window prepare / verify_wait / apply and the state machine's
   finalize persist / wal / apply) beside phase 8's; (b) the handoff:
   the last blocks as CommitBlockMessages, the last one's commit a
   150-lane PRIORITY_LIVE ticket on the card, consensus at 1,026; (c)
   eight live heights played by utils.chaingen.ValidatorStubs (the
   proposer's proposal and parts, then 150 prevotes, then 150
   precommits) with skip_timeout_commit, the device route pinned: each
   height stores the stubs' block with the shadow chain's state, each
   vote wave is one 150-lane PRIORITY_LIVE ticket on the card, and the
   fourth height's forged precommit is dropped (absent from the vote
   set and the seen commit) while the height commits; per-height walls
   from the proposal's delivery to the stored block, every ticket's
   label, width, route and wall; (d) eight more heights unforced, with
   the route of each ticket. The kernels line adds ingest_launches and
   live_launches, and each kernel against its plain version on the
   first live height's prevote wave, the forged height's precommit wave
   (its forged lane included) and the handoff's commit, each found by
   its ticket's label (live_max_abs_err, one entry each), with its
   device time and bound at the prevote wave's width.

11. network, on phase 8's corpus, over TCP loopback with secret
   connections and MConnection at their default rates (the X25519 and
   AEAD tiers in use on the network line): (a) four validator Nodes on
   the card (test_config timeouts, device route pinned), each dialing
   the others; 256 txs in at one node's mempool; the net runs to height
   12; every node must store the same block at every height, every tx
   be committed exactly once, and every vote wave a node's consensus
   reactor receives go through its coalescer to the card (every
   dispatch launching each kernel once); the median height wall and
   the bytes each node sent and received; (b) a full-width join: a
   serving Node with no signer whose sqlite stores hold the corpus as
   phase 8 built it (150 validators x 1,025 blocks, copied before phase
   10 extends it), and a fresh joiner Node (no signer, blocksync and
   adaptive_sync on, device route pinned) that dials it and pulls the
   blocks through its BlockSyncNetReactor's NetPeerClient; every block
   must enter the joiner's started ConsensusState through
   ingest_verified_block, block 1,025 from the serving node's consensus
   reactor as a CommitBlock catch-up (a 150-lane PRIORITY_LIVE ticket),
   every state row and block ID equal the source's; blocks/s to the
   last ingest (beside phases 8 and 10a of the run:
   beside_blocks_per_s), bytes on the wire per block and the span
   split; (c) the serving node stopped, a StubPeer
   (utils.chaingen) dials the joiner and plays the 150 validators for
   eight heights over the wire (skip_timeout_commit; the reactor's
   default wave rule: a wave goes once all its votes are in, or a
   grace after +2/3): each prevote and precommit wave must arrive
   through ConsensusReactor.receive and be one 150-lane PRIORITY_LIVE
   ticket on the card, dispatched by the reactor's coalescer (its
   wave_log says how each closed), each height store
   the stubs' block with the shadow chain's state, and the fourth
   height's forged precommit be dropped while the height commits on
   149; per-height walls from the proposal's send to the stored block,
   beside phase 10c's median (beside_commit_wall_median_s); (d) eight more heights unforced, with the route
   of each ticket. The kernels line adds net_launches (11a / 11b / 11c)
   and each kernel against its plain version on 11c's first prevote
   wave and the forged height's precommit wave (net_max_abs_err), with
   its device time and bound at the prevote wave's width.

12. evidence, the device route pinned: (a) on a copy of phase 8's
   corpus as phase 8 built it, a node's EvidencePool over its stores
   takes light-client attacks at committed height 1,000: a fork signed
   by all 150 with the real set and a lunatic fork signed by 51 of the
   150 claiming a set of those 51, each from the height before and from
   six heights back; each must be accepted and pending, its two commit
   checks (trusting, then light) each one PRIORITY_CATCHUP ticket on
   the card launching K1-K3 once; then a fabricated header under the
   genuine commit, a common height ahead of the block, a claimed
   byzantine set or total power that differs from the derived one, and
   one forged signature among the 150 must be refused on the card and,
   with the same error, on the plain kernels; each ticket's lanes and
   wall and each add_evidence wall are printed; (b) four validator
   Nodes over TCP (11a's shape): the fourth key equivocates prevotes
   through node 0's ConsensusReactor.receive, and a lunatic fork of
   height 2 signed by two keys is handed to node 1; both pieces of
   evidence must gossip on 0x38, be checked by every node (the fork's
   two checks on the card at every node), land in blocks and reach
   every app as MISBEHAVIOR_DUPLICATE_VOTE / LIGHT_CLIENT_ATTACK with
   the offenders' powers, each app's records equal to what the blocks'
   evidence gives by evidence_to_misbehavior; heights from the
   equivocation and from the handoff to the committing block; (c) a
   fifth node (no signer, blocksync on) dials the four and must reach
   their height through the evidence blocks with the same block IDs,
   states and misbehavior records, with at least one of its own
   blocksync windows verified on the card. The kernels line adds
   evidence_launches (12a / 12b / 12c; counters zeroed just before
   each, read just after; 12c also counts the validators' consensus,
   which runs on, and 12c_joiner the joiner's own windows) and each kernel against its plain version on
   12a's widest tickets (evidence_max_abs_err), with its device time
   and bound at the trusting check's 150 lanes.

13. RPC and the light serving plane, the device route pinned: (a)
   serving_storm: config 4's chain (phase 9's keys and rotation,
   headers minted once a height) served to bench.py::bench_serve's
   storm, 1,000 sessions on 64 threads asking for 40 distinct heights
   of [25,000, 50,000) drawn by default_rng(1013): a per-request pass
   (a fresh Client for each distinct height: the reference blocks), a
   cold pass on a fresh LightServingPlane (a pool of 8 clients) and a
   warm pass on it; every served block must equal the reference's,
   every plane ticket be a PRIORITY_LIGHT ticket on the card (none
   degraded) launching each kernel once (counters zeroed just before
   the plane's passes, read just after), and the engine's verdicts
   equal serial verify_commit_light / verify_commit_light_trusting on
   a valid commit, one with a forged signature among the first 100
   lanes and ones under 2/3 and 1/3, on the card and on the plain
   kernels; sessions/s, p50 and p99 and the wall of each pass, the
   plane's coalesce and cache counters and every light ticket's lanes;
   (b) rpc_net: 11a's four validators with rpc.laddr on every node
   (kvstore with prove=True, the kv indexer), a websocket subscriber on
   NewBlock from before the first block, 256 txs over HTTP (16 by
   broadcast_tx_commit), then every tx by tx(prove) with its proof
   against the block's data hash, tx_search and block_search by
   height, status, and abci_query(prove) on 16 keys with each proof
   held against the app hash of the next header, whose commit is
   verified on the card; a light-client attack handed to node 1 by
   broadcast_evidence must reach every app within 1-3 heights; every
   tx committed once, the subscriber must see every height once, in
   order, and every ticket take the device route; (c) rpc_light: two
   Nodes serve phase 8's corpus from sqlite over RPC, a port Client
   (HTTPProvider primary and witness) behind a LightProxy over a
   LightServingPlane answers 256 concurrent /header requests over 16
   heights of [2, 1,024], then /commit, /validators, /block and /tx at
   each: every answer verified and equal to the corpus,
   /serving_status with cache hits and coalesced dispatches, every
   ticket a light one on the card. The kernels line adds
   serve_launches (13a / 13b / 13c) and each kernel against its plain
   version on 13a's widest light ticket and one of 13c's
   (serve_max_abs_err), with its device time and bound at 13a's
   widest.

14. statesync, the device route pinned, on phase 8's genesis (150
   validators): a chain of 544 heights x 256 txs a block (139,264
   kvstore keys) minted by utils.chaingen with the app writing on-disk
   snapshots at 510 and 520 (a checksumming kvstore: each chunk's
   SHA-256 in the snapshot's metadata), then served by three source
   Nodes (no signer, RPC on, storage.snapshot_interval 10) from sqlite
   copies of its home, the third corrupting every chunk it serves:
   (a) a fresh Node with statesync.enable (two sources as its RPC
   primary and witness, the trust root at height 1, its app a
   checksumming kvstore too, so that it reads the chunk hashes) dials
   all three, restores the newest snapshot, bans the corrupting sender
   and blocksyncs the tail to 544; its block store must start at 521,
   every block ID from 521 and every state row from 520 equal the
   source's, the restored pairs (133,120, at least 131,072) hash by the
   kvstore's rule to the app hash the light client certified, and a
   pre-snapshot
   key is among them; every state-provider ticket a PRIORITY_CATCHUP
   ticket on the card; the restore wall split into light checks and
   chunk fetch and apply, chunks a second, the tail, every ticket, the
   header cache's stats and K1-K3 launches (counters zeroed just
   before each joiner, read just after); (b) the same with adaptive
   sync, consensus started on the restored state ingesting the tail;
   (c) a fourth source pruning to its last 64 blocks (retain_blocks 64,
   prune_interval_s 0.2) until its base is 480: RPC block below the
   base answers the structured pruned error, and a joiner with its
   trust root at 492 restores from it alone, every chunk served under
   the retention plane's serve floor. The kernels line adds
   statesync_launches (14a / 14b / 14c) and each kernel against its
   plain version on 14a's widest state-provider ticket and its first
   tail window (statesync_max_abs_err), with its device time and bound
   at the provider ticket's width.

The line before last is the card's name and power limit; the last is
{"ok": true, "device": {...}}. Any failure exits non-zero with no
result line; a run that outlives RUN_LIMIT_S (1,140 s) ends non-zero
with every thread's stack on stderr. Needs no network; exits non-zero without a GPU or
without the rest of the repository.
"""

from __future__ import annotations

import faulthandler
import json
import math
import os
import statistics
import subprocess
import sys
import time

SEED = 20261016
RUN_LIMIT_S = 1140  # the smoke must exit within 1,200 s
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
# phase 10: phase 8's corpus ingested through consensus, then live
# heights played by 150 validator stubs, one with a forged precommit
LIVE_HEIGHTS = 8
N_VALS_LIVE = REPLAY_VALS
LIVE_FORGE_AT = 3  # the fourth live height
LIVE_FORGE_LANE = 17
# phase 11: the network. (a) four validators to height 12 with 256 txs;
# (b) the join over TCP of phase 8's corpus; (c) live heights from the
# stub peer over the wire, one with a forged precommit, at the node's
# default configuration
NET_VALS = 4
NET_TXS = 256
NET_HEIGHTS = 12
NET_LIVE_HEIGHTS = 8
NET_FORGE_AT = 3  # the fourth live height
NET_DEADLINE_S = 300
# phase 12: evidence. (a) light-client attacks on phase 8's corpus at a
# committed height: an equivocation fork signed by all 150 with the
# real set, a lunatic fork signed by 51 (510 of 1,500 power, just over
# a third) claiming a set of those 51, each from the height before and
# from EV_COMMON_BACK heights back; (b) the 4-validator net of 11a's
# shape commits a duplicate vote and a lunatic fork of
# NET_EV_ATTACK_AT signed by two keys; (c) a fifth node joins it
EV_ATTACK_AT = 1000
EV_LUNATIC = 51
EV_COMMON_BACK = 6
NET_EV_ATTACK_AT = 2
# phase 13: RPC and the light serving plane. (a) config 4's chain (the
# bisection's 150 validators, sets rotating every 2,500 heights) served
# to bench.py::bench_serve's storm: 1,000 sessions on 64 threads over
# 40 distinct heights drawn from [25,000, 50,000), a pool of 8 verifier
# clients; (b) 11a's four validators with RPC, 256 txs over HTTP (16 by
# broadcast_tx_commit), proved queries on 16 keys; (c) phase 8's corpus
# served over RPC to a light proxy, 256 header requests over 16 heights
SERVE_SESSIONS = 1000
SERVE_WORKERS = 64
SERVE_POOL = 8
SERVE_DISTINCT = 40
SERVE_SEED = 1013
SERVE_FORGED_LANE = 17  # among the first 100 lanes
RPC_TXS = 256
RPC_COMMIT_TXS = 16
RPC_QUERY_KEYS = 16
LIGHT_REQUESTS = 256
LIGHT_HEIGHTS = 16
# phase 14: statesync, on phase 8's genesis (150 validators)
SS_BLOCKS = 544
SS_TXS = 256
SS_SNAPSHOTS = (510, 520)  # on disk: the newest leaves a 24-height tail
SS_MIN_RESTORED_KEYS = 131072
SS_RETAIN = 64
SS_TRUST_IN_WINDOW = 492
SS_DEADLINE_S = 240

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


# every phase line printed so far, by phase: later phases report
# theirs beside earlier ones of the same run
EMITTED: dict = {}


def emit(phase: str, **kw) -> None:
    EMITTED[phase] = kw
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


# --- recording the verify path ------------------------------------------------


class Recorder:
    """Records, while active, every verify ticket (label, priority,
    lanes, the route the scheduler took, submit-to-resolve wall) and
    every device dispatch (its ``dispatch`` dict, the kernel items of
    the first dispatch of each width in ``kept``, and of every dispatch
    by its ticket's label in ``labelled``)."""

    def __init__(self, sched):
        self.sched = sched
        self.tickets, self.routes, self.dispatches, self.kept = [], [], [], {}
        self.labelled = {}

    def __enter__(self):
        from cometbft_tpu_torch.crypto import batch
        from cometbft_tpu_torch.ops import ed25519 as ed

        self._real = (self.sched.submit, batch.route_to_device, ed.verify_batch_async)
        real_submit, real_route, real_async = self._real
        real_dispatch = self.sched._dispatch_device

        def submit(items, **kw):
            t = real_submit(items, **kw)
            self.tickets.append(t)
            return t

        def route(n, device):
            r = real_route(n, device)
            self.routes.append("device" if r else "host")
            return r

        def recording(items, device=None, precomp=None):
            h = real_async(items, device=device, precomp=precomp)
            self.dispatches.append(h.dispatch)
            self.kept.setdefault(len(items), list(items))
            return h

        def dispatch(ticket, ed_idx, ed_items):
            self.labelled.setdefault(ticket.label, []).append(list(ed_items))
            return real_dispatch(ticket, ed_idx, ed_items)

        self.sched.submit, batch.route_to_device, ed.verify_batch_async = submit, route, recording
        self.sched._dispatch_device = dispatch
        return self

    def __exit__(self, *exc):
        from cometbft_tpu_torch.crypto import batch
        from cometbft_tpu_torch.ops import ed25519 as ed

        check(self.sched.drain(60) or exc[0] is not None, "the verify scheduler did not drain")
        _, batch.route_to_device, ed.verify_batch_async = self._real
        del self.sched.submit, self.sched._dispatch_device
        return False

    def rows(self, start=0):
        """(label, priority, lanes, route, wall) of each ticket from
        ``start``, in submission order."""
        return [(t.label, t.priority, len(t.items), r, t.wall())
                for t, r in zip(self.tickets[start:], self.routes[start:])]


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
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.node.inprocess import build_node
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

    # one dispatcher thread routes the catch-up class in submission
    # order, so the i-th routing decision is the i-th ticket's; the
    # stopped reactor's lookahead may still be queued: the recorder's
    # drain lets it resolve, so its dispatch counts in this replay
    with Recorder(S.scheduler()) as rec:
        reactor, redos, t0, wall = asyncio.run(main())
    tickets = [(n, r, w) for _, _, n, r, w in rec.rows()]
    return (fresh, reactor, rows, redos, {k: v for k, v in spans.items()}, rec.dispatches,
            tickets, wall, stamp["last"] - t0, rec.kept)


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
    # (the one-height tail), for phase 6; the corpus, for phase 10
    return launches, {n: kept[n] for n in {max(kept), min(kept)}}, (gen, privs, src, src_rows)


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
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.light import Client, TrustOptions, verifier
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
    checked = []
    hops = {name: getattr(verifier, name) for name in ("verify_adjacent", "verify_non_adjacent")}

    def hop(fn, untrusted_at):
        def checked_hop(*args, **kw):
            checked.append(args[untrusted_at].height)
            return fn(*args, **kw)
        return checked_hop

    out = {"error": None}
    verifier.verify_adjacent = hop(hops["verify_adjacent"], 2)
    verifier.verify_non_adjacent = hop(hops["verify_non_adjacent"], 3)
    try:
        with Recorder(S.scheduler()) as rec:
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
    finally:
        for name, fn in hops.items():
            setattr(verifier, name, fn)
    out.update(
        fetched=list(primary.fetched), hops=client.hops, cache=len(client.cache),
        at=checked[-1] if checked else None, client=client, kept=rec.kept,
        tickets=[(lb, n, r, w) for lb, _, n, r, w in rec.rows()],
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


# --- phase 10: consensus --------------------------------------------------------


def phase_consensus(dev, gen, privs, src, src_rows):
    """Phase 10 on phase 8's corpus: (a) adaptive sync into a started
    ConsensusState, (b) the handoff by a CommitBlockMessage, (c) eight
    live heights played by the validator stubs with the device route
    pinned, one with a forged precommit, (d) eight more unforced.
    Returns the launches of (a) and (c) and, for phase 6, the kernel
    items of the first live height's prevote wave, of the forged
    height's precommit wave and of the handoff's commit."""
    import asyncio
    import shutil
    from collections import defaultdict

    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.blocksync.reactor import VERIFY_WINDOW, BlockSyncReactor
    from cometbft_tpu_torch.config.config import test_config
    from cometbft_tpu_torch.consensus.reactor import CommitBlockMessage
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.node.inprocess import build_node
    from cometbft_tpu_torch.trace import NOOP as TRACE_NOOP
    from cometbft_tpu_torch.trace import Tracer
    from cometbft_tpu_torch.utils import log
    from cometbft_tpu_torch.utils.chaingen import StorePeerClient, ValidatorStubs

    top = src.block_store.height()
    home = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "consensus")
    shutil.rmtree(home, ignore_errors=True)
    cfg = test_config(home)
    cfg.consensus.vote_batch_window_ms = 2.0
    cfg.consensus.skip_timeout_commit = True
    # no propose timeout fires while a stub height is played
    cfg.consensus.timeout_propose_s = 30.0
    node = build_node(gen, device=dev, config=cfg, home=home, wal=True)
    cs = node.cs
    rows: dict = {}
    stamp: dict = {}
    _record_states(node, rows, stamp)
    ingested = []
    real_ingest = cs.ingest_verified_block

    def ingest(block, parts, commit):
        ingested.append(block.height)
        return real_ingest(block, parts, commit)

    cs.ingest_verified_block = ingest
    spans = defaultdict(lambda: [0, 0.0])

    def observe(name, dur_ns, args):
        spans[name][0] += 1
        spans[name][1] += dur_ns / 1e6
        if name == "consensus.finalize":
            for k in ("persist_ms", "wal_ms", "apply_ms"):
                spans[f"consensus.finalize.{k[:-3]}"][0] += 1
                spans[f"consensus.finalize.{k[:-3]}"][1] += args[k]

    tracer = Tracer(name="consensus")
    tracer.add_observer(observe)
    cs.tracer = tracer
    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)
    # one line a finalized block would bury the smoke's own output
    log.set_level("consensus:error,*:info")
    out = {}
    # the steps share one event loop: the state machine's tasks live on it
    loop = asyncio.new_event_loop()

    def same_rows(upto, what):
        bad = [h for h in range(1, upto + 1) if rows.get(h) != src_rows.get(h)]
        check(not bad, f"{what}: state differs from the source at heights {bad[:5]}")
        bad = [h for h in range(1, upto + 1)
               if node.block_store.load_block_meta(h).block_id != src.block_store.load_block_meta(h).block_id]
        check(not bad, f"{what}: block IDs differ at heights {bad[:5]}")

    async def adaptive():
        await cs.start()
        caught = asyncio.Event()
        reactor = BlockSyncReactor(node.state, node.block_exec, node.block_store,
                                   on_caught_up=lambda st: caught.set(), block_ingestor=cs,
                                   device=dev)
        reactor.tracer = tracer
        t0 = time.perf_counter()
        reactor.pool.set_peer_range("good", StorePeerClient(src), 1, top)
        await reactor.start()
        try:
            await asyncio.wait_for(caught.wait(), REPLAY_DEADLINE_S)
        finally:
            await reactor.stop()
        return reactor, t0, time.perf_counter() - t0

    async def wait_height(h, what, timeout=120):
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while cs.rs.height < h:
            check(loop.time() < deadline, f"{what}: consensus at {cs.rs.height}")
            await asyncio.sleep(0.001)

    async def handoff():
        t = {}
        for h in range(cs.rs.height, top + 1):
            t0 = time.perf_counter()
            cs.enqueue_nowait("commit_block", CommitBlockMessage(
                src.block_store.load_block(h), src.block_store.load_seen_commit(h),
                src.block_store.load_extended_commit(h)), "src")
            await wait_height(h + 1, "handoff")
            t[h] = time.perf_counter() - t0
        return t

    sent = {}  # height -> (prevote sign bytes, precommit sign bytes, forged signatures)

    async def live(heights, forge_at=None):
        stubs = ValidatorStubs(src, privs)
        res = []
        for h in heights:
            src.mempool.check_tx(b"live%d=v%d" % (h, h))
            m = stubs.messages(h, forge=(LIVE_FORGE_LANE,) if h == forge_at else ())
            sent[h] = (m.prevotes[0].sign_bytes(gen.chain_id), m.precommits[0].sign_bytes(gen.chain_id),
                       [m.precommits[i].signature for i in m.forged])
            walls = await stubs.play_height(cs, m)
            stubs.finish(m)
            # the wave's last callbacks land after the commit
            deadline = asyncio.get_running_loop().time() + 30
            while sum(v is not None for v in cs.rs.last_commit.votes) < N_VALS_LIVE - len(m.forged):
                check(asyncio.get_running_loop().time() < deadline, f"height {h}: late precommits")
                await asyncio.sleep(0.001)
            check(node.block_store.load_block_meta(h).block_id == src.block_store.load_block_meta(h).block_id,
                  f"height {h}: the stored block is not the stubs'")
            check(rows[h] == _state_row(src.state), f"height {h}: state differs from the shadow chain")
            seen = node.block_store.load_seen_commit(h)
            res.append({"height": h, "walls_s": walls,
                        "breakdown_ms": cs.last_commit_breakdown["phases"],
                        "precommits_in": sum(v is not None for v in cs.rs.last_commit.votes),
                        "seen_commit_signatures": sum(not c.is_absent() for c in seen.signatures),
                        "forged": list(m.forged)})
            if m.forged:
                i = m.forged[0]
                check(cs.rs.last_commit.votes[i] is None, f"height {h}: the forged precommit was added")
                check(seen.signatures[i].signature != m.precommits[i].signature,
                      f"height {h}: the forged signature is in the seen commit")
        return res

    try:
        # 10a: adaptive sync, the device route pinned (floor 1)
        batch.set_min_device_batch(1)
        kernels.reset_counts()
        with Recorder(sched) as rec:
            reactor, t0, wall = loop.run_until_complete(adaptive())
        launches_a = dict(kernels.LAUNCHES)
        applied = len(ingested)
        to_last = stamp["last"] - t0
        tickets = rec.rows()
        check(reactor.loop_errors.count == 0, f"adaptive: the pool routine caught {reactor.loop_errors!r}")
        check(ingested == list(range(1, applied + 1)) and applied >= top - 2,
              f"adaptive: ingested {ingested[:3]}...{ingested[-3:]} ({applied})")
        check(sorted(rows) == ingested, "adaptive: a block was applied outside ingest_verified_block")
        same_rows(applied, "adaptive")
        check(all(r == "device" for _, _, _, r, _ in tickets), "adaptive: a window left the device route")
        check(all(d["device"] == str(dev) and all(d["launches"][k] == 1 for k in SOURCES)
                  for d in rec.dispatches), "adaptive: a window's dispatch did not launch each kernel once")
        check(all(launches_a[k] == len(rec.dispatches) == len(tickets) for k in SOURCES),
              f"adaptive: launches {launches_a} against {len(rec.dispatches)} dispatches")
        out["adaptive"] = {
            "validators": REPLAY_VALS, "blocks": top, "ingested": applied, "window": VERIFY_WINDOW,
            "route": "device (pinned)", "to_last_ingest_s": to_last,
            "blocks_per_s": applied / to_last, "wall_s": wall,
            "signatures_per_s": sum(d["lanes"] for d in rec.dispatches) / to_last,
            "tickets": len(tickets), "dispatch_lanes": [d["lanes"] for d in rec.dispatches],
            "ticket_walls": ticket_walls([(n, r, w) for _, _, n, r, w in tickets]),
            "pipeline_stats": reactor.pipeline_stats, "launches": launches_a,
            "spans_ms": {k: v[1] for k, v in spans.items() if not k.startswith("consensus.step")},
            "span_counts": {k: v[0] for k, v in spans.items() if not k.startswith("consensus.step")},
            "loop_errors": reactor.loop_errors.count,
            "wal_bytes": sum(os.path.getsize(p) for p in _wal_files(cs._wal_path)),
        }
        emit("consensus_adaptive", **out["adaptive"])

        # 10b: the handoff, the device route still pinned
        kernels.reset_counts()
        with Recorder(sched) as rec:
            walls = loop.run_until_complete(handoff())
        launches_b = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        check(cs.rs.height == top + 1 and cs.loop_errors.count == 0,
              f"handoff: consensus at {cs.rs.height}, {cs.loop_errors!r}")
        same_rows(top, "handoff")
        last = tickets[-1]
        check(last[0] == "commit" and last[1] == S.PRIORITY_LIVE and last[2] == REPLAY_VALS
              and last[3] == "device", f"handoff ticket {last}")
        check(all(launches_b[k] == len(tickets) for k in SOURCES), f"handoff launches {launches_b}")
        handoff_items = rec.labelled["commit"][-1]
        check(len(handoff_items) == REPLAY_VALS, f"handoff: {len(handoff_items)} lanes")
        out["handoff"] = {"heights": list(walls), "wall_s": walls, "tickets": tickets,
                          "launches": launches_b, "consensus_height": cs.rs.height}
        emit("consensus_handoff", **out["handoff"])

        # 10c: live rounds, the device route pinned; no tracer, as a
        # node runs (the state machine's own breakdown is per height)
        cs.tracer = TRACE_NOOP
        heights = list(range(top + 1, top + 1 + LIVE_HEIGHTS))
        kernels.reset_counts()
        with Recorder(sched) as rec:
            res = loop.run_until_complete(live(heights, forge_at=heights[LIVE_FORGE_AT]))
        launches_c = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        check(cs.loop_errors.count == 0, f"live: {cs.loop_errors!r}")
        check(node.app.app_hash == src.state.app_hash, "live: final app hash != the shadow chain's")
        waves = [t for t in tickets if t[0] == "vote-wave"]
        check(len(waves) == 2 * LIVE_HEIGHTS and all(
            p == S.PRIORITY_LIVE and n == N_VALS_LIVE and r == "device" for _, p, n, r, _ in waves),
            f"live: vote waves {[(lb, p, n, r) for lb, p, n, r, _ in waves]}")
        check(all(r == "device" and p == S.PRIORITY_LIVE for _, p, _, r, _ in tickets),
              "live: a ticket left the device route or the live class")
        check(all(launches_c[k] == len(tickets) == len(rec.dispatches) for k in SOURCES),
              f"live: launches {launches_c} against {len(tickets)} tickets")
        # a wave's lanes all sign one message (a canonical vote holds no
        # validator): the first height's prevotes, the forged height's
        # precommits, each found among the recorded vote waves
        def wave_of(sb):
            found = [w for w in rec.labelled["vote-wave"] if {m for m, _, _ in w} == {sb}]
            check(len(found) == 1, f"live: {len(found)} vote waves sign the message")
            return found[0]

        fh = heights[LIVE_FORGE_AT]
        live_items = {"prevote": wave_of(sent[heights[0]][0]), "precommit": wave_of(sent[fh][1])}
        check(set(sent[fh][2]) <= {sig for _, _, sig in live_items["precommit"]},
              "live: the forged precommit is not in its height's wave")
        out["live"] = {
            "heights": heights, "route": "device (pinned)", "per_height": res,
            "commit_wall_s": [r["walls_s"]["stored"] for r in res],
            "commit_wall_median_s": statistics.median(r["walls_s"]["stored"] for r in res),
            "tickets": [(lb, n, r, w) for lb, _, n, r, w in tickets],
            "ticket_walls": {lb: ticket_walls([(n, r, w) for l2, _, n, r, w in tickets if l2 == lb])
                             for lb in sorted({t[0] for t in tickets})},
            "launches": launches_c, "app_hash": node.app.app_hash.hex(),
        }
        emit("consensus_live", **out["live"])

        # 10d: eight more heights, unforced, routed by the calibration
        batch.set_min_device_batch(floor)
        batch.calibration = batch._Calibration()
        heights = list(range(heights[-1] + 1, heights[-1] + 1 + LIVE_HEIGHTS))
        with Recorder(sched) as rec:
            res = loop.run_until_complete(live(heights))
        tickets = rec.rows()
        check(cs.loop_errors.count == 0 and node.app.app_hash == src.state.app_hash,
              "unforced live: errors or app hash")
        out["live_unforced"] = {
            "heights": heights,
            "ticket_routes": "".join(r[0] for _, _, _, r, _ in tickets),
            "ticket_labels": [lb for lb, _, _, _, _ in tickets],
            "commit_wall_s": [r["walls_s"]["stored"] for r in res],
            "ticket_walls": {lb: ticket_walls([(n, r, w) for l2, _, n, r, w in tickets if l2 == lb])
                             for lb in sorted({t[0] for t in tickets})},
            "learned": batch.calibration.snapshot(),
        }
        emit("consensus_live_unforced", **out["live_unforced"])
    finally:
        batch.set_min_device_batch(floor)
        log.set_level("info")
        loop.run_until_complete(cs.stop())
        loop.close()
        S.set_scheduler(None)
        sched.close()
        node.close_stores()
        shutil.rmtree(home, ignore_errors=True)
    return launches_a, launches_c, live_items, handoff_items


# --- phase 11: network ----------------------------------------------------------


def corpus_snapshot(src) -> tuple:
    """The corpus node's store contents (block store, state store), for
    phase 11's serving node: phase 10 extends the corpus."""
    return list(src.block_db.iter_prefix(b"")), list(src.state_db.iter_prefix(b""))


def _sqlite_home(home, snapshot) -> None:
    """A node home whose sqlite stores hold ``snapshot``."""
    import shutil

    from cometbft_tpu_torch.utils import kv

    shutil.rmtree(home, ignore_errors=True)
    os.makedirs(home)
    for name, items in zip(("blockstore.db", "state.db"), snapshot):
        db = kv.open_kv("sqlite", os.path.join(home, name))
        db.write_batch(items)
        db.close()


def _peer_bytes(node) -> dict:
    """What a node's peers carried: "sent" counts sealed frames on the
    wire (1,040 bytes each), "received" the frames' payloads plus their
    16-byte tags, as MConnection's rate limiters count them."""
    peers = list(node.switch.peers.values())
    return {"sent": sum(p.send_total for p in peers), "received": sum(p.recv_total for p in peers),
            "peers": len(peers)}


def phase_network(dev, gen, privs, snapshot, top, src_rows):
    """Phase 11: (a) a four-validator net of Nodes over TCP, (b) the
    join of phase 8's corpus over TCP into an adaptive-sync Node, (c)
    eight live heights played over the wire by the stub peer with the
    device route pinned, one with a forged precommit, (d) eight more
    unforced. Returns the launches of (a), (b) and (c) and, for phase
    6, the kernel items of (c)'s first prevote wave and of the forged
    height's precommit wave."""
    import asyncio
    import shutil
    from collections import defaultdict

    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.blocksync.reactor import VERIFY_WINDOW
    from cometbft_tpu_torch.config.config import test_config
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import chacha20poly1305 as aead
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.crypto import x25519
    from cometbft_tpu_torch.node.inprocess import build_node, make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.trace import Tracer
    from cometbft_tpu_torch.utils import log
    from cometbft_tpu_torch.utils.chaingen import StubPeer, ValidatorStubs

    n_vals = len(privs)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "network")
    shutil.rmtree(root, ignore_errors=True)
    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)
    log.set_level("consensus:error,p2p:error,blocksync:error,*:info")
    loop = asyncio.new_event_loop()
    nodes = []  # every Node started here, stopped in the finally
    out = {}
    tiers = {"x25519": x25519.TIER, "aead": aead.TIER}

    async def until(cond, what, timeout=NET_DEADLINE_S, poll=0.005):
        deadline = asyncio.get_running_loop().time() + timeout
        while not cond():
            check(asyncio.get_running_loop().time() < deadline, f"timed out: {what}")
            await asyncio.sleep(poll)

    def config(home, moniker, **kw):
        cfg = test_config(home)
        cfg.base.moniker = moniker
        cfg.blocksync.enable = False
        for k, v in kw.items():
            sec, _, name = k.partition("__")
            setattr(getattr(cfg, sec), name, v)
        return cfg

    async def net4():
        g4, k4 = make_genesis(NET_VALS, chain_id="smoke-net", seed=SEED)
        pv_root = os.path.join(root, "pv")
        os.makedirs(pv_root)
        pvs = make_privvals(k4, root=pv_root)
        net = [Node(config(".", f"net{i}"), g4, privval=pv, device=dev) for i, pv in enumerate(pvs)]
        nodes.extend(net)
        for n in net:
            await n.start()
        for i, a in enumerate(net):
            for b in net[i + 1:]:
                await a.dial(b.listen_addr)
        await until(lambda: all(n.switch.num_peers() == NET_VALS - 1 for n in net), "the full mesh")
        txs = [b"net%03d=v%03d" % (i, i) for i in range(NET_TXS)]
        check(all(net[0].parts.mempool.check_tx(tx).is_ok() for tx in txs), "a tx was refused")
        seen = {}  # height -> first time node 0 stored it
        t0 = time.perf_counter()

        def progressed():
            h = net[0].height
            if h and h not in seen:
                seen[h] = time.perf_counter()
            return all(n.height >= NET_HEIGHTS for n in net)

        await until(progressed, f"height {NET_HEIGHTS}")
        wall = time.perf_counter() - t0
        committed = [tx for h in range(1, net[0].height + 1) for tx in net[0].parts.block_store.load_block(h).data.txs]
        bytes_ = {n.config.base.moniker: _peer_bytes(n) for n in net}
        for h in range(1, NET_HEIGHTS + 1):
            check(len({n.block_id_hash_at(h) for n in net}) == 1, f"net: nodes differ at height {h}")
        for n in net:
            await n.stop()
            nodes.remove(n)
        waves = {n.config.base.moniker: n.consensus_reactor.vote_verifier.dispatches for n in net}
        closes = {n.config.base.moniker: [e[3] for e in n.consensus_reactor.wave_log] for n in net}
        errors = sum(n.parts.cs.loop_errors.count for n in net)
        hs = sorted(seen)
        walls = [seen[b] - seen[a] for a, b in zip(hs, hs[1:]) if b == a + 1]
        return {"committed": committed, "txs": txs, "wall_s": wall, "height_walls_s": walls,
                "bytes": bytes_, "reactor_waves": waves, "wave_closes": closes, "loop_errors": errors,
                "heights": net[0].height}

    spans = defaultdict(lambda: [0, 0.0])

    def observe(name, dur_ns, args):
        spans[name][0] += 1
        spans[name][1] += dur_ns / 1e6
        if name == "consensus.finalize":
            for k in ("persist_ms", "wal_ms", "apply_ms"):
                spans[f"consensus.finalize.{k[:-3]}"][0] += 1
                spans[f"consensus.finalize.{k[:-3]}"][1] += args[k]

    serve_home = os.path.join(root, "serve")
    serve_cfg = config(serve_home, "serve", base__db_backend="sqlite")
    join_cfg = config(os.path.join(root, "join"), "join", blocksync__enable=True,
                      blocksync__adaptive_sync=True, consensus__skip_timeout_commit=True,
                      consensus__timeout_propose_s=30.0)
    rows: dict = {}
    stamp: dict = {}
    ingested = []  # (height, through a CommitBlock)
    joiner = {}

    async def join():
        _sqlite_home(serve_home, snapshot)
        serving = Node(serve_cfg, gen, home=serve_home, device=dev)
        check(serving.height == top, f"serving node at {serving.height}")
        nodes.append(serving)
        await serving.start()
        node = Node(join_cfg, gen, home=join_cfg.root_dir, device=dev)
        nodes.append(node)
        joiner["node"] = node
        cs = node.parts.cs
        _record_states(node.parts, rows, stamp)
        real_ingest, real_cb = cs.ingest_verified_block, cs._handle_commit_block
        in_cb = []

        def ingest(block, parts, commit):
            ingested.append((block.height, bool(in_cb)))
            return real_ingest(block, parts, commit)

        def commit_block(payload, peer_id):
            in_cb.append(1)
            try:
                return real_cb(payload, peer_id)
            finally:
                in_cb.pop()

        cs.ingest_verified_block, cs._handle_commit_block = ingest, commit_block
        tracer = Tracer(name="join")
        tracer.add_observer(observe)
        cs.tracer = tracer
        node.blocksync_reactor.inner.tracer = tracer
        await node.start()
        t0 = time.perf_counter()
        await node.dial(serving.listen_addr)
        await until(lambda: cs.rs.height > top, f"the joiner at {top + 1}")
        wall = time.perf_counter() - t0
        await asyncio.sleep(0.2)  # the last acknowledgements
        got, served = _peer_bytes(node), _peer_bytes(serving)
        await serving.stop()
        nodes.remove(serving)
        return t0, wall, got, served

    sent = {}  # height -> (prevote sign bytes, precommit sign bytes, forged signatures)

    async def live(stubs, stub, heights, forge_at=None):
        node = joiner["node"]
        cs = node.parts.cs
        res = []
        for h in heights:
            stubs.shadow.mempool.check_tx(b"net%d=v%d" % (h, h))
            m = stubs.messages(h, forge=(LIVE_FORGE_LANE,) if h == forge_at else ())
            sent[h] = (m.prevotes[0].sign_bytes(gen.chain_id), m.precommits[0].sign_bytes(gen.chain_id),
                       [m.precommits[i].signature for i in m.forged])
            walls = await stubs.play_height(cs, m, deliver=stub.deliver_for(m))
            stubs.finish(m)
            await until(lambda: sum(v is not None for v in cs.rs.last_commit.votes) >= n_vals - len(m.forged),
                        f"height {h}: late precommits", timeout=30)
            check(node.parts.block_store.load_block_meta(h).block_id
                  == stubs.shadow.block_store.load_block_meta(h).block_id,
                  f"height {h}: the stored block is not the stubs'")
            check(rows[h] == _state_row(stubs.shadow.state), f"height {h}: state differs from the shadow chain")
            seen = node.parts.block_store.load_seen_commit(h)
            res.append({"height": h, "walls_s": walls,
                        "precommits_in": sum(v is not None for v in cs.rs.last_commit.votes),
                        "seen_commit_signatures": sum(not c.is_absent() for c in seen.signatures),
                        "forged": list(m.forged)})
            if m.forged:
                i = m.forged[0]
                check(cs.rs.last_commit.votes[i] is None, f"height {h}: the forged precommit was added")
                check(seen.signatures[i].signature != m.precommits[i].signature,
                      f"height {h}: the forged signature is in the seen commit")
        return res

    stub = None
    shadow = None
    try:
        batch.set_min_device_batch(1)
        # 11a: four validators over TCP, the device route pinned
        kernels.reset_counts()
        with Recorder(sched) as rec:
            a = loop.run_until_complete(net4())
        launches_a = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        counts = {tx: a["committed"].count(tx) for tx in a["txs"]}
        check(all(c == 1 for c in counts.values()),
              f"net: txs committed {sorted(set(counts.values()))} times, not once")
        check(len(a["committed"]) == NET_TXS, f"net: {len(a['committed'])} txs committed")
        check(a["loop_errors"] == 0, f"net: {a['loop_errors']} loop errors")
        waves = [t for t in tickets if t[0] == "vote-wave"]
        check(len(waves) == sum(a["reactor_waves"].values()) > 0, f"net: {len(waves)} wave tickets")
        check(all(r == "device" and p == S.PRIORITY_LIVE for _, p, _, r, _ in waves), "net: a wave left the card")
        check(all(r == "device" for _, _, _, r, _ in tickets), "net: a ticket left the device route")
        check(all(d["device"] == str(dev) and all(d["launches"][k] == 1 for k in SOURCES)
                  for d in rec.dispatches), "net: a dispatch did not launch each kernel once")
        check(all(launches_a[k] == len(rec.dispatches) == len(tickets) for k in SOURCES),
              f"net: launches {launches_a} against {len(tickets)} tickets")
        out["net"] = {
            "validators": NET_VALS, "heights": a["heights"], "txs": NET_TXS,
            "txs_committed_once": True, "wall_s": a["wall_s"],
            "height_wall_median_s": statistics.median(a["height_walls_s"]),
            "height_walls_s": a["height_walls_s"], "bytes": a["bytes"], "tiers": tiers,
            "send_rate": test_config().p2p.send_rate,
            "tickets": len(tickets), "wave_tickets": len(waves),
            "wave_lanes": [n for _, _, n, _, _ in waves],
            "wave_closes": {m: {how: c.count(how) for how in ("whole", "grace")}
                            for m, c in a["wave_closes"].items()},
            "ticket_walls": {lb: ticket_walls([(n, r, w) for l2, _, n, r, w in tickets if l2 == lb])
                             for lb in sorted({t[0] for t in tickets})},
            "launches": launches_a,
        }
        emit("network_net", **out["net"])

        # 11b: the join over TCP, the device route pinned
        kernels.reset_counts()
        with Recorder(sched) as rec:
            t0, wall, got, served = loop.run_until_complete(join())
        launches_b = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        node = joiner["node"]
        cs = node.parts.cs
        heights = [h for h, _ in ingested]
        check(heights == list(range(1, top + 1)), f"join: ingested {heights[:3]}...{heights[-3:]} ({len(heights)})")
        check(sorted(rows) == heights, "join: a block was applied outside ingest_verified_block")
        check(ingested[-1] == (top, True), f"join: block {top} did not come as a CommitBlock")
        bad = [h for h in range(1, top + 1) if rows[h] != src_rows[h]]
        check(not bad, f"join: state differs from the source at heights {bad[:5]}")
        check(node.blocksync_reactor.inner.loop_errors.count == 0 and cs.loop_errors.count == 0,
              f"join: {node.blocksync_reactor.inner.loop_errors!r} {cs.loop_errors!r}")
        windows = [t for t in tickets if t[0] != "commit"]
        commits = [t for t in tickets if t[0] == "commit"]
        check(commits and commits[-1][1:4] == (S.PRIORITY_LIVE, n_vals, "device"),
              f"join: the catch-up commit ticket {commits[-1:] }")
        check(all(r == "device" for _, _, _, r, _ in tickets), "join: a ticket left the device route")
        check(all(d["device"] == str(dev) and all(d["launches"][k] == 1 for k in SOURCES)
                  for d in rec.dispatches), "join: a dispatch did not launch each kernel once")
        check(all(launches_b[k] == len(rec.dispatches) == len(tickets) for k in SOURCES),
              f"join: launches {launches_b} against {len(tickets)} tickets")
        to_last = stamp["last"] - t0
        out["join"] = {
            "validators": n_vals, "blocks": top, "window": VERIFY_WINDOW, "route": "device (pinned)",
            "to_last_ingest_s": to_last, "blocks_per_s": top / to_last, "wall_s": wall,
            "beside_blocks_per_s": {ph: EMITTED.get(ph, {}).get("blocks_per_s")
                                    for ph in ("replay", "consensus_adaptive")},
            "through_commit_block": [h for h, cb in ingested if cb],
            "wire_bytes_served": served["sent"], "wire_bytes_per_block": served["sent"] / top,
            "payload_bytes_received": got["received"], "wire_bytes_sent": got["sent"],
            "window_tickets": len(windows), "commit_tickets": len(commits),
            "ticket_walls": {lb: ticket_walls([(n, r, w) for l2, _, n, r, w in tickets if l2 == lb])
                             for lb in sorted({t[0] for t in tickets})},
            "dispatch_lanes": [d["lanes"] for d in rec.dispatches],
            "pipeline_stats": node.blocksync_reactor.inner.pipeline_stats,
            "spans_ms": {k: v[1] for k, v in spans.items() if not k.startswith("consensus.step")},
            "span_counts": {k: v[0] for k, v in spans.items() if not k.startswith("consensus.step")},
            "launches": launches_b, "tiers": tiers,
        }
        emit("network_join", **out["join"])

        # 11c: live heights over the wire, the device route pinned
        cs.tracer = Tracer(name="join", enabled=False)
        shadow = build_node(gen, config=serve_cfg, home=serve_home, device=dev)
        stubs = ValidatorStubs(shadow, privs)
        stub = StubPeer(gen.chain_id)
        loop.run_until_complete(stub.connect(node.listen_addr))
        loop.run_until_complete(until(lambda: node.switch.num_peers() == 1, "the stub peer"))
        heights = list(range(top + 1, top + 1 + NET_LIVE_HEIGHTS))
        reactor = node.consensus_reactor
        reactor.wave_log.clear()
        dispatched = reactor.vote_verifier.dispatches
        kernels.reset_counts()
        with Recorder(sched) as rec:
            res = loop.run_until_complete(live(stubs, stub, heights, forge_at=heights[NET_FORGE_AT]))
        launches_c = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        closes = [e[2:] for e in reactor.wave_log]  # type, how, votes, to +2/3 s, to dispatch s
        check(cs.loop_errors.count == 0, f"live: {cs.loop_errors!r}")
        check(node.parts.app.app_hash == shadow.state.app_hash, "live: app hash != the shadow chain's")
        waves = [t for t in tickets if t[0] == "vote-wave"]
        check(len(waves) == 2 * NET_LIVE_HEIGHTS and all(
            p == S.PRIORITY_LIVE and n == n_vals and r == "device" for _, p, n, r, _ in waves),
            f"live: vote waves {[(lb, p, n, r) for lb, p, n, r, _ in waves]}, closed {closes}")
        check(reactor.vote_verifier.dispatches - dispatched == len(waves),
              f"live: {reactor.vote_verifier.dispatches - dispatched} reactor dispatches, {len(waves)} waves")
        check(all(r == "device" and p == S.PRIORITY_LIVE for _, p, _, r, _ in tickets),
              "live: a ticket left the device route or the live class")
        check(all(launches_c[k] == len(tickets) == len(rec.dispatches) for k in SOURCES),
              f"live: launches {launches_c} against {len(tickets)} tickets")

        def wave_of(sb):
            found = [w for w in rec.labelled["vote-wave"] if {m for m, _, _ in w} == {sb}]
            check(len(found) == 1, f"live: {len(found)} vote waves sign the message")
            return found[0]

        fh = heights[NET_FORGE_AT]
        net_items = {"prevote": wave_of(sent[heights[0]][0]), "precommit": wave_of(sent[fh][1])}
        check(set(sent[fh][2]) <= {sig for _, _, sig in net_items["precommit"]},
              "live: the forged precommit is not in its height's wave")
        out["live"] = {
            "heights": heights, "route": "device (pinned)", "per_height": res,
            "commit_wall_s": [r["walls_s"]["stored"] for r in res],
            "commit_wall_median_s": statistics.median(r["walls_s"]["stored"] for r in res),
            "beside_commit_wall_median_s": EMITTED.get("consensus_live", {}).get("commit_wall_median_s"),
            "tickets": [(lb, n, r, w) for lb, _, n, r, w in tickets],
            "ticket_walls": {lb: ticket_walls([(n, r, w) for l2, _, n, r, w in tickets if l2 == lb])
                             for lb in sorted({t[0] for t in tickets})},
            "wave_closes": closes,
            "stub_bytes_sent": stub.bytes_sent, "launches": launches_c,
        }
        emit("network_live", **out["live"])

        # 11d: eight more heights, unforced, routed by the calibration
        batch.set_min_device_batch(floor)
        batch.calibration = batch._Calibration()
        heights = list(range(heights[-1] + 1, heights[-1] + 1 + NET_LIVE_HEIGHTS))
        reactor.wave_log.clear()
        with Recorder(sched) as rec:
            res = loop.run_until_complete(live(stubs, stub, heights))
        tickets = rec.rows()
        check(cs.loop_errors.count == 0 and node.parts.app.app_hash == shadow.state.app_hash,
              "unforced live: errors or app hash")
        out["live_unforced"] = {
            "heights": heights,
            "ticket_routes": "".join(r[0] for _, _, _, r, _ in tickets),
            "ticket_labels": [lb for lb, _, _, _, _ in tickets],
            "commit_wall_s": [r["walls_s"]["stored"] for r in res],
            "wave_closes": [e[2:] for e in reactor.wave_log],
            "learned": batch.calibration.snapshot(),
        }
        emit("network_live_unforced", **out["live_unforced"])
    finally:
        batch.set_min_device_batch(floor)
        log.set_level("info")
        if stub is not None:
            loop.run_until_complete(stub.stop())
        for n in nodes:
            loop.run_until_complete(n.stop())
        loop.close()
        S.set_scheduler(None)
        sched.close()
        if shadow is not None:
            shadow.close_stores()
        shutil.rmtree(root, ignore_errors=True)
    return {"11a": launches_a, "11b": launches_b, "11c": launches_c}, net_items


# --- phase 12: evidence ---------------------------------------------------------


def _corpus_stores(snapshot):
    """A block store and a state store over a copy of the corpus (the
    stores a node over it has): phase 10 extends the corpus itself."""
    from types import SimpleNamespace

    from cometbft_tpu_torch.state.store import Store as StateStore
    from cometbft_tpu_torch.store.block_store import BlockStore
    from cometbft_tpu_torch.utils import kv

    block_db, state_db = kv.MemKV(), kv.MemKV()
    block_db.write_batch(snapshot[0])
    state_db.write_batch(snapshot[1])
    return SimpleNamespace(block_store=BlockStore(block_db), state_store=StateStore(state_db))


class PlainKernels:
    """While active, the verify path calls the kernels' plain PyTorch
    versions on the card's tensors in place of K1-K3."""

    def __enter__(self):
        from cometbft_tpu_torch.ops import curve25519 as cv
        from cometbft_tpu_torch.ops import ladder as ld
        from cometbft_tpu_torch.ops import sc25519 as sc

        self._mods = (sc, cv, ld)
        self._real = (sc.hash_digits, cv.decompress, ld.verify)
        sc.hash_digits, cv.decompress, ld.verify = sc.hash_digits_plain, cv.decompress_plain, ld.verify_plain
        return self

    def __exit__(self, *exc):
        sc, cv, ld = self._mods
        sc.hash_digits, cv.decompress, ld.verify = self._real
        return False


def _verdict(pool, ev):
    """("accepted", None) or the refusal's (type, message)."""
    try:
        pool.add_evidence(ev)
    except Exception as e:  # the verdict under test, whatever its type
        return type(e).__name__, str(e)
    return "accepted", None


def _misbehavior_rows(node, upto):
    """What the app kept, and what the committed blocks' evidence makes
    of it by the JAX package's rule (``evidence_to_misbehavior``), to
    height ``upto``."""
    from cometbft_tpu_torch.state.execution import evidence_to_misbehavior

    kept = [r for r in node.parts.app.misbehavior_seen if r[0] <= upto]
    made = [(h, m.type_, m.validator_address, m.validator_power, m.height)
            for h in range(1, upto + 1)
            for m in evidence_to_misbehavior(node.parts.block_store.load_block(h).evidence)]
    return kept, made


def phase_evidence(dev, gen, privs, snapshot, top):
    """Phase 12: (a) light-client attacks on the corpus as phase 8 built
    it, accepted and refused on the card, the refusals again on the
    plain kernels; (b) a 4-validator net over TCP commits a duplicate
    vote and a lunatic fork; (c) a fifth node joins that chain by
    blocksync over TCP. Returns the launches of (a), (b) and (c) and,
    for phase 6, the kernel items of the widest evidence ticket."""
    import asyncio
    import dataclasses
    import shutil

    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.abci.types import (MISBEHAVIOR_DUPLICATE_VOTE,
                                               MISBEHAVIOR_LIGHT_CLIENT_ATTACK)
    from cometbft_tpu_torch.config.config import test_config
    from cometbft_tpu_torch.consensus.reactor import VOTE_CHANNEL, encode_vote_msg
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.evidence.pool import EvidencePool
    from cometbft_tpu_torch.evidence.types import DuplicateVoteEvidence
    from cometbft_tpu_torch.light.types import LightBlock
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.utils import chaingen, kv, log

    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "evidence")
    shutil.rmtree(root, ignore_errors=True)
    out, launches = {}, {}
    loop = asyncio.new_event_loop()
    nodes = []  # every Node started here, stopped in the finally
    try:
        batch.set_min_device_batch(1)
        # 12a: light-client attacks at the corpus's 150 validators
        corpus = _corpus_stores(snapshot)
        check(corpus.block_store.height() == top, f"corpus copy at {corpus.block_store.height()}")
        h = EV_ATTACK_AT
        n_vals = len(privs)
        full = chaingen.conflicting_block(corpus, privs, h)
        lunatic = chaingen.conflicting_block(corpus, privs, h, signers=privs[:EV_LUNATIC])
        attacks = {
            "equivocation": chaingen.light_attack(corpus, full, h - 1),
            "lunatic": chaingen.light_attack(corpus, lunatic, h - 1),
            "equivocation_back": chaingen.light_attack(corpus, full, h - EV_COMMON_BACK),
            "lunatic_back": chaingen.light_attack(corpus, lunatic, h - EV_COMMON_BACK),
        }
        width = {"equivocation": n_vals, "lunatic": EV_LUNATIC}
        pool = EvidencePool(kv.MemKV(), corpus.state_store, corpus.block_store, device=dev)
        accepted = {}
        ev_items = None
        kernels.reset_counts()
        for name, ev in attacks.items():
            before = dict(kernels.LAUNCHES)
            with Recorder(sched) as rec:
                t0 = time.perf_counter()
                verdict = _verdict(pool, ev)
                wall = time.perf_counter() - t0
            tickets = rec.rows()
            lanes = width[name.split("_")[0]]
            check(verdict == ("accepted", None), f"12a {name}: {verdict}")
            check(ev.hash() in {e.hash() for e in pool.pending_evidence(1 << 30)}, f"12a {name}: not pending")
            check([(lb, p, n, r) for lb, p, n, r, _ in tickets]
                  == [("trusting", S.PRIORITY_CATCHUP, lanes, "device"), ("light", S.PRIORITY_CATCHUP, lanes, "device")],
                  f"12a {name}: tickets {tickets}")
            check(all(kernels.LAUNCHES[k] - before[k] == 2 for k in SOURCES),
                  f"12a {name}: launches {kernels.LAUNCHES} from {before}")
            if name == "equivocation":
                ev_items = {lb: rec.labelled[lb][0] for lb in ("trusting", "light")}
            accepted[name] = {"lanes": lanes, "common_height": ev.common_height,
                              "byzantine": len(ev.byzantine_validators), "add_evidence_s": wall,
                              "tickets": [(lb, n, r, w) for lb, _, n, r, w in tickets]}
        launches["12a"] = dict(kernels.LAUNCHES)

        real = corpus.block_store.load_block(h).header
        genuine = corpus.block_store.load_seen_commit(h)
        vals = corpus.state_store.load_validators(h)
        forged = attacks["equivocation"]
        sigs = list(forged.conflicting_block.commit.signatures)
        lane = n_vals // 2
        sigs[lane] = dataclasses.replace(sigs[lane], signature=bytes([sigs[lane].signature[0] ^ 1])
                                         + sigs[lane].signature[1:])
        forged_block = LightBlock(full.header, dataclasses.replace(full.commit, signatures=sigs), full.validator_set)
        variants = {
            "fabricated_header": chaingen.light_attack(
                corpus, LightBlock(dataclasses.replace(real, app_hash=b"\x55" * 32), genuine, vals), h - 1),
            "common_ahead": chaingen.light_attack(corpus, LightBlock(real, genuine, vals), h + 1),
            "byzantine_set": dataclasses.replace(
                attacks["lunatic"], byzantine_validators=attacks["lunatic"].byzantine_validators[:-1]),
            "total_power": dataclasses.replace(
                attacks["equivocation"], total_voting_power=attacks["equivocation"].total_voting_power + 1),
            "forged_signature": chaingen.light_attack(corpus, forged_block, h - 1),
        }
        refused = {}
        for name, ev in variants.items():
            on_card = EvidencePool(kv.MemKV(), corpus.state_store, corpus.block_store, device=dev)
            with Recorder(sched) as rec:
                t0 = time.perf_counter()
                card_verdict = _verdict(on_card, ev)
                card_s = time.perf_counter() - t0
            tickets = rec.rows()
            with PlainKernels():
                on_plain = EvidencePool(kv.MemKV(), corpus.state_store, corpus.block_store, device=dev)
                t0 = time.perf_counter()
                plain_verdict = _verdict(on_plain, ev)
                plain_s = time.perf_counter() - t0
            check(card_verdict[0] not in ("accepted", "DeviceRouteError"), f"12a {name}: {card_verdict}")
            check(card_verdict == plain_verdict, f"12a {name}: card {card_verdict}, plain {plain_verdict}")
            check(on_card.size() == on_plain.size() == 0, f"12a {name}: left pending")
            check(all(r == "device" for _, _, _, r, _ in tickets), f"12a {name}: a ticket left the card")
            refused[name] = {"error": card_verdict, "card_s": card_s, "plain_s": plain_s,
                             "tickets": [(lb, n, r, w) for lb, _, n, r, w in tickets]}
        check(refused["forged_signature"]["error"][0] == "ErrInvalidSignature",
              f"12a: the forged lane {refused['forged_signature']['error']}")
        check(all(refused[k]["error"][0] == "EvidenceError" for k in variants if k != "forged_signature"),
              f"12a: refusals {refused}")
        out["attacks"] = {"validators": n_vals, "attack_height": h, "lunatic_signers": EV_LUNATIC,
                          "common_back": EV_COMMON_BACK, "accepted": accepted, "refused": refused,
                          "pending": pool.size(), "launches": launches["12a"]}
        emit("evidence_attacks", **out["attacks"])

        # 12b: a 4-validator net over TCP commits both kinds of evidence
        log.set_level("consensus:error,p2p:error,blocksync:error,*:info")
        g4, k4 = make_genesis(NET_VALS, chain_id="smoke-evidence", seed=SEED)
        pv_root = os.path.join(root, "pv")
        os.makedirs(pv_root)
        pvs = make_privvals(k4, root=pv_root)
        rows = {}  # moniker -> {height: state row}

        def config(moniker, **kw):
            cfg = test_config(".")
            cfg.base.moniker = moniker
            cfg.blocksync.enable = False
            for k, v in kw.items():
                sec, _, name = k.partition("__")
                setattr(getattr(cfg, sec), name, v)
            return cfg

        def recorded(node):
            mine = rows.setdefault(node.config.base.moniker, {})
            real_complete = node.parts.block_exec.apply_complete

            def complete(new_state, *rest):
                st = real_complete(new_state, *rest)
                mine[st.last_block_height] = _state_row(st)
                return st

            node.parts.block_exec.apply_complete = complete
            return node

        async def until(cond, what, timeout=NET_DEADLINE_S):
            deadline = asyncio.get_running_loop().time() + timeout
            while not cond():
                check(asyncio.get_running_loop().time() < deadline, f"timed out: {what}")
                await asyncio.sleep(0.01)

        def records(n, kind, addr, ev_height=None):
            return [r for r in n.parts.app.misbehavior_seen
                    if r[1] == kind and r[2] == addr and ev_height in (None, r[4])]

        byz = k4[3]
        byz_addr = byz.pub_key().address()
        lca_addrs = [p.pub_key().address() for p in k4[2:]]
        powers = {v.address: v.voting_power for v in g4.validator_set().validators}

        async def net():
            net_nodes = [recorded(Node(config(f"ev{i}"), g4, privval=pv, device=dev)) for i, pv in enumerate(pvs)]
            nodes.extend(net_nodes)
            for n in net_nodes:
                await n.start()
            for i, a in enumerate(net_nodes):
                for b in net_nodes[i + 1:]:
                    await a.dial(b.listen_addr)
            await until(lambda: all(n.switch.num_peers() == NET_VALS - 1 for n in net_nodes), "the full mesh")
            await until(lambda: all(n.height > NET_EV_ATTACK_AT for n in net_nodes), f"height {NET_EV_ATTACK_AT + 1}")
            # the fourth key equivocates prevotes into node 0's
            # consensus reactor, once a round, at its current height and
            # round until the conflict registers
            target = net_nodes[0]
            idx = g4.validator_set().get_by_address(byz_addr)[0]
            peer = next(iter(target.switch.peers.values()))
            reactor = target.switch.reactor("consensus")
            t0, eq_height = time.perf_counter(), target.height
            played = set()
            deadline = asyncio.get_running_loop().time() + 60
            while not target.parts.evpool.pending_evidence(1 << 20):
                check(asyncio.get_running_loop().time() < deadline, "12b: no duplicate-vote evidence formed")
                rs = target.parts.cs.rs
                if (rs.height, rs.round) not in played:
                    played.add((rs.height, rs.round))
                    for v in chaingen.equivocating_votes(byz, idx, g4.chain_id, rs.height, rs.round):
                        reactor.receive(VOTE_CHANNEL, peer, encode_vote_msg(v))
                await asyncio.sleep(0.005)
            dup = target.parts.evpool.pending_evidence(1 << 20)[0]
            check(isinstance(dup, DuplicateVoteEvidence), f"12b: {dup!r}")
            await until(lambda: all(records(n, MISBEHAVIOR_DUPLICATE_VOTE, byz_addr) for n in net_nodes),
                        "the duplicate vote at every app")
            dup_s = time.perf_counter() - t0
            dup_at = records(target, MISBEHAVIOR_DUPLICATE_VOTE, byz_addr)[0][0]
            # a lunatic fork signed by two of the four keys, handed to
            # node 1; every node that receives it checks it on the card
            fork = chaingen.conflicting_block(net_nodes[0].parts, k4, NET_EV_ATTACK_AT, signers=k4[2:])
            lca = chaingen.light_attack(net_nodes[0].parts, fork, NET_EV_ATTACK_AT - 1)
            t0, lca_height = time.perf_counter(), net_nodes[1].height
            await net_nodes[1].add_evidence(lca)
            await until(lambda: all(records(n, MISBEHAVIOR_LIGHT_CLIENT_ATTACK, a, lca.common_height)
                                    for n in net_nodes for a in lca_addrs), "the lunatic fork at every app")
            lca_s = time.perf_counter() - t0
            lca_at = records(target, MISBEHAVIOR_LIGHT_CLIENT_ATTACK, lca_addrs[0], lca.common_height)[0][0]
            for n in net_nodes:
                check(records(n, MISBEHAVIOR_DUPLICATE_VOTE, byz_addr)[0][3] == powers[byz_addr],
                      "12b: the duplicate vote's power")
                check(all(records(n, MISBEHAVIOR_LIGHT_CLIENT_ATTACK, a, lca.common_height)[0][3] == powers[a]
                          for a in lca_addrs), "12b: the attackers' powers")
            upto = min(n.height for n in net_nodes)
            for n in net_nodes:
                kept, made = _misbehavior_rows(n, upto)
                check(kept == made, f"12b {n.config.base.moniker}: app kept {kept}, blocks give {made}")
            for hh in range(1, upto + 1):
                check(len({n.block_id_hash_at(hh) for n in net_nodes}) == 1, f"12b: nodes differ at height {hh}")
            return net_nodes, {
                "duplicate_vote": {"injected_at_height": eq_height, "committed_in_block": dup_at,
                                   "heights": dup_at - eq_height, "wall_s": dup_s,
                                   "rounds_played": len(played)},
                "light_attack": {"handed_at_height": lca_height, "committed_in_block": lca_at,
                                 "heights": lca_at - lca_height, "wall_s": lca_s,
                                 "byzantine": len(lca.byzantine_validators)},
                "heights": upto,
                "evidence_blocks": [hh for hh in range(1, upto + 1)
                                    if net_nodes[0].parts.block_store.load_block(hh).evidence],
                "misbehavior_seen": [(r[0], r[1], r[2].hex()[:12], r[3], r[4])
                                     for r in net_nodes[0].parts.app.misbehavior_seen],
                "loop_errors": sum(n.parts.cs.loop_errors.count for n in net_nodes),
            }

        kernels.reset_counts()
        with Recorder(sched) as rec:
            net_nodes, b = loop.run_until_complete(net())
        launches["12b"] = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        checks_ = [t for t in tickets if t[0] in ("trusting", "light")]
        check(b["loop_errors"] == 0, f"12b: {b['loop_errors']} loop errors")
        # two a node that checked the fork: the one it was handed to and
        # each that took it from the wire before its block
        check(checks_ and len(checks_) % 2 == 0 and len(checks_) <= 2 * NET_VALS
              and all(p == S.PRIORITY_CATCHUP and n == 2 and r == "device" for _, p, n, r, _ in checks_),
              f"12b: evidence tickets {[(lb, p, n, r) for lb, p, n, r, _ in checks_]}")
        check(all(r == "device" for _, _, _, r, _ in tickets), "12b: a ticket left the device route")
        check(all(d["device"] == str(dev) and all(d["launches"][k] == 1 for k in SOURCES)
                  for d in rec.dispatches), "12b: a dispatch did not launch each kernel once")
        check(all(launches["12b"][k] == len(rec.dispatches) == len(tickets) for k in SOURCES),
              f"12b: launches {launches['12b']} against {len(tickets)} tickets")
        out["net"] = {**b, "validators": NET_VALS, "tickets": len(tickets), "evidence_tickets": len(checks_),
                      "ticket_walls": {lb: ticket_walls([(n, r, w) for l2, _, n, r, w in tickets if l2 == lb])
                                       for lb in sorted({t[0] for t in tickets})},
                      "launches": launches["12b"]}
        emit("evidence_net", **out["net"])

        # 12c: a fifth node joins that chain by blocksync over TCP
        async def join():
            joiner = recorded(Node(config("ev-join", blocksync__enable=True), g4, device=dev))
            nodes.append(joiner)
            await joiner.start()
            t0 = time.perf_counter()
            for n in net_nodes:
                await joiner.dial(n.listen_addr)
            target = min(n.height for n in net_nodes)
            await until(lambda: joiner.height >= target and target in rows["ev-join"], f"the joiner at {target}")
            return joiner, target, time.perf_counter() - t0

        kernels.reset_counts()
        with Recorder(sched) as rec:
            joiner, target, wall = loop.run_until_complete(join())
        launches["12c"] = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        mine, theirs = rows["ev-join"], rows["ev0"]
        bad = [hh for hh in range(1, target + 1) if mine.get(hh) != theirs.get(hh)]
        check(not bad, f"12c: the joiner's state differs at heights {bad[:5]}")
        bad = [hh for hh in range(1, target + 1) if joiner.block_id_hash_at(hh) != net_nodes[0].block_id_hash_at(hh)]
        check(not bad, f"12c: block IDs differ at heights {bad[:5]}")
        kept, made = _misbehavior_rows(joiner, target)
        check(kept == made == _misbehavior_rows(net_nodes[0], target)[0],
              f"12c: the joiner's misbehavior {kept}")
        check(any(r[1] == MISBEHAVIOR_LIGHT_CLIENT_ATTACK for r in kept)
              and any(r[1] == MISBEHAVIOR_DUPLICATE_VOTE for r in kept), "12c: the joiner skipped the evidence")
        check(all(r == "device" for _, _, _, r, _ in tickets) and tickets, "12c: a ticket left the device route")
        check(all(launches["12c"][k] == len(rec.dispatches) == len(tickets) for k in SOURCES),
              f"12c: launches {launches['12c']} against {len(tickets)} tickets")
        # the four validators keep running consensus meanwhile, so most
        # of 12c's launches are theirs; the joiner's own are its
        # blocksync windows, the only "coalesced" tickets (the
        # validators run no blocksync), each one device dispatch
        windows = [t for t in tickets if t[0] == "coalesced"]
        stats = joiner.blocksync_reactor.inner.pipeline_stats
        check(windows and len(rec.labelled.get("coalesced", [])) == len(windows)
              <= stats["dispatched"] + stats["predispatched"],
              f"12c: {len(windows)} joiner windows on the card, pipeline {stats}")
        launches["12c_joiner"] = {k: len(windows) for k in SOURCES}
        out["join"] = {"heights": target, "wall_s": wall, "evidence_blocks": b["evidence_blocks"],
                       "misbehavior_equal": True, "tickets": len(tickets), "joiner_windows": len(windows),
                       "joiner_window_lanes": [n for _, _, n, _, _ in windows],
                       "joiner_pipeline": dict(stats),
                       "ticket_labels": sorted({t[0] for t in tickets}),
                       "loop_errors": joiner.parts.cs.loop_errors.count + joiner.blocksync_reactor.inner.loop_errors.count,
                       "launches": launches["12c"], "joiner_launches": launches["12c_joiner"]}
        check(out["join"]["loop_errors"] == 0, f"12c: {out['join']['loop_errors']} loop errors")
        emit("evidence_join", **out["join"])
    finally:
        batch.set_min_device_batch(floor)
        log.set_level("info")
        for n in nodes:
            loop.run_until_complete(n.stop())
        loop.close()
        S.set_scheduler(None)
        sched.close()
        shutil.rmtree(root, ignore_errors=True)
    return launches, ev_items


# --- phase 13: RPC and the light serving plane ----------------------------------


class MemoProvider:
    """utils.chaingen.RotatingLightProvider with every height minted
    once (thread-safe): the passes of 13a pay the signing once, as
    bench.py::bench_serve's provider does."""

    def __init__(self, inner):
        import threading

        self.inner = inner
        self.chain_id = inner.chain_id
        self._memo: dict = {}
        self._lock = threading.Lock()
        self.minted = 0
        self.mint_s = 0.0

    def light_block(self, height):
        with self._lock:
            lb = self._memo.get(height)
        if lb is None:
            t = time.perf_counter()
            lb = self.inner.light_block(height)
            with self._lock:
                lb = self._memo.setdefault(height, lb)
                self.minted += 1
                self.mint_s += time.perf_counter() - t
        return lb

    def report_evidence(self, ev):
        self.inner.report_evidence(ev)


def _rank(values, q):
    """The nearest-rank q-quantile of ``values``."""
    values = sorted(values)
    return values[max(0, math.ceil(q * len(values)) - 1)]


def _pcts(lat) -> dict:
    return {"p50_ms": _rank(lat, 0.50), "p99_ms": _rank(lat, 0.99)}


def _storm(schedule, serve_one, workers):
    """Run ``serve_one(height)`` for every entry of ``schedule`` on
    ``workers`` threads: (blocks by session, latencies ms, wall s)."""
    import concurrent.futures

    got, lat = [None] * len(schedule), [0.0] * len(schedule)

    def one(i):
        t = time.perf_counter()
        got[i] = serve_one(schedule[i])
        lat[i] = (time.perf_counter() - t) * 1e3

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(workers) as ex:
        for f in [ex.submit(one, i) for i in range(len(schedule))]:
            f.result()
    return got, lat, time.perf_counter() - t0


def _pass_line(lat, wall) -> dict:
    return {"sessions": len(lat), "sessions_per_s": len(lat) / wall, **_pcts(lat), "wall_s": wall}


def engine_parity(dev, lb) -> dict:
    """The serving engine's verdicts against serial verify_commit_light
    / verify_commit_light_trusting on ``lb``'s commit, valid and forged:
    one bad signature among the first 100 lanes, a commit under 2/3
    (light) and one under 1/3 (trusting). Fails unless equal; the six
    jobs must be one coalesced dispatch."""
    import dataclasses
    import threading
    from fractions import Fraction

    from cometbft_tpu_torch.light.serving import CoalescedCommitVerifier
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.types.block import CommitSig

    vals, commit, h = lb.validator_set, lb.commit, lb.height
    sigs = list(commit.signatures)
    bad = sigs[SERVE_FORGED_LANE]
    forged = dataclasses.replace(commit, signatures=sigs[:SERVE_FORGED_LANE] + [
        dataclasses.replace(bad, signature=bytes([bad.signature[0] ^ 1]) + bad.signature[1:])]
        + sigs[SERVE_FORGED_LANE + 1:])

    def signed_by(n):
        return dataclasses.replace(commit, signatures=sigs[:n] + [CommitSig.absent()] * (len(sigs) - n))

    third = Fraction(1, 3)
    jobs = [("light", vals, commit.block_id, h, commit),
            ("light", vals, commit.block_id, h, forged),
            ("light", vals, commit.block_id, h, signed_by(len(sigs) * 3 // 5)),
            ("trusting", vals, commit, third),
            ("trusting", vals, forged, third),
            ("trusting", vals, signed_by(len(sigs) * 4 // 15), third)]

    def name(e):
        return None if e is None else (type(e).__name__, str(e))

    serial = []
    for job in jobs:
        try:
            if job[0] == "light":
                V.verify_commit_light(lb.header.chain_id, *job[1:], device=dev)
            else:
                V.verify_commit_light_trusting(lb.header.chain_id, job[1], job[2], trust_level=job[3],
                                               device=dev)
            serial.append(None)
        except V.CommitVerifyError as e:
            serial.append(name(e))
    engine = CoalescedCommitVerifier(lb.header.chain_id, window_s=0.05, device=dev)
    coalesced = [None] * len(jobs)
    other = []

    def submit(i, job):
        try:
            if job[0] == "light":
                engine.verify_commit_light(*job[1:])
            else:
                engine.verify_commit_light_trusting(*job[1:])
        except V.CommitVerifyError as e:
            coalesced[i] = name(e)
        except Exception as e:  # anything else is a failure of the check
            other.append(repr(e))

    threads = [threading.Thread(target=submit, args=(i, j)) for i, j in enumerate(jobs)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    check(not other, f"engine parity: {other}")
    check(coalesced == serial, f"engine parity: coalesced {coalesced} != serial {serial}")
    check(serial[0] is None and serial[3] is None and all(serial[i] for i in (1, 2, 4, 5)),
          f"engine parity: the forged commits were not refused: {serial}")
    check(engine.dispatches == 1, f"engine parity: {engine.dispatches} dispatches, want 1")
    return {"verdicts": [None if v is None else v[0] for v in serial], "dispatches": engine.dispatches,
            "jobs": len(jobs)}


def phase_serving(dev):
    """13a: BASELINE config 4's chain served to SERVE_SESSIONS light
    sessions: a per-request pass (one fresh Client for each distinct
    height: the reference blocks), a cold pass on a fresh
    LightServingPlane and a warm pass on the same plane, the device
    route pinned; the engine's verdicts against the serial checks on
    the card and on the plain kernels. Returns the plane passes'
    launches and the kernel items of the widest light ticket."""
    import numpy as np

    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.light import Client, LightServingPlane, TrustOptions
    from cometbft_tpu_torch.utils.chaingen import RotatingLightProvider

    keys = bisect_keys()
    t0_ns = time.time_ns() - (BISECT_TARGET + 120) * 1_000_000_000
    provider = MemoProvider(RotatingLightProvider("bench-chain", keys, BISECT_VALS, BISECT_EPOCH,
                                                  BISECT_SHIFT, t0_ns))
    root = provider.light_block(1)
    trust = TrustOptions(10 * 365 * 86400 * 10**9, 1, root.hash())
    rng = np.random.default_rng(SERVE_SEED)
    distinct = sorted(int(x) for x in rng.choice(np.arange(BISECT_TARGET // 2, BISECT_TARGET),
                                                 size=SERVE_DISTINCT, replace=False))
    schedule = [distinct[i % SERVE_DISTINCT] for i in range(SERVE_SESSIONS)]
    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)
    out = {}
    t_phase = time.perf_counter()
    try:
        batch.set_min_device_batch(1)
        # the per-request pass: a fresh client for each distinct height
        per_client, lat, wall = _storm(
            distinct, lambda h: Client("bench-chain", trust, provider, device=dev)
            .verify_light_block_at_height(h), SERVE_WORKERS)
        ref = {lb.height: lb for lb in per_client}
        check(sorted(ref) == distinct, "per-request pass: a height was not served")
        out["per_request"] = {**_pass_line(lat, wall), "minted": provider.minted, "mint_s": provider.mint_s}

        # the plane: its clients' trust roots are checked before it
        # exists (catch-up tickets); from there on every ticket is the
        # plane's
        clients = [Client("bench-chain", trust, provider, device=dev) for _ in range(SERVE_POOL)]
        plane = LightServingPlane(clients, max_sessions=SERVE_SESSIONS + SERVE_WORKERS,
                                  max_inflight=SERVE_WORKERS, device=dev)

        def serve_one(h):
            with plane.open_session() as s:
                return s.verified_block(h)

        minted = provider.minted
        before = sched.stats()
        kernels.reset_counts()
        with Recorder(sched) as rec:
            cold, lat_c, wall_c = _storm(schedule, serve_one, SERVE_WORKERS)
            cache_cold = plane.cache.stats()
            warm, lat_w, wall_w = _storm(schedule, serve_one, SERVE_WORKERS)
        launches = dict(kernels.LAUNCHES)
        after = sched.stats()
        tickets = rec.rows()
        moved = {k: after[k] - before[k] for k in ("device_dispatches", "host_chunks", "degraded")}
        by_class = {k: after["by_class"][k] - before["by_class"][k] for k in after["by_class"]}
        for what, got in (("cold", cold), ("warm", warm)):
            bad = [h for h, lb in zip(schedule, got) if lb.hash() != ref[h].hash()]
            check(not bad, f"13a {what}: served blocks differ from the per-request pass at {bad[:5]}")
        check(tickets and all(p == S.PRIORITY_LIGHT and r == "device" for _, p, _, r, _ in tickets),
              f"13a: a plane ticket left the light class or the card: "
              f"{sorted({(p, r) for _, p, _, r, _ in tickets})}")
        check(moved == {"device_dispatches": len(tickets), "host_chunks": 0, "degraded": 0},
              f"13a: scheduler {moved} against {len(tickets)} tickets")
        check(all(launches[k] == len(tickets) == len(rec.dispatches) for k in SOURCES),
              f"13a: launches {launches} against {len(tickets)} light tickets")
        check(all(d["device"] == str(dev) and all(d["launches"][k] == 1 for k in SOURCES)
                  for d in rec.dispatches), "13a: a dispatch did not launch each kernel once")
        stats = plane.stats()
        check(stats["requests_shed"] == 0 and stats["sessions_shed"] == 0, f"13a: shed {stats}")
        jobs = rec.labelled.get("jobs", [])
        widest = max(jobs, key=len)
        out["cold"] = _pass_line(lat_c, wall_c)
        out["warm"] = _pass_line(lat_w, wall_w)
        out["plane"] = {
            "coalesce": stats["coalesce"], "cache_after_cold": cache_cold, "cache": stats["cache"],
            "light_ticket_lanes": [n for _, _, n, _, _ in tickets],
            "ticket_walls": ticket_walls([(n, r, w) for _, _, n, r, w in tickets]),
            "tickets_by_class": {name: sum(t[1] == c for t in tickets) for c, name in enumerate(S.CLASS_NAMES)},
            "lanes_by_class": by_class, "scheduler": moved, "minted_in_plane_passes":
            provider.minted - minted, "verifier_pool": SERVE_POOL,
        }

        # the engine's verdicts against the serial checks, on the card
        # and on the plain kernels
        lb = ref[distinct[0]]
        out["engine_parity"] = {"card": engine_parity(dev, lb)}
        with PlainKernels():
            out["engine_parity"]["plain"] = engine_parity(dev, lb)
        check(out["engine_parity"]["card"] == out["engine_parity"]["plain"], "13a: card and plain verdicts differ")
    finally:
        batch.set_min_device_batch(floor)
        S.set_scheduler(None)
        sched.close()
    emit("serving_storm", validators=BISECT_VALS, target=BISECT_TARGET, distinct=SERVE_DISTINCT,
         sessions=SERVE_SESSIONS, workers=SERVE_WORKERS, route="device (pinned)", launches=launches,
         seconds=time.perf_counter() - t_phase, **out)
    return launches, widest


async def _rpc_calls(cli, walls, route, **params):
    """One JSON-RPC call, its wall kept by route."""
    t = time.perf_counter()
    res = await cli.call(route, **params)
    walls.setdefault(route, []).append(time.perf_counter() - t)
    return res


def _wall_lines(walls) -> dict:
    return {r: {"calls": len(w), "median_ms": statistics.median(w) * 1e3, "p99_ms": _rank(w, 0.99) * 1e3}
            for r, w in sorted(walls.items())}


def phase_rpc(dev, gen, privs, snapshot, top):
    """13b: a 4-validator TCP net with rpc.laddr on every node (kvstore
    with prove=True, the kv indexer): txs over HTTP, a websocket
    subscriber, verified queries and a light-client attack through
    broadcast_evidence. 13c: two Nodes serving phase 8's corpus over
    RPC to a port Client (HTTPProvider primary and witness) behind a
    LightProxy over a LightServingPlane. Returns both launches and
    the kernel items of one of 13c's light tickets."""
    import asyncio
    import base64
    import hashlib
    import shutil

    import aiohttp
    import numpy as np

    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.abci.types import MISBEHAVIOR_LIGHT_CLIENT_ATTACK
    from cometbft_tpu_torch.config.config import test_config
    from cometbft_tpu_torch.crypto import batch, merkle
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.light import Client, LightServingPlane, TrustOptions
    from cometbft_tpu_torch.light.http_provider import HTTPProvider
    from cometbft_tpu_torch.light.proxy import LightProxy
    from cometbft_tpu_torch.models.kvstore import KVStoreApplication
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.rpc.client import HTTPClient
    from cometbft_tpu_torch.types import validation as V
    from cometbft_tpu_torch.types.block import tx_hash
    from cometbft_tpu_torch.utils import chaingen, codec, log

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "rpc")
    shutil.rmtree(root, ignore_errors=True)
    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)
    log.set_level("consensus:error,p2p:error,blocksync:error,*:info")
    loop = asyncio.new_event_loop()
    nodes, clients = [], []
    launches = {}

    async def until(cond, what, timeout=NET_DEADLINE_S, poll=0.01):
        deadline = asyncio.get_running_loop().time() + timeout
        while not cond():
            check(asyncio.get_running_loop().time() < deadline, f"timed out: {what}")
            await asyncio.sleep(poll)

    def config(home, moniker, **kw):
        cfg = test_config(home)
        cfg.base.moniker = moniker
        cfg.blocksync.enable = False
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        for k, v in kw.items():
            sec, _, name = k.partition("__")
            setattr(getattr(cfg, sec), name, v)
        return cfg

    async def net():
        g4, k4 = make_genesis(NET_VALS, chain_id="smoke-rpc", seed=SEED)
        pv_root = os.path.join(root, "pv")
        os.makedirs(pv_root)
        pvs = make_privvals(k4, root=pv_root)
        net_nodes = [Node(config(".", f"rpc{i}", tx_index__indexer="kv"), g4, privval=pv,
                          app=KVStoreApplication(prove=True), device=dev) for i, pv in enumerate(pvs)]
        nodes.extend(net_nodes)
        for n in net_nodes:
            await n.start()
        cli = [HTTPClient(n.rpc_server.listen_addr) for n in net_nodes]
        clients.extend(cli)
        # one websocket subscriber on NewBlock, open through the run
        # from before the first block (no height commits before the
        # mesh: each validator holds a quarter of the power)
        frames, arrived = [], []
        events = await cli[0].subscribe("tm.event='NewBlock'")

        async def read():
            async for e in events:
                frames.append(int(e["data"]["value"]["block"]["header"]["height"]))
                arrived.append(time.perf_counter())

        reader = asyncio.ensure_future(read())
        try:
            return await net_body(g4, k4, net_nodes, cli, frames, arrived)
        finally:
            # the subscriber and the clients go before the servers do
            reader.cancel()
            await asyncio.gather(reader, return_exceptions=True)
            for c in cli:
                await c.close()
                clients.remove(c)
            for n in net_nodes:
                await n.stop()
                nodes.remove(n)

    async def net_body(g4, k4, net_nodes, cli, frames, arrived):
        for i, a in enumerate(net_nodes):
            for b in net_nodes[i + 1:]:
                await a.dial(b.listen_addr)
        await until(lambda: all(n.switch.num_peers() == NET_VALS - 1 for n in net_nodes), "the full mesh")
        walls: dict = {}
        txs = [b"rpc%03d=v%03d" % (i, i) for i in range(RPC_TXS)]
        t0 = time.perf_counter()

        async def send(i, tx):
            c = cli[i % NET_VALS]
            if i < RPC_TXS - RPC_COMMIT_TXS:
                r = await _rpc_calls(c, walls, "broadcast_tx_sync", tx=base64.b64encode(tx).decode())
                check(r["code"] == 0, f"13b: broadcast_tx_sync refused {tx!r}: {r}")
            else:
                r = await _rpc_calls(c, walls, "broadcast_tx_commit", tx=base64.b64encode(tx).decode())
                check(r["check_tx"]["code"] == 0 and r["tx_result"]["code"] == 0 and int(r["height"]) > 0,
                      f"13b: broadcast_tx_commit {r}")

        await asyncio.gather(*(send(i, tx) for i, tx in enumerate(txs)))
        hashes = {tx_hash(tx): tx for tx in txs}

        def committed():
            got = [t for h in range(1, net_nodes[0].height + 1)
                   for t in net_nodes[0].parts.block_store.load_block(h).data.txs]
            return len(set(got) & set(txs)) == len(txs)

        await until(committed, "every tx committed")
        tx_wall = time.perf_counter() - t0
        top4 = net_nodes[0].height
        got = [t for h in range(1, top4 + 1) for t in net_nodes[0].parts.block_store.load_block(h).data.txs]
        counts = {tx: got.count(tx) for tx in txs}
        check(all(c == 1 for c in counts.values()), f"13b: txs committed {sorted(set(counts.values()))} times")
        # queries: every tx by hash with its proof, tx_search by height,
        # block_search, status, validators, commit
        by_height: dict = {}
        for h_, tx in hashes.items():
            r = await _rpc_calls(cli[1], walls, "tx", hash=h_.hex(), prove=True)
            check(base64.b64decode(r["tx"]) == tx, f"13b: tx {h_.hex()} answered another tx")
            height = int(r["height"])
            blk = net_nodes[0].parts.block_store.load_block(height)
            p = merkle.decode_proof(base64.b64decode(r["proof"]["proof_b64"]))
            check(bytes.fromhex(r["proof"]["root_hash"]) == blk.header.data_hash
                  and p.verify(blk.header.data_hash, h_), f"13b: tx {h_.hex()}: proof does not verify")
            by_height.setdefault(height, set()).add(tx)
        for height, want in sorted(by_height.items()):
            found, page = set(), 1
            while len(found) < len(want):  # pages of at most 100 (the route's cap)
                r = await _rpc_calls(cli[2], walls, "tx_search", query=f"tx.height={height}",
                                     per_page="100", page=str(page))
                check(r["txs"] and int(r["total_count"]) == len(want), f"13b: tx_search at {height}, page {page}")
                found |= {base64.b64decode(t["tx"]) for t in r["txs"]}
                page += 1
            check(found == want, f"13b: tx_search at {height}")
            r = await _rpc_calls(cli[3], walls, "block_search", query=f"block.height={height}")
            check([int(b["block"]["header"]["height"]) for b in r["blocks"]] == [height],
                  f"13b: block_search at {height}")
        st = await _rpc_calls(cli[0], walls, "status")
        check(int(st["sync_info"]["latest_block_height"]) >= top4, "13b: status behind")
        # abci_query(prove=True) on RPC_QUERY_KEYS keys, each proof held
        # against the app hash of the height after, whose commit is
        # verified on the card
        for i in range(RPC_QUERY_KEYS):
            key = b"rpc%03d" % (i * (RPC_TXS // RPC_QUERY_KEYS))
            r = await _rpc_calls(cli[i % NET_VALS], walls, "abci_query", path="/store", data=key.hex(),
                                 prove=True)
            resp = r["response"]
            hq = int(resp["height"])
            await until(lambda: net_nodes[0].height > hq, f"height {hq + 1}")
            cm = await _rpc_calls(cli[0], walls, "commit", height=str(hq + 1))
            vs = await _rpc_calls(cli[0], walls, "validators", height=str(hq + 1))
            hdr = codec.decode_header(base64.b64decode(cm["header_b64"]))
            commit = codec.decode_commit(base64.b64decode(cm["commit_b64"]))
            vals = codec.decode_validator_set(base64.b64decode(vs["validator_set_b64"]))
            check(vals.hash() == hdr.validators_hash, "13b: validators do not match the header")
            await asyncio.to_thread(V.verify_commit_light, g4.chain_id, vals, commit.block_id, hq + 1, commit,
                                    device=dev)
            merkle.ProofRuntime().verify_value(merkle.decode_proof_ops(base64.b64decode(resp["proof_ops"])),
                                               hdr.app_hash, key, base64.b64decode(resp["value"]))
        # a light-client attack (a lunatic fork signed by two keys)
        # handed to node 1 over RPC
        fork = chaingen.conflicting_block(net_nodes[0].parts, k4, NET_EV_ATTACK_AT, signers=k4[2:])
        lca = chaingen.light_attack(net_nodes[0].parts, fork, NET_EV_ATTACK_AT - 1)
        ev_at = net_nodes[1].height
        t_ev = time.perf_counter()
        await _rpc_calls(cli[1], walls, "broadcast_evidence", evidence=base64.b64encode(lca.encode()).decode())
        addrs = [p.pub_key().address() for p in k4[2:]]

        def recorded(n):
            return [r for r in n.parts.app.misbehavior_seen
                    if r[1] == MISBEHAVIOR_LIGHT_CLIENT_ATTACK and r[4] == lca.common_height]

        await until(lambda: all(len(recorded(n)) == len(addrs) for n in net_nodes), "the attack at every app")
        ev_wall = time.perf_counter() - t_ev
        ev_block = recorded(net_nodes[0])[0][0]
        check(1 <= ev_block - ev_at <= 3, f"13b: the evidence committed {ev_block - ev_at} heights after")
        check(all(recorded(n) == recorded(net_nodes[0]) for n in net_nodes), "13b: nodes recorded it differently")
        await until(lambda: net_nodes[0].height > ev_block and frames and frames[-1] >= ev_block,
                    "the subscriber at the evidence block")
        last = net_nodes[0].height
        for hh in range(1, last):
            check(len({n.block_id_hash_at(hh) for n in net_nodes if n.height >= hh}) == 1,
                  f"13b: nodes differ at {hh}")
        check(frames == list(range(1, frames[-1] + 1)),
              f"13b: the subscriber saw {frames[:3]}...{frames[-3:]}")
        # a height's wall: between two NewBlock frames at the subscriber
        height_walls = [b - a for a, b in zip(arrived, arrived[1:])]
        return {"validators": NET_VALS, "txs": RPC_TXS, "tx_commit": RPC_COMMIT_TXS, "tx_wall_s": tx_wall,
                "heights": last, "height_wall_median_s": statistics.median(height_walls),
                "rpc_walls": _wall_lines(walls), "ws_frames": len(frames),
                "ws_heights": [frames[0], frames[-1]], "proved_queries": RPC_QUERY_KEYS,
                "evidence": {"handed_at_height": ev_at, "committed_in_block": ev_block,
                             "heights": ev_block - ev_at, "wall_s": ev_wall, "byzantine": len(addrs)},
                "loop_errors": sum(n.parts.cs.loop_errors.count for n in net_nodes)}

    async def light():
        homes = [os.path.join(root, f"serve{i}") for i in range(2)]
        serving = []
        for i, home in enumerate(homes):
            _sqlite_home(home, snapshot)
            n = Node(config(home, f"serve{i}", base__db_backend="sqlite"), gen, home=home, device=dev)
            nodes.append(n)
            await n.start()
            serving.append(n)
        src = serving[0].parts
        addrs = [n.rpc_server.listen_addr for n in serving]
        primary, witness = HTTPProvider(gen.chain_id, addrs[0]), HTTPProvider(gen.chain_id, addrs[1])
        # the trust root from the corpus itself
        root_hash = src.block_store.load_block_meta(1).header.hash()
        client = await asyncio.to_thread(
            Client, gen.chain_id, TrustOptions(10 * 365 * 86400 * 10**9, 1, root_hash), primary,
            witnesses=[witness], device=dev)
        plane = LightServingPlane([client], max_sessions=4 * LIGHT_REQUESTS, max_inflight=LIGHT_REQUESTS,
                                  device=dev)
        proxy = LightProxy(client, addrs[0], plane=plane)
        await proxy.start("127.0.0.1:0")
        rng = np.random.default_rng(SEED)
        heights = sorted(int(x) for x in rng.choice(np.arange(2, min(top, 1025)), LIGHT_HEIGHTS,
                                                    replace=False))
        walls: dict = {}
        kernels.reset_counts()
        try:
            with Recorder(sched) as rec:
                async with aiohttp.ClientSession(connector=aiohttp.TCPConnector(limit=0)) as sess:
                    async def get(route, **params):
                        t = time.perf_counter()
                        async with sess.get(f"http://{proxy.listen_addr}/{route}", params=params) as r:
                            body = await r.json()
                        walls.setdefault(route, []).append(time.perf_counter() - t)
                        check("result" in body and body["result"].get("verified") is True,
                              f"13c: /{route} {params}: {body.get('error')}")
                        return body["result"]

                    t0 = time.perf_counter()
                    hdrs = await asyncio.gather(*(get("header", height=str(heights[i % LIGHT_HEIGHTS]))
                                                  for i in range(LIGHT_REQUESTS)))
                    header_wall = time.perf_counter() - t0
                    for i, r in enumerate(hdrs):
                        h = heights[i % LIGHT_HEIGHTS]
                        check(base64.b64decode(r["header_b64"]) == codec.encode_header(src.block_store.load_block(h).header),
                              f"13c: header {h} differs from the corpus")
                    for h in heights:
                        blk = src.block_store.load_block(h)
                        cm = await get("commit", height=str(h))
                        check(base64.b64decode(cm["commit_b64"]) == codec.encode_commit(
                            src.block_store.load_block_commit(h) or src.block_store.load_seen_commit(h)),
                            f"13c: commit {h}")
                        vs = await get("validators", height=str(h))
                        check(base64.b64decode(vs["validator_set_b64"])
                              == codec.encode_validator_set(src.state_store.load_validators(h)), f"13c: validators {h}")
                        b = await get("block", height=str(h))
                        check(base64.b64decode(b["block_b64"]) == codec.encode_block(blk), f"13c: block {h}")
                        tx = blk.data.txs[0]
                        t = await get("tx", hash="0x" + hashlib.sha256(tx).hexdigest())
                        check(base64.b64decode(t["tx"]) == tx and int(t["height"]) == h, f"13c: tx at {h}")
                    async with sess.get(f"http://{proxy.listen_addr}/serving_status") as r:
                        status = (await r.json())["result"]
        finally:
            await proxy.stop()
            await asyncio.to_thread(primary.close)
            await asyncio.to_thread(witness.close)
        check(status["cache"]["hits"] > 0 and status["coalesce"] and status["coalesce"]["dispatches"] > 0,
              f"13c: serving_status {status}")
        tickets = rec.rows()
        lt = [t for t in tickets if t[1] == S.PRIORITY_LIGHT]
        check(lt and len(lt) == len(tickets) and all(r == "device" for _, _, _, r, _ in tickets),
              f"13c: tickets {sorted({(p, r) for _, p, _, r, _ in tickets})}: not all light on the card")
        for n in serving:
            await n.stop()
            nodes.remove(n)
        return {"requests": LIGHT_REQUESTS, "heights": heights, "header_wall_s": header_wall,
                "request_walls": _wall_lines(walls), "serving_status": status,
                "light_tickets": [{"lanes": n, "wall_ms": w * 1e3} for _, _, n, _, w in lt],
                "tickets_by_class": {name: sum(t[1] == c for t in tickets)
                                     for c, name in enumerate(S.CLASS_NAMES)}}, rec

    try:
        batch.set_min_device_batch(1)
        kernels.reset_counts()
        t_phase = time.perf_counter()
        with Recorder(sched) as rec:
            b = loop.run_until_complete(net())
        launches["13b"] = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        check(b["loop_errors"] == 0, f"13b: {b['loop_errors']} loop errors")
        check(tickets and all(r == "device" for _, _, _, r, _ in tickets), "13b: a ticket left the device route")
        check(all(launches["13b"][k] == len(rec.dispatches) == len(tickets) for k in SOURCES),
              f"13b: launches {launches['13b']} against {len(tickets)} tickets")
        emit("rpc_net", **b, tickets=len(tickets), ticket_labels=sorted({t[0] for t in tickets}),
             launches=launches["13b"], seconds=time.perf_counter() - t_phase)

        t_phase = time.perf_counter()
        c, rec = loop.run_until_complete(light())
        launches["13c"] = dict(kernels.LAUNCHES)
        n_tickets = len(rec.rows())
        check(all(launches["13c"][k] == n_tickets == len(rec.dispatches) for k in SOURCES),
              f"13c: launches {launches['13c']} against {n_tickets} tickets")
        emit("rpc_light", validators=REPLAY_VALS, **c, launches=launches["13c"],
             seconds=time.perf_counter() - t_phase)
        light_items = rec.labelled["jobs"][0]
    finally:
        batch.set_min_device_batch(floor)
        for cl in clients:
            loop.run_until_complete(cl.close())
        for n in nodes:
            loop.run_until_complete(n.stop())
        loop.close()
        log.set_level("info")
        S.set_scheduler(None)
        sched.close()
        shutil.rmtree(root, ignore_errors=True)
    return launches, light_items



# --- phase 14: statesync -------------------------------------------------------


def _kv_app_hash(height, state) -> bytes:
    """The kvstore's flat app hash, computed here from the pairs: SHA-256
    over the height and every (key, value), length-prefixed, in key
    order (models/kvstore.py, not called)."""
    import hashlib

    h = hashlib.sha256(height.to_bytes(8, "big"))
    for k in sorted(state):
        v = state[k]
        h.update(len(k).to_bytes(4, "big") + k + len(v).to_bytes(4, "big") + v)
    return h.digest()


def phase_statesync(dev, gen, privs):
    """Phase 14: a 150-validator chain of 544 heights x 256 txs minted
    with on-disk snapshots at 510 and 520, served by three source Nodes
    from sqlite copies (one of them corrupting every chunk it serves);
    (a) a fresh Node restores the newest snapshot by statesync and
    blocksyncs the tail, (b) the same with adaptive sync, (c) a joiner
    with its trust root inside the retained window restores from a
    source that prunes to its last 64 blocks. Returns the launches of
    (a), (b), (c) and, for phase 6, the kernel items of 14a's widest
    state-provider ticket and of its first tail window."""
    import asyncio
    import shutil
    from collections import Counter
    from contextlib import contextmanager

    from cometbft_tpu_torch import kernels
    from cometbft_tpu_torch.abci.types import RequestQuery
    from cometbft_tpu_torch.config.config import test_config
    from cometbft_tpu_torch.crypto import batch
    from cometbft_tpu_torch.crypto import scheduler as S
    from cometbft_tpu_torch.models.kvstore import KVStoreApplication
    from cometbft_tpu_torch.node.inprocess import build_node
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.rpc.client import HTTPClient, RPCClientError
    from cometbft_tpu_torch.statesync.snapshots import SnapshotStore
    from cometbft_tpu_torch.utils import chaingen, log

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", "statesync")
    shutil.rmtree(root, ignore_errors=True)
    floor = batch._MIN_DEVICE_BATCH
    sched = S.VerifyScheduler()
    S.set_scheduler(sched)
    log.set_level("consensus:error,p2p:error,blocksync:error,statesync:error,*:info")
    loop = asyncio.new_event_loop()
    nodes, clients = [], []
    launches, items = {}, {}

    # the corpus: snapshots on disk at 510 and 520 only (the app writes
    # through the store while it is attached), so the newest leaves a
    # 24-height tail
    t0 = time.perf_counter()
    mint = os.path.join(root, "mint")
    app = KVStoreApplication(chunk_hashes=True)
    mint_cfg = test_config(mint)
    mint_cfg.base.db_backend = "sqlite"
    mint_cfg.tx_index.indexer = "null"
    src = build_node(gen, app=app, config=mint_cfg, home=mint, device=dev)
    src_rows: dict = {}
    _record_states(src, src_rows)
    chaingen.make_chain(gen, privs, SS_SNAPSHOTS[0] - 10, txs_per_block=SS_TXS, node=src)
    app.snapshot_store = SnapshotStore(os.path.join(mint, "snapshots"), keep_recent=2)
    chaingen.make_chain(gen, privs, SS_SNAPSHOTS[-1] - SS_SNAPSHOTS[0] + 10, txs_per_block=SS_TXS, node=src)
    check(app.snapshot_store.heights() == list(SS_SNAPSHOTS), f"14: snapshots {app.snapshot_store.heights()}")
    app.snapshot_store = None
    chaingen.make_chain(gen, privs, SS_BLOCKS - SS_SNAPSHOTS[-1], txs_per_block=SS_TXS, node=src)
    app.persist_path = os.path.join(mint, "app_state.json")
    app._persist()
    top = src.block_store.height()
    check(top == SS_BLOCKS and len(app.state) == SS_BLOCKS * SS_TXS, f"14: corpus at {top}, {len(app.state)} keys")
    snap = SnapshotStore(os.path.join(mint, "snapshots")).list_snapshots()[-1]
    blob_bytes = sum(len(SnapshotStore(os.path.join(mint, "snapshots")).load_chunk(snap.height, 1, i))
                     for i in range(snap.chunks))
    src.close_stores()
    emit("statesync_corpus", validators=len(gen.validators), blocks=top, txs_per_block=SS_TXS,
         keys=len(app.state), snapshots=list(SS_SNAPSHOTS), snapshot_bytes=blob_bytes,
         snapshot_chunks=snap.chunks, chunk_size=KVStoreApplication.SNAPSHOT_CHUNK,
         seconds=time.perf_counter() - t0)
    final_pairs = dict(app.state)
    del app

    def config(home, moniker, **kw):
        cfg = test_config(home)
        cfg.base.moniker = moniker
        cfg.blocksync.enable = False
        cfg.rpc.laddr = "tcp://127.0.0.1:0"
        for k, v in kw.items():
            sec, _, name = k.partition("__")
            setattr(getattr(cfg, sec), name, v)
        return cfg

    async def until(cond, what, timeout=SS_DEADLINE_S, poll=0.01):
        deadline = asyncio.get_running_loop().time() + timeout
        while not cond():
            check(asyncio.get_running_loop().time() < deadline, f"timed out: {what}")
            await asyncio.sleep(poll)

    async def source(i, **kw):
        home = os.path.join(root, f"src{i}")
        shutil.copytree(mint, home)
        n = Node(config(home, f"src{i}", base__db_backend="sqlite", tx_index__indexer="null",
                        storage__snapshot_interval=10, **kw), gen, home=home, device=dev)
        nodes.append(n)
        await n.start()
        check(n.height == top and n.parts.app.height == top, f"14: source {i} at {n.height}")
        return n

    def corrupting(n):
        """Every chunk ``n`` serves has its first byte flipped."""
        real = n.parts.app.load_snapshot_chunk
        served = Counter()

        def load(height, format_, index):
            chunk = real(height, format_, index)
            served[height] += 1
            return bytes([chunk[0] ^ 0xFF]) + chunk[1:] if chunk else chunk

        n.parts.app.load_snapshot_chunk = load
        return served

    async def join(name, servers, dial, trust_h, adaptive=False):
        """A fresh Node restoring by statesync from ``dial``, its app a
        checksumming kvstore (it reads the snapshot's chunk hashes, so a
        corrupt chunk bans its sender); returns its line, the Node and
        its recorder."""
        trust = servers[0].parts.block_store.load_block_meta(trust_h).header.hash()
        cfg = config(".", name, rpc__laddr="", blocksync__enable=True, blocksync__adaptive_sync=adaptive,
                     statesync__enable=True, statesync__trust_height=trust_h,
                     statesync__trust_hash=bytes(trust).hex(), statesync__discovery_time_s=30.0,
                     statesync__rpc_servers=[s.rpc_server.listen_addr for s in servers])
        j = Node(cfg, gen, app=KVStoreApplication(chunk_hashes=True), device=dev)
        nodes.append(j)
        rows, marks = {}, {}
        real_complete = j.parts.block_exec.apply_complete
        real_bootstrap = j.parts.state_store.bootstrap

        def complete(new_state, *rest):
            st = real_complete(new_state, *rest)
            rows[st.last_block_height] = _state_row(st)
            marks["last"] = time.perf_counter()
            return st

        def bootstrap(state):
            marks["restored"] = time.perf_counter()
            rows[state.last_block_height] = _state_row(state)
            marks["pairs"] = dict(j.parts.app.state)
            return real_bootstrap(state)

        j.parts.block_exec.apply_complete = complete
        j.parts.state_store.bootstrap = bootstrap
        kernels.reset_counts()
        with Recorder(sched) as rec:
            t_start = time.perf_counter()
            await j.start()
            for s in dial:
                await j.dial(s.listen_addr)
            await until(lambda: j.statesync_error is not None or (j.height >= top and "last" in marks),
                        f"{name}: the joiner at {top}")
            check(j.statesync_error is None, f"{name}: statesync failed: {j.statesync_error!r}")
        syncer = j.statesync_reactor.syncer
        ls = syncer.last_sync
        snap_h = ls["height"]
        check(snap_h == SS_SNAPSHOTS[-1], f"{name}: restored {snap_h}, not the newest snapshot")
        bs = j.parts.block_store
        check(bs.base() == snap_h + 1 > 1, f"{name}: block store base {bs.base()}")
        bad = [h for h in range(snap_h + 1, top + 1)
               if bs.load_block_meta(h).block_id != servers[0].parts.block_store.load_block_meta(h).block_id]
        check(not bad, f"{name}: block IDs differ at {bad[:5]}")
        bad = [h for h in range(snap_h, top + 1) if rows.get(h) != src_rows[h]]
        check(not bad, f"{name}: state differs from the source at {bad[:5]}")
        # the restored pairs, hashed here by the kvstore's rule, give the
        # app hash the light client certified (header snap_h + 1), and a
        # pre-snapshot key is among them
        certified = j.statesync_provider.client.store.get(snap_h + 1).header.app_hash
        pairs = marks["pairs"]
        check(len(pairs) == snap_h * SS_TXS >= SS_MIN_RESTORED_KEYS and pairs.get(b"h1_0") == b"v1",
              f"{name}: restored {len(pairs)} pairs")
        check(_kv_app_hash(snap_h, pairs) == certified == rows[snap_h][0], f"{name}: restored app hash")
        launch = dict(kernels.LAUNCHES)
        tickets = rec.rows()
        light = [t for t in tickets if t[0] in ("trusting", "light")]
        tail = [t for t in tickets if t[0] == "coalesced"]
        check(light and all(p == S.PRIORITY_CATCHUP and r == "device" for _, p, _, r, _ in light),
              f"{name}: state-provider tickets {[(l, p, r) for l, p, _, r, _ in light]}")
        check(tail and all(r == "device" for *_, r, _ in tail), f"{name}: tail windows off the card")
        check(all(launch[k] == len(rec.dispatches) == len(tickets) for k in SOURCES),
              f"{name}: launches {launch} against {len(tickets)} tickets")
        wall = marks["last"] - t_start
        restore = marks["restored"] - t_start
        line = {
            "snapshot_height": snap_h, "chunks": ls["chunks"], "bytes": ls["bytes"],
            "restored_keys": len(pairs), "keys": len(j.parts.app.state),
            "restore_wall_s": restore, "light_s": ls["light_s"], "chunks_s": ls["chunks_s"],
            "chunks_per_s": ls["chunks"] / ls["chunks_s"], "tail_s": marks["last"] - marks["restored"],
            "tail_blocks": top - snap_h, "wall_s": wall, "banned_peers": sorted(syncer.banned_peers),
            "provider_tickets": [{"label": lbl, "priority": S.CLASS_NAMES[p], "lanes": n, "wall_ms": w * 1e3}
                                 for lbl, p, n, _, w in light],
            "tail_tickets": [{"lanes": n, "wall_ms": w * 1e3} for _, _, n, _, w in tail],
            "header_cache": j.light_header_cache.stats() if j.light_header_cache is not None else None,
            "provider": j.statesync_provider.cache_stats(), "launches": launch,
        }
        return line, j, rec

    async def run():
        nonlocal launches, items
        srcs = [await source(i) for i in range(3)]
        served = corrupting(srcs[2])
        bad_id = srcs[2].node_info.node_id
        # 14a: statesync, then blocksync
        a, ja, rec = await join("ss-a", srcs[:2], srcs, 1)
        check(served[SS_SNAPSHOTS[-1]] >= 1 and a["banned_peers"] == [bad_id],
              f"14a: the corrupting source served {dict(served)}, banned {a['banned_peers']}")
        check(a["keys"] == SS_BLOCKS * SS_TXS and ja.parts.app.state == final_pairs, "14a: the app's pairs")
        q = ja.parts.app.query(RequestQuery(path="/store", data=b"h1_0"))
        check(q.code == 0 and q.value == b"v1", "14a: a pre-snapshot key")
        emit("statesync_restore", **a, seconds=a["wall_s"])
        launches["14a"] = a["launches"]
        provider = [x for lbl in ("trusting", "light") for x in rec.labelled.get(lbl, [])]
        items["provider"] = max(provider, key=len)
        items["tail"] = rec.labelled["coalesced"][0]
        await ja.stop()
        nodes.remove(ja)
        # 14b: the same into adaptive sync
        b, jb, _ = await join("ss-b", srcs[:2], srcs, 1, adaptive=True)
        check(jb._cs_started and b["banned_peers"] == [bad_id],
              f"14b: consensus {jb._cs_started}, banned {b['banned_peers']}")
        emit("statesync_adaptive", **b, seconds=b["wall_s"])
        launches["14b"] = b["launches"]
        await jb.stop()
        nodes.remove(jb)
        # 14c: from a source that prunes to its last 64 blocks
        pruned = await source(3, storage__retain_blocks=SS_RETAIN, storage__prune_interval_s=0.2)
        ret = pruned.parts.retention
        await until(lambda: pruned.parts.block_store.base() >= top - SS_RETAIN, "14c: the source's prune")
        base = pruned.parts.block_store.base()
        cli = HTTPClient(pruned.rpc_server.listen_addr)
        clients.append(cli)
        try:
            await cli.call("block", height=str(base - 1))
            check(False, "14c: a pruned block was served")
        except RPCClientError as e:
            check(json.loads(e.data) == {"pruned": True, "base": str(base)}, f"14c: pruned error {e.data}")
            pruned_error = {"code": e.code, "message": e.message, "data": e.data}
        real_serving = ret.serving
        serves = Counter()

        @contextmanager
        def serving(height):
            serves[height] += 1
            with real_serving(height):
                serves["floor_seen"] = min(serves.get("floor_seen") or height, ret._serve_floor())
                yield

        ret.serving = serving
        c, jc, _ = await join("ss-c", [pruned, srcs[1]], [pruned], SS_TRUST_IN_WINDOW)
        reconciles = ret.reconciles
        check(serves[SS_SNAPSHOTS[-1]] == c["chunks"] and serves["floor_seen"] == SS_SNAPSHOTS[-1],
              f"14c: serves {dict(serves)}")
        emit("statesync_pruned", **c, source_base=base, retain_blocks=SS_RETAIN, pruned_error=pruned_error,
             serve_floor=serves["floor_seen"], chunks_served=serves[SS_SNAPSHOTS[-1]],
             retention=ret.stats(), reconciles=reconciles, seconds=c["wall_s"])
        launches["14c"] = c["launches"]

    try:
        batch.set_min_device_batch(1)
        t_phase = time.perf_counter()
        loop.run_until_complete(run())
        emit("statesync_phase", seconds=time.perf_counter() - t_phase)
    finally:
        batch.set_min_device_batch(floor)
        for cl in clients:
            loop.run_until_complete(cl.close())
        for n in nodes:
            loop.run_until_complete(n.stop())
        loop.close()
        log.set_level("info")
        S.set_scheduler(None)
        sched.close()
        shutil.rmtree(root, ignore_errors=True)
    return launches, items


def _wal_files(path):
    from cometbft_tpu_torch.consensus.wal import _group_files

    return _group_files(path)


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
    # a hang fails the run inside its time limit, with every thread's
    # stack on stderr
    faulthandler.dump_traceback_later(RUN_LIMIT_S, exit=True)
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
    replay_launches, replay_items, corpus = phase_replay(dev)
    bisect_launches, bisect_items = phase_bisect(dev)
    # phase 11 serves the corpus as phase 8 built it: phase 10 extends it
    gen, privs, src, src_rows = corpus
    net_corpus = (corpus_snapshot(src), src.block_store.height(), dict(src_rows))
    ingest_launches, live_launches, live_items, handoff_items = phase_consensus(dev, *corpus)
    net_launches, net_items = phase_network(dev, gen, privs, *net_corpus)
    evidence_launches, evidence_items = phase_evidence(dev, gen, privs, *net_corpus[:2])
    serve_launches_a, serve_widest = phase_serving(dev)
    serve_launches_bc, rpc_light_items = phase_rpc(dev, gen, privs, *net_corpus[:2])
    serve_launches = {"13a": serve_launches_a, **serve_launches_bc}
    ss_launches, ss_items = phase_statesync(dev, gen, privs)

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
    # phase 10's own inputs: a live prevote wave, the forged height's
    # precommit wave and the handoff's commit; timed at the prevote wave
    x_waves = {k: kernel_inputs(its, dev) for k, its in (*live_items.items(), ("handoff", handoff_items))}
    wave_calls = {k: stage_calls(xw) for k, xw in x_waves.items()}
    live_errs = {k: compare(c) for k, c in wave_calls.items()}
    x_live, live_calls = x_waves["prevote"], wave_calls["prevote"]
    # phase 11's own inputs: the first prevote wave received over the
    # wire and the forged height's precommit wave; timed at the prevote
    x_net = {k: kernel_inputs(its, dev) for k, its in net_items.items()}
    net_calls = {k: stage_calls(xn) for k, xn in x_net.items()}
    net_errs = {k: compare(c) for k, c in net_calls.items()}
    x_netp, netp_calls = x_net["prevote"], net_calls["prevote"]
    # phase 12's own inputs: the widest evidence tickets (12a's
    # equivocation fork, 150 lanes each); timed at the trusting check's
    x_ev = {k: kernel_inputs(its, dev) for k, its in evidence_items.items()}
    ev_calls = {k: stage_calls(xe) for k, xe in x_ev.items()}
    ev_errs = {k: compare(c) for k, c in ev_calls.items()}
    x_evt, evt_calls = x_ev["trusting"], ev_calls["trusting"]
    # phase 13's own inputs: 13a's widest light ticket (a coalesced
    # batch of the serving engine) and one of 13c's; timed at 13a's
    x_serve = {"13a_widest": kernel_inputs(serve_widest, dev), "13c": kernel_inputs(rpc_light_items, dev)}
    serve_calls = {k: stage_calls(xs) for k, xs in x_serve.items()}
    serve_errs = {k: compare(c) for k, c in serve_calls.items()}
    x_sw, sw_calls = x_serve["13a_widest"], serve_calls["13a_widest"]
    # phase 14's own inputs: 14a's widest state-provider ticket and its
    # first tail window; timed at the provider ticket
    x_ss = {k: kernel_inputs(its, dev) for k, its in ss_items.items()}
    ss_calls = {k: stage_calls(xs) for k, xs in x_ss.items()}
    ss_errs = {k: compare(c) for k, c in ss_calls.items()}
    x_ssp, ssp_calls = x_ss["provider"], ss_calls["provider"]
    emit("main_path_vs_plain", lanes=x["n"], commit_lanes=x_commit["n"],
         replay_lanes=list(x_replay), bisect_lanes=list(x_bisect),
         live_lanes={k: xw["n"] for k, xw in x_waves.items()},
         net_lanes={k: xn["n"] for k, xn in x_net.items()},
         evidence_lanes={k: xe["n"] for k, xe in x_ev.items()},
         serve_lanes={k: xs["n"] for k, xs in x_serve.items()},
         statesync_lanes={k: xs["n"] for k, xs in x_ss.items()}, equal=True, max_abs_err=errs,
         commit_max_abs_err=commit_errs, replay_max_abs_err=replay_errs,
         bisect_max_abs_err=bisect_errs, live_max_abs_err=live_errs, net_max_abs_err=net_errs,
         evidence_max_abs_err=ev_errs, serve_max_abs_err=serve_errs, statesync_max_abs_err=ss_errs)
    rows = []
    for name in ("ladder", "decompress", "hash_digits"):
        f, plain = calls[name]
        extra = occupancy(name)
        parts = (name, "straus") if name == "ladder" else (name,)
        replay_err = max(e[k] for e in replay_errs.values() for k in parts)
        bisect_err = max(e[k] for e in bisect_errs.values() for k in parts)
        live_err = {w: max(e[k] for k in parts) for w, e in live_errs.items()}
        net_err = {w: max(e[k] for k in parts) for w, e in net_errs.items()}
        ev_err = {w: max(e[k] for k in parts) for w, e in ev_errs.items()}
        serve_err = {w: max(e[k] for k in parts) for w, e in serve_errs.items()}
        ss_err = {w: max(e[k] for k in parts) for w, e in ss_errs.items()}
        err = max(max(errs[k], commit_errs[k]) for k in parts)
        b_ms, b_by = bound(name, x, int_rate)
        bc_ms, bc_by = bound(name, x_commit, int_rate)
        br_ms, br_by = bound(name, x_replay[n_wide], int_rate)
        bs_ms, bs_by = bound(name, x_bisect[b_wide], int_rate)
        bl_ms, bl_by = bound(name, x_live, int_rate)
        bn_ms, bn_by = bound(name, x_netp, int_rate)
        be_ms, be_by = bound(name, x_evt, int_rate)
        bsv_ms, bsv_by = bound(name, x_sw, int_rate)
        bss_ms, bss_by = bound(name, x_ssp, int_rate)
        bb_ms, bb_by = bound(name, x_bulk, int_rate)
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "pinned_launches": pinned[name], "replay_launches": replay_launches[name],
            "bisect_launches": bisect_launches[name],
            "ingest_launches": ingest_launches[name], "live_launches": live_launches[name],
            "net_launches": {ph: ls[name] for ph, ls in net_launches.items()},
            "evidence_launches": {ph: ls[name] for ph, ls in evidence_launches.items()},
            "serve_launches": {ph: ls[name] for ph, ls in serve_launches.items()},
            "statesync_launches": {ph: ls[name] for ph, ls in ss_launches.items()},
            "max_abs_err": max(err, replay_err, bisect_err, *live_err.values(), *net_err.values(),
                               *ev_err.values(), *serve_err.values(), *ss_err.values()),
            "tolerance": 0,
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
            "live_lanes": {w: xw["n"] for w, xw in x_waves.items()},
            "live_max_abs_err": live_err,
            "live_ms": graph_ms(live_calls[name][0]),
            "live_call_ms": cuda_ms(live_calls[name][0], 20),
            "live_plain_ms": cuda_ms(live_calls[name][1], 2, warm=0),
            "live_bound_ms": bl_ms, "live_bound_by": bl_by,
            "net_lanes": {w: xn["n"] for w, xn in x_net.items()},
            "net_max_abs_err": net_err,
            "net_ms": graph_ms(netp_calls[name][0]),
            "net_call_ms": cuda_ms(netp_calls[name][0], 20),
            "net_plain_ms": cuda_ms(netp_calls[name][1], 2, warm=0),
            "net_bound_ms": bn_ms, "net_bound_by": bn_by,
            "evidence_lanes": {w: xe["n"] for w, xe in x_ev.items()},
            "evidence_max_abs_err": ev_err,
            "evidence_ms": graph_ms(evt_calls[name][0]),
            "evidence_call_ms": cuda_ms(evt_calls[name][0], 20),
            "evidence_plain_ms": cuda_ms(evt_calls[name][1], 2, warm=0),
            "evidence_bound_ms": be_ms, "evidence_bound_by": be_by,
            "serve_lanes": {w: xs["n"] for w, xs in x_serve.items()},
            "serve_max_abs_err": serve_err,
            "serve_ms": graph_ms(sw_calls[name][0]),
            "serve_call_ms": cuda_ms(sw_calls[name][0], 20),
            "serve_plain_ms": cuda_ms(sw_calls[name][1], 2, warm=0),
            "serve_bound_ms": bsv_ms, "serve_bound_by": bsv_by,
            "statesync_lanes": {w: xs["n"] for w, xs in x_ss.items()},
            "statesync_max_abs_err": ss_err,
            "statesync_ms": graph_ms(ssp_calls[name][0]),
            "statesync_call_ms": cuda_ms(ssp_calls[name][0], 20),
            "statesync_plain_ms": cuda_ms(ssp_calls[name][1], 2, warm=0),
            "statesync_bound_ms": bss_ms, "statesync_bound_by": bss_by,
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
