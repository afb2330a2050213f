"""The port's tracing plane (cometbft_tpu_torch/trace) held to the JAX
package's: the cases of ``tests/test_trace.py``, on the port, and
parity cases.

1. Tracer core: preallocated ring reuse, the disabled fast path's
   overhead bound, span/instant/counter semantics and observers (which
   see completed spans only, as the JAX ones do), the shared NOOP
   tracer, the span→metrics bridge.
2. Export, summary and the CLI (``python -m cometbft_tpu_torch.trace``).
3. Live instrumentation: consensus height ⊇ round ⊇ step on a one-node
   ``LocalNet``, the host plane's chunk spans on the process tracer.
4. Cross-node timelines: clock-anchor rebase, per-height attribution,
   the timeline CLI, summaries by height, the stamp/correlate overhead
   bounds.
5. Parity: one event list through both packages' ``chrome_trace``,
   ``summarize``, ``summarize_by_height``, ``rebase`` and
   ``attribute_heights`` gives equal outputs, and the CLI prints the
   same text.
6. Off-loop writers: the verify scheduler's device watcher thread and
   the host plane's workers write the process ring while the loop
   writes it; the ring stays whole (one event per cursor value, every
   event well-formed).

7. The chaos-bound cases on the port's chaos harness (``device="cpu"``):
   a traced 4-node run exports a Perfetto-loadable dump whose every
   committed height is a complete attribution chain, and same-seed runs
   reproduce the attribution's structure.
"""

import asyncio
import io
import json
import threading
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from cometbft_tpu import trace as jtrace
from cometbft_tpu.trace.cli import main as jtrace_cli
from cometbft_tpu_torch.trace import (
    NOOP,
    SpanMetricsBridge,
    Tracer,
    attribute_heights,
    attribution_key,
    chrome_trace,
    format_waterfall,
    merge_events,
    percentile,
    read_jsonl,
    rebase,
    summarize,
    summarize_by_height,
    write_jsonl,
)
from cometbft_tpu_torch.trace.cli import main as trace_cli
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)


def run(coro, timeout=240):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --- 1. tracer core ------------------------------------------------------


def test_ring_reuses_slots_without_growing():
    t = Tracer("ring", size=16)
    # warm up: lap the ring once
    for i in range(16):
        t.instant(f"e{i}")
    slot_ids = {id(s) for s in t._ring}
    assert len(t._ring) == 16
    # three more laps: same slot objects, same ring length
    for i in range(48):
        t.instant("later", k=i)
    assert len(t._ring) == 16
    assert {id(s) for s in t._ring} == slot_ids
    ev = t.snapshot()
    assert len(ev) == 16
    # only the newest 16 events survive, in seq order
    assert [e["args"]["k"] for e in ev] == list(range(32, 48))
    st = t.stats()
    assert st["written"] == 64 and st["dropped"] == 48


def test_disabled_tracer_fast_path_overhead():
    """The disabled span() path must stay a near-free attribute check.
    The bound scales with a no-op-call baseline measured in the same
    conditions (plus an absolute backstop), so suite contention cannot
    flake it; a disabled path that started doing real work (ring
    writes, clock reads, object churn) blows the ratio regardless."""
    import gc

    t = Tracer("off", size=64, enabled=False)
    en = Tracer("on", size=1024)
    N = 50_000

    def per_call(fn):
        best = None
        for _ in range(7):
            t0 = time.perf_counter_ns()
            for _ in range(N):
                fn()
            dt = (time.perf_counter_ns() - t0) / N
            best = dt if best is None else min(best, dt)
        return best

    def noop():
        pass

    gc.disable()
    try:
        baseline = per_call(noop)
        bare = per_call(lambda: t.span("x"))
        kw = per_call(lambda: t.span("x", height=1, round=0))
        enabled = per_call(lambda: en.span("x", height=1).end())
    finally:
        gc.enable()
    assert bare < max(1500, 12 * baseline), f"disabled bare span() {bare:.0f}ns/call (baseline {baseline:.0f}ns)"
    assert kw < max(3000, 25 * baseline), f"disabled kwargs span() {kw:.0f}ns/call (baseline {baseline:.0f}ns)"
    # and strictly cheaper than a real (enabled) span cycle
    assert bare < enabled, (bare, enabled)
    # and it must be an actual no-op: nothing entered the ring
    assert t.snapshot() == []
    t.instant("x", a=1)
    t.counter("c", 1)
    assert t.snapshot() == []


def test_span_semantics_and_observer():
    t = Tracer("s", size=64)
    with t.span("outer", tid="tr", height=1) as sp:
        sp.set(extra=7)
        with t.span("inner", tid="tr"):
            pass
    # manual begin/end (the consensus step machine's usage)
    h = t.span("manual", tid="tr")
    h.end()
    h.end()  # idempotent: records exactly once
    ev = t.snapshot()
    assert [e["name"] for e in ev] == ["inner", "outer", "manual"]  # completion order
    outer, inner = ev[1], ev[0]
    assert outer["args"] == {"height": 1, "extra": 7}
    assert outer["ts_ns"] <= inner["ts_ns"]
    assert outer["ts_ns"] + outer["dur_ns"] >= inner["ts_ns"] + inner["dur_ns"]
    # observers see every completed span (and no instant or counter);
    # a raising observer is dropped without disturbing the hot path
    seen = []
    t.add_observer(lambda n, d, a: seen.append((n, a)))

    def bad(n, d, a):
        raise RuntimeError("boom")

    t.add_observer(bad)
    t.span("obs", k=2).end()
    t.span("obs2").end()
    t.instant("inst")
    t.counter("ctr", 3)
    assert ("obs", {"k": 2}) in seen and ("obs2", {}) in seen
    assert [n for n, _ in seen] == ["obs", "obs2"]
    assert bad not in t._observers


def test_noop_tracer_is_disabled_and_shared():
    assert not NOOP.enabled
    sp = NOOP.span("anything", height=1)
    with sp:
        sp.set(x=1)
    NOOP.instant("i")
    NOOP.counter("c", 1)
    assert NOOP.snapshot() == []


def test_metrics_bridge_routes_by_span_name():
    got = []
    b = SpanMetricsBridge()
    b.route("consensus.step", lambda dur_s, args: got.append((dur_s, args)))
    t = Tracer("b", size=8)
    t.add_observer(b)
    t.span("consensus.step", step="PROPOSE").end()
    t.span("unrouted").end()
    assert len(got) == 1
    dur_s, args = got[0]
    assert args["step"] == "PROPOSE" and dur_s >= 0


# --- 2. export / summary / CLI ------------------------------------------


def _sample_tracer():
    t = Tracer("n0", size=64)
    with t.span("a.outer", tid="x", height=1):
        with t.span("a.inner", tid="x"):
            pass
    t.instant("mark", tid="y", k=1)
    t.counter("depth", 3, tid="y")
    return t


def test_chrome_trace_structure():
    t = _sample_tracer()
    ct = chrome_trace({"n0": t.snapshot()})
    json.loads(json.dumps(ct))  # serializable
    te = ct["traceEvents"]
    metas = [e for e in te if e["ph"] == "M"]
    assert {"process_name", "thread_name"} <= {e["name"] for e in metas}
    xs = [e for e in te if e["ph"] == "X"]
    assert {e["name"] for e in xs} == {"a.outer", "a.inner"}
    for e in xs:
        assert e["dur"] >= 0 and isinstance(e["pid"], int)
    assert [e for e in te if e["ph"] == "i"][0]["s"] == "t"
    assert [e for e in te if e["ph"] == "C"][0]["args"] == {"value": 3}


def test_jsonl_roundtrip_and_cli(tmp_path, capsys):
    t = _sample_tracer()
    p = write_jsonl(str(tmp_path / "n0.trace.jsonl"), "n0", t.snapshot())
    back = read_jsonl([str(tmp_path)])
    assert list(back) == ["n0"] and len(back["n0"]) == 4

    assert trace_cli(["dump", p]) == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.strip().splitlines()]
    assert len(lines) == 4 and all(e["node"] == "n0" for e in lines)

    out = tmp_path / "trace.json"
    assert trace_cli(["convert", str(tmp_path), "-o", str(out)]) == 0
    capsys.readouterr()
    with open(out) as f:
        assert "traceEvents" in json.load(f)

    assert trace_cli(["summarize", p]) == 0
    text = capsys.readouterr().out
    assert "a.outer" in text and "p95ms" in text and "== n0 ==" in text

    assert trace_cli(["summarize", "--json", p]) == 0
    s = json.loads(capsys.readouterr().out)
    assert s["n0"]["a.outer"]["count"] == 1

    # empty input is an error, not a silent pass
    empty = tmp_path / "empty"
    empty.mkdir()
    assert trace_cli(["summarize", str(empty)]) == 1


def test_summary_percentiles():
    durs = list(range(1, 101))  # 1..100 "ns"
    events = [{"name": "k", "ph": "X", "ts_ns": 0, "dur_ns": d, "tid": "t"} for d in durs]
    events.append({"name": "c", "ph": "C", "ts_ns": 0, "dur_ns": 0, "tid": "t", "args": {"value": 9}})
    s = summarize({"n": events})
    k = s["n"]["k"]
    assert k["count"] == 100
    assert abs(percentile(sorted(durs), 0.5) - 50.5) < 1e-9
    assert k["max_ms"] == round(100 / 1e6, 3)
    assert s["n"]["_counters"] == {"c": 9}
    assert percentile([], 0.5) == 0.0
    assert percentile([7], 0.99) == 7.0


# --- 3. live instrumentation --------------------------------------------


def test_consensus_span_nesting_one_node():
    """height ⊇ round ⊇ step on a real consensus run, plus mempool and
    commit events — the per-node wiring end-to-end."""
    from cometbft_tpu_torch.node.inprocess import LocalNet, build_node, make_genesis, make_privvals

    async def main():
        gen, privs = make_genesis(1, chain_id="trace-nest")
        parts = build_node(gen, privval=make_privvals(privs)[0], device="cpu")
        net = LocalNet([parts])
        await net.start()
        parts.mempool.check_tx(b"t=1")
        await net.wait_for_height(3, 120)
        await net.stop()
        return parts

    parts = run(main())
    assert parts.tracer.enabled  # always-on default
    assert parts.tracer.meta["anchor_wall_ns"] > 0
    ev = parts.tracer.snapshot()
    _assert_consensus_nesting(ev, min_heights=3)
    names = {e["name"] for e in ev}
    assert {"mempool.insert", "mempool.reap", "consensus.commit", "clock.anchor"} <= names
    reaps = [e for e in ev if e["name"] == "mempool.reap"]
    assert any(e["args"].get("txs", 0) >= 1 for e in reaps)


def _assert_consensus_nesting(events, min_heights=1, require_steps=()):
    def encloses(o, i):
        return o["ts_ns"] <= i["ts_ns"] and o["ts_ns"] + o["dur_ns"] >= i["ts_ns"] + i["dur_ns"]

    steps = [e for e in events if e["name"] == "consensus.step"]
    rounds = [e for e in events if e["name"] == "consensus.round"]
    heights = [e for e in events if e["name"] == "consensus.height"]
    assert len(heights) >= min_heights, (len(heights), min_heights)
    assert steps and rounds
    for s in steps:
        assert any(
            r["args"]["height"] == s["args"]["height"] and r["args"]["round"] == s["args"]["round"]
            and encloses(r, s)
            for r in rounds
        ), f"step span not nested in its round: {s}"
    for r in rounds:
        assert any(
            h["args"]["height"] == r["args"]["height"] and encloses(h, r) for h in heights
        ), f"round span not nested in its height: {r}"
    kinds = {s["args"]["step"] for s in steps}
    assert set(require_steps) <= kinds, (require_steps, kinds)


def test_crypto_chunk_spans_on_process_tracer():
    """The parallel-verify plane records dispatch instants + per-chunk
    worker spans (worker id, lane count, tier) on the process-wide
    tracer."""
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.crypto.parallel_verify import ParallelVerifyEngine
    from cometbft_tpu_torch.trace import enable_global, global_tracer

    g = global_tracer()
    was_enabled = g.enabled
    enable_global()
    g.clear()
    try:
        priv = Ed25519PrivKey.from_seed(b"\x11" * 32)
        pk = priv.pub_key()
        items = []
        for i in range(40):
            m = b"chunk-span-%03d" % i
            items.append((pk, m, priv.sign(m)))
        eng = ParallelVerifyEngine(workers=2, min_parallel=8)
        try:
            assert all(eng.verify(items))
        finally:
            eng.close()
        ev = g.snapshot()
        dispatches = [e for e in ev if e["name"] == "crypto.batch.dispatch"]
        chunks = [e for e in ev if e["name"] == "crypto.verify_chunk"]
        assert eng.tier != "serial", "no worker pool on this host"
        assert dispatches and dispatches[0]["args"]["lanes"] == 40
        assert dispatches[0]["args"]["tier"] == eng.tier
        if eng.tier == "thread":
            # the thread tier shares the ring: chunk spans carry the
            # worker, the lanes and the tier
            assert chunks
            assert sum(c["args"]["lanes"] for c in chunks) == 40
            assert all(c["args"]["tier"] == "thread" and c["tid"] for c in chunks)
    finally:
        enable_global(was_enabled)
        g.clear()


# --- 4. cross-node timelines ---------------------------------------------


def _mk_ring(node, mono_anchor, wall_anchor, events):
    """One node's ring: a clock.anchor instant then ``events``."""
    out = [
        {"seq": 0, "name": "clock.anchor", "ph": "i", "ts_ns": mono_anchor, "dur_ns": 0, "tid": "main",
         "args": {"wall_ns": wall_anchor}},
    ]
    for i, e in enumerate(events, start=1):
        out.append({
            "seq": i, "ph": e.get("ph", "i"), "tid": "t", "dur_ns": e.get("dur_ns", 0),
            **{k: e[k] for k in ("name", "ts_ns", "args")},
        })
    return {node: out}


def test_rebase_aligns_rings_across_clock_domains():
    """Two rings whose monotonic clocks are wildly offset but whose
    anchors map to the same wall instant land on ONE axis: an event 5
    ms after n0's anchor and one 6 ms after n1's come out 1 ms apart."""
    WALL = 1_700_000_000_000_000_000
    by_node = {}
    by_node.update(_mk_ring("n0", 10_000_000, WALL, [{"name": "a", "ts_ns": 15_000_000, "args": {}}]))
    by_node.update(_mk_ring("n1", 999_000_000_000, WALL, [{"name": "b", "ts_ns": 999_006_000_000, "args": {}}]))
    rebased, offsets, base = rebase(by_node)
    assert offsets["n0"] != offsets["n1"]  # different mono domains
    ts = {e["name"]: e["ts_ns"] for evs in rebased.values() for e in evs if e["name"] in ("a", "b")}
    assert ts["b"] - ts["a"] == 1_000_000
    # zeroed at the earliest event (the anchors themselves)
    assert min(e["ts_ns"] for evs in rebased.values() for e in evs) == 0
    # merged view is stable-sorted on the shared axis, nodes tagged
    flat = merge_events(rebased)
    assert [e["ts_ns"] for e in flat] == sorted(e["ts_ns"] for e in flat)
    assert all("node" in e for e in flat)


def test_rebase_unanchored_ring_borrows_median_offset():
    by_node = {}
    by_node.update(_mk_ring("n0", 100, 1_000_100, [{"name": "a", "ts_ns": 200, "args": {}}]))
    # no anchor at all in n1's ring
    by_node["n1"] = [{"seq": 0, "name": "b", "ph": "i", "ts_ns": 250, "dur_ns": 0, "tid": "t", "args": {}}]
    rebased, offsets, _ = rebase(by_node)
    assert offsets["n1"] is None
    ts = {e["name"]: e["ts_ns"] for evs in rebased.values() for e in evs}
    # borrowed n0's offset: raw deltas preserved on the shared axis
    assert ts["b"] - ts["a"] == 50


def _two_node_height(send_recv_n0, send_recv_n1):
    W = 1_000_000_000

    def ring(node, send_recv):
        evs = [
            {"name": "consensus.quorum.prevote", "ph": "X", "ts_ns": 10_000_000, "dur_ns": 3_000_000,
             "args": {"height": 5, "round": 0, "step": "prevote"}},
            {"name": "consensus.quorum.precommit", "ph": "X", "ts_ns": 10_000_000, "dur_ns": 5_000_000,
             "args": {"height": 5, "round": 0, "step": "precommit"}},
            {"name": "consensus.verify", "ph": "X", "ts_ns": 11_000_000, "dur_ns": 400_000,
             "args": {"height": 5, "round": 0, "accepted": True}},
            {"name": "consensus.finalize", "ph": "X", "ts_ns": 16_000_000, "dur_ns": 2_000_000,
             "args": {"height": 5, "persist_ms": 0.5, "wal_ms": 1.0, "apply_ms": 0.5}},
        ] + send_recv
        return _mk_ring(node, 0, W, evs)

    by_node = {}
    by_node.update(ring("n0", send_recv_n0))
    by_node.update(ring("n1", send_recv_n1))
    return by_node


SEND_N0 = [{"name": "p2p.msg.send", "ph": "i", "ts_ns": 9_000_000,
            "args": {"kind": "proposal", "h": 5, "r": 0, "seq": 1}}]
RECV_N1 = [
    {"name": "p2p.msg.recv", "ph": "i", "ts_ns": 9_800_000,
     "args": {"kind": "proposal", "h": 5, "r": 0, "seq": 1, "origin": "n0"}},
    {"name": "consensus.proposal.complete", "ph": "i", "ts_ns": 9_900_000, "args": {"height": 5, "round": 0}},
]


def test_attribute_heights_waterfall_and_completeness():
    """Synthetic 2-node height: proposal send on n0 correlates to n1's
    recv; quorum/verify/finalize legs land in the waterfall; dropping
    the peer's arrival flips the chain to PARTIAL."""
    by_node = _two_node_height(SEND_N0, RECV_N1)
    heights = attribute_heights(rebase(by_node)[0])
    assert sorted(heights) == [5]
    rec = heights[5]
    assert rec["proposer"] == "n0"
    assert rec["committed"] == ["n0", "n1"]
    assert rec["complete"]
    assert rec["propagation_ms"] == {"n1": 0.8}
    assert rec["parts_ms"] == {"n1": 0.9}
    assert rec["quorum_prevote_ms"] == {"n0": 3.0, "n1": 3.0}
    assert rec["quorum_precommit_ms"] == {"n0": 5.0, "n1": 5.0}
    assert rec["verify_ms"] == {"n0": 0.4, "n1": 0.4}
    assert rec["finalize"]["n1"]["wal_ms"] == 1.0
    assert attribution_key(heights) == [(5, "n0", ("n0", "n1"), True)]
    assert "complete" in format_waterfall(heights)

    # peel n1's arrival instants: the chain is no longer complete
    by_node["n1"] = [e for e in by_node["n1"] if e["name"] not in ("p2p.msg.recv", "consensus.proposal.complete")]
    heights = attribute_heights(rebase(by_node)[0])
    assert not heights[5]["complete"]
    assert heights[5]["missing_arrival"] == ["n1"]
    assert "PARTIAL" in format_waterfall(heights)

    # ...unless the node caught up via commit_block gossip, which is
    # its own causal chain (recv instant on the stamped catch-up)
    by_node["n1"].append({"seq": 99, "name": "p2p.msg.recv", "ph": "i", "ts_ns": 15_000_000, "dur_ns": 0,
                          "tid": "t", "args": {"kind": "commit_block", "h": 5, "seq": 9, "origin": "n0"}})
    heights = attribute_heights(rebase(by_node)[0])
    assert heights[5]["complete"]


def test_timeline_cli_json_and_strict(tmp_path):
    W = 2_000_000_000
    ring = _mk_ring("n0", 0, W, [
        {"name": "consensus.finalize", "ph": "X", "ts_ns": 5_000_000, "dur_ns": 1_000_000,
         "args": {"height": 3, "persist_ms": 0.1, "wal_ms": 0.2, "apply_ms": 0.3}},
    ])
    p = write_jsonl(str(tmp_path / "n0.trace.jsonl"), "n0", ring["n0"])
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = trace_cli(["timeline", p, "--json"])
    assert rc == 0
    doc = json.loads(buf.getvalue())
    assert doc["offsets_ns"]["n0"] == W
    assert doc["heights"]["3"]["committed"] == ["n0"]
    # no proposal send anywhere: the chain is incomplete => --strict
    # exits 3
    assert not doc["heights"]["3"]["complete"]
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = trace_cli(["timeline", p, "--strict"])
    assert rc == 3
    assert "PARTIAL" in buf.getvalue()


def test_summarize_by_height_groups_across_nodes(tmp_path, capsys):
    events = []
    for h in (1, 2):
        for node_dur in (1_000_000, 3_000_000):
            events.append({"name": "consensus.quorum.prevote", "ph": "X", "ts_ns": 0, "dur_ns": node_dur,
                           "tid": "c", "args": {"height": h, "step": "prevote"}})
    # height-less spans stay out of the by-height grouping
    events.append({"name": "wal.fsync", "ph": "X", "ts_ns": 0, "dur_ns": 9_000_000, "tid": "w", "args": {}})
    bh = summarize_by_height({"n0": events[:2] + events[-1:], "n1": events[2:4]})
    assert sorted(bh) == [1, 2]
    assert bh[1]["consensus.quorum.prevote"]["count"] == 2
    assert bh[1]["consensus.quorum.prevote"]["max_ms"] == 3.0
    assert "wal.fsync" not in bh[1]

    # CLI: --by-height lands in both the table and the JSON doc
    p = write_jsonl(str(tmp_path / "n0.trace.jsonl"), "n0", events)
    assert trace_cli(["summarize", p, "--by-height"]) == 0
    text = capsys.readouterr().out
    assert "== height 1 ==" in text and "== height 2 ==" in text
    assert trace_cli(["summarize", p, "--by-height", "--json"]) == 0
    doc = json.loads(capsys.readouterr().out)
    assert "summary" in doc and "by_height" in doc
    assert doc["by_height"]["1"]["consensus.quorum.prevote"]["count"] == 2


def _per_call(fn, n=20_000, repeats=7):
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter_ns()
        for _ in range(n):
            fn()
        dt = (time.perf_counter_ns() - t0) / n
        best = dt if best is None else min(best, dt)
    return best


def test_stamp_and_correlate_overhead_bounds():
    """Stamping a send and correlating a receive are per-MESSAGE costs
    on the p2p hot path: bounded against a no-op-call baseline measured
    under the same conditions, with an absolute backstop."""
    import gc

    from cometbft_tpu_torch.p2p import tracewire

    payload = b"\x05" + b"v" * 120  # a vote-sized message
    enabled = Tracer("on", size=4096)
    st = tracewire.TraceStamper(enabled, origin="n0")
    wire = st.wrap(payload, "vote", height=3, round_=0)
    ctx, _ = tracewire.unstamp(wire)
    disabled = Tracer("off", size=4, enabled=False)
    st_off = tracewire.TraceStamper(disabled, origin="n0")

    def noop():
        pass

    gc.disable()
    try:
        baseline = _per_call(noop)
        stamp_cost = _per_call(lambda: st.wrap(payload, "vote", height=3, round_=0))
        unstamp_cost = _per_call(lambda: tracewire.unstamp(wire))
        correlate_cost = _per_call(lambda: st.on_receive(ctx, "peerid"))
        recv_off = _per_call(lambda: st_off.on_receive(ctx, "peerid"))
        plain_check = _per_call(lambda: payload[:2] == tracewire.MAGIC)
    finally:
        gc.enable()
    assert stamp_cost < max(25_000, 150 * baseline), f"stamp-encode {stamp_cost:.0f}ns/call"
    assert unstamp_cost < max(15_000, 100 * baseline), f"unstamp {unstamp_cost:.0f}ns/call"
    assert correlate_cost < max(25_000, 150 * baseline), f"correlate-on-receive {correlate_cost:.0f}ns/call"
    assert recv_off < max(2_000, 15 * baseline), f"disabled on_receive {recv_off:.0f}ns/call"
    assert plain_check < max(2_000, 15 * baseline), f"magic check {plain_check:.0f}ns/call"
    assert disabled.snapshot() == []


def test_stamp_msg_disabled_switch_path_is_attribute_check():
    """Switch.stamp_msg with no stamping plane must stay a near-free
    None check (every per-peer gossip send pays it)."""
    import gc

    from cometbft_tpu_torch.p2p import MemoryTransport, NodeInfo, NodeKey
    from cometbft_tpu_torch.p2p.switch import Switch

    nk = NodeKey.generate()
    info = NodeInfo(node_id=nk.node_id, network="ovh")
    sw = Switch(MemoryTransport(nk, info), info)
    assert sw.stamper is None
    msg = b"m" * 64

    def noop():
        pass

    gc.disable()
    try:
        baseline = _per_call(noop)
        cost = _per_call(lambda: sw.stamp_msg(0x21, msg, "vote", height=1))
    finally:
        gc.enable()
    assert cost < max(3_000, 25 * baseline), f"disabled stamp_msg {cost:.0f}ns/call (baseline {baseline:.0f}ns)"


# --- 5. parity with the JAX package --------------------------------------


def _mixed_events():
    """Two rings with every event kind the readers distinguish: spans
    with and without heights, instants, counters, stamps and anchors,
    from a seeded generator."""
    rng = np.random.default_rng(15)
    by_node = _two_node_height(SEND_N0, RECV_N1)
    for node, evs in by_node.items():
        seq = len(evs)
        for i in range(40):
            h = int(rng.integers(1, 6))
            kind = ("consensus.step", "wal.fsync", "mempool.batch", "blocksync.window.apply")[i % 4]
            evs.append({"seq": seq, "name": kind, "ph": "X", "ts_ns": int(rng.integers(0, 50_000_000)),
                        "dur_ns": int(rng.integers(0, 9_000_000)), "tid": ("c", "w", "m", "b")[i % 4],
                        "args": {"height": h, "step": "prevote"} if i % 4 == 0 else {}})
            seq += 1
        evs.append({"seq": seq, "name": "mempool.size", "ph": "C", "ts_ns": 1, "dur_ns": 0, "tid": "mempool",
                    "args": {"value": int(rng.integers(0, 100))}})
        evs.append({"seq": seq + 1, "name": "obs.stall", "ph": "i", "ts_ns": 2, "dur_ns": 0, "tid": "watchdog",
                    "args": {"stalled_ms": 700.0}})
    return by_node


def test_export_summary_and_timeline_equal_jax():
    by_node = _mixed_events()
    assert chrome_trace(by_node) == jtrace.chrome_trace(by_node)
    assert summarize(by_node) == jtrace.summarize(by_node)
    assert summarize_by_height(by_node) == jtrace.summarize_by_height(by_node)
    assert rebase(by_node) == jtrace.rebase(by_node)
    rebased = rebase(by_node)[0]
    assert merge_events(rebased) == jtrace.merge_events(rebased)
    heights = attribute_heights(rebased)
    assert heights == jtrace.attribute_heights(rebased)
    assert attribution_key(heights) == jtrace.attribution_key(heights)
    assert format_waterfall(heights) == jtrace.format_waterfall(heights)
    assert percentile([3, 1, 4], 0.5) == jtrace.percentile([3, 1, 4], 0.5)


@pytest.mark.parametrize("args", [["summarize"], ["summarize", "--by-height"], ["timeline"],
                                  ["timeline", "--json"], ["summarize", "--json"], ["dump"]])
def test_trace_cli_prints_what_jax_prints(tmp_path, args):
    by_node = _mixed_events()
    paths = [write_jsonl(str(tmp_path / f"{n}.trace.jsonl"), n, evs) for n, evs in by_node.items()]
    outs = []
    for cli in (trace_cli, jtrace_cli):
        buf = io.StringIO()
        with redirect_stdout(buf):
            rc = cli([args[0], *paths, *args[1:]])
        outs.append((rc, buf.getvalue()))
    assert outs[0] == outs[1]
    assert outs[0][1]


def test_port_ring_reads_in_jax_tools(tmp_path):
    """A ring the port's Tracer wrote exports to JSONL that the JAX
    reader, summary and timeline take as their own."""
    t = _sample_tracer()
    t.meta["anchor_wall_ns"] = 1
    p = write_jsonl(str(tmp_path / "n0.trace.jsonl"), "n0", t.snapshot())
    mine, theirs = read_jsonl([p]), jtrace.read_jsonl([p])
    assert mine == theirs
    assert jtrace.summarize(theirs) == summarize(mine)


# --- 6. off-loop writers --------------------------------------------------


class _ReadyHandle:
    """A device dispatch that is ready a moment after it was made."""

    def __init__(self, n):
        self.n = n

    def wait(self):
        time.sleep(0.001)
        return self

    def result(self):
        return [True] * self.n


def test_scheduler_watcher_writes_process_ring_while_loop_writes(monkeypatch):
    """The verify scheduler's device watcher thread ("verify-sched-dev")
    completes its ``crypto.sched.dispatch`` spans on the process ring
    from off the loop while a loop task writes the same ring: the
    cursor is atomic under the GIL, so every written event has its own
    sequence number, the ring holds exactly its size of the newest
    ones, and every surviving event is whole."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import scheduler as sched_mod
    from cometbft_tpu_torch.crypto.keys import Ed25519PrivKey
    from cometbft_tpu_torch.ops import ed25519 as ed
    from cometbft_tpu_torch.trace import enable_global, global_tracer

    monkeypatch.setattr(ed, "verify_batch_async", lambda items, device=None: _ReadyHandle(len(items)))
    g = global_tracer()
    was_enabled = g.enabled
    enable_global()
    g.clear()
    writers = []

    def note(name, dur_ns, args):
        if name == "crypto.sched.dispatch":
            writers.append(threading.current_thread().name)

    g.add_observer(note)
    old_min = crypto_batch._MIN_DEVICE_BATCH
    crypto_batch.set_min_device_batch(1)
    sched = sched_mod.VerifyScheduler()
    priv = Ed25519PrivKey.from_seed(b"\x22" * 32)
    items = [(priv.pub_key(), b"w%d" % i, priv.sign(b"w%d" % i)) for i in range(4)]
    try:
        async def main():
            loop_spans = 0
            tickets = []
            for i in range(60):
                tickets.append(sched.submit(items, device=torch.device("cpu"), label="w"))
                for _ in range(50):
                    with g.span("loop.work", tid="loop", i=i):
                        pass
                    loop_spans += 1
                await asyncio.sleep(0)
            for t in tickets:
                ok, _ = await asyncio.to_thread(t.result, 30)
                assert ok
            return loop_spans

        loop_spans = run(main(), timeout=120)
    finally:
        g.remove_observer(note)
        sched.close()
        crypto_batch.set_min_device_batch(old_min)
        enable_global(was_enabled)
    ev = g.snapshot()
    g.clear()
    assert "verify-sched-dev" in writers and len(writers) == 60
    written = loop_spans + 60
    assert g.stats()["ring"] == 8192
    seqs = [e["seq"] for e in ev]
    assert len(set(seqs)) == len(seqs) == min(written, 8192)
    assert all(e["name"] in ("loop.work", "crypto.sched.dispatch") and e["ph"] == "X" and e["dur_ns"] >= 0
               for e in ev)
    assert {e["name"] for e in ev} == {"loop.work", "crypto.sched.dispatch"}


# --- 7. chaos-bound cases -------------------------------------------------


def test_chaos_run_traced_perfetto_loadable(tmp_path):
    """A 4-node in-process chaos net with tracing enabled exports a
    Perfetto-loadable trace whose consensus step spans nest correctly
    per height/round on every node, with WAL fsync spans alongside."""
    from cometbft_tpu_torch.chaos import FaultSchedule, run_schedule

    async def main():
        return await run_schedule(
            FaultSchedule([]),  # no faults: the fast acceptance run
            seed=77,
            base_dir=str(tmp_path / "net"),
            n_nodes=4,
            settle_heights=3,
            liveness_bound_s=120.0,
            trace_dir=str(tmp_path / "traces"),
            device="cpu",
        )

    report = run(main())
    assert report.ok, report.format()
    assert report.trace_files
    jsonls = [p for p in report.trace_files if p.endswith(".jsonl")]
    chrome = [p for p in report.trace_files if p.endswith("trace.json")]
    # one ring per node (no restarts in this schedule)
    node_dumps = [p for p in jsonls if "/n" in p]
    assert len(node_dumps) == 4, report.trace_files
    assert len(chrome) == 1

    # Perfetto-loadable: valid JSON, traceEvents, process metadata for
    # every node, X events with ts+dur
    with open(chrome[0]) as f:
        ct = json.load(f)
    te = ct["traceEvents"]
    procs = {
        e["args"]["name"]
        for e in te
        if e["ph"] == "M" and e["name"] == "process_name"
    }
    assert {"n0", "n1", "n2", "n3"} <= procs
    assert all(
        "ts" in e and "dur" in e for e in te if e["ph"] == "X"
    )

    by_node = read_jsonl(node_dumps)
    for node, events in by_node.items():
        _assert_consensus_nesting(
            events, min_heights=2,
            require_steps=("PROPOSE", "PREVOTE", "PRECOMMIT", "COMMIT"),
        )
        names = {e["name"] for e in events}
        # chaos homes persist a WAL: the fsync barrier must be spanned
        assert "wal.fsync" in names, (node, sorted(names))
        # cross-node tracing: every ring carries its clock
        # anchor and the stamped-correlation instants
        assert "clock.anchor" in names, (node, sorted(names))
        assert {"p2p.msg.send", "p2p.msg.recv"} <= names, node
        assert {
            "consensus.quorum.prevote", "consensus.quorum.precommit",
            "consensus.finalize",
        } <= names, (node, sorted(names))
    # and the summary machinery digests the whole dump
    s = summarize(by_node)
    assert all("consensus.step" in kinds for kinds in s.values())

    # every committed height carries a COMPLETE
    # attribution chain — the proposer's proposal send correlated to
    # arrival instants on all committing peers, both quorum legs
    # measured per height
    rebased, offsets, _base = rebase(by_node)
    assert all(o is not None for o in offsets.values()), offsets
    heights = attribute_heights(rebased)
    assert len(heights) >= 2, sorted(heights)
    # the net stops node by node once every node passed its target, so
    # the top height may be finalized by the nodes stopped last only:
    # its proposer is held to having committed it where every node did
    every_node = min(report.final_heights.values())
    for h, rec in heights.items():
        assert rec["complete"], (h, rec)
        if h <= every_node:
            assert rec["proposer"] in rec["committed"], rec
        assert rec["quorum_prevote_ms"] and rec["quorum_precommit_ms"]
        for n, f in rec["finalize"].items():
            assert f["total_ms"] >= 0 and f["wal_ms"] is not None
    # non-proposer nodes saw the proposal propagate (positive delta
    # on the shared in-process clock)
    any_prop = [
        v for rec in heights.values()
        for v in rec["propagation_ms"].values()
    ]
    assert any_prop and all(v >= 0 for v in any_prop)
    # the waterfall table renders one row per height
    table = format_waterfall(heights)
    assert "complete" in table and "PARTIAL" not in table

    # the timeline CLI digests the same dump: --strict passes, -o
    # writes a Perfetto-loadable merged view on one rebased axis
    out = tmp_path / "timeline.json"
    assert (
        trace_cli(
            ["timeline", str(tmp_path / "traces"), "--strict",
             "-o", str(out)]
        )
        == 0
    )
    with open(out) as f:
        tl = json.load(f)
    assert tl["traceEvents"]


def test_chaos_same_seed_attribution_is_deterministic(tmp_path):
    """Same-seed chaos runs replay the same message decision stream,
    so the attribution table's STRUCTURE — committed heights, the
    proposer per height, chain completeness — reproduces exactly
    (latency columns are wall-clock and jitter run to run; the common
    committed prefix is compared because wall time decides how many
    heights land before the schedule ends)."""
    from cometbft_tpu_torch.chaos import FaultSchedule, run_schedule

    async def one(i):
        return await run_schedule(
            FaultSchedule([]),
            seed=909,
            base_dir=str(tmp_path / f"net{i}"),
            n_nodes=4,
            settle_heights=2,
            liveness_bound_s=120.0,
            trace_dir=str(tmp_path / f"traces{i}"),
            profile_hz=0,
            device="cpu",
        )

    keys = []
    for i in range(2):
        report = run(one(i))
        assert report.ok, report.format()
        by_node = read_jsonl(
            [p for p in report.trace_files if "/n" in p]
        )
        rebased, _, _ = rebase(by_node)
        heights = attribute_heights(rebased)
        assert heights
        keys.append(
            {
                h: (rec["proposer"], rec["complete"])
                for h, rec in heights.items()
            }
        )
    common = sorted(set(keys[0]) & set(keys[1]))
    assert common, (sorted(keys[0]), sorted(keys[1]))
    for h in common:
        assert keys[0][h] == keys[1][h], (h, keys[0][h], keys[1][h])
