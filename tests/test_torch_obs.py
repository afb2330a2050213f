"""The port's runtime health plane (cometbft_tpu_torch/obs and the
stuck-task watchdog of utils/debug.py) held to the JAX package's: the
cases of ``tests/test_obs.py``, the chaos stall case included, and both
cases of ``tests/test_watchdog.py``, on the port.

1. Loop watchdog: lag sampling, the flight record of an injected stall
   (the offending frame in the record and in the ring), the per-beat
   overhead bound, and stall attribution (a frame of the torch library
   or of the port's ``ops`` layer names its subsystem).
2. Sampling profiler: attributes a named hot function, folded output,
   idle filter, per-sample cost.
3. Backpressure telemetry: ``InstrumentedQueue`` counters, registry
   aggregation, the event bus's bounded shed-and-count, the put
   overhead bound, and a ``Node``'s registry with every hot-plane queue
   (``mempool.ingest``, ``consensus.inbox``, ``events.subs``,
   ``p2p.send``, ``blocksync.window``, ``crypto.verify.dispatch``).
4. Span budgets: evaluation semantics, the ``summarize --budget`` exit
   codes, the checked-in ``tools/span_budgets.toml``.
5. Stuck-task watchdog: a task stuck on one await is reported once; an
   active one never.

6. The chaos stall case: a ``stall`` scheduled on the port's chaos net
   (``device="cpu"``) is flight-recorded with the ``chaos_stall`` frame,
   in the report and in the dumped rings, and the run stays clean.
"""

import asyncio
import io
import json
import sys
import threading
import time

import pytest
import torch

from cometbft_tpu_torch.obs import (
    InstrumentedQueue,
    LoopWatchdog,
    QueueRegistry,
    SamplingProfiler,
    evaluate_budgets,
    format_verdicts,
    load_budgets,
)
from cometbft_tpu_torch.obs.watchdog import attribute_frame
from cometbft_tpu_torch.trace import Tracer
from cometbft_tpu_torch.utils import log as L
from cometbft_tpu_torch.utils.debug import StuckTaskWatchdog
from torch_hard_limit import hard_limit  # noqa: F401

torch.set_num_threads(1)


def run(coro, timeout=240):
    return asyncio.run(asyncio.wait_for(coro, timeout))


# --- 1. loop watchdog ----------------------------------------------------


def _blockingly_hog_the_loop(duration_s: float) -> None:
    """Named needle for the flight-record assertions below."""
    time.sleep(duration_s)


def test_watchdog_flight_records_injected_stall():
    """A synchronous callback blocking the loop past the threshold is
    snapshotted MID-STALL: the record's loop stack contains the
    offending frame, instants land on the trace ring, and the lag
    window registers the stall-sized lag afterwards."""
    tr = Tracer("wd", size=256)

    async def main():
        wd = LoopWatchdog(tracer=tr, interval_s=0.05, stall_s=0.15, name="wd-test")
        wd.start()
        try:
            await asyncio.sleep(0.3)  # a few clean beats first
            _blockingly_hog_the_loop(0.7)
            await asyncio.sleep(0.3)  # let the post-stall beat land
        finally:
            wd.stop()
        return wd

    wd = run(main())
    assert wd.stall_count >= 1
    rec = wd.stalls[0]
    assert rec["stalled_s"] >= 0.15
    assert any("_blockingly_hog_the_loop" in line for line in rec["loop_stack"]), rec["loop_stack"]
    assert rec["tasks"], rec
    ev = tr.snapshot()
    stalls = [e for e in ev if e["name"] == "obs.stall"]
    assert stalls and "_blockingly_hog_the_loop" in stalls[0]["args"]["loop_stack"]
    assert any(e["name"] == "obs.stall.tasks" for e in ev)
    lag = wd.lag_stats()
    assert lag["samples"] >= 3
    assert lag["max_ms"] >= 150.0, lag
    assert any(e["name"] == "obs.loop.lag" for e in ev)


def test_watchdog_quiet_loop_no_stalls():
    async def main():
        wd = LoopWatchdog(tracer=Tracer("q", size=64), interval_s=0.05, stall_s=0.5, name="quiet")
        wd.start()
        try:
            for _ in range(6):
                await asyncio.sleep(0.05)
        finally:
            wd.stop()
        return wd

    wd = run(main())
    assert wd.stall_count == 0
    assert wd.last_stall_ago_s() is None
    assert wd.lag_stats()["samples"] >= 3


def test_watchdog_beat_bookkeeping_overhead_bounded():
    """The per-beat cost (one deque append + one ring append) stays a
    handful of call-costs, scaled against a no-op baseline."""
    import gc

    wd = LoopWatchdog(tracer=Tracer("ov", size=4096), name="ov")
    N = 20_000

    def per_call(fn):
        best = None
        for _ in range(5):
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
        now_ns = time.monotonic_ns()
        beat = per_call(lambda: wd._record_beat(0.001, now_ns))
        wd_off = LoopWatchdog(name="off")  # NOOP tracer
        beat_off = per_call(lambda: wd_off._record_beat(0.001, now_ns))
    finally:
        gc.enable()
    assert beat < max(20_000, 60 * baseline), (beat, baseline)
    assert beat_off < max(8_000, 25 * baseline), (beat_off, baseline)


def _frame_in(code_src: str, filename: str):
    """A frame whose code lives in ``filename`` (stall attribution reads
    only the frames' file names)."""
    ns = {"sys": sys}
    exec(compile(code_src, filename, "exec"), ns)
    return ns["grab"]()


@pytest.mark.parametrize("filename, subsystem", [
    ("/usr/lib/python3/site-packages/torch/cuda/__init__.py", "torch"),
    ("/repo/cometbft_tpu_torch/ops/ed25519.py", "ops"),
    ("/repo/cometbft_tpu_torch/kernels.py", "kernels"),
    ("/repo/cometbft_tpu_torch/consensus/wal.py", "consensus"),
    ("/repo/tests/some_test.py", "unknown"),
])
def test_stall_attribution_names_torch_and_ops_frames(filename, subsystem):
    """A stall whose innermost frame is a synchronous torch call (or
    the port's ops layer) is attributed to it: the finding phase 18 of
    the smoke looks for."""
    frame = _frame_in("def grab():\n    return sys._getframe()\n", filename)
    assert attribute_frame(frame) == subsystem


# --- 2. sampling profiler ------------------------------------------------


def _spin_named(stop: "threading.Event") -> None:
    """CPU-burning needle the profiler must attribute."""
    x = 0
    while not stop.is_set():
        x = (x * 1103515245 + 12345) & 0xFFFFFFFF


def test_profiler_attributes_named_hot_function():
    stop = threading.Event()
    t = threading.Thread(target=_spin_named, args=(stop,), daemon=True)
    t.start()
    try:
        p = SamplingProfiler(hz=97).start()
        deadline = time.monotonic() + 20.0
        while time.monotonic() < deadline:
            time.sleep(0.2)
            if p.samples >= 10 and "_spin_named" in p.folded():
                break
        p.stop()
    finally:
        stop.set()
        t.join(10)
    assert not t.is_alive()
    assert p.samples >= 10
    folded = p.folded()
    assert "_spin_named" in folded, folded[:500]
    for line in folded.splitlines():
        stack, _, count = line.rpartition(" ")
        assert stack and count.isdigit(), line
    top = p.top_lines(5)
    assert top and top[0]["samples"] >= 1 and 0 < top[0]["pct"] <= 100


def test_profiler_write_folded_and_idle_filter(tmp_path):
    stop = threading.Event()
    idle = threading.Thread(target=stop.wait, daemon=True)
    idle.start()
    p = SamplingProfiler(hz=97).start()
    time.sleep(0.4)
    p.stop()
    stop.set()
    idle.join(10)
    path = p.write_folded(str(tmp_path / "p.folded"))
    text = open(path).read()
    assert text.startswith("#") and "Hz" in text.splitlines()[0]
    assert not any(
        ln.rpartition(" ")[0].endswith("threading:wait") for ln in text.splitlines()[1:] if ln
    ), text


def test_profiler_sample_cost_bounded():
    p = SamplingProfiler(hz=1)
    best = None
    for _ in range(50):
        t0 = time.perf_counter_ns()
        p.sample_once()
        dt = time.perf_counter_ns() - t0
        best = dt if best is None else min(best, dt)
    assert best < 5_000_000, f"sample_once {best}ns"
    assert p.samples == 50


# --- 3. backpressure telemetry ------------------------------------------


def test_instrumented_queue_counters():
    async def main():
        q = InstrumentedQueue(4, name="t")
        for i in range(3):
            q.put_nowait(i)
        assert q.stats()["depth"] == 3
        assert q.high_watermark == 3
        q.get_nowait()
        await q.put(99)  # put() funnels through put_nowait
        assert q.enqueued == 4
        assert q.high_watermark == 3
        q.put_nowait(1)
        with pytest.raises(asyncio.QueueFull):
            q.put_nowait(2)
        q.count_drop()
        assert q.stats() == {"depth": 4, "high_watermark": 4, "enqueued": 5, "dropped": 1, "maxsize": 4}

    run(main())


def test_queue_registry_snapshot_and_aggregates():
    reg = QueueRegistry()
    q = InstrumentedQueue(8, name="a")
    reg.register_queue("a", lambda: q)
    reg.register("down", lambda: None)  # plane not running
    reg.register("cb", lambda: {"depth": 2, "high_watermark": 7, "dropped": 3})

    def boom():
        raise RuntimeError("torn read")

    reg.register("broken", boom)
    snap = reg.snapshot()
    assert set(snap) == {"a", "cb"}  # None + raising entries skipped
    assert reg.high_watermarks() == {"a": 0, "cb": 7}
    assert reg.total_dropped() == 3
    assert reg.get("down") is None and reg.get("broken") is None


def test_event_bus_bounded_subscribers_shed_and_count():
    from cometbft_tpu_torch.types import events as ev

    async def main():
        bus = ev.EventBus()
        bus.set_loop(asyncio.get_running_loop())
        sub = ev.Subscription(bus, lambda e: True, queue_size=8)
        bus._subs.append(sub)
        for i in range(20):
            bus.publish(ev.Event("Tx", {"i": i}))
        await asyncio.sleep(0.05)
        assert sub.queue.qsize() == 8  # bounded, not 20
        assert bus.dropped == 12
        assert sub.queue.dropped == 12
        stats = bus.queue_stats()
        assert stats["dropped"] == 12 and stats["subscribers"] == 1
        # the retained events are the OLDEST 8 (head-of-line kept)
        first = await sub.queue.get()
        assert first.data["i"] == 0

    run(main())


def test_instrumented_queue_put_overhead_bounded():
    import gc

    async def main():
        plain = asyncio.Queue(100_000)
        inst = InstrumentedQueue(100_000, name="ov")
        N = 30_000

        def timed(q):
            best = None
            for _ in range(4):
                while not q.empty():
                    q.get_nowait()
                t0 = time.perf_counter_ns()
                for i in range(N):
                    q.put_nowait(i)
                dt = (time.perf_counter_ns() - t0) / N
                best = dt if best is None else min(best, dt)
            return best

        gc.disable()
        try:
            base = timed(plain)
            ours = timed(inst)
        finally:
            gc.enable()
        assert ours < max(4 * base, base + 3000), (ours, base)

    run(main())


def test_node_queue_registry_wired():
    """A built Node registers every hot-plane queue and health reads
    them live, with the loop watchdog's lag."""
    from cometbft_tpu_torch.config.config import test_config as make_test_cfg
    from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
    from cometbft_tpu_torch.node.node import Node
    from cometbft_tpu_torch.rpc import core
    from cometbft_tpu_torch.rpc.env import Environment

    gen, privs = make_genesis(1, chain_id="obs-reg")

    async def main():
        node = Node(make_test_cfg("."), gen, privval=make_privvals(privs)[0], device="cpu")
        await node.start()
        try:
            while node.height < 1:
                await asyncio.sleep(0.05)
            names = set(node.queues.names())
            assert {"mempool.ingest", "consensus.inbox", "events.subs", "p2p.send", "blocksync.window",
                    "crypto.verify.dispatch"} <= names
            snap = node.queues.snapshot()
            assert snap["consensus.inbox"]["enqueued"] >= 1
            assert snap["mempool.ingest"]["maxsize"] == 10_000
            h = core.health(Environment.from_node(node))
            assert h["status"] in ("ok", "degraded")
            assert "consensus.inbox" in h["queue_high_watermarks"]
            assert "loop_lag_ms" in h and h["loop_stalls"] == 0
        finally:
            await node.stop()

    run(main(), timeout=120)


# --- 4. span budgets -----------------------------------------------------

_BUDGET_TOML = """
[budget."k.fast"]
p95_ms = 10.0
p99_ms = 20.0
min_count = 3

[budget."k.rare"]
p99_ms = 1.0
min_count = 100

[budget."k.slow"]
max_ms = 5.0
"""


def _summary(slow_ms: float):
    from cometbft_tpu_torch.trace import summarize

    events = [{"name": "k.fast", "ph": "X", "ts_ns": 0, "dur_ns": int(2e6)} for _ in range(10)]
    events.append({"name": "k.rare", "ph": "X", "ts_ns": 0, "dur_ns": int(9e6)})
    events.append({"name": "k.slow", "ph": "X", "ts_ns": 0, "dur_ns": int(slow_ms * 1e6)})
    return summarize({"n0": events})


def test_budget_evaluation_semantics(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text(_BUDGET_TOML)
    budgets = load_budgets(str(p))
    ok_rows = evaluate_budgets(_summary(slow_ms=1.0), budgets)
    # k.rare skipped (min_count 100 unmet) — a thin tail is not a pass
    assert {r["span"] for r in ok_rows} == {"k.fast", "k.slow"}
    assert all(r["ok"] for r in ok_rows)
    bad_rows = evaluate_budgets(_summary(slow_ms=50.0), budgets)
    over = [r for r in bad_rows if not r["ok"]]
    assert len(over) == 1 and over[0]["span"] == "k.slow"
    table = format_verdicts(bad_rows)
    assert "OVER" in table and "FAIL" in table
    assert "PASS" in format_verdicts(ok_rows)
    # unknown keys are a config error, not silence
    p2 = tmp_path / "bad.toml"
    p2.write_text('[budget."x"]\np95_sec = 1.0\n')
    with pytest.raises(ValueError):
        load_budgets(str(p2))
    # the JAX engine gives the same verdicts
    from cometbft_tpu.obs import budget as jbudget

    assert jbudget.evaluate_budgets(_summary(slow_ms=50.0), jbudget.load_budgets(str(p))) == bad_rows
    assert jbudget.format_verdicts(bad_rows) == table


def test_summarize_budget_cli_exit_codes(tmp_path, capsys):
    """summarize --budget fails (exit 2) on an inflated span and passes
    on budgets that hold."""
    from cometbft_tpu_torch.trace import write_jsonl
    from cometbft_tpu_torch.trace.cli import main as trace_cli

    budget = tmp_path / "b.toml"
    budget.write_text('[budget."k.slow"]\nmax_ms = 5.0\n')
    slow = [{"name": "k.slow", "ph": "X", "ts_ns": 0, "dur_ns": int(80e6), "tid": "t"}]
    fast = [dict(slow[0], dur_ns=int(1e6))]
    p_bad = write_jsonl(str(tmp_path / "bad.trace.jsonl"), "n0", slow)
    p_ok = write_jsonl(str(tmp_path / "ok.trace.jsonl"), "n0", fast)

    rc = trace_cli(["summarize", p_bad, "--budget", str(budget)])
    out = capsys.readouterr().out
    assert rc == 2 and "OVER" in out and "FAIL" in out

    rc = trace_cli(["summarize", p_ok, "--budget", str(budget)])
    out = capsys.readouterr().out
    assert rc == 0 and "PASS" in out

    rc = trace_cli(["summarize", "--json", p_bad, "--budget", str(budget)])
    doc = json.loads(capsys.readouterr().out)
    assert rc == 2
    assert doc["budget_verdicts"][0]["span"] == "k.slow"
    assert doc["summary"]["n0"]["k.slow"]["count"] == 1


def test_checked_in_budget_file_loads():
    """The shipped tools/span_budgets.toml (the default of --budget)
    parses and bounds the span kinds the instrumented planes emit."""
    import os

    from cometbft_tpu_torch.obs.budget import default_budget_file

    path = default_budget_file()
    assert path == os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                                "span_budgets.toml")
    budgets = load_budgets(path)
    assert {"consensus.step", "wal.fsync", "obs.loop.lag"} <= set(budgets)
    for span, entry in budgets.items():
        assert any(k in entry for k in ("p50_ms", "p95_ms", "p99_ms", "max_ms")), span


# --- chaos stall acceptance ----------------------------------------------


def test_chaos_stall_is_flight_recorded(tmp_path):
    """A forced loop stall under chaos produces a flight-recorder dump
    whose snapshot contains the offending frame, reproducible from one
    seed line — and the run stays invariant-clean (the stall is a perf
    fault, not a BFT one)."""
    from cometbft_tpu_torch.chaos import FaultEvent, FaultSchedule, run_schedule
    from cometbft_tpu_torch.trace import read_jsonl

    async def main():
        return await run_schedule(
            FaultSchedule([FaultEvent("stall", at_height=2, duration_s=1.2)]),
            seed=606,
            base_dir=str(tmp_path / "net"),
            n_nodes=4,
            settle_heights=2,
            liveness_bound_s=120.0,
            trace_dir=str(tmp_path / "traces"),
            device="cpu",
        )

    report = run(main())
    assert report.ok, report.format()
    assert report.stall_records, "flight recorder missed the stall"
    assert any(
        any("chaos_stall" in ln for ln in r.get("loop_stack", [])) for r in report.stall_records
    ), report.stall_records
    # the stall instants are in the dumped rings next to the spans
    jsonls = [p for p in report.trace_files if p.endswith(".jsonl")]
    all_events = [e for evs in read_jsonl(jsonls).values() for e in evs]
    stall_instants = [e for e in all_events if e["name"] == "obs.stall"]
    assert stall_instants
    assert any("chaos_stall" in e["args"].get("loop_stack", "") for e in stall_instants)
    # the chaos profiler wrote folded stacks beside the trace files
    assert report.profile_file and "profile.folded" in report.profile_file


# --- 5. stuck-task watchdog ----------------------------------------------


def test_reports_stuck_task_once():
    async def main():
        buf = io.StringIO()
        L.set_writer(buf)
        try:
            wd = StuckTaskWatchdog(interval_s=0.05, stall_s=0.2)
            wd.start()
            forever = asyncio.Event()

            async def stuck():
                await forever.wait()  # never set

            t = asyncio.get_running_loop().create_task(stuck(), name="stuck-task")
            await asyncio.sleep(1.0)
            wd.stop()
            names = [n for n, _ in wd.stalled]
            assert "stuck-task" in names
            # reported once, not on every sample
            assert names.count("stuck-task") == 1
            out = buf.getvalue()
            assert "task stuck at the same await point" in out
            assert "stuck-task" in out
            forever.set()
            await t
        finally:
            L.set_writer(sys.stderr)

    run(main(), timeout=30)


def test_active_tasks_not_reported():
    async def main():
        wd = StuckTaskWatchdog(interval_s=0.05, stall_s=0.2)
        wd.start()

        async def busy():
            for _ in range(100):
                await asyncio.sleep(0.01)

        t = asyncio.get_running_loop().create_task(busy(), name="busy")
        await t
        wd.stop()
        assert all(n != "busy" for n, _ in wd.stalled)

    run(main(), timeout=30)
