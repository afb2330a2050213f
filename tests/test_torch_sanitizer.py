"""The port's runtime concurrency sanitizer (``analysis/runtime.py``)
held to the JAX package's: the 19 cases of ``tests/test_sanitizer.py``.
The flight-record case runs on each package with its own watchdog and
``chaos_stall``; the two chaos schedules (``lock_inversion`` on a live
4-node net, detected, and missed with the sanitizer off) run on the
port's chaos harness (``device="cpu"``), their nemesis record held to
the JAX injection's.

Each case runs once on each package's module and what it returns (the
findings' kinds, lock sets, objects and threads, the graph's stats,
the stall buckets) must be equal across the two:
  1. lock-order graph: ABBA inversion detected (both stacks carried),
     consistent order stays clean, multi-lock cycles, RLock
     reentrancy, Condition interop (wait releases the bookkeeping);
  2. loop-affinity guard: owner binding, foreign-thread findings,
     sanctioned handoff, adopt-on-first-use;
  3. disabled-mode contract: ``sanitized_lock`` returns the RAW lock
     (identity) and the enabled-mode proxy cost stays a small multiple
     of a bare acquire (the JAX bracket, scaled to a bare acquire);
  4. stall attribution: frames bucket to the owning subsystem (the
     port adds ``torch``, ``ops`` and ``kernels``);
  5. ``inject_lock_inversion`` is deterministic and its findings are
     classified as injected.
"""

import asyncio
import threading
import time

from cometbft_tpu.analysis import runtime as jrt
from cometbft_tpu_torch.analysis import runtime as prt
from torch_hard_limit import hard_limit  # noqa: F401

MODS = {"jax": jrt, "port": prt}


def both(case):
    got = {name: case(rt) for name, rt in MODS.items()}
    assert got["port"] == got["jax"]
    return got["port"]


def _san(rt):
    s = rt.ConcurrencySanitizer()
    s.enable()
    return s


def _lock(rt, san, name):
    return rt.SanitizedLock(san, threading.Lock(), name)


def _kinds(san):
    return [f.kind for f in san.findings]


# --- 1. lock-order graph -------------------------------------------------


def test_abba_inversion_detected_with_both_stacks():
    def case(rt):
        san = _san(rt)
        a, b = _lock(rt, san, "plane.a"), _lock(rt, san, "plane.b")
        with a:
            with b:
                pass
        assert not san.findings  # one order alone is fine
        with b:
            with a:
                pass
        assert _kinds(san) == ["lock-order-cycle"]
        d = san.findings[0].detail
        assert sorted(d["locks"]) == ["plane.a", "plane.b"]
        # BOTH acquisition stacks present and point at this test
        assert any("test_torch_sanitizer" in ln for ln in d["stack_forward"])
        assert any("test_torch_sanitizer" in ln for ln in d["stack_reverse"])
        return _kinds(san), d["locks"], d["edge"], d["reverse"]

    both(case)


def test_consistent_order_never_reports():
    def case(rt):
        san = _san(rt)
        a, b = _lock(rt, san, "x.a"), _lock(rt, san, "x.b")
        for _ in range(50):
            with a:
                with b:
                    pass
        assert not san.findings
        assert san.stats()["edges"] == 1
        return san.stats()

    both(case)


def test_three_lock_cycle_detected():
    def case(rt):
        san = _san(rt)
        a, b, c = (_lock(rt, san, n) for n in ("c3.a", "c3.b", "c3.c"))
        with a:
            with b:
                pass
        with b:
            with c:
                pass
        assert not san.findings
        with c:
            with a:
                pass
        assert _kinds(san) == ["lock-order-cycle"]
        assert set(san.findings[0].detail["locks"]) == {"c3.a", "c3.b", "c3.c"}
        return _kinds(san), san.findings[0].detail["reverse"]

    both(case)


def test_cycle_reported_once_per_lock_set():
    def case(rt):
        san = _san(rt)
        a, b = _lock(rt, san, "once.a"), _lock(rt, san, "once.b")
        for _ in range(5):
            with a:
                with b:
                    pass
            with b:
                with a:
                    pass
        assert len(san.findings) == 1
        return san.stats()

    both(case)


def test_rlock_reentrancy_no_self_edge():
    def case(rt):
        san = _san(rt)
        r = rt.SanitizedLock(san, threading.RLock(), "re.lock")
        with r:
            with r:  # reentrant: not an ordering edge
                pass
        assert san.stats()["edges"] == 0 and not san.findings
        return san.stats()

    both(case)


def test_condition_wait_releases_bookkeeping():
    """threading.Condition over a sanitized RLock keeps exact semantics
    AND the held-stack: while wait() has released the lock, another
    thread's acquire must not record a bogus edge."""

    def case(rt):
        san = _san(rt)
        lk = rt.SanitizedLock(san, threading.RLock(), "cond.lock")
        cond = threading.Condition(lk)
        other = _lock(rt, san, "cond.other")
        woke = threading.Event()

        def waiter():
            with cond:
                cond.wait(timeout=5.0)
                woke.set()

        t = threading.Thread(target=waiter)
        t.start()
        time.sleep(0.1)
        with other:
            pass
        with cond:
            cond.notify_all()
        t.join(5.0)
        assert woke.is_set()
        assert not san.findings
        return woke.is_set(), _kinds(san)

    both(case)


# --- 2. loop-affinity guard ----------------------------------------------


def test_affinity_owner_thread_is_clean():
    def case(rt):
        san = _san(rt)
        san.tag("aff.obj")
        for _ in range(3):
            san.touch("aff.obj")
        assert not san.findings
        return san.stats()

    both(case)


def test_affinity_foreign_thread_flagged_once():
    def case(rt):
        san = _san(rt)
        san.tag("aff.hot")

        def foreign():
            san.touch("aff.hot")
            san.touch("aff.hot")  # deduped per (object, thread)

        t = threading.Thread(target=foreign, name="foreign-t")
        t.start()
        t.join(5.0)
        assert _kinds(san) == ["loop-affinity"]
        d = san.findings[0].detail
        assert d["object"] == "aff.hot" and d["thread"] == "foreign-t"
        assert any("test_torch_sanitizer" in ln for ln in d["stack"])
        return _kinds(san), d["object"], d["owner"], d["thread"]

    both(case)


def test_affinity_handoff_is_sanctioned():
    def case(rt):
        san = _san(rt)
        san.tag("aff.pool")

        def worker():
            with san.handoff("aff.pool"):
                san.touch("aff.pool")

        t = threading.Thread(target=worker)
        t.start()
        t.join(5.0)
        assert not san.findings
        # without the handoff the same touch DOES report
        t2 = threading.Thread(target=lambda: san.touch("aff.pool"))
        t2.start()
        t2.join(5.0)
        assert _kinds(san) == ["loop-affinity"]
        return _kinds(san)

    both(case)


def test_touch_adopt_binds_first_caller():
    def case(rt):
        san = _san(rt)
        san.touch_adopt("adopt.obj")  # first use adopts
        san.touch_adopt("adopt.obj")
        assert not san.findings
        t = threading.Thread(target=lambda: san.touch_adopt("adopt.obj"))
        t.start()
        t.join(5.0)
        assert _kinds(san) == ["loop-affinity"]
        return _kinds(san), san.stats()["tagged"]

    both(case)


def test_untagged_touch_is_noop():
    def case(rt):
        san = _san(rt)
        san.touch("never.tagged")
        assert not san.findings
        return san.stats()

    both(case)


# --- 3. disabled-mode / overhead contract --------------------------------


def test_disabled_sanitized_lock_returns_raw_lock():
    """Disabled mode is free BY CONSTRUCTION: the raw lock comes back
    unchanged (identity)."""

    def case(rt):
        was = rt.get_sanitizer().enabled
        rt.disable()
        try:
            raw = threading.Lock()
            assert rt.sanitized_lock(raw, "free.lock") is raw
            rraw = threading.RLock()
            assert rt.sanitized_lock(rraw, "free.rlock") is rraw
            rt.enable()
            wrapped = rt.sanitized_lock(raw, "free.lock")
            assert wrapped is not raw and isinstance(wrapped, rt.SanitizedLock)
            return type(wrapped).__name__, wrapped.name
        finally:
            if not was:
                rt.disable()

    both(case)


def test_disabled_touch_is_attribute_check():
    def case(rt):
        san = _san(rt)
        san.disable()
        san.tag("cheap.obj")  # tag ignores enablement; touch must no-op
        t = threading.Thread(target=lambda: san.touch("cheap.obj"))
        t.start()
        t.join(5.0)
        assert not san.findings
        return _kinds(san)

    both(case)


def test_enabled_acquire_overhead_bounded():
    """Enabled-mode proxy acquire/release against a bare lock: the
    steady state (edges already known, nothing else held) stays a
    small multiple. The JAX bracket (25x a bare cycle + 20 us)."""
    import gc

    def case(rt):
        san = _san(rt)
        raw = threading.Lock()
        wrapped = _lock(rt, san, "ov.lock")
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

        def raw_cycle():
            raw.acquire()
            raw.release()

        def wrapped_cycle():
            wrapped.acquire()
            wrapped.release()

        gc.disable()
        try:
            base = per_call(raw_cycle)
            got = per_call(wrapped_cycle)
        finally:
            gc.enable()
        assert got < base * 25 + 20_000, (rt.__name__, base, got)
        return san.stats()["lock_acquires"]

    both(case)


# --- 4. stall attribution ------------------------------------------------


def test_attribute_frames_buckets_by_plane():
    stacks = [
        ["consensus/wal.py:254 write", "asyncio/events.py:80 _run"],
        ["chaos/nemesis.py:38 chaos_stall"],
        ["asyncio/events.py:80 _run", "p2p/switch.py:100 receive"],
        ["somewhere/else.py:1 f"],
        [],
    ]

    def case(rt):
        return [rt.attribute_frames(s) for s in stacks]

    assert both(case) == ["consensus", "chaos", "p2p", "unknown", "unknown"]
    # the port's own buckets: the torch library, its ops layer and the
    # kernels' loader (the JAX package has no such frames)
    assert prt.attribute_frames(["torch/cuda/__init__.py:954 synchronize", "ops/ed25519.py:80 verify"]) == "torch"
    assert prt.attribute_frames(["ops/ed25519.py:300 verify_batch_async"]) == "ops"
    assert prt.attribute_frames(["cometbft_tpu_torch/kernels.py:120 build_all"]) == "kernels"
    assert prt.attribute_stall({"loop_stack": ["light/serving.py:700 serve"]}) == "light"
    assert prt.attribute_stall({}) == "unknown"


# --- 5. injection --------------------------------------------------------


def test_inject_lock_inversion_deterministic():
    def case(rt):
        g = rt.get_sanitizer()
        was = g.enabled
        g.enable()
        try:
            g.reset()
            rec = rt.inject_lock_inversion()
            assert rec["enabled"]
            assert rec["observed"] == ["lock-order-cycle", "loop-affinity"]
            finds = g.snapshot()
            assert {f["kind"] for f in finds} == {"lock-order-cycle", "loop-affinity"}
            # every injected finding is classified as injected, and a
            # genuine finding is NOT
            assert all(rt.injected_finding(f) for f in finds)
            assert not rt.injected_finding({"detail": {"locks": ["wal.append", "mempool.pool"]}})
            return rec, sorted(f["kind"] for f in finds)
        finally:
            g.reset()
            if not was:
                g.disable()

    both(case)


def test_flight_record_carries_subsystem():
    """The watchdog's flight record names the guilty subsystem (the
    chaos_stall frame lives in chaos/nemesis.py), in both packages."""
    import cometbft_tpu.chaos.nemesis as jnemesis
    import cometbft_tpu.obs as jobs
    import cometbft_tpu_torch.chaos.nemesis as pnemesis
    import cometbft_tpu_torch.obs as pobs

    def case(obs, nemesis):
        wd = obs.LoopWatchdog(interval_s=0.02, stall_s=0.1, name="attr")

        async def main():
            wd.start()
            await asyncio.sleep(0.1)
            nemesis.chaos_stall(0.4)  # block the loop; monitor fires mid-stall
            await asyncio.sleep(0.2)
            wd.stop()
            return list(wd.stalls)

        stalls = asyncio.run(asyncio.wait_for(main(), 60))
        assert stalls, "stall not captured"
        assert stalls[0]["subsystem"] == "chaos", stalls[0]
        return stalls[0]["subsystem"]

    assert case(pobs, pnemesis) == case(jobs, jnemesis)


# --- 6. chaos pipeline ---------------------------------------------------


def test_chaos_lock_inversion_schedule_detects(tmp_path):
    """The acceptance shape: a seeded schedule carrying lock_inversion
    runs a real 4-node net, the sanitizer reports BOTH injected
    findings, they are expected (run stays OK), and they ride the
    report; the nemesis record is the JAX injection's."""
    from cometbft_tpu_torch.chaos import FaultEvent, FaultSchedule, run_schedule

    sched = FaultSchedule([FaultEvent(action="lock_inversion", at_height=2)])
    report = asyncio.run(
        asyncio.wait_for(
            run_schedule(sched, seed=1337, base_dir=str(tmp_path), n_nodes=4, liveness_bound_s=60.0, device="cpu"),
            240,
        )
    )
    assert report.ok, report.violations
    kinds = {f["kind"] for f in report.sanitizer_findings}
    assert {"lock-order-cycle", "loop-affinity"} <= kinds
    # the nemesis trace records what the injection observed — part of
    # the seed-line replay contract
    ev = report.trace[0]
    assert ev["action"] == "lock_inversion"
    assert ev["observed"] == ["lock-order-cycle", "loop-affinity"]
    g = jrt.get_sanitizer()
    was = g.enabled
    g.enable()
    try:
        g.reset()
        want = jrt.inject_lock_inversion()
    finally:
        g.reset()
        if not was:
            g.disable()
    assert {k: ev[k] for k in want} == want


def test_chaos_missed_detection_is_violation(tmp_path):
    """A sanitizer that cannot flag its own injection proves nothing:
    with the sanitizer force-disabled, a scheduled lock_inversion
    must FAIL the run."""
    from cometbft_tpu_torch.chaos import FaultEvent, FaultSchedule, run_schedule

    g = prt.get_sanitizer()
    sched = FaultSchedule([FaultEvent(action="lock_inversion", at_height=2)])

    def no_sanitizer(cfg):
        # keep build_node from re-enabling the process-wide sanitizer
        cfg.instrumentation.sanitizer = False

    async def main():
        g.disable()
        return await run_schedule(
            sched,
            seed=1338,
            base_dir=str(tmp_path),
            n_nodes=4,
            liveness_bound_s=60.0,
            config_hook=no_sanitizer,
            device="cpu",
        )

    try:
        report = asyncio.run(asyncio.wait_for(main(), 240))
    finally:
        g.enable()
    assert not report.ok
    assert any("lock_inversion injected" in v for v in report.violations)
