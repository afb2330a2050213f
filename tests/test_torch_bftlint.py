"""The port's bftlint (``cometbft_tpu_torch.analysis``) against the JAX
package's, and its gate over the port.

Counterparts of the cases of ``tests/test_bftlint.py``:

1. the rule fixtures: for each of the JAX suite's fixture sources, the
   port's ``analyze_source`` at ``cometbft_tpu_torch/<plane>/x.py``
   gives the same rule IDs at the same lines and columns as the JAX
   one at ``cometbft_tpu/<plane>/x.py`` (JAX201-204 aside, which the
   port replaces by TCH201-204), and each positive still flags and
   each negative stays clean; the torch rules have their own
   fixtures, a true positive and a clean case each;
2. the suppression / baseline / CLI machinery contracts;
3. the call graph;
4. the gate over the port: ``cometbft_tpu_torch/`` lints clean against
   the package's own (empty) baseline, the command line fails on a
   seeded violation and times its rules, and a whole pass stays
   inside a CPU-time budget (C31: the JAX case holds a wall budget,
   which fails under the suite's load, C0);
5. whole-tree parity: the port's engine over the JAX package's tree,
   torch rules off, gives exactly the JAX engine's findings with its
   JAX rules off, with the tree's suppressions and with them stripped.

Every case that scans a whole tree or starts a process has the 300 s
hard limit of ``tests/torch_hard_limit.py``.
"""

import ast as _ast
import json
import re
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import test_bftlint as jref
from cometbft_tpu.analysis import analyze_source as janalyze_source
from cometbft_tpu.analysis import registry as jregistry
from cometbft_tpu.analysis.engine import run as jrun
from cometbft_tpu_torch.analysis import analyze_source
from cometbft_tpu_torch.analysis import baseline as baseline_mod
from cometbft_tpu_torch.analysis import registry
from cometbft_tpu_torch.analysis.callgraph import Project
from cometbft_tpu_torch.analysis.cli import DEFAULT_BASELINE, main
from cometbft_tpu_torch.analysis.engine import run
from cometbft_tpu_torch.analysis.findings import Finding
from cometbft_tpu_torch.analysis.registry import all_project_rules, all_rules, resolve
from torch_hard_limit import hard_limit  # noqa: F401

REPO_ROOT = Path(__file__).resolve().parents[1]
PORT = REPO_ROOT / "cometbft_tpu_torch"

# a whole pass of the port's engine over cometbft_tpu_torch/, in CPU
# seconds of the process (time.process_time): 14-18 s on a CPU host,
# alone and under the suite's `-n 6` load; the budget leaves room for
# a slower host and guards the growth curve, as the JAX wall budget
# did (ROADMAP C31)
WHOLE_PASS_CPU_BUDGET_S = 60.0


def port_path(jax_path: str) -> str:
    return jax_path.replace("cometbft_tpu/", "cometbft_tpu_torch/", 1)


def ids_of(src: str, path: str = "x.py"):
    return sorted({f.rule_id for f in analyze_source(textwrap.dedent(src), path)})


def sites(findings, drop_prefix):
    return sorted((f.rule_id, f.line, f.col) for f in findings if not f.rule_id.startswith(drop_prefix))


# --- 1. rule fixtures ---------------------------------------------------


@pytest.mark.parametrize(
    "rule_id,bad,good",
    jref.FIXTURES,
    ids=[f"{r}-{i}" for i, (r, _, _) in enumerate(jref.FIXTURES)],
)
def test_rule_fixture_matches_jax(rule_id, bad, good):
    jpath = jref.FIXTURE_PATHS.get(rule_id, "x.py")
    ppath = port_path(jpath)
    for src in (bad, good):
        src = textwrap.dedent(src)
        assert sites(analyze_source(src, ppath), "TCH") == sites(janalyze_source(src, jpath), "JAX")
    if not rule_id.startswith("JAX"):
        assert rule_id in ids_of(bad, ppath), f"{rule_id} missed its positive"
        assert rule_id not in ids_of(good, ppath), f"{rule_id} false-positived on its negative"


TCH_FIXTURES = [
    (
        "TCH201",  # host-sync-in-async-plane (a hot async plane)
        """
        import torch
        async def on_votes(verdicts, ev):
            ok = verdicts.cpu()
            n = verdicts.sum().item()
            torch.cuda.synchronize()
            ev.synchronize()
            return ok.tolist(), n
        """,
        """
        import asyncio
        async def on_votes(handle):
            return await asyncio.to_thread(lambda: handle.wait().result())
        def result(verdicts):
            return verdicts.cpu().numpy()  # sync context: fine
        """,
    ),
    (
        "TCH202",  # stray-cuda-synchronize
        """
        import torch
        def drain():
            torch.cuda.synchronize()
        """,
        """
        def drain(event):
            event.synchronize()  # the dispatch's own event: fine
        """,
    ),
    (
        "TCH203",  # tensor-element-loop (ops/)
        """
        import torch
        def limbs(n, t: torch.Tensor):
            a = torch.arange(n)
            out = [int(v) for v in a]
            for i, v in enumerate(t.tolist()):
                out.append(v + i)
            return out
        """,
        """
        import torch
        def limbs(n, items):
            a = torch.arange(n)
            for i in range(10):
                a = a + i
            for m, pk, sig in items:
                pass
            return a * 2
        """,
    ),
    (
        "TCH204",  # per-call-kernel-build: in a per-dispatch function
        """
        import ctypes
        def verify_batch(items, path):
            lib = ctypes.CDLL(path)
            return lib.verify(items)
        """,
        """
        import ctypes
        _lib = None
        def load(path):
            global _lib
            if _lib is None:
                _lib = ctypes.CDLL(path)
            return _lib
        def verify_batch(items, path):
            return load(path).verify(items)
        """,
    ),
    (
        "TCH204",  # in a loop, and built and invoked in one expression
        """
        import torch
        from cometbft_tpu_torch import kernels
        def warm(names, f, x):
            for n in names:
                kernels.build_all()
            return torch.compile(f)(x)
        """,
        """
        import torch
        from cometbft_tpu_torch import kernels
        def prepare(f):
            kernels.build_all()
            return torch.compile(f)
        """,
    ),
]

TCH_PATHS = {
    "TCH201": "cometbft_tpu_torch/consensus/x.py",
    "TCH202": "cometbft_tpu_torch/consensus/x.py",
    "TCH203": "cometbft_tpu_torch/ops/x.py",
    "TCH204": "cometbft_tpu_torch/ops/x.py",
}


@pytest.mark.parametrize(
    "rule_id,bad,good", TCH_FIXTURES, ids=[f"{r}-{i}" for i, (r, _, _) in enumerate(TCH_FIXTURES)]
)
def test_torch_rule_fixture(rule_id, bad, good):
    path = TCH_PATHS[rule_id]
    assert rule_id in ids_of(bad, path), f"{rule_id} missed its positive"
    assert rule_id not in ids_of(good, path), f"{rule_id} false-positived on its negative"


def test_torch_rules_are_scoped():
    """TCH201 only in the async planes, TCH202 not at the designated
    sync points, TCH203 only in ops/."""
    sync = TCH_FIXTURES[0][1]
    assert "TCH201" in ids_of(sync, "cometbft_tpu_torch/node/x.py")
    assert "TCH201" not in ids_of(sync, "cometbft_tpu_torch/ops/x.py")
    assert "TCH201" not in ids_of(sync, "x.py")
    stray = TCH_FIXTURES[1][1]
    for path in ("cometbft_tpu_torch/ops/ed25519.py", "cometbft_tpu_torch/kernels.py", "chip_smoke.py"):
        assert "TCH202" not in ids_of(stray, path), path
    assert "TCH202" in ids_of(stray, "x.py")
    assert "TCH203" not in ids_of(TCH_FIXTURES[2][1], "cometbft_tpu_torch/consensus/x.py")
    # each host-sync spelling is its own finding
    found = [f for f in analyze_source(textwrap.dedent(sync), TCH_PATHS["TCH201"]) if f.rule_id == "TCH201"]
    assert [f.line for f in found] == [4, 5, 6, 7, 8]


def test_asy109_scoped_to_hot_planes():
    src = """
    import asyncio
    def f():
        return asyncio.Queue()
    """
    assert "ASY109" not in ids_of(src)
    assert "ASY109" not in ids_of(src, "cometbft_tpu_torch/utils/x.py")
    for pkg in ("p2p", "consensus", "types", "obs", "rpc"):
        assert "ASY109" in ids_of(src, f"cometbft_tpu_torch/{pkg}/x.py"), pkg
        # the same planes in the JAX tree, for the whole-tree parity
        assert "ASY109" in ids_of(src, f"cometbft_tpu/{pkg}/x.py"), pkg


def test_asy107_scoped_to_trace_package():
    src = """
    import time
    def stamp():
        return time.time()
    """
    assert "ASY107" not in ids_of(src)
    assert "ASY107" in ids_of(src, "cometbft_tpu_torch/trace/export.py")
    assert "ASY107" in ids_of(src, "trace/export.py")


def test_asy116_sanctioned_registration():
    src = """
    class Indexer:
        def __init__(self, db):
            self.db = db
        def index(self, e):
            self.db.write_batch([(b"k", b"v")])
    class Service:
        def __init__(self, bus, idx: Indexer):
            self.idx = idx
            bus.add_sync_listener(idx.index)  # bftlint: disable=ASY116
    """
    assert "ASY116" not in ids_of(src)


def test_asy116_repo_indexer_shape_stays_clean():
    findings = [f for f in run([str(PORT / "state")]) if f.rule_id == "ASY116"]
    assert findings == [], findings


def test_at_least_eight_distinct_rules_have_fixtures():
    covered = {r for r, _, _ in jref.FIXTURES + TCH_FIXTURES if r not in ("SYN000",)}
    assert len(covered) >= 8, covered


def test_every_registered_rule_has_a_fixture():
    registered = {r.rule_id for r in all_rules()} | {pr.rule_id for pr in all_project_rules()}
    covered = {r for r, _, _ in jref.FIXTURES + TCH_FIXTURES}
    assert registered <= covered, registered - covered
    assert {r for r in registered if r.startswith("TCH")} == {"TCH201", "TCH202", "TCH203", "TCH204"}
    assert not any(r.startswith("JAX") for r in registered)


# --- 2a. suppression machinery -------------------------------------------


def test_disable_silences_only_named_rule_on_that_line():
    base = ids_of(jref.TWO_RULES_ONE_LINE.format(""))
    assert {"ASY101", "ASY106"} <= set(base)
    got = ids_of(jref.TWO_RULES_ONE_LINE.format("  # bftlint: disable=ASY106"))
    assert "ASY106" not in got and "ASY101" in got


def test_disable_does_not_leak_to_other_lines():
    src = """
    import time
    async def f():
        time.sleep(1)  # bftlint: disable=ASY101
        time.sleep(2)
    """
    found = analyze_source(textwrap.dedent(src), "x.py")
    assert [f.line for f in found if f.rule_id == "ASY101"] == [5]


def test_disable_by_rule_name_and_disable_next():
    src = """
    import time
    async def f():
        # bftlint: disable-next=blocking-call-in-async
        time.sleep(1)
    """
    assert "ASY101" not in ids_of(src)
    src = """
    import torch
    def drain():
        # bftlint: disable-next=stray-cuda-synchronize
        torch.cuda.synchronize()
    """
    assert "TCH202" not in ids_of(src)


def test_disable_file_silences_whole_file_one_rule_only():
    src = """
    # bftlint: disable-file=ASY101
    import asyncio, time
    async def f():
        time.sleep(1)
        asyncio.sleep(2)
    """
    got = ids_of(src)
    assert "ASY101" not in got and "ASY102" in got


def test_unknown_suppression_is_reported():
    src = """
    def f():
        return 1  # bftlint: disable=NOPE999
    """
    assert "SUP001" in ids_of(src)
    # a JAX rule is unknown to the port: the port has no JAX201
    assert "SUP001" in ids_of("def f():\n    return 1  # bftlint: disable=JAX201\n")


def test_resolve_accepts_id_and_name():
    assert resolve("ASY101") == "ASY101"
    assert resolve("blocking-call-in-async") == "ASY101"
    assert resolve("TCH203") == "TCH203"
    assert resolve("tensor-element-loop") == "TCH203"
    assert resolve("nope") is None


# --- 2b. baseline machinery ------------------------------------------------


def _f(path, line, rule="ASY104"):
    return Finding(path, line, 0, rule, "broad-except-in-async", "m")


def test_baseline_roundtrip(tmp_path):
    entries = baseline_mod.build([_f("a.py", 1), _f("a.py", 9)])
    p = tmp_path / "b.json"
    baseline_mod.save(str(p), entries)
    assert baseline_mod.load(str(p)) == {"a.py": {"ASY104": 2}}
    assert "cometbft_tpu_torch.analysis --update-baseline" in json.loads(p.read_text())["note"]


def test_baseline_exact_count_is_clean_and_over_is_new():
    bl = {"a.py": {"ASY104": 2}}
    new, stale = baseline_mod.apply([_f("a.py", 1), _f("a.py", 9)], bl)
    assert new == [] and stale == []
    new, stale = baseline_mod.apply([_f("a.py", 1), _f("a.py", 9), _f("a.py", 30)], bl)
    assert len(new) == 3
    assert stale == []


def test_stale_baseline_entries_are_reported():
    bl = {"a.py": {"ASY104": 2}, "gone.py": {"ASY101": 1}}
    new, stale = baseline_mod.apply([_f("a.py", 1)], bl)
    assert new == []
    got = {(s.path, s.rule_id, s.allowed, s.current) for s in stale}
    assert got == {("a.py", "ASY104", 2, 1), ("gone.py", "ASY101", 1, 0)}


# --- 2c. CLI exit-code contract --------------------------------------------


def test_cli_exit_zero_on_clean(tmp_path, capsys):
    p = tmp_path / "ok.py"
    p.write_text(jref.CLEAN)
    assert main([str(p), "--no-baseline"]) == 0
    assert "clean" in capsys.readouterr().out


def test_cli_exit_one_on_violation(tmp_path, capsys):
    p = tmp_path / "bad.py"
    p.write_text(jref.DIRTY)
    assert main([str(p), "--no-baseline"]) == 1
    assert "ASY101" in capsys.readouterr().out


def test_cli_baseline_covers_violation(tmp_path, capsys):
    p = tmp_path / "bad.py"
    p.write_text(jref.DIRTY)
    bl = tmp_path / "bl.json"
    assert main([str(p), "--baseline", str(bl), "--update-baseline"]) == 0
    capsys.readouterr()
    assert main([str(p), "--baseline", str(bl)]) == 0


def test_cli_stale_reported_and_fail_on_stale(tmp_path, capsys):
    p = tmp_path / "ok.py"
    p.write_text(jref.CLEAN)
    bl = tmp_path / "bl.json"
    baseline_mod.save(str(bl), {"nothere.py": {"ASY101": 1}})
    assert main([str(p), "--baseline", str(bl)]) == 0
    assert "stale baseline" in capsys.readouterr().out
    assert main([str(p), "--baseline", str(bl), "--fail-on-stale"]) == 1


def test_cli_json_format(tmp_path, capsys):
    p = tmp_path / "bad.py"
    p.write_text(jref.DIRTY)
    assert main([str(p), "--no-baseline", "--format", "json"]) == 1
    doc = json.loads(capsys.readouterr().out)
    assert doc["findings"][0]["rule_id"] == "ASY101"


def test_cli_syntax_error_fails(tmp_path):
    p = tmp_path / "broken.py"
    p.write_text("def f(:\n")
    assert main([str(p), "--no-baseline"]) == 1


def test_cli_nonexistent_path_is_usage_error(tmp_path, capsys):
    ghost = str(tmp_path / "no_such_dir")
    assert main([ghost, "--no-baseline"]) == 2
    bl = tmp_path / "bl.json"
    baseline_mod.save(str(bl), {"a.py": {"ASY104": 1}})
    assert main([ghost, "--baseline", str(bl), "--update-baseline"]) == 2
    assert baseline_mod.load(str(bl)) == {"a.py": {"ASY104": 1}}


def test_lockish_does_not_match_block_identifiers():
    src = """
    import asyncio
    async def f(self):
        with self.block_writer():
            await asyncio.sleep(0)
    """
    assert "ASY105" not in ids_of(src)
    src2 = """
    import asyncio
    async def f(self):
        with self.state_lock:
            await asyncio.sleep(0)
    """
    assert "ASY105" in ids_of(src2)


def test_build_invoke_in_loop_reports_once():
    """The counterpart of the JAX jit-wrap-and-invoke case: a build
    made and invoked inside a loop is one finding, not two."""
    src = """
    import torch
    def f(xs, g):
        for x in xs:
            y = torch.compile(g)(x)
        return y
    """
    found = [f for f in analyze_source(textwrap.dedent(src), "x.py") if f.rule_id == "TCH204"]
    assert len(found) == 1, found


# --- 2d. call graph ---------------------------------------------------------


def _proj(**files):
    return Project([
        (f"cometbft_tpu_torch/consensus/{k}.py", _ast.parse(textwrap.dedent(v)))
        for k, v in files.items()
    ])


F = "cometbft_tpu_torch/consensus/m.py"


def test_callgraph_cycles_terminate():
    p = _proj(m="""
        import time
        def a():
            b()
        def b():
            a()
            time.sleep(1)
        def pure_cycle_x():
            pure_cycle_y()
        def pure_cycle_y():
            pure_cycle_x()
    """)
    assert p.blocking_chain(F + "::a") == ["b", "time.sleep"]
    assert p.blocking_chain(F + "::pure_cycle_x") is None


def test_callgraph_inheritance_and_super_dispatch():
    p = _proj(m="""
        import time
        class Base:
            def helper(self):
                time.sleep(1)
            def stop(self):
                self.helper()
        class Child(Base):
            def stop(self):
                super().stop()
        class GrandChild(Child):
            def run(self):
                self.helper()
    """)
    assert p.blocking_chain(F + "::Child.stop") == ["super().stop", "self.helper", "time.sleep"]
    assert p.blocking_chain(F + "::GrandChild.run") == ["self.helper", "time.sleep"]


def test_callgraph_decorated_defs_still_resolve():
    p = _proj(m="""
        import functools, time
        def deco(fn):
            return fn
        @deco
        def helper():
            time.sleep(1)
        @functools.lru_cache(maxsize=None)
        def cached_helper():
            helper()
        def entry():
            cached_helper()
    """)
    assert p.blocking_chain(F + "::entry") == ["cached_helper", "helper", "time.sleep"]


def test_callgraph_functools_partial_edge():
    p = _proj(m="""
        import functools, time
        def helper(x):
            time.sleep(x)
        def entry():
            functools.partial(helper, 1)()
        def entry2(run):
            run(functools.partial(helper, 2))
    """)
    assert p.blocking_chain(F + "::entry") == ["helper", "time.sleep"]
    assert p.blocking_chain(F + "::entry2") == ["helper", "time.sleep"]


def test_callgraph_lambda_callees_attributed_to_enclosing():
    p = _proj(m="""
        import time
        def helper():
            time.sleep(1)
        def entry(xs):
            return sorted(xs, key=lambda x: helper())
    """)
    assert p.blocking_chain(F + "::entry") == ["helper", "time.sleep"]


def test_callgraph_attr_types_from_init_and_annotations():
    p = _proj(m="""
        class Wal:
            async def flush(self):
                pass
        class Pool:
            def __init__(self):
                self.inner = Wal()
        class CS:
            def __init__(self, wal: Wal):
                self.wal = wal
                self.pool = Pool()
    """)
    assert p.module_classes[F]["CS"].attr_types == {"wal": "Wal", "pool": "Pool"}
    assert p.module_classes[F]["Pool"].attr_types == {"inner": "Wal"}


def test_asy102_deep_chain_via_inferred_types():
    src = """
    class Pool:
        async def stop(self):
            pass
    class R:
        def __init__(self):
            self.pool = Pool()
        async def shutdown(self):
            self.pool.stop()
    """
    assert "ASY102" in ids_of(src)
    good = """
    class Pool:
        async def stop(self):
            pass
    class R:
        def __init__(self):
            self.pool = Pool()
        async def shutdown(self):
            await self.pool.stop()
        async def unknown_attr(self):
            self.other.stop()
    """
    assert "ASY102" not in ids_of(good)


def test_asy114_reports_the_full_chain_in_message():
    src = textwrap.dedent("""
    import time
    class Pool:
        def drain(self):
            self._wait()
        def _wait(self):
            time.sleep(0.5)
    class Reactor:
        def __init__(self):
            self.pool = Pool()
        async def run(self):
            self.pool.drain()
    """)
    found = [f for f in analyze_source(src, "cometbft_tpu_torch/consensus/x.py") if f.rule_id == "ASY114"]
    assert len(found) == 1
    assert "self.pool.drain" in found[0].message and "time.sleep" in found[0].message


def test_sanctioned_leaf_suppression_kills_chains():
    src = """
    import os, threading
    class W:
        def __init__(self):
            self._lock = threading.Lock()
        def _barrier(self, f):
            os.fsync(f.fileno())  # bftlint: disable=ASY114,ASY111
        def persist(self, f):
            with self._lock:
                self._barrier(f)
        async def apersist(self, f):
            self._barrier(f)
    """
    got = ids_of(src, "cometbft_tpu_torch/consensus/x.py")
    assert "ASY114" not in got and "ASY115" not in got
    direct = """
    import os, threading
    class W:
        def __init__(self):
            self._lock = threading.Lock()
        def persist(self, f):
            with self._lock:
                os.fsync(f.fileno())  # bftlint: disable=ASY114,ASY111
    """
    assert "ASY115" not in ids_of(direct, "cometbft_tpu_torch/consensus/x.py")


def test_asy114_scoped_to_hot_planes():
    src = """
    import time
    def helper():
        time.sleep(1)
    async def f():
        helper()
    """
    assert "ASY114" in ids_of(src, "cometbft_tpu_torch/consensus/x.py")
    assert "ASY114" in ids_of(src, "cometbft_tpu_torch/node/x.py")
    assert "ASY114" not in ids_of(src, "cometbft_tpu_torch/chaos/x.py")
    assert "ASY114" not in ids_of(src, "x.py")


def test_asy115_async_lock_flavor():
    src = """
    import time, asyncio
    class W:
        def _grind(self):
            time.sleep(0.1)
        async def hot(self):
            async with self._lock:
                self._grind()
    """
    assert "ASY115" in ids_of(src, "cometbft_tpu_torch/consensus/x.py")


# --- 3. the gate over the port ----------------------------------------------


def test_full_tree_is_clean_against_checked_in_baseline(capsys):
    rc = main([str(PORT)])
    out = capsys.readouterr().out
    assert rc == 0, f"bftlint regressions:\n{out}"


def test_seeded_violation_fixture_fails_the_gate(tmp_path):
    bad = tmp_path / "seeded.py"
    bad.write_text(
        "import asyncio, time\n"
        "async def reactor():\n"
        "    time.sleep(0.5)\n"
        "    asyncio.create_task(reactor())\n"
    )
    proc = subprocess.run(
        [sys.executable, "-m", "cometbft_tpu_torch.analysis", str(bad)],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 1, proc.stdout + proc.stderr
    assert "ASY101" in proc.stdout and "ASY103" in proc.stdout


def test_command_line_entry_point():
    """The counterpart of the JAX suite's ``tools/lint.sh`` case: the
    command line over the port (its default path) with --fail-on-stale
    and --timings passes and times the interprocedural rules too."""
    proc = subprocess.run(
        [sys.executable, "-m", "cometbft_tpu_torch.analysis", "--fail-on-stale", "--timings"],
        cwd=REPO_ROOT, capture_output=True, text=True, timeout=280,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "rule timings" in proc.stdout
    assert "ASY114*" in proc.stdout and "TCH201" in proc.stdout
    assert proc.stdout.strip().endswith("bftlint: clean")


def test_shipped_baseline_is_empty():
    """The port's own baseline, beside the package; the JAX one
    (tools/bftlint_baseline.json) is the JAX package's."""
    assert DEFAULT_BASELINE == PORT / "analysis" / "bftlint_baseline.json"
    assert json.loads(DEFAULT_BASELINE.read_text())["entries"] == {}


def test_whole_repo_pass_stays_under_budget():
    """C31: the JAX case's 15 s wall fails under the suite's load (C0);
    the port's holds the pass's CPU seconds, which load does not
    inflate the way it inflates a wall."""
    t0 = time.process_time()
    findings = run([str(PORT)])
    cpu = time.process_time() - t0
    assert findings == []
    assert cpu < WHOLE_PASS_CPU_BUDGET_S, f"bftlint took {cpu:.1f} CPU s (budget {WHOLE_PASS_CPU_BUDGET_S} s)"


# --- 4. whole-tree parity with the JAX engine ---------------------------------


def _without(monkeypatch, rules: dict, prefix: str) -> None:
    for rid in [r for r in rules if r.startswith(prefix)]:
        monkeypatch.delitem(rules, rid)


@pytest.fixture
def torch_and_jax_rules_off(monkeypatch):
    registry.all_rules()
    jregistry.all_rules()
    _without(monkeypatch, registry._RULES, "TCH")
    _without(monkeypatch, jregistry._RULES, "JAX")


def _key_set(findings, root: str):
    return sorted((f.path.split(root, 1)[-1], f.line, f.col, f.rule_id) for f in findings)


def test_whole_jax_tree_parity(torch_and_jax_rules_off):
    tree = str(REPO_ROOT / "cometbft_tpu")
    assert _key_set(run([tree]), "cometbft_tpu/") == _key_set(jrun([tree]), "cometbft_tpu/")


_DIRECTIVE = re.compile(r"#\s*bftlint:\s*disable")


def test_whole_jax_tree_parity_without_its_suppressions(torch_and_jax_rules_off, tmp_path):
    """The JAX tree with every suppression comment taken out: both
    engines find the same violations, each rule at the same sites."""
    src = REPO_ROOT / "cometbft_tpu"
    dst = tmp_path / "cometbft_tpu"
    n_stripped = 0
    for f in src.rglob("*.py"):
        if "__pycache__" in f.parts:
            continue
        text = f.read_text(encoding="utf-8")
        n_stripped += len(_DIRECTIVE.findall(text))
        out = dst / f.relative_to(src)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(_DIRECTIVE.sub("# stripped", text), encoding="utf-8")
    assert n_stripped >= 20
    port, jax = run([str(dst)]), jrun([str(dst)])
    assert len(jax) >= 20
    assert _key_set(port, "cometbft_tpu/") == _key_set(jax, "cometbft_tpu/")


# --- 5. what the port's own findings repaired --------------------------------


def test_unsafe_disconnect_peers_retains_its_tasks():
    """ASY103 in the port's rpc/core.py: the route dropped the task
    of each peer's removal, which the loop holds only weakly; it now
    spawns them through utils/tasks, which keeps each until it ends."""
    import asyncio
    import gc

    from cometbft_tpu_torch.rpc import core
    from cometbft_tpu_torch.utils import tasks

    removed = []

    async def main():
        gate = asyncio.Event()

        class Switch:
            peers = {"a": "peer-a", "b": "peer-b"}

            async def _remove_peer(self, peer, exc):
                await gate.wait()
                removed.append(peer)

        class Env:
            switch = Switch()

        before = tasks.pending_count()
        assert core.unsafe_disconnect_peers(Env()) == {"log": "disconnected 2 peers"}
        assert tasks.pending_count() == before + 2
        gc.collect()
        gate.set()
        for _ in range(10):
            await asyncio.sleep(0)
        assert sorted(removed) == ["peer-a", "peer-b"]
        assert tasks.pending_count() == before

    asyncio.run(main())
    src = (PORT / "rpc" / "core.py").read_text()
    assert "ASY103" not in ids_of(src, "cometbft_tpu_torch/rpc/core.py")
