"""The port's catch-up spans: the replay loop's ``blocksync.window.*``
and the executor's ``exec.*`` phases on one tracer, and the benchmark's
readers of them.

A joiner catches up a 30-block chain through ``BlockSyncReactor``
(``device="cpu"``, windows of 8) with a ``Tracer`` set on the reactor.
Its first peer serves height 1 tampered, so the first pass applies
nothing and the routine backs off; the routine starts before any block
is buffered, so it first waits on its peers; after each pass it yields
to the pool's fetch tasks. The cases read the ring:
every span is named, nests where docs/TRACE.md says, and overlaps
nothing it must not. A second joiner, its reactor left on ``NOOP``,
records no window span. The benchmark's per-block readers are checked
on hand-built contexts.
"""

import asyncio
import importlib.util
import json
from pathlib import Path

import pytest
import torch

from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
from cometbft_tpu_torch.trace import NOOP, Tracer
from cometbft_tpu_torch.utils.chaingen import StorePeerClient, TamperingPeerClient, make_chain
from torch_hard_limit import hard_limit  # noqa: F401

CPU = "cpu"
N_BLOCKS = 30
ROOT = Path(__file__).resolve().parent.parent
W = "blocksync.window."
PHASES = ("exec.finalize", "exec.save", "exec.commit", "exec.events")
NEW_SPANS = {W + "lookahead", W + "fill_wait", W + "backoff", W + "yield", W + "stage", W + "exec", *PHASES}


def _end(e):
    return e["ts_ns"] + e["dur_ns"]


def _inside(inner, outer):
    return outer["ts_ns"] <= inner["ts_ns"] and _end(inner) <= _end(outer)


def _disjoint(a, b):
    return _end(a) <= b["ts_ns"] or _end(b) <= a["ts_ns"]


def _catch_up(traced: bool):
    """(events of the reactor's tracer, events of the joiner's own ring,
    the reactor, the joiner) after a whole catch-up."""
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    try:
        gen, privs = make_genesis(3, chain_id="span-chain")
        src = make_chain(gen, privs, N_BLOCKS, device=CPU)

        async def main():
            fresh = build_node(gen, device=CPU)
            caught = asyncio.Event()
            reactor = BlockSyncReactor(
                fresh.state,
                fresh.block_exec,
                fresh.block_store,
                on_caught_up=lambda st: caught.set(),
                verify_window=8,
                device=CPU,
            )
            tracer = Tracer(name="spans", size=1 << 15)
            if traced:
                reactor.tracer = tracer
            await reactor.start()
            reactor.pool.set_peer_range("evil", TamperingPeerClient(src, 1), 1, 1)
            loop = asyncio.get_running_loop()
            deadline = loop.time() + 60
            while 1 not in reactor.pool.blocks:
                assert loop.time() < deadline, "the tampering peer never served height 1"
                await asyncio.sleep(0.01)
            reactor.pool.set_peer_range("good", StorePeerClient(src), 1, src.block_store.height())
            await asyncio.wait_for(caught.wait(), 90)
            await reactor.stop()
            assert reactor.loop_errors.count == 0, reactor.loop_errors
            return tracer.snapshot(), fresh.tracer.snapshot(), reactor, fresh

        return asyncio.run(asyncio.wait_for(main(), 120))
    finally:
        sched_mod.set_scheduler(None)
        pv.set_engine(None)
        eng.close()


@pytest.fixture(scope="module")
def traced():
    return _catch_up(traced=True)


def _named(events, name):
    return [e for e in events if e["name"] == name]


def test_catch_up_records_every_new_span(traced):
    events, _, reactor, fresh = traced
    assert reactor.blocks_applied >= N_BLOCKS - 2
    assert fresh.block_store.height() == reactor.blocks_applied
    assert NEW_SPANS <= {e["name"] for e in events}
    # the tampered height: a pass that applied nothing, then a refetch
    assert [e["args"]["reason"] for e in _named(events, W + "backoff")][:1] == ["none_applied"]
    assert len(_named(events, W + "apply")) >= 2
    assert any(e["args"]["jobs"] > 0 for e in _named(events, W + "lookahead"))
    assert all("blocks" in e["args"] for e in _named(events, W + "fill_wait"))
    assert reactor.last_window_bps > 0


def test_one_exec_span_a_block_holds_its_four_phases(traced):
    events, _, reactor, _ = traced
    execs = _named(events, W + "exec")
    assert sorted(e["args"]["height"] for e in execs) == list(range(1, reactor.blocks_applied + 1))
    for ex in execs:
        h = ex["args"]["height"]
        for phase in PHASES:
            mine = [e for e in _named(events, phase) if e["args"]["height"] == h]
            assert len(mine) == 1, (h, phase, mine)
            assert _inside(mine[0], ex), (h, phase)
    for phase in PHASES:
        assert len(_named(events, phase)) == reactor.blocks_applied, phase


def test_stage_persist_and_exec_nest_in_apply_and_do_not_overlap(traced):
    events, _, _, _ = traced
    applies = _named(events, W + "apply")
    children = [e for e in events if e["name"] in (W + "stage", W + "persist", W + "exec")]
    assert len(_named(events, W + "stage")) == len(applies)
    for c in children:
        owners = [a for a in applies if _inside(c, a)]
        assert len(owners) == 1, c
    for a in applies:
        mine = sorted((c for c in children if _inside(c, a)), key=lambda c: c["ts_ns"])
        assert mine[0]["name"] == W + "stage"
        for x, y in zip(mine, mine[1:]):
            assert _disjoint(x, y), (x, y)


def test_lookahead_sits_between_verify_wait_and_apply(traced):
    events, _, _, _ = traced
    waits, looks, applies = (_named(events, W + s) for s in ("verify_wait", "lookahead", "apply"))
    assert len(waits) == len(looks) == len(applies)
    for wait, look, apply in zip(waits, looks, applies):
        assert _end(wait) <= look["ts_ns"] and _end(look) <= apply["ts_ns"], (wait, look, apply)
    for p in _named(events, W + "prepare"):
        for look in looks:
            assert _disjoint(p, look)


@pytest.mark.parametrize("between", ["fill_wait", "backoff", "yield"])
def test_span_between_passes_overlaps_no_other_window_span(traced, between):
    events, _, _, _ = traced
    mine = _named(events, W + between)
    others = [e for e in events if e["name"].startswith(W) and e["name"] != W + between]
    assert mine and others
    for f in mine:
        for o in others:
            assert _disjoint(f, o), (f, o)


def test_a_yield_follows_each_pass_before_the_next(traced):
    events, _, _, _ = traced
    passes = sorted(_named(events, W + "apply") + _named(events, W + "backoff"), key=lambda e: e["ts_ns"])
    starts = sorted(e["ts_ns"] for e in _named(events, W + "prepare"))
    yields = _named(events, W + "yield")
    for p in passes:
        nxt = min((t for t in starts if t >= _end(p)), default=None)
        mine = [y for y in yields if y["ts_ns"] >= _end(p) and (nxt is None or _end(y) <= nxt)]
        assert len(mine) == 1, (p, mine)


def test_reactor_tracer_reaches_its_executor(traced):
    _, node_ring, reactor, fresh = traced
    assert fresh.block_exec.tracer is reactor.tracer
    assert reactor.tracer is not fresh.tracer
    # the executor recorded on the reactor's tracer, not the node's
    assert not [e for e in node_ring if e["name"].startswith("exec.")]


def test_reactor_left_on_noop_records_no_window_span():
    events, node_ring, reactor, fresh = _catch_up(traced=False)
    assert reactor.tracer is NOOP and events == [] and NOOP.snapshot() == []
    assert reactor.blocks_applied >= N_BLOCKS - 2
    # build_node points the executor at the node's ring: its phases land
    # there, and no window span does
    assert fresh.block_exec.tracer is fresh.tracer
    names = [e["name"] for e in node_ring]
    assert names.count("exec.finalize") == reactor.blocks_applied
    assert not [n for n in names if n.startswith(W)]


# --- the benchmark's readers -------------------------------------------------

READERS = {
    "blocksync.lookahead_ms_per_block": W + "lookahead",
    "blocksync.fill_wait_ms_per_block": W + "fill_wait",
    "blocksync.stage_ms_per_block": W + "stage",
    "exec.block_ms_per_block": W + "exec",
}


def _reader(name):
    path = ROOT / "bftbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"reader_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", sorted(READERS))
def test_new_reader_gives_its_span_per_block(name):
    span = READERS[name]
    other = W + "apply"
    ctx = {"blocksync_ns": {span: 7_500_000, other: 90_000_000}, "attempted": 3}
    assert _reader(name).read(ctx) == pytest.approx(2.5)


@pytest.mark.parametrize("name", sorted(READERS))
def test_new_reader_gives_none_without_its_span(name):
    ctx = {"blocksync_ns": {W + "apply": 90_000_000}, "attempted": 3}
    assert _reader(name).read(ctx) is None
    assert _reader(name).read({"attempted": 3}) is None
    assert _reader(name).read({"blocksync_ns": {READERS[name]: 1_000_000}, "attempted": 0}) is None


def _per_layer():
    return json.loads((ROOT / "BENCHMARK.json").read_text())["per_layer"]


@pytest.mark.parametrize("name", [m["name"] for m in _per_layer()])
def test_every_per_layer_entry_has_its_reader(name):
    assert (ROOT / "bftbench" / "metrics" / f"{name}.py").is_file()


def test_new_entries_read_spans_of_the_catch_up_cell():
    entries = {m["name"]: m for m in _per_layer()}
    for name in READERS:
        m = entries[name]
        assert (m["source"], m["moves"], m["workloads"]) == (
            "program_span", "catchup_blocks_per_s", ["catchup.osmosis150"])
        # a layer that BENCHMARK.json already names, letter for letter
        same = "exec.apply_ms_per_block" if name.startswith("exec.") else "blocksync.prepare_ms_per_block"
        assert m["layer"] == entries[same]["layer"]
