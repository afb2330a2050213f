"""The port's Prometheus metrics (utils/metrics.py) held to the JAX
package's: the cases of ``tests/test_metrics.py`` and the two
``test_light_metrics_*`` cases of ``tests/test_light_serving.py``, on
the port, and parity cases.

- The real tier: a bare ``NodeMetrics`` serves its families over HTTP;
  a one-validator ``Node`` with ``prometheus = true`` exposes live
  consensus gauges, the span→metrics bridge's histograms, the loop-lag
  histogram, queue gauges, quorum latency and vote skew; over lp2p the
  traffic gauges read the muxed peers and stamped traffic lands
  propagation samples; a light serving plane's spans feed the light
  families; a blocksync joiner's spans feed the block-processing
  histogram (one ``exec.finalize`` a block), the window histogram and
  the window gauge.
- The missing-library tier is a refusal, not a placeholder (a port
  departure): where the JAX module degrades every metric to a no-op
  shim and serves a placeholder page, the port's ``NodeMetrics``
  raises ``MetricsUnavailable``, ``Node.start`` with ``prometheus =
  true`` fails before it opens anything, and a light serving front
  cannot attach. These three cases keep the JAX shim cases' places.
- Parity: a bare ``NodeMetrics`` of each package registers the same
  families (name, type, help text) with the same label names and
  histogram buckets; a one-validator node of each package, driven
  alike, exposes the same sample names (but the port's fill-wait window
  samples), label names and queue labels, and equal deterministic
  counters (txs committed, blocks synced,
  validators, peers, mempool size).
"""

import asyncio
import importlib
import sys
import time

import aiohttp
import pytest
import torch

from cometbft_tpu.utils import metrics as jmetrics
from cometbft_tpu_torch.config.config import test_config as make_test_cfg
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.node.inprocess import make_genesis, make_privvals
from cometbft_tpu_torch.node.node import Node
from cometbft_tpu_torch.utils import metrics as metrics_mod
from torch_hard_limit import hard_limit  # noqa: F401


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def run(coro, timeout=120):
    return asyncio.run(asyncio.wait_for(coro, timeout))


class _without_prometheus:
    """The metrics module reloaded as it imports where
    ``prometheus_client`` is missing (a None entry in ``sys.modules``
    makes the import raise ImportError); restored on exit."""

    def __enter__(self):
        self.saved = {k: v for k, v in sys.modules.items()
                      if k == "prometheus_client" or k.startswith("prometheus_client.")}
        for k in self.saved:
            sys.modules[k] = None
        sys.modules["prometheus_client"] = None
        return importlib.reload(metrics_mod)

    def __exit__(self, *exc):
        for k in list(sys.modules):
            if k == "prometheus_client" or k.startswith("prometheus_client."):
                del sys.modules[k]
        sys.modules.update(self.saved)
        importlib.reload(metrics_mod)
        return False


def _value(text, prefix):
    lines = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    assert lines, f"{prefix} not rendered"
    return float(lines[0].split()[-1])


async def _scrape(addr):
    async with aiohttp.ClientSession() as s:
        async with s.get(f"http://{addr}/metrics") as resp:
            assert resp.status == 200
            return await resp.text()


# --- the missing-library tier: a refusal ----------------------------------


def test_metrics_shim_without_prometheus():
    """Without the library the module imports (the node without
    ``prometheus`` runs), but NodeMetrics refuses to build."""
    with _without_prometheus() as shimmed:
        assert not shimmed.HAVE_PROMETHEUS
        with pytest.raises(shimmed.MetricsUnavailable, match="prometheus_client"):
            shimmed.NodeMetrics("shim-chain")
    assert metrics_mod.HAVE_PROMETHEUS


def test_metrics_server_endpoint_shim_tier():
    """A node with ``prometheus = true`` and no library fails
    ``Node.start`` before it listens anywhere, instead of serving a
    placeholder page."""
    gen, privs = make_genesis(1, chain_id="shim-srv")
    cfg = make_test_cfg(".")
    cfg.instrumentation.prometheus = True
    cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
    node = Node(cfg, gen, privval=make_privvals(privs)[0], device="cpu")
    with _without_prometheus() as shimmed:
        async def main():
            with pytest.raises(shimmed.MetricsUnavailable):
                await node.start()
            assert node.metrics is None and node.metrics_server is None
            assert not node.transport.listen_addr
            assert node.switch.num_peers() == 0

        run(main())
    node.parts.close_stores()


def test_light_metrics_shim_tier():
    """A standalone light serving front cannot attach metrics without
    the library: the registry refuses before any span is bridged."""
    with _without_prometheus() as shimmed:
        with pytest.raises(shimmed.MetricsUnavailable):
            shimmed.NodeMetrics("serve-metrics-shim")


# --- the real tier ---------------------------------------------------------


def test_metrics_server_endpoint_real_tier_standalone():
    """A bare NodeMetrics (no node attached) serves the registered
    metric families over HTTP."""

    async def main():
        m = metrics_mod.NodeMetrics("real-srv")
        m.height.set(7)
        srv = metrics_mod.MetricsServer(m)
        await srv.start("127.0.0.1:0")
        try:
            text = await _scrape(srv.listen_addr)
        finally:
            await srv.stop()
        assert _value(text, "cometbft_consensus_height{") == 7
        for fam in ("cometbft_loop_lag_seconds", "cometbft_loop_stalls_total",
                    "cometbft_consensus_quorum_latency_seconds", "cometbft_p2p_msg_propagation_seconds",
                    "cometbft_consensus_vote_arrival_skew_seconds"):
            assert fam in text, fam

    run(main())


def test_prometheus_metrics_endpoint():
    gen, privs = make_genesis(1, chain_id="metrics-chain")

    async def main():
        cfg = make_test_cfg(".")
        cfg.instrumentation.prometheus = True
        cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
        node = Node(cfg, gen, privval=make_privvals(privs)[0], device="cpu")
        await node.start()
        try:
            node.parts.mempool.check_tx(b"m=1")
            while node.height < 3:
                await asyncio.sleep(0.05)
            text = await _scrape(node.metrics_server.listen_addr)
        finally:
            await node.stop()
        assert 'cometbft_consensus_height{chain_id="metrics-chain"}' in text
        assert _value(text, "cometbft_consensus_height{") >= 3
        for fam in ("cometbft_mempool_size", "cometbft_p2p_peers", "cometbft_consensus_total_txs",
                    "cometbft_blocksync_pipeline_reused_total", "cometbft_p2p_reconnect_attempts_total",
                    "cometbft_p2p_peer_flaps_total", "cometbft_p2p_starvation_seconds",
                    "cometbft_consensus_wal_fsync_seconds", "cometbft_blocksync_window_blocks_per_s",
                    "cometbft_queue_high_watermark{", "cometbft_queue_dropped_total{",
                    "cometbft_p2p_msg_propagation_seconds", "cometbft_crypto_coalesce_dispatches_total"):
            assert fam in text, fam
        lines = text.splitlines()
        # span→metrics bridge: consensus step spans landed by height 3
        steps = [ln for ln in lines if ln.startswith("cometbft_consensus_step_duration_seconds_count{")]
        assert steps and any(float(ln.split()[-1]) > 0 for ln in steps), steps
        # the loop watchdog's lag beats landed in the histogram
        assert _value(text, "cometbft_loop_lag_seconds_count{") > 0
        q_depth = [ln for ln in lines if ln.startswith("cometbft_queue_depth{")]
        assert any('queue="consensus.inbox"' in ln for ln in q_depth)
        assert any('queue="mempool.ingest"' in ln for ln in q_depth)
        # a single-node chain observes its own 2/3 quorum: both steps
        # carry samples by height 3, and the vote skew a peer="self"
        q_counts = [ln for ln in lines if ln.startswith("cometbft_consensus_quorum_latency_seconds_count{")]
        for step in ("prevote", "precommit"):
            lns = [ln for ln in q_counts if f'step="{step}"' in ln]
            assert lns and float(lns[0].split()[-1]) > 0, (step, q_counts)
        skew = [ln for ln in lines if ln.startswith("cometbft_consensus_vote_arrival_skew_seconds{")]
        assert any('peer="self"' in ln for ln in skew), skew

    run(main())


def test_prometheus_metrics_over_lp2p():
    """Traffic gauges read the lp2p peers' muxer counters, and stamped
    consensus traffic between two nodes of one process lands live
    propagation samples."""
    gen, privs = make_genesis(2, chain_id="metrics-lp2p")

    async def main():
        nodes = []
        for pv_ in make_privvals(privs):
            cfg = make_test_cfg(".")
            cfg.p2p.use_libp2p_equivalent = True
            cfg.instrumentation.prometheus = True
            cfg.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
            nodes.append(Node(cfg, gen, privval=pv_, device="cpu"))
        for n in nodes:
            await n.start()
        try:
            await nodes[0].dial(nodes[1].listen_addr)
            while any(n.height < 2 for n in nodes):
                await asyncio.sleep(0.05)
            text = await _scrape(nodes[0].metrics_server.listen_addr)
        finally:
            for n in nodes:
                await n.stop()
        assert _value(text, "cometbft_p2p_message_receive_bytes_total{") > 0
        prop = [ln for ln in text.splitlines() if ln.startswith("cometbft_p2p_msg_propagation_seconds_count{")]
        assert prop and any(float(ln.split()[-1]) > 0 for ln in prop), prop

    run(main())


def _emit_light_spans(tracer):
    t0 = time.monotonic_ns()
    tracer.complete("light.cache.hit", t0, 0, "light", height=5)
    tracer.complete("light.cache.hit", t0, 0, "light", height=5)
    tracer.complete("light.cache.miss", t0, 0, "light", height=6)
    tracer.complete("light.verify.coalesced", t0, 1000, "light", n=7)


def test_light_metrics_real_tier():
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import StoreBackedProvider
    from cometbft_tpu_torch.light.serving import LightServingPlane
    from cometbft_tpu_torch.trace.tracer import Tracer
    from cometbft_tpu_torch.utils.chaingen import make_chain

    gen, privs = make_genesis(4, chain_id="serve-metrics", seed=13)
    node = make_chain(gen, privs, 3, device="cpu")
    try:
        prov = StoreBackedProvider(gen.chain_id, node.block_store, node.state_store)
        lc = Client(gen.chain_id, TrustOptions(period_ns=24 * 3600 * 10**9, height=1,
                                               hash=prov.light_block(1).hash()), prov, device="cpu")
        m = metrics_mod.NodeMetrics("serve-metrics")
        tracer = Tracer(name="m", size=256)
        plane = LightServingPlane([lc], device="cpu")
        sess = plane.open_session()
        m.attach_light_serving(tracer, plane)
        _emit_light_spans(tracer)
        body = m.render().decode()
        for fam in ("cometbft_light_cache_hits_total", "cometbft_light_cache_misses_total",
                    "cometbft_light_verify_batch_size", "cometbft_light_sessions"):
            assert fam in body, fam
        assert _value(body, "cometbft_light_cache_hits_total{") == 2.0
        assert _value(body, "cometbft_light_cache_misses_total{") == 1.0
        assert _value(body, "cometbft_light_sessions{") == 1.0
        assert _value(body, "cometbft_light_verify_batch_size_count{") == 1.0
        assert _value(body, "cometbft_light_verify_batch_size_sum{") == 7.0
        sess.close()
        assert m.render().decode()  # render still healthy post-close
    finally:
        node.close_stores()


def test_blocksync_catch_up_feeds_block_processing_and_window_gauge():
    """A joiner's metrics attached as ``Node`` attaches them, its
    blocksync reactor on the node's ring as ``Node`` sets it: each
    applied block lands one ``exec.finalize`` observation in
    ``cometbft_state_block_processing_seconds``, the window gauge reads
    the last window's rate, and the lookahead, fill-wait, yield and
    staging stages reach ``cometbft_blocksync_window_seconds``."""
    import types

    from cometbft_tpu_torch.blocksync.reactor import BlockSyncReactor
    from cometbft_tpu_torch.node.inprocess import build_node
    from cometbft_tpu_torch.utils.chaingen import StorePeerClient, make_chain

    gen, privs = make_genesis(3, chain_id="sync-metrics", seed=21)
    src = make_chain(gen, privs, 20, device="cpu")

    async def main():
        fresh = build_node(gen, device="cpu")
        caught = asyncio.Event()
        reactor = BlockSyncReactor(fresh.state, fresh.block_exec, fresh.block_store,
                                   on_caught_up=lambda st: caught.set(), verify_window=8, device="cpu")
        reactor.tracer = fresh.tracer
        node = types.SimpleNamespace(
            parts=fresh, switch=types.SimpleNamespace(num_peers=lambda: 0, peers={}),
            blocksync_reactor=types.SimpleNamespace(inner=reactor), mempool_reactor=None,
            consensus_reactor=None)
        m = metrics_mod.NodeMetrics("sync-metrics")
        m.attach(node)
        assert _value(m.render().decode(), "cometbft_blocksync_window_blocks_per_s{") == 0.0
        await reactor.start()
        reactor.pool.set_peer_range("src", StorePeerClient(src), 1, src.block_store.height())
        await asyncio.wait_for(caught.wait(), 90)
        await reactor.stop()
        return m.render().decode(), reactor

    text, reactor = run(main())
    assert reactor.blocks_applied >= 18
    assert _value(text, "cometbft_state_block_processing_seconds_count{") == reactor.blocks_applied
    assert _value(text, "cometbft_blocksync_window_blocks_per_s{") == reactor.last_window_bps > 0
    for stage in ("prepare", "verify_wait", "lookahead", "fill_wait", "yield", "apply", "stage", "persist"):
        assert _value(text, f'cometbft_blocksync_window_seconds_count{{chain_id="sync-metrics",stage="{stage}"}}') > 0


# --- parity with the JAX package -------------------------------------------


def _families(m):
    """{name: (type, help, label names, histogram buckets)} of a
    NodeMetrics' registry."""
    out = {}
    for collector in list(m.registry._collector_to_names):
        bounds = getattr(collector, "_upper_bounds", None)
        for fam in collector.describe():
            out[fam.name] = (fam.type, fam.documentation, tuple(collector._labelnames),
                             tuple(bounds) if bounds is not None else None)
    return out


def test_metric_families_equal_jax():
    mine = _families(metrics_mod.NodeMetrics("parity"))
    theirs = _families(jmetrics.NodeMetrics("parity"))
    assert mine == theirs
    assert len(mine) >= 40


def _samples(text):
    """(sample name, label names) pairs and the queue label values of a
    scrape."""
    pairs, queues = set(), set()
    for ln in text.splitlines():
        if not ln or ln.startswith("#"):
            continue
        head = ln.rsplit(" ", 1)[0]
        name, _, labels = head.partition("{")
        keys = []
        for kv in labels.rstrip("}").split(","):
            if "=" in kv:
                k, _, v = kv.partition("=")
                keys.append(k)
                if k == "queue":
                    queues.add(v.strip('"'))
        pairs.add((name, tuple(sorted(keys))))
    return pairs, queues


DETERMINISTIC = ("cometbft_consensus_total_txs_total{", "cometbft_blocksync_blocks_synced{",
                 "cometbft_consensus_validators{", "cometbft_p2p_peers{", "cometbft_mempool_size{")


def test_node_metrics_equal_jax_on_the_same_run(tmp_path):
    """One validator of each package, the same genesis and the same
    three txs, each until the txs are committed and two more heights
    passed: both scrapes carry the same samples and label names, the
    same queues, and equal deterministic counters."""
    import os

    from cometbft_tpu.config.config import test_config as jtest_config
    from cometbft_tpu.crypto.keys import Ed25519PrivKey as JPriv
    from cometbft_tpu.node.node import Node as JNode
    from cometbft_tpu.privval.file_pv import FilePV as JFilePV
    from cometbft_tpu.types.genesis import GenesisDoc as JGenesisDoc

    gen, privs = make_genesis(1, chain_id="metrics-parity", seed=5)
    jgen = JGenesisDoc.from_json(gen.to_json())
    d = os.path.join(str(tmp_path), "jpv")
    os.makedirs(d)
    jpv = JFilePV(JPriv.from_seed(privs[0].seed), os.path.join(d, "key.json"), os.path.join(d, "state.json"))
    jpv.save_key()
    jpv.save_state()
    txs = [b"k%d=v%d" % (i, i) for i in range(3)]

    def pcfg():
        c = make_test_cfg(".")
        c.instrumentation.prometheus = True
        c.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
        return c

    def jcfg():
        c = jtest_config(".")
        c.p2p.laddr = "tcp://127.0.0.1:0"
        c.rpc.laddr = ""
        c.instrumentation.prometheus = True
        c.instrumentation.prometheus_listen_addr = "127.0.0.1:0"
        return c

    async def drive(node):
        await node.start()
        try:
            while node.height < 1:
                await asyncio.sleep(0.02)
            for tx in txs:
                assert node.parts.mempool.check_tx(tx).is_ok()

            def committed_at():
                for h in range(1, node.height + 1):
                    if txs[-1] in node.parts.block_store.load_block(h).data.txs:
                        return h
                return None

            while committed_at() is None:
                await asyncio.sleep(0.02)
            top = committed_at() + 2
            while node.height < top:
                await asyncio.sleep(0.02)
            # scrape between heights: the last block is an empty one
            while node.parts.block_store.load_block(node.height).data.txs:
                await asyncio.sleep(0.02)
            return await _scrape(node.metrics_server.listen_addr)
        finally:
            await node.stop()

    async def main():
        mine = await drive(Node(pcfg(), gen, privval=make_privvals(privs, root=str(tmp_path))[0], device="cpu"))
        theirs = await drive(JNode(jcfg(), jgen, privval=jpv))
        return mine, theirs

    mine, theirs = run(main(), timeout=120)
    (p_pairs, p_queues), (j_pairs, j_queues) = _samples(mine), _samples(theirs)
    # one departure: the port's replay loop spans its wait on peers
    # (blocksync.window.fill_wait), the JAX package's does not, so the
    # node's start in blocksync lands window samples of that stage alone
    stages = {ln.split('stage="', 1)[1].split('"', 1)[0] for ln in mine.splitlines()
              if ln.startswith("cometbft_blocksync_window_seconds_count{")}
    assert stages <= {"fill_wait"}, stages
    window = {n for n, _ in p_pairs if n.startswith("cometbft_blocksync_window_seconds_")}
    assert p_pairs - j_pairs == ({(n, k) for n, k in p_pairs if n in window} if stages else set()), (
        p_pairs ^ j_pairs)
    assert j_pairs <= p_pairs, (p_pairs ^ j_pairs)
    assert p_queues == j_queues and "mempool.ingest" in p_queues
    for prefix in DETERMINISTIC:
        assert _value(mine, prefix) == _value(theirs, prefix), prefix
    assert _value(mine, "cometbft_consensus_total_txs_total{") == 3
