"""Prometheus metrics (reference: per-subsystem metrics.go files
generated by metricsgen, exposed via node/node.go:913-931); a copy of
the JAX package's ``utils/metrics.py``.

One registry per node (labels carry chain_id like the reference's
MetricsProvider, node/setup.go:82-101); gauges that mirror live
state are callback-backed so collection never needs bookkeeping
hooks. Served over aiohttp at /metrics when
[instrumentation] prometheus = true. Every family keeps the JAX name,
labels and buckets.

Departure: ``prometheus_client`` is required, with no placeholder
tier. Where the JAX module degrades every metric to a no-op shim and
serves a placeholder page while the node reports ``prometheus =
true``, ``NodeMetrics`` here raises ``MetricsUnavailable`` when the
library is missing, so ``Node.start`` fails instead of exporting
nothing. ``HAVE_PROMETHEUS`` records whether it imported."""

from __future__ import annotations

import time
from typing import Optional

try:
    from prometheus_client import (
        CONTENT_TYPE_LATEST,
        CollectorRegistry,
        Counter,
        Gauge,
        Histogram,
        generate_latest,
    )

    HAVE_PROMETHEUS = True
except ImportError:
    HAVE_PROMETHEUS = False


class MetricsUnavailable(RuntimeError):
    """``prometheus_client`` is not installed: the node cannot export
    the metrics its config asks for."""


from ..types import events as ev

NS = "cometbft"


class NodeMetrics:
    def __init__(self, chain_id: str):
        if not HAVE_PROMETHEUS:
            raise MetricsUnavailable(
                "instrumentation.prometheus needs the prometheus_client package, which is not installed"
            )
        self.registry = CollectorRegistry()
        self.chain_id = chain_id
        label = {"chain_id": chain_id}

        def gauge(sub, name, doc):
            g = Gauge(
                f"{NS}_{sub}_{name}", doc, ["chain_id"],
                registry=self.registry,
            )
            return g.labels(**label)

        def counter(sub, name, doc):
            c = Counter(
                f"{NS}_{sub}_{name}", doc, ["chain_id"],
                registry=self.registry,
            )
            return c.labels(**label)

        def hist(sub, name, doc, buckets):
            h = Histogram(
                f"{NS}_{sub}_{name}", doc, ["chain_id"],
                registry=self.registry, buckets=buckets,
            )
            return h.labels(**label)

        # consensus (reference consensus/metrics.go)
        self.height = gauge("consensus", "height", "committed height")
        self.rounds = gauge("consensus", "rounds", "round of last commit")
        self.num_txs = gauge("consensus", "num_txs", "txs in last block")
        self.block_size = gauge(
            "consensus", "block_size_bytes", "last block size"
        )
        self.total_txs = counter(
            "consensus", "total_txs", "total committed txs"
        )
        self.block_interval = hist(
            "consensus",
            "block_interval_seconds",
            "time between blocks",
            (0.05, 0.1, 0.25, 0.5, 1, 2, 5, 10, 30),
        )
        self.validators = gauge(
            "consensus", "validators", "validator-set size"
        )
        # state (reference state/execution.go:292 BlockProcessingTime;
        # fed by the exec.finalize span through the bridge below)
        self.block_processing = hist(
            "state",
            "block_processing_seconds",
            "ApplyBlock duration",
            (0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        # mempool / p2p / blocksync gauges are callback-backed
        self._g_mempool = Gauge(
            f"{NS}_mempool_size", "pending txs", ["chain_id"],
            registry=self.registry,
        )
        self._g_peers = Gauge(
            f"{NS}_p2p_peers", "connected peers", ["chain_id"],
            registry=self.registry,
        )
        # live-summed over peers' flowrate totals / blocksync counter
        self._g_recv = Gauge(
            f"{NS}_p2p_message_receive_bytes_total", "bytes received",
            ["chain_id"], registry=self.registry,
        )
        self._g_send = Gauge(
            f"{NS}_p2p_message_send_bytes_total", "bytes sent",
            ["chain_id"], registry=self.registry,
        )
        self._g_blocksync = Gauge(
            f"{NS}_blocksync_blocks_synced",
            "blocks applied by blocksync", ["chain_id"],
            registry=self.registry,
        )
        # pipelined verify dispatch (blocksync/reactor.py
        # pipeline_stats): reused ~= windows means the next-window
        # lookahead is genuinely hiding device latency behind applies
        self._g_pipeline = {
            k: Gauge(
                f"{NS}_blocksync_pipeline_{k}_total",
                f"pipelined verify windows {k}",
                ["chain_id"], registry=self.registry,
            )
            for k in ("reused", "dispatched", "predispatched",
                      "discarded")
        }
        # crypto: the async coalescing verifier (crypto/coalesce.py)
        self._g_coalesce_submitted = Gauge(
            f"{NS}_crypto_coalesce_submitted_total",
            "signatures submitted to the coalescing verifier",
            ["chain_id"], registry=self.registry,
        )
        self._g_coalesce_dispatches = Gauge(
            f"{NS}_crypto_coalesce_dispatches_total",
            "batch dispatches by the coalescing verifier",
            ["chain_id"], registry=self.registry,
        )
        self._g_coalesce_cache_hits = Gauge(
            f"{NS}_crypto_coalesce_cache_hits_total",
            "coalescing-verifier signature-cache hits",
            ["chain_id"], registry=self.registry,
        )
        self._g_stuck_tasks = Gauge(
            f"{NS}_watchdog_stuck_tasks_total",
            "tasks the stuck-await watchdog reported",
            ["chain_id"], registry=self.registry,
        )
        # self-healing connectivity plane (p2p/reconnect.py,
        # docs/CHAOS.md "Self-healing connectivity")
        self._g_reconnect_attempts = Gauge(
            f"{NS}_p2p_reconnect_attempts_total",
            "persistent-peer reconnect dial attempts (fast + slow lane)",
            ["chain_id"], registry=self.registry,
        )
        self._g_peer_flaps = Gauge(
            f"{NS}_p2p_peer_flaps_total",
            "established peer connections lost to errors",
            ["chain_id"], registry=self.registry,
        )
        self._g_starvation = Gauge(
            f"{NS}_p2p_starvation_seconds",
            "cumulative seconds spent with zero connected peers",
            ["chain_id"], registry=self.registry,
        )
        # span→metrics bridge targets (trace/bridge.py): the tracing
        # plane feeds these with the step/window/fsync durations the
        # scrape surface previously lacked
        self._h_step = Histogram(
            f"{NS}_consensus_step_duration_seconds",
            "consensus step duration by step kind",
            ["chain_id", "step"], registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 2, 5, 10),
        )
        self._h_bs_window = Histogram(
            f"{NS}_blocksync_window_seconds",
            "blocksync window stage duration",
            ["chain_id", "stage"], registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self._h_wal_fsync = Histogram(
            f"{NS}_consensus_wal_fsync_seconds",
            "consensus WAL fsync barrier duration",
            ["chain_id"], registry=self.registry,
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 1),
        )
        # mempool ingest plane (docs/PERF.md): batched CheckTx wall
        # time and post-commit recheck wall time (async: off the
        # consensus critical section), via the same span bridge
        self._h_mp_batch = Histogram(
            f"{NS}_mempool_batch_duration_seconds",
            "batched CheckTx (ingest plane) duration",
            ["chain_id"], registry=self.registry,
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1),
        )
        self._h_mp_recheck = Histogram(
            f"{NS}_mempool_recheck_duration_seconds",
            "post-commit recheck duration (async: background)",
            ["chain_id"], registry=self.registry,
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self._g_ingest = {
            k: Gauge(
                f"{NS}_mempool_ingest_{k}_total",
                f"mempool ingest queue: {d}",
                ["chain_id"], registry=self.registry,
            )
            for k, d in (
                ("submitted", "txs enqueued"),
                ("batches", "batches drained"),
                ("dropped", "txs shed under overload"),
            )
        }
        self._g_bs_window_bps = Gauge(
            f"{NS}_blocksync_window_blocks_per_s",
            "throughput of the last applied blocksync window",
            ["chain_id"], registry=self.registry,
        )
        # cross-node causal tracing (docs/TRACE.md "Cross-node
        # timelines"): the quorum-wait legs of the per-height commit
        # waterfall, live p2p propagation (same-clock-domain stamps
        # only — cross-host correlation is the offline timeline
        # tool's job) and per-peer vote-arrival skew
        self._h_quorum = Histogram(
            f"{NS}_consensus_quorum_latency_seconds",
            "time from round entry to observing 2/3 non-nil "
            "prevotes/precommits",
            ["chain_id", "step"], registry=self.registry,
            buckets=(0.01, 0.05, 0.1, 0.25, 0.5, 1, 2, 5, 15, 60),
        )
        self._h_propagation = Histogram(
            f"{NS}_p2p_msg_propagation_seconds",
            "stamped p2p message propagation, send instant to "
            "receive instant (same clock domain only)",
            ["chain_id", "kind"], registry=self.registry,
            buckets=(0.0005, 0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self._g_vote_skew = Gauge(
            f"{NS}_consensus_vote_arrival_skew_seconds",
            "latest vote's arrival lag behind the first vote of its "
            "(round, type) wave, per delivering peer",
            ["chain_id", "peer"], registry=self.registry,
        )
        # runtime health plane (obs/, docs/OBS.md): loop scheduling
        # lag via the watchdog heartbeat's obs.loop.lag spans, stall
        # flight-record count, and per-queue backpressure telemetry
        self._h_loop_lag = Histogram(
            f"{NS}_loop_lag_seconds",
            "event-loop scheduling lag (watchdog heartbeat)",
            ["chain_id"], registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 5),
        )
        self._g_loop_stalls = Gauge(
            f"{NS}_loop_stalls_total",
            "loop stalls flight-recorded by the watchdog",
            ["chain_id"], registry=self.registry,
        )
        # light-client serving plane (light/serving.py): cache
        # hit/miss counters and the coalesced verify batch size ride
        # the span→metrics bridge (light.cache.{hit,miss} /
        # light.verify.coalesced spans); the sessions gauge is
        # callback-backed on the plane. *_total metrics follow this
        # file's idiom of bridge/callback-fed Gauges.
        self._g_light_cache = {
            k: Gauge(
                f"{NS}_light_cache_{k}_total",
                f"cross-client verified-header cache {k}",
                ["chain_id"], registry=self.registry,
            )
            for k in ("hits", "misses")
        }
        self._g_light_sessions = Gauge(
            f"{NS}_light_sessions",
            "active light serving sessions",
            ["chain_id"], registry=self.registry,
        )
        self._h_light_batch = Histogram(
            f"{NS}_light_verify_batch_size",
            "jobs per coalesced light commit-verify dispatch",
            ["chain_id"], registry=self.registry,
            buckets=(1, 2, 4, 8, 16, 32, 64, 128, 256),
        )
        # outbound fan-out plane (rpc/fanout.py, state/indexer.py):
        # bridge-fed histograms for one event through the hub and one
        # height's batched index flush; queue gauges (per-subscriber
        # sheds included) ride the generic _g_queue series below via
        # the rpc.fanout / state.index registry entries
        self._h_fanout_deliver = Histogram(
            f"{NS}_fanout_deliver_seconds",
            "one committed event fanned out to all subscriber groups",
            ["chain_id"], registry=self.registry,
            buckets=(0.0001, 0.0005, 0.001, 0.005, 0.01, 0.05, 0.1,
                     0.5, 1),
        )
        self._h_index_flush = Histogram(
            f"{NS}_index_flush_seconds",
            "one height's index rows + marker in one write_batch",
            ["chain_id"], registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        # storage lifecycle plane (store/retention.py): base height,
        # cumulative pruned rows, and on-disk footprint — the soak's
        # "bounded disk" assertion as a scrape
        self._g_storage = {
            k: Gauge(
                f"{NS}_storage_{k}",
                f"storage lifecycle {d} (store/retention.py)",
                ["chain_id"], registry=self.registry,
            )
            for k, d in (
                ("base_height", "lowest retained block height"),
                ("pruned_total", "cumulative pruned rows, all legs"),
                ("disk_bytes", "total bytes under the node home"),
            )
        }
        self._h_storage_prune = Histogram(
            f"{NS}_storage_prune_seconds",
            "one retention prune leg (all bounded batches)",
            ["chain_id", "kind"], registry=self.registry,
            buckets=(0.001, 0.005, 0.01, 0.05, 0.1, 0.5, 1, 5),
        )
        self._h_storage_snapshot = Histogram(
            f"{NS}_storage_snapshot_seconds",
            "one app snapshot mirrored to the on-disk store",
            ["chain_id"], registry=self.registry,
            buckets=(0.001, 0.01, 0.05, 0.1, 0.5, 1, 5, 30),
        )
        self._g_queue = {
            k: Gauge(
                f"{NS}_queue_{k}",
                f"hot-plane queue {d} (obs/queues.py)",
                ["chain_id", "queue"], registry=self.registry,
            )
            for k, d in (
                ("depth", "current backlog"),
                ("high_watermark", "worst backlog since start"),
                ("dropped_total", "items shed under overload"),
            )
        }
        self._last_block_time: Optional[float] = None

    # --- wiring ---------------------------------------------------------

    def attach(self, node) -> None:
        """Subscribe to the event bus + point callback gauges at live
        structures."""
        p = node.parts
        self._g_mempool.labels(chain_id=self.chain_id).set_function(
            lambda: p.mempool.size()
        )
        self._g_peers.labels(chain_id=self.chain_id).set_function(
            lambda: node.switch.num_peers()
        )
        self._g_recv.labels(chain_id=self.chain_id).set_function(
            lambda: sum(
                pe.recv_total for pe in node.switch.peers.values()
            )
        )
        self._g_send.labels(chain_id=self.chain_id).set_function(
            lambda: sum(
                pe.send_total for pe in node.switch.peers.values()
            )
        )
        self._g_blocksync.labels(chain_id=self.chain_id).set_function(
            lambda: node.blocksync_reactor.inner.blocks_applied
        )
        for k, g in self._g_pipeline.items():
            g.labels(chain_id=self.chain_id).set_function(
                lambda key=k: node.blocksync_reactor.inner
                .pipeline_stats[key]
            )
        ing = getattr(node.mempool_reactor, "ingest", None)
        if ing is not None:
            for k, g in self._g_ingest.items():
                g.labels(chain_id=self.chain_id).set_function(
                    lambda key=k, q=ing: getattr(q, key)
                )
        vv = getattr(node.consensus_reactor, "vote_verifier", None)
        if vv is not None:
            self._g_coalesce_submitted.labels(
                chain_id=self.chain_id
            ).set_function(lambda: vv.submitted)
            self._g_coalesce_dispatches.labels(
                chain_id=self.chain_id
            ).set_function(lambda: vv.dispatches)
            self._g_coalesce_cache_hits.labels(
                chain_id=self.chain_id
            ).set_function(lambda: vv.cache_hits)
        self._g_stuck_tasks.labels(chain_id=self.chain_id).set_function(
            lambda: len(node.watchdog.stalled)
            if getattr(node, "watchdog", None)
            else 0
        )
        plane = getattr(node.switch, "reconnect", None)
        if plane is not None:
            self._g_reconnect_attempts.labels(
                chain_id=self.chain_id
            ).set_function(lambda: plane.attempts_total)
            self._g_peer_flaps.labels(
                chain_id=self.chain_id
            ).set_function(lambda: plane.flaps_total)
            self._g_starvation.labels(
                chain_id=self.chain_id
            ).set_function(lambda: plane.starvation_seconds())
        self._g_loop_stalls.labels(chain_id=self.chain_id).set_function(
            lambda: node.loop_watchdog.stall_count
            if getattr(node, "loop_watchdog", None)
            else 0
        )
        queues = getattr(node, "queues", None)
        if queues is not None:
            # one labeled series per registered hot-plane queue; the
            # registry callbacks return None while a plane is down —
            # gauges then read 0 rather than erroring the scrape
            def q_stat(name, key):
                s = queues.get(name)
                return 0 if s is None else int(s.get(key, 0))

            for qname in queues.names():
                for k, g in self._g_queue.items():
                    stat_key = (
                        "dropped" if k == "dropped_total" else k
                    )
                    g.labels(
                        chain_id=self.chain_id, queue=qname
                    ).set_function(
                        lambda n=qname, sk=stat_key: q_stat(n, sk)
                    )
        self._g_bs_window_bps.labels(
            chain_id=self.chain_id
        ).set_function(
            lambda: getattr(
                node.blocksync_reactor.inner, "last_window_bps", 0.0
            )
        )
        ret = getattr(p, "retention", None)
        if ret is not None and ret.enabled:
            self._g_storage["base_height"].labels(
                chain_id=self.chain_id
            ).set_function(lambda: p.block_store.base())
            self._g_storage["pruned_total"].labels(
                chain_id=self.chain_id
            ).set_function(
                lambda: ret.pruned_blocks_total
                + ret.pruned_index_total
                + ret.pruned_evidence_total
            )
            self._g_storage["disk_bytes"].labels(
                chain_id=self.chain_id
            ).set_function(lambda: ret.disk_bytes() or 0)
        # span→metrics bridge: completed spans from the node's tracer
        # feed the step/window/fsync histograms (trace/bridge.py)
        tracer = getattr(p, "tracer", None)
        if tracer is not None and tracer.enabled:
            from ..trace import SpanMetricsBridge

            cid = self.chain_id
            bridge = SpanMetricsBridge()
            bridge.route(
                "consensus.step",
                lambda dur_s, args: self._h_step.labels(
                    chain_id=cid, step=str(args.get("step", "?"))
                ).observe(dur_s),
            )
            for stage in (
                "prepare", "verify_wait", "lookahead", "fill_wait",
                "yield", "apply", "stage", "persist",
            ):
                bridge.route(
                    f"blocksync.window.{stage}",
                    lambda dur_s, args, s=stage: self._h_bs_window
                    .labels(chain_id=cid, stage=s).observe(dur_s),
                )
            # upstream's BlockProcessingTime times FinalizeBlock
            bridge.route(
                "exec.finalize",
                lambda dur_s, args: self.block_processing.observe(
                    dur_s
                ),
            )
            bridge.route(
                "wal.fsync",
                lambda dur_s, args: self._h_wal_fsync.labels(
                    chain_id=cid
                ).observe(dur_s),
            )
            bridge.route(
                "mempool.batch",
                lambda dur_s, args: self._h_mp_batch.labels(
                    chain_id=cid
                ).observe(dur_s),
            )
            bridge.route(
                "mempool.recheck",
                lambda dur_s, args: self._h_mp_recheck.labels(
                    chain_id=cid
                ).observe(dur_s),
            )
            bridge.route(
                "obs.loop.lag",
                lambda dur_s, args: self._h_loop_lag.labels(
                    chain_id=cid
                ).observe(dur_s),
            )
            for step in ("prevote", "precommit"):
                bridge.route(
                    f"consensus.quorum.{step}",
                    lambda dur_s, args, s=step: self._h_quorum
                    .labels(chain_id=cid, step=s).observe(dur_s),
                )
            bridge.route(
                "p2p.msg.propagation",
                lambda dur_s, args: self._h_propagation.labels(
                    chain_id=cid, kind=str(args.get("kind", "?"))
                ).observe(dur_s),
            )
            bridge.route(
                "consensus.vote.skew",
                lambda dur_s, args: self._g_vote_skew.labels(
                    chain_id=cid, peer=str(args.get("peer", "?"))
                ).set(dur_s),
            )
            bridge.route(
                "fanout.deliver",
                lambda dur_s, args: self._h_fanout_deliver.labels(
                    chain_id=cid
                ).observe(dur_s),
            )
            bridge.route(
                "fanout.index.flush",
                lambda dur_s, args: self._h_index_flush.labels(
                    chain_id=cid
                ).observe(dur_s),
            )
            bridge.route(
                "storage.prune",
                lambda dur_s, args: self._h_storage_prune.labels(
                    chain_id=cid, kind=str(args.get("kind", "?"))
                ).observe(dur_s),
            )
            bridge.route(
                "storage.snapshot",
                lambda dur_s, args: self._h_storage_snapshot.labels(
                    chain_id=cid
                ).observe(dur_s),
            )
            self._route_light(bridge)
            tracer.add_observer(bridge)
        p.event_bus.add_sync_listener(self._on_event)
        self._node = node

    def _route_light(self, bridge) -> None:
        """Route the light serving plane's spans into the light
        metrics (docs/TRACE.md ``light.*`` rows). Cache hit/miss are
        zero-duration complete spans, so they fire observers; the
        batch-size histogram observes the span's ``n`` arg, not its
        duration."""
        cid = self.chain_id
        for span, kind in (
            ("light.cache.hit", "hits"),
            ("light.cache.miss", "misses"),
        ):
            bridge.route(
                span,
                lambda dur_s, args, g=self._g_light_cache[kind]: g
                .labels(chain_id=cid).inc(),
            )
        bridge.route(
            "light.verify.coalesced",
            lambda dur_s, args: self._h_light_batch.labels(
                chain_id=cid
            ).observe(float(args.get("n", 0) or 0)),
        )

    def attach_light_serving(self, tracer, plane=None) -> None:
        """Wire a standalone light serving front (a LightProxy — no
        Node to attach() to) into this registry: bridge the plane's
        tracer spans and point the sessions gauge at the plane."""
        from ..trace import SpanMetricsBridge

        bridge = SpanMetricsBridge()
        self._route_light(bridge)
        tracer.add_observer(bridge)
        if plane is not None:
            self._g_light_sessions.labels(
                chain_id=self.chain_id
            ).set_function(plane.active_sessions)

    def _on_event(self, e: ev.Event) -> None:
        if e.type_ != ev.EVENT_NEW_BLOCK or not isinstance(e.data, dict):
            return
        block = e.data["block"]
        self.height.set(block.height)
        self.num_txs.set(len(block.data.txs))
        meta = self._node.parts.block_store.load_block_meta(block.height)
        if meta is not None:
            self.block_size.set(meta.block_size)
        self.total_txs.inc(len(block.data.txs))
        self.validators.set(
            self._node.parts.state.validators.size()
            if self._node.parts.state and self._node.parts.state.validators
            else 0
        )
        if block.last_commit is not None:
            self.rounds.set(block.last_commit.round)
        now = time.monotonic()
        if self._last_block_time is not None:
            self.block_interval.observe(now - self._last_block_time)
        self._last_block_time = now

    # --- serving --------------------------------------------------------

    def render(self) -> bytes:
        return generate_latest(self.registry)


class MetricsServer:
    def __init__(self, metrics: NodeMetrics):
        self.metrics = metrics
        self._runner = None
        self.listen_addr = ""

    async def start(self, addr: str) -> None:
        from aiohttp import web

        host, _, port = addr.rpartition(":")

        async def handler(_request):
            return web.Response(
                body=self.metrics.render(),
                content_type=CONTENT_TYPE_LATEST.split(";")[0],
            )

        app = web.Application()
        app.router.add_get("/metrics", handler)
        self._runner = web.AppRunner(app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host or "127.0.0.1", int(port))
        try:
            await site.start()
        except BaseException:
            await self._runner.cleanup()
            self._runner = None
            raise
        h, p = site._server.sockets[0].getsockname()[:2]  # noqa: SLF001
        self.listen_addr = f"{h}:{p}"

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()
            self._runner = None
