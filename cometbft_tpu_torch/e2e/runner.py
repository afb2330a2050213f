"""E2E runner (reference test/e2e/runner/): provision node homes from
a manifest, launch real OS processes, apply tx load over RPC, inject
perturbations (kill/restart, pause/resume), wait for the target
height, then assert network-wide agreement.

Usage:
    python -m cometbft_tpu_torch.e2e.runner manifest.toml [--dir DIR]
        [--device cuda|cpu]

A copy of the JAX package's ``e2e/runner.py``, with its perturbations,
light nodes, evidence injection, gRPC check and block-interval
benchmark. Where the JAX runner pins its children to the CPU platform,
this one launches every child as ``python -m cometbft_tpu_torch
--device <device> --home <home> start`` (or ``light``): ``device`` is
the runner's (None is the GPU, and raises without one), never chosen
from the environment.
"""

from __future__ import annotations

import asyncio
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import urllib.request
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ..config.config import default_config, write_toml
from ..device import resolve
from ..p2p.key import NodeKey
from ..privval.file_pv import FilePV
from ..types.genesis import GenesisDoc
from ..types.validator_set import Validator
from .manifest import Manifest, NodeSpec

BASE_PORT = 27000
# run()'s phase budgets beyond timeout_s: all-node convergence, then
# the post phase — perturbation-finish wait (<=30s), the gRPC
# broadcast check (<=40s client deadline), and the bulk block-interval
# benchmark (a handful of 5s-bounded RPCs). Tests derive their OUTER
# guard from these so the guard can never truncate a healthy run
# mid-phase.
CONVERGENCE_BUDGET_S = 120.0
POST_BUDGET_S = 120.0


@dataclass
class RunnerNode:
    spec: NodeSpec
    home: str
    p2p_port: int
    rpc_port: int
    grpc_port: int = 0
    node_id: str = ""
    proc: Optional[subprocess.Popen] = None
    started: bool = False

    @property
    def rpc(self) -> str:
        return f"http://127.0.0.1:{self.rpc_port}"


class Runner:
    def __init__(self, manifest: Manifest, base_dir: str,
                 base_port: int = BASE_PORT, device=None):
        self.m = manifest
        self.dir = base_dir
        # the children's --device: resolved here, so a runner without a
        # GPU fails before it launches anything
        self.device = resolve(device).type
        self.nodes: Dict[str, RunnerNode] = {}
        port = base_port
        for name, spec in manifest.nodes.items():
            self.nodes[name] = RunnerNode(
                spec, os.path.join(base_dir, name), port, port + 1,
                grpc_port=port + 2,
            )
            port += 3
        self.failures: List[str] = []

    # --- provisioning -------------------------------------------------

    def setup(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)
        validators = []
        pvs = {}
        for name, rn in self.nodes.items():
            os.makedirs(os.path.join(rn.home, "config"), exist_ok=True)
            os.makedirs(os.path.join(rn.home, "data"), exist_ok=True)
            pv = FilePV.load_or_generate(
                os.path.join(rn.home, "config", "priv_validator_key.json"),
                os.path.join(rn.home, "data", "priv_validator_state.json"),
            )
            pvs[name] = pv
            nk = NodeKey.load_or_gen(
                os.path.join(rn.home, "config", "node_key.json")
            )
            rn.node_id = nk.node_id
            if rn.spec.mode == "validator":
                validators.append(Validator(pv.pub_key(), rn.spec.power))
        gen = GenesisDoc(chain_id=self.m.chain_id, validators=validators)
        peers = ",".join(
            f"{rn.node_id}@127.0.0.1:{rn.p2p_port}"
            for rn in self.nodes.values()
            # light nodes run only the proxy daemon — nothing ever
            # listens on their p2p port
            if rn.spec.mode != "light"
        )
        for name, rn in self.nodes.items():
            cfg = default_config(rn.home)
            cfg.base.moniker = name
            cfg.p2p.laddr = f"tcp://127.0.0.1:{rn.p2p_port}"
            cfg.rpc.laddr = f"tcp://127.0.0.1:{rn.rpc_port}"
            cfg.rpc.unsafe = True  # perturbations use the unsafe routes
            if rn.spec.grpc:
                cfg.rpc.grpc_laddr = f"tcp://127.0.0.1:{rn.grpc_port}"
                # commit-await must survive a perturbed, contended net
                # (kill/pause perturbations land around the same
                # heights the check runs at)
                cfg.rpc.timeout_broadcast_tx_commit_s = 30.0
            cfg.p2p.persistent_peers = ",".join(
                p for p in peers.split(",")
                if not p.startswith(rn.node_id)
            )
            cfg.blocksync.enable = rn.spec.block_sync or rn.spec.state_sync
            cfg.blocksync.adaptive_sync = rn.spec.adaptive_sync
            cfg.mempool.type_ = rn.spec.mempool
            cfg.base.db_backend = rn.spec.db
            cfg.consensus.timeout_commit_s = 0.2
            if rn.spec.state_sync:
                cfg.statesync.enable = True
                cfg.statesync.rpc_servers = [
                    f"127.0.0.1:{o.rpc_port}"
                    for o in self.nodes.values()
                    if o.spec.start_at == 0 and o.spec.name != name
                ][:2]
                cfg.statesync.trust_height = 1  # filled at start_at time
                cfg.statesync.discovery_time_s = 15.0
            write_toml(cfg, os.path.join(rn.home, "config", "config.toml"))
            with open(
                os.path.join(rn.home, "config", "genesis.json"), "w"
            ) as f:
                f.write(gen.to_json())
            if rn.spec.mode in ("full", "light", "seed"):
                os.remove(
                    os.path.join(
                        rn.home, "config", "priv_validator_key.json"
                    )
                )

    # --- process control ----------------------------------------------

    def _launch(self, rn: RunnerNode, extra_env=None, argv=None) -> None:
        env = dict(os.environ)
        if extra_env:
            env.update(extra_env)
        if argv is None:
            if rn.spec.mode == "light":
                # every light launch path (initial + perturbation
                # restart) must go through _launch_light, which builds
                # the proxy argv with retries off the event loop — a
                # bare relaunch here would start a FULL node on the
                # light node's port
                raise RuntimeError(
                    "light nodes launch via _launch_light"
                )
            argv = [
                sys.executable, "-m", "cometbft_tpu_torch",
                "--device", self.device, "--home", rn.home, "start",
            ]
        rn.proc = subprocess.Popen(
            argv,
            cwd=os.path.dirname(os.path.dirname(os.path.dirname(__file__))),
            env=env,
            stdout=open(os.path.join(rn.home, "node.log"), "a"),
            stderr=subprocess.STDOUT,
            start_new_session=True,
        )
        rn.started = True

    async def _launch_light(self, rn: RunnerNode) -> None:
        """Launch a light-mode node: the verifying RPC proxy daemon
        (reference e2e light-node dimension), trust-rooted at block 1
        of a REACHABLE full node, witnesses wired to the other full
        nodes, serving on the node's rpc_port — so every runner
        assertion (status polling, agreement at the target height)
        exercises the LIGHT-VERIFIED path for this node. Retried off
        the event loop: the anchor candidates may be mid-perturbation
        (killed/paused) when the start height arrives."""
        last_err = None
        for _ in range(10):
            try:
                argv = await asyncio.to_thread(self._light_argv, rn)
                self._launch(rn, argv=argv)
            except asyncio.CancelledError:
                raise
            except Exception as e:
                last_err = e
                await asyncio.sleep(2.0)
                continue
            # SUPERVISE startup: the daemon's own trust-root fetch can
            # hit the anchor mid-perturbation and exit — a dead or
            # never-serving daemon retries with a freshly-chosen
            # anchor instead of silently failing convergence
            for _ in range(30):
                if rn.proc.poll() is not None:
                    last_err = RuntimeError(
                        "light daemon exited at startup "
                        f"rc={rn.proc.returncode}"
                    )
                    break
                h = await asyncio.to_thread(self._height, rn)
                if h >= 0:
                    return  # serving verified status
                await asyncio.sleep(0.5)
            else:
                last_err = RuntimeError(
                    "light daemon never served status"
                )
                try:
                    rn.proc.terminate()
                except ProcessLookupError:
                    pass
            rn.started = False
            await asyncio.sleep(1.0)
        self.failures.append(
            f"light node {rn.spec.name} never launched: {last_err!r}"
        )

    def _light_argv(self, rn: RunnerNode) -> list:
        full = [
            o
            for o in self.nodes.values()
            if o is not rn and o.started and o.spec.mode != "light"
        ]
        primary = None
        trust = None
        for cand in full:
            try:
                trust = self._rpc(cand, "block?height=1")
                primary = cand
                break
            except Exception:
                continue
        if primary is None:
            raise RuntimeError(
                "no reachable full node to anchor the light node"
            )
        witnesses = [o for o in full if o is not primary][:2]
        argv = [
            sys.executable, "-m", "cometbft_tpu_torch",
            "--device", self.device, "light",
            self.m.chain_id,
            "-p", f"127.0.0.1:{primary.rpc_port}",
            "--trust-height", "1",
            "--trust-hash", trust["block_id"]["hash"].lower(),
            "--laddr", f"tcp://127.0.0.1:{rn.rpc_port}",
            "--dir", os.path.join(rn.home, "light"),
        ]
        if witnesses:
            argv += [
                "-w",
                ",".join(
                    f"127.0.0.1:{o.rpc_port}" for o in witnesses
                ),
            ]
        return argv

    def _peer_addrs(self, rn: RunnerNode) -> list:
        """Other nodes' id@host:port addresses (reconnect targets)."""
        return [
            f"{other.node_id}@127.0.0.1:{other.p2p_port}"
            for name, other in self.nodes.items()
            if other is not rn
            and other.started
            and other.spec.mode != "light"
        ]

    def _rpc(self, rn: RunnerNode, path: str, timeout: float = 3.0):
        with urllib.request.urlopen(
            f"{rn.rpc}/{path}", timeout=timeout
        ) as r:
            body = json.load(r)
        if "result" not in body:
            raise RuntimeError(body.get("error"))
        return body["result"]

    def _rpc_post(self, rn: RunnerNode, method: str, params: dict,
                  timeout: float = 3.0):
        req = urllib.request.Request(
            rn.rpc + "/",
            data=json.dumps(
                {"jsonrpc": "2.0", "id": 1, "method": method,
                 "params": params}
            ).encode(),
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = json.load(r)
        if "result" not in body:
            raise RuntimeError(body.get("error"))
        return body["result"]

    def _height(self, rn: RunnerNode) -> int:
        try:
            return int(
                self._rpc(rn, "status")["sync_info"]["latest_block_height"]
            )
        except Exception:
            return -1

    def network_height(self) -> int:
        return max(
            (self._height(rn) for rn in self.nodes.values() if rn.started),
            default=-1,
        )

    async def _network_height(self) -> int:
        # a SIGSTOP'd node accepts TCP but never answers; keep the 3s
        # stalls off the event loop
        return await asyncio.to_thread(self.network_height)

    # --- phases -------------------------------------------------------

    async def run(self, timeout_s: float = 300.0) -> bool:
        deadline = time.monotonic() + timeout_s
        aux_tasks: List[asyncio.Task] = []
        # start genesis nodes (a start_at=0 LIGHT node anchors itself
        # once the chain reaches height 1 — the retrying launcher
        # absorbs the wait)
        for rn in self.nodes.values():
            if rn.spec.start_at == 0:
                if rn.spec.mode == "light":
                    aux_tasks.append(
                        asyncio.create_task(self._launch_light(rn))
                    )
                else:
                    self._launch(rn)
        load_task = (
            asyncio.create_task(self._load_routine())
            if self.m.load_tx_rate > 0
            else None
        )
        pert_tasks = [
            asyncio.create_task(self._perturb_routine(rn))
            for rn in self.nodes.values()
            if rn.spec.perturbations
        ]
        late = [
            rn for rn in self.nodes.values() if rn.spec.start_at > 0
        ]
        try:
            while time.monotonic() < deadline:
                h = await self._network_height()
                for rn in late[:]:
                    if h >= rn.spec.start_at:
                        if rn.spec.mode == "light":
                            aux_tasks.append(
                                asyncio.create_task(
                                    self._launch_light(rn)
                                )
                            )
                        else:
                            await asyncio.to_thread(
                                self._fill_trust, rn
                            )
                            self._launch(rn)
                        late.remove(rn)
                if h >= self.m.target_height:
                    break
                await asyncio.sleep(0.5)
            else:
                self.failures.append(
                    f"timed out below target height "
                    f"({self.network_height()}/{self.m.target_height})"
                )
            # light-node launches must FINISH before convergence is
            # judged (a still-retrying launch would silently exclude
            # the node from the all-nodes check)
            if aux_tasks:
                await asyncio.gather(*aux_tasks, return_exceptions=True)
            # wait for EVERY node (incl. late joiners) to converge —
            # pointless if the net never reached the target at all
            if not self.failures:
                conv_deadline = time.monotonic() + CONVERGENCE_BUDGET_S
                hs = {}
                while time.monotonic() < conv_deadline:
                    started = [
                        (n, rn)
                        for n, rn in self.nodes.items()
                        if rn.started
                    ]
                    heights = await asyncio.gather(
                        *(
                            asyncio.to_thread(self._height, rn)
                            for _, rn in started
                        )
                    )
                    hs = dict(zip((n for n, _ in started), heights))
                    if all(
                        h >= self.m.target_height for h in hs.values()
                    ):
                        break
                    await asyncio.sleep(0.5)
                else:
                    self.failures.append(
                        f"nodes failed to converge: {hs}"
                    )
            # drive the gRPC broadcast API AFTER convergence — and
            # after QUIESCING the perturbation/load routines: a
            # lagging perturbation poll could otherwise fire its kill
            # mid-BroadcastTx and turn an intended perturbation into a
            # spurious testnet failure
            if not self.failures:
                # let lagging perturbation routines FINISH (their height
                # polls can trail the chain by seconds; cancelling a
                # not-yet-fired evidence injection would fail the
                # evidence assertion), then quiesce everything before
                # the gRPC check so no kill can race the in-flight RPC
                if pert_tasks:
                    # generous: a lagging evidence routine may still be
                    # inside its RPC retry loop (serial 3s-timeout
                    # height polls under contention)
                    await asyncio.wait(pert_tasks, timeout=60.0)
                quiesce = [t for t in [load_task, *pert_tasks] if t]
                for t in quiesce:
                    t.cancel()
                await asyncio.gather(*quiesce, return_exceptions=True)
                await self._check_grpc_broadcast()
                await asyncio.to_thread(self._benchmark_intervals)
        finally:
            if load_task:
                load_task.cancel()
            for t in pert_tasks:
                t.cancel()
            for t in aux_tasks:
                t.cancel()
        self._check_agreement()
        if any(
            p.kind in ("evidence", "evidence_lca")
            for rn in self.nodes.values()
            for p in rn.spec.perturbations
        ):
            # off-loop: the bounded wait inside must not stall
            # cancelled tasks' cleanup
            await asyncio.to_thread(self._check_evidence_committed)
        return not self.failures

    def _check_evidence_committed(self) -> None:
        """Injected evidence must end up inside a committed block
        (reference e2e evidence assertion). Bounded WAIT, not a
        snapshot: a late injection (LCA retries until the chain is
        tall enough) can leave the evidence pending at the target
        height — consensus keeps producing blocks after the load
        stops, so the next proposal from a pool-holding validator
        commits it within a couple of heights."""
        if not getattr(self, "_evidence_injected", False):
            self.failures.append("evidence perturbation never injected")
            return
        rn = next(o for o in self.nodes.values() if o.started)
        scanned = 0
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            top = self._height(rn)
            ok_through = scanned
            for h in range(scanned + 1, top + 1):
                try:
                    blk = self._rpc(rn, f"block?height={h}")
                except Exception:
                    # transient fetch failure: do NOT advance past h —
                    # the next pass re-examines it
                    break
                if blk["block"]["evidence"]["evidence"]:
                    return
                ok_through = h
            scanned = ok_through
            # sync-only call path: this method runs in a worker thread
            # via asyncio.to_thread (see the caller) — a blocking
            # sleep here parks the worker, not the event loop
            time.sleep(1.0)
        self.failures.append("no committed block contains evidence")

    def _fill_trust(self, rn: RunnerNode) -> None:
        """Late statesync nodes need a live trust root."""
        if not rn.spec.state_sync:
            return
        src = next(
            o for o in self.nodes.values()
            if o.started and o.spec.start_at == 0
        )
        blk = self._rpc(src, "block?height=1")
        cfg_path = os.path.join(rn.home, "config", "config.toml")
        with open(cfg_path) as f:
            text = f.read()
        text = text.replace(
            'trust_hash = ""',
            f'trust_hash = "{blk["block_id"]["hash"].lower()}"',
        )
        with open(cfg_path, "w") as f:
            f.write(text)

    # --- load + perturbations -----------------------------------------

    async def _load_routine(self) -> None:
        import base64

        seq = 0
        interval = 1.0 / self.m.load_tx_rate
        targets = [
            rn for rn in self.nodes.values() if rn.spec.start_at == 0
        ]
        while True:
            rn = targets[seq % len(targets)]
            tx = base64.b64encode(
                b"load-%06d=v%d" % (seq, seq)
            ).decode()
            seq += 1
            try:
                # JSON-RPC POST: base64 '+'/'/' chars survive (GET
                # query strings decode '+' to space)
                await asyncio.to_thread(
                    self._rpc_post, rn, "broadcast_tx_sync",
                    {"tx": tx}, 2.0,
                )
            except asyncio.CancelledError:
                raise  # run teardown cancels the load routine
            except (OSError, ValueError):
                pass  # node restarting mid-perturbation; keep loading
            await asyncio.sleep(interval)

    def _benchmark_intervals(self) -> None:
        """Block-interval statistics over the run (reference
        test/e2e/runner/benchmark.go:15-50: mean/stddev/min/max of the
        header-time deltas), recorded on ``self.benchmark``. Headers
        come from the bulk ``blockchain`` endpoint (20 metas per call)
        of a GENESIS node — a statesync joiner lacks pre-snapshot
        blocks. Non-monotonic header-time pairs (possible under BFT
        time with clock skew) are counted and reported, not silently
        dropped."""
        import statistics

        rn = next(
            (
                r
                for r in self.nodes.values()
                if r.started and r.spec.start_at == 0
            ),
            None,
        )
        if rn is None:
            return
        times = {}
        lo, hi = 2, self.m.target_height
        h = hi
        while h >= lo:
            for attempt in (1, 2, 3):
                try:
                    res = self._rpc(
                        rn,
                        f"blockchain?minHeight={lo}&maxHeight={h}",
                        timeout=5.0,
                    )
                    break
                except Exception as e:
                    if attempt == 3:
                        # post-convergence RPC should answer; a
                        # silent skip would make the smoke test fail
                        # with an inexplicable missing benchmark
                        self.failures.append(
                            f"benchmark: blockchain RPC failed: {e!r}"
                        )
                        return
                    # sync-only call path: _benchmark_intervals runs
                    # in a worker thread via asyncio.to_thread — this
                    # retry backoff never touches the event loop
                    time.sleep(0.2)
            metas = res.get("block_metas") or []
            if not metas:
                self.failures.append(
                    f"benchmark: no block metas <= {h}"
                )
                return
            for meta in metas:
                times[int(meta["header"]["height"])] = int(
                    meta["header"]["time_ns"]
                )
            nxt = min(times) - 1
            if nxt >= h:  # floor not advancing (pruned store): stop
                break
            h = nxt
        seq = [times[k] for k in sorted(times)]
        deltas = [(b - a) / 1e9 for a, b in zip(seq, seq[1:])]
        mono = [d for d in deltas if d > 0]
        if len(mono) < 2:
            return
        self.benchmark = {
            "blocks": len(seq),
            "non_monotonic_intervals": len(deltas) - len(mono),
            "interval_mean_s": round(statistics.mean(mono), 3),
            "interval_stddev_s": round(statistics.pstdev(mono), 3),
            "interval_min_s": round(min(mono), 3),
            "interval_max_s": round(max(mono), 3),
        }
        print(f"block-interval benchmark: {self.benchmark}")

    async def _check_grpc_broadcast(self) -> None:
        """Black-box drive of the legacy gRPC broadcast API on every
        grpc-enabled node: Ping + one BroadcastTx with commit
        semantics (reference test/e2e exercises live RPC the same
        way). Runs post-convergence; a failure is a testnet
        failure."""
        targets = [
            rn
            for rn in self.nodes.values()
            if rn.spec.grpc and rn.started
        ]
        if not targets:
            return
        from ..rpc.grpc_api import GRPCBroadcastClient

        def drive(rn):
            cli = GRPCBroadcastClient(f"127.0.0.1:{rn.grpc_port}")
            try:
                cli.ping()
                res = cli.broadcast_tx(
                    b"grpc-%s=1" % rn.spec.name.encode(), timeout=40.0
                )
                if res["check_tx"]["code"] != 0 or res["tx_result"][
                    "code"
                ] != 0:
                    self.failures.append(
                        f"{rn.spec.name}: gRPC broadcast rejected {res}"
                    )
            except Exception as e:
                self.failures.append(
                    f"{rn.spec.name}: gRPC broadcast failed: {e!r}"
                )
            finally:
                cli.close()

        await asyncio.gather(
            *(asyncio.to_thread(drive, rn) for rn in targets)
        )

    async def _perturb_routine(self, rn: RunnerNode) -> None:
        for pert in sorted(rn.spec.perturbations, key=lambda p: p.height):
            while await self._network_height() < pert.height:
                await asyncio.sleep(0.3)
            if not rn.proc:
                continue
            if pert.kind == "kill":
                print(f"[perturb] SIGKILL {rn.spec.name}", flush=True)
                rn.proc.send_signal(signal.SIGKILL)
                rn.proc.wait()
                await asyncio.sleep(pert.restart_delay_s)
                print(f"[perturb] restart {rn.spec.name}", flush=True)
                if rn.spec.mode == "light":
                    # retried off the event loop; anchors may be
                    # mid-perturbation themselves
                    await self._launch_light(rn)
                else:
                    self._launch(rn)
            elif pert.kind == "pause":
                print(f"[perturb] SIGSTOP {rn.spec.name}", flush=True)
                rn.proc.send_signal(signal.SIGSTOP)
                await asyncio.sleep(pert.pause_s)
                print(f"[perturb] SIGCONT {rn.spec.name}", flush=True)
                rn.proc.send_signal(signal.SIGCONT)
            elif pert.kind == "disconnect":
                # drop all peers via the unsafe RPC (reference does
                # this at the docker network layer); reconnect by
                # dialing the net's persistent peers again
                print(f"[perturb] disconnect {rn.spec.name}", flush=True)
                try:
                    await asyncio.to_thread(
                        self._rpc, rn, "unsafe_disconnect_peers"
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    print(f"[perturb] disconnect failed: {e}", flush=True)
                    continue
                await asyncio.sleep(pert.disconnect_s)
                peers = ",".join(
                    f'"{p}"' for p in self._peer_addrs(rn)
                )
                print(f"[perturb] reconnect {rn.spec.name}", flush=True)
                try:
                    await asyncio.to_thread(
                        self._rpc, rn, f"dial_peers?peers=[{peers}]"
                    )
                except asyncio.CancelledError:
                    raise
                except Exception as e:
                    print(f"[perturb] reconnect failed: {e}", flush=True)
            elif pert.kind == "upgrade":
                # graceful stop, relaunch as a newer version, confirm
                # the restarted node REPORTS that version and rejoins
                # (reference runner/perturb.go:37: stop container,
                # start the -u image; here: same binary, bumped
                # CMT_NODE_VERSION)
                print(
                    f"[perturb] upgrade {rn.spec.name} -> "
                    f"{pert.upgrade_version}",
                    flush=True,
                )
                rn.proc.send_signal(signal.SIGTERM)
                try:
                    rn.proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    rn.proc.send_signal(signal.SIGKILL)
                    rn.proc.wait()
                await asyncio.sleep(1.0)
                self._launch(
                    rn, extra_env={"CMT_NODE_VERSION": pert.upgrade_version}
                )
                for _ in range(40):
                    await asyncio.sleep(0.5)
                    try:
                        st = await asyncio.to_thread(self._rpc, rn, "status")
                        got = st["node_info"]["version"]
                        if got == pert.upgrade_version:
                            self._upgraded_ok = True
                            break
                    except asyncio.CancelledError:
                        raise
                    except (OSError, ValueError, KeyError):
                        continue  # node still rebooting; poll again
                else:
                    self.failures.append(
                        f"{rn.spec.name} never reported upgraded "
                        f"version {pert.upgrade_version}"
                    )
            elif pert.kind in ("evidence", "evidence_lca"):
                # byzantine-evidence injection through another node's
                # broadcast_evidence RPC (reference
                # test/e2e/runner/evidence.go:32): "evidence" = this
                # node's key equivocates (DuplicateVoteEvidence);
                # "evidence_lca" = a >1/3-power subset of the real
                # validator keys signs a lunatic fork
                # (LightClientAttackEvidence). Retried: on a loaded
                # host an RPC can time out transiently.
                inject = (
                    self._inject_lca_evidence
                    if pert.kind == "evidence_lca"
                    else self._inject_evidence
                )
                print(
                    f"[perturb] {pert.kind} from {rn.spec.name}",
                    flush=True,
                )
                last_err = None
                try:
                    for attempt in range(10):
                        try:
                            await asyncio.to_thread(inject, rn)
                            self._evidence_injected = True
                            break
                        except asyncio.CancelledError:
                            raise
                        except Exception as e:
                            last_err = e
                            print(
                                f"[perturb] evidence attempt {attempt} "
                                f"failed: {e}",
                                flush=True,
                            )
                            await asyncio.sleep(2.0)
                    else:
                        # record WHY so a 'never injected' assertion
                        # is diagnosable instead of a bare flag check
                        self.failures.append(
                            f"evidence injection exhausted retries: "
                            f"{last_err!r}"
                        )
                except asyncio.CancelledError:
                    # quiesce cancelled us mid-retry: still leave a
                    # diagnosable cause behind the flag check
                    self.failures.append(
                        "evidence injection cancelled mid-retry "
                        f"(last error: {last_err!r})"
                    )
                    raise

    def _inject_lca_evidence(self, rn: RunnerNode) -> None:
        """Craft a lunatic-fork LightClientAttackEvidence signed by a
        >1/3-power subset of the net's real validator keys (the runner
        owns every validator home) and submit it over another node's
        broadcast_evidence RPC — the e2e twin of the in-process attack
        in tests/test_byzantine.py. The receiving pool must re-derive
        the byzantine set, verify both commits, and gossip it into a
        block."""
        import base64
        import dataclasses
        import time as _time

        from ..evidence.types import LightClientAttackEvidence
        from ..light.types import LightBlock
        from ..types.block import (
            BLOCK_ID_FLAG_COMMIT, BlockID, Commit, CommitSig, PartSetHeader,
        )
        from ..types.validator_set import ValidatorSet
        from ..types.vote import PRECOMMIT, Vote
        from ..utils import codec

        target = next(
            o for o in self.nodes.values() if o is not rn and o.started
        )
        h = self._height(target) - 1
        if h < 2:
            raise RuntimeError("chain too short for LCA evidence")
        com = self._rpc(target, f"commit?height={h}")
        header = codec.decode_header(
            base64.b64decode(com["header_b64"])
        )
        vs = codec.decode_validator_set(
            base64.b64decode(
                self._rpc(target, f"validators?height={h}")[
                    "validator_set_b64"
                ]
            )
        )
        common_vals = codec.decode_validator_set(
            base64.b64decode(
                self._rpc(target, f"validators?height={h - 1}")[
                    "validator_set_b64"
                ]
            )
        )
        pv_by_addr = {}
        for o in self.nodes.values():
            keyfile = os.path.join(
                o.home, "config", "priv_validator_key.json"
            )
            if o.spec.mode != "validator" or not os.path.exists(keyfile):
                continue
            pv = FilePV.load(
                keyfile,
                os.path.join(
                    o.home, "data", "priv_validator_state.json"
                ),
            )
            pv_by_addr[pv.pub_key().address()] = pv
        total = common_vals.total_voting_power()
        chosen, power = [], 0
        for v in sorted(vs.validators, key=lambda x: -x.voting_power):
            pv = pv_by_addr.get(v.address)
            if pv is None:
                continue
            chosen.append((v, pv))
            power += v.voting_power
            if power * 3 > total:
                break
        if not power * 3 > total:
            raise RuntimeError(
                "not enough validator keys for >1/3 power"
            )
        fvs = ValidatorSet([v for v, _ in chosen])
        forged = dataclasses.replace(
            header,
            app_hash=b"\x77" * 32,
            validators_hash=fvs.hash(),
            next_validators_hash=fvs.hash(),
        )
        fbid = BlockID(
            forged.hash(), PartSetHeader(1, forged.hash())
        )
        now = _time.time_ns()
        sigs = []
        for v, pv in chosen:
            vote = Vote(
                type_=PRECOMMIT,
                height=h,
                round=0,
                block_id=fbid,
                timestamp_ns=now,
                validator_address=v.address,
                validator_index=0,
            )
            sigs.append(
                CommitSig(
                    block_id_flag=BLOCK_ID_FLAG_COMMIT,
                    validator_address=v.address,
                    timestamp_ns=now,
                    signature=pv.priv_key.sign(
                        vote.sign_bytes(self.m.chain_id)
                    ),
                )
            )
        lb = LightBlock(
            header=forged,
            commit=Commit(h, 0, fbid, sigs),
            validator_set=fvs,
        )
        ev = LightClientAttackEvidence(
            conflicting_block=lb,
            common_height=h - 1,
            total_voting_power=total,
            timestamp_ns=now,
        )
        ev.byzantine_validators = ev.byzantine_from(common_vals)
        self._rpc_post(
            target,
            "broadcast_evidence",
            {"evidence": "0x" + ev.encode().hex()},
            5.0,
        )

    def _inject_evidence(self, rn: RunnerNode) -> None:
        import time as _time

        from ..evidence.types import DuplicateVoteEvidence
        from ..types.block import BlockID, PartSetHeader
        from ..types.vote import PREVOTE, Vote

        pv = FilePV.load(
            os.path.join(rn.home, "config", "priv_validator_key.json"),
            os.path.join(rn.home, "data", "priv_validator_state.json"),
        )
        # equivocate at a recent committed height so receiving pools
        # can resolve the validator set
        target = next(
            o for o in self.nodes.values() if o is not rn and o.started
        )
        h = self._height(target)
        if h < 1:
            raise RuntimeError("no committed height yet")
        votes = []
        now = _time.time_ns()
        for tag in (b"\xaa", b"\xbb"):
            v = Vote(
                type_=PREVOTE,
                height=h,
                round=0,
                block_id=BlockID(tag * 32, PartSetHeader(1, tag * 32)),
                timestamp_ns=now,
                validator_address=pv.pub_key().address(),
                validator_index=0,  # receiving pool resolves by address
                signature=b"",
            )
            v.signature = pv.priv_key.sign(v.sign_bytes(self.m.chain_id))
            votes.append(v)
        ev = DuplicateVoteEvidence.from_votes(
            votes[0], votes[1], rn.spec.power, 0, now
        )
        self._rpc_post(
            target,
            "broadcast_evidence",
            {"evidence": "0x" + ev.encode().hex()},
            5.0,
        )

    # --- assertions ---------------------------------------------------

    def _check_agreement(self) -> None:
        """All nodes must agree on the block at target height."""
        target = self.m.target_height
        hashes = {}
        for name, rn in self.nodes.items():
            if not rn.started:
                continue
            try:
                res = self._rpc(rn, f"block?height={target}")
                hashes[name] = res["block_id"]["hash"]
            except Exception as e:
                self.failures.append(f"{name}: no block {target}: {e}")
        if len(set(hashes.values())) > 1:
            self.failures.append(f"HASH DISAGREEMENT at {target}: {hashes}")

    def stop(self) -> None:
        for rn in self.nodes.values():
            if rn.proc is not None:
                try:
                    rn.proc.send_signal(signal.SIGCONT)  # unfreeze
                    rn.proc.terminate()
                except ProcessLookupError:
                    pass
        for rn in self.nodes.values():
            if rn.proc is not None:
                try:
                    rn.proc.wait(timeout=5)
                except Exception:
                    rn.proc.kill()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="cometbft-tpu-torch-e2e")
    ap.add_argument("manifest")
    ap.add_argument("--dir", default=os.path.join(tempfile.gettempdir(), "cometbft-torch-e2e"))
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--device", default="cuda",
                    help="the children's --device: cuda (the default; "
                    "fails without a GPU) or cpu")
    args = ap.parse_args(argv)
    m = Manifest.load(args.manifest)
    try:
        runner = Runner(m, args.dir, device=args.device)
    except RuntimeError as e:
        print(f"Error: {e} (on the command line: --device cpu)", file=sys.stderr)
        return 1
    runner.setup()
    try:
        ok = asyncio.run(runner.run(args.timeout))
    finally:
        runner.stop()
    if ok:
        print(f"PASS: {len(m.nodes)} nodes converged at height "
              f">= {m.target_height}")
        return 0
    print("FAIL:")
    for f in runner.failures:
        print(f"  - {f}")
    return 1


if __name__ == "__main__":
    sys.exit(main())
