"""``python -m cometbft_tpu_torch``: the node's command line (reference
cmd/cometbft/main.go:14-49, the command registry).

A copy of the JAX package's ``cmd/main.py``. Commands: init, start,
testnet, light, replay, rollback, reindex-event, reset and
unsafe-reset-all, inspect, compact, gen-node-key, gen-validator,
show-node-id, show-validator, bootstrap-state, signer, abci-server,
abci-cli, debug (``dump``/``kill``: a live node's status, net info,
consensus dump and, with ``--pprof-laddr``, stacks and heap, archived
by ``utils/debug.collect_debug_dump``), load (timestamped tx load
against a node's RPC and the commit-latency report, ``e2e/load.py``;
no device) and version.

Where the JAX package pins its JAX platform, the port takes
``--device`` (default ``cuda``), resolved by ``device.resolve`` for the
subcommands that reach the signature checks (tagged by
:func:`_compute_cmd`): on a machine without a GPU they exit non-zero
with that error unless given ``--device cpu``. Only those subcommands
import torch; ``init``, ``signer`` and ``abci-server`` stay light.
``start`` builds its node with :func:`node_from_home`: a remote signer
(``base.priv_validator_laddr``, wrapped in ``RetrySignerClient``) or the
home's ``FilePV``, the app-side mempool's kvstore for
``base.abci = "kvstore-appmem"``, an out-of-process app for
``base.proxy_app``; on a card it builds the kernels first and claims
the card, so a start without one fails at once; SIGINT and SIGTERM stop
the node and it exits 0.

Home layout (reference config directory conventions):
  <home>/config/config.toml, genesis.json, node_key.json,
               priv_validator_key.json
  <home>/data/priv_validator_state.json, *.db, cs.wal/
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import shutil
import signal
import sys

VERSION = "0.1.0"


def _compute_cmd(fn):
    """Marks a subcommand that reaches the signature checks: main()
    resolves ``--device`` for it (importing torch); the others never
    import torch."""
    fn._reaches_device = True
    return fn


def _home(args) -> str:
    return os.path.expanduser(args.home)


def _paths(home: str) -> dict:
    return {
        "config": os.path.join(home, "config"),
        "data": os.path.join(home, "data"),
        "config_toml": os.path.join(home, "config", "config.toml"),
        "genesis": os.path.join(home, "config", "genesis.json"),
        "node_key": os.path.join(home, "config", "node_key.json"),
        "pv_key": os.path.join(home, "config", "priv_validator_key.json"),
        "pv_state": os.path.join(home, "data", "priv_validator_state.json"),
    }


def _load_config(home: str):
    from ..config.config import default_config, load_toml

    p = _paths(home)
    if os.path.exists(p["config_toml"]):
        cfg = load_toml(p["config_toml"])
    else:
        cfg = default_config(home)
    cfg.root_dir = home
    return cfg


def _open_db(home: str, name: str):
    """One of the home's stores, on the backend its config names
    (``base.db_backend``: ``sqlite`` or ``logdb``)."""
    from ..utils import kv

    return kv.open_kv(_load_config(home).base.db_backend, os.path.join(_paths(home)["data"], name))


def _genesis(home: str):
    from ..types.genesis import GenesisDoc

    with open(_paths(home)["genesis"]) as f:
        return GenesisDoc.from_json(f.read())


# --- init ----------------------------------------------------------------


def cmd_init(args) -> int:
    """Initialise a home dir: config, genesis (this node as sole
    validator), node key, privval key (reference commands/init.go)."""
    from ..config.config import default_config, write_toml
    from ..p2p.key import NodeKey
    from ..privval.file_pv import FilePV
    from ..types.genesis import GenesisDoc
    from ..types.validator_set import Validator

    home = _home(args)
    p = _paths(home)
    os.makedirs(p["config"], exist_ok=True)
    os.makedirs(p["data"], exist_ok=True)

    cfg = default_config(home)
    if not os.path.exists(p["config_toml"]):
        write_toml(cfg, p["config_toml"])
    pv = FilePV.load_or_generate(p["pv_key"], p["pv_state"])
    nk = NodeKey.load_or_gen(p["node_key"])
    if not os.path.exists(p["genesis"]):
        gen = GenesisDoc(
            chain_id=args.chain_id or "test-chain-%s" % os.urandom(3).hex(),
            validators=[Validator(pv.pub_key(), 10)],
        )
        with open(p["genesis"], "w") as f:
            f.write(gen.to_json())
        print(f"Generated genesis file {p['genesis']}")
    print(f"Initialised node in {home} (node id {nk.node_id})")
    return 0


# --- start ---------------------------------------------------------------


def node_from_home(home: str, device, log_level: str = "", out=print):
    """The ``Node`` that ``start`` runs for ``home``, built on
    ``device`` (a resolved torch device). With
    ``base.priv_validator_laddr`` set it listens there for a remote
    signer and waits for it to dial in."""
    from ..node.node import Node
    from ..p2p.key import NodeKey
    from ..privval.file_pv import FilePV
    from ..utils.log import set_level

    p = _paths(home)
    cfg = _load_config(home)
    # a level like "info" or "consensus:debug,*:info" (reference
    # libs/log and config log_level)
    set_level(log_level or cfg.base.log_level)
    gen = _genesis(home)
    if device.type == "cuda":
        import torch

        from .. import kernels

        # build the kernels now (under the checkout's build lock) and
        # take a context on the card: a start without nvcc or without
        # the card fails here, not at its first vote wave
        kernels.build_all()
        torch.zeros(1, device=device)
    if cfg.base.priv_validator_laddr:
        from ..privval.signer import RetrySignerClient, SignerClient

        # bounded retries around every sign call: a transient signer
        # hiccup must not become a missed vote (reference
        # privval/retry_signer_client.go)
        pv = RetrySignerClient(SignerClient(cfg.base.priv_validator_laddr))
        out(f"waiting for remote signer on {pv.listen_addr} ...")
        pv.wait_for_signer()
        pv.pub_key()  # fetch and cache the validator's identity
    else:
        pv = FilePV.load(p["pv_key"], p["pv_state"]) if os.path.exists(p["pv_key"]) else None
    nk = NodeKey.load_or_gen(p["node_key"])
    app = None
    if cfg.base.abci == "kvstore-appmem":
        from ..models.kvstore import AppMempoolKVStore

        app = AppMempoolKVStore()
    return Node(cfg, gen, privval=pv, node_key=nk, app=app, home=p["data"], device=device)


@_compute_cmd
def cmd_start(args) -> int:
    home = _home(args)

    async def main():
        node = node_from_home(home, args.device, args.log_level)
        await node.start()
        card = ""
        if node.device.type == "cuda":
            import torch

            card = f" ({torch.cuda.get_device_name(node.device)})"
        print(
            f"Node {node.node_key.node_id} started on device {node.device}{card}: "
            f"p2p {node.listen_addr}, "
            f"rpc {node.rpc_server.listen_addr if node.rpc_server else '-'}, "
            f"grpc {node.grpc_server.port if node.grpc_server else '-'}",
            flush=True,
        )
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        print("shutting down...", flush=True)
        await node.stop()
        close = getattr(node.parts.privval, "close", None)
        if close is not None:
            close()

    asyncio.run(main())
    return 0


# --- key and identity helpers ------------------------------------------


def cmd_gen_node_key(args) -> int:
    from ..p2p.key import NodeKey

    nk = NodeKey.load_or_gen(_paths(_home(args))["node_key"])
    print(nk.node_id)
    return 0


def cmd_show_node_id(args) -> int:
    from ..p2p.key import NodeKey

    nk = NodeKey.load(_paths(_home(args))["node_key"])
    print(nk.node_id)
    return 0


def cmd_gen_validator(args) -> int:
    from ..privval.file_pv import FilePV

    p = _paths(_home(args))
    os.makedirs(p["config"], exist_ok=True)
    os.makedirs(p["data"], exist_ok=True)
    pv = FilePV.load_or_generate(p["pv_key"], p["pv_state"])
    pub = pv.pub_key()
    print(json.dumps({"address": pub.address().hex().upper(),
                      "pub_key": {"type": pub.type_, "value": bytes(pub).hex()}}, indent=2))
    return 0


def cmd_show_validator(args) -> int:
    from ..privval.file_pv import FilePV

    p = _paths(_home(args))
    pub = FilePV.load(p["pv_key"], p["pv_state"]).pub_key()
    print(json.dumps({"type": pub.type_, "value": bytes(pub).hex()}))
    return 0


# --- testnet -------------------------------------------------------------


def cmd_testnet(args) -> int:
    """Write a multi-node testnet's homes (reference
    commands/testnet.go): node i listens for p2p on starting-port + 2i
    and for RPC on the port after it, with the others as persistent
    peers."""
    from ..config.config import default_config, write_toml
    from ..p2p.key import NodeKey
    from ..privval.file_pv import FilePV
    from ..types.genesis import GenesisDoc
    from ..types.validator_set import Validator

    out = os.path.expanduser(args.o)
    n = args.v
    pvs, nks = [], []
    for i in range(n):
        p = _paths(os.path.join(out, f"node{i}"))
        os.makedirs(p["config"], exist_ok=True)
        os.makedirs(p["data"], exist_ok=True)
        pvs.append(FilePV.load_or_generate(p["pv_key"], p["pv_state"]))
        nks.append(NodeKey.load_or_gen(p["node_key"]))
    gen = GenesisDoc(
        chain_id=args.chain_id or "testnet-%s" % os.urandom(3).hex(),
        validators=[Validator(pv.pub_key(), 10) for pv in pvs],
    )
    base_p2p = args.starting_port
    peers = [f"{nks[i].node_id}@127.0.0.1:{base_p2p + 2 * i}" for i in range(n)]
    for i in range(n):
        home = os.path.join(out, f"node{i}")
        p = _paths(home)
        cfg = default_config(home)
        cfg.p2p.laddr = f"tcp://127.0.0.1:{base_p2p + 2 * i}"
        cfg.rpc.laddr = f"tcp://127.0.0.1:{base_p2p + 2 * i + 1}"
        cfg.p2p.persistent_peers = ",".join(pr for j, pr in enumerate(peers) if j != i)
        cfg.base.moniker = f"node{i}"
        write_toml(cfg, p["config_toml"])
        with open(p["genesis"], "w") as f:
            f.write(gen.to_json())
    print(f"Wrote {n}-node testnet to {out} (chain {gen.chain_id})")
    return 0


# --- maintenance ---------------------------------------------------------


def cmd_reset(args, all_: bool = False) -> int:
    """Delete data (blocks, state, WAL) and reset the privval's sign
    state (reference commands/reset.go)."""
    from ..privval.file_pv import FilePV

    p = _paths(_home(args))
    data = p["data"]
    if os.path.isdir(data):
        for name in os.listdir(data):
            if name == "priv_validator_state.json":
                continue
            full = os.path.join(data, name)
            if os.path.isdir(full):
                shutil.rmtree(full, ignore_errors=True)
            else:
                os.remove(full)
    if os.path.exists(p["pv_key"]):
        pv = FilePV.load(p["pv_key"], p["pv_state"])
        pv.last = type(pv.last)()  # zero sign state
        pv.save_state()
    print(f"Reset data in {data}")
    return 0


def cmd_rollback(args) -> int:
    from ..state.rollback import rollback_state
    from ..state.store import Store as StateStore
    from ..store.block_store import BlockStore

    block_db = _open_db(_home(args), "blockstore.db")
    state_db = _open_db(_home(args), "state.db")
    st = rollback_state(StateStore(state_db), BlockStore(block_db), remove_block=args.hard)
    print(f"Rolled back state to height {st.last_block_height} (app_hash {st.app_hash.hex()[:16]})")
    block_db.close()
    state_db.close()
    return 0


def cmd_compact(args) -> int:
    import sqlite3

    home = _home(args)
    data = _paths(home)["data"]
    backend = _load_config(home).base.db_backend
    n = 0
    for name in os.listdir(data) if os.path.isdir(data) else []:
        if not name.endswith(".db"):
            continue
        if backend == "logdb" and name in ("blockstore.db", "state.db", "tx_index.db"):
            db = _open_db(home, name)
            db.compact()
            db.close()
        else:
            con = sqlite3.connect(os.path.join(data, name))
            con.execute("VACUUM")
            con.close()
        n += 1
    print(f"Compacted {n} {backend} databases")
    return 0


def cmd_reindex_event(args) -> int:
    """Rebuild the tx and block indexes from stored blocks and finalize
    responses (reference commands/reindex_event.go)."""
    from ..state.execution import decode_finalize_response
    from ..state.indexer import LAST_INDEXED_KEY, BlockIndexer, TxIndexer, _enc_height
    from ..state.store import Store as StateStore
    from ..store.block_store import BlockStore

    block_db = _open_db(_home(args), "blockstore.db")
    state_db = _open_db(_home(args), "state.db")
    index_db = _open_db(_home(args), "tx_index.db")
    bs, ss = BlockStore(block_db), StateStore(state_db)
    txi, bli = TxIndexer(index_db), BlockIndexer(index_db)
    start = args.start_height or bs.base()
    end = args.end_height or bs.height()
    count = 0
    for h in range(start, end + 1):
        blk = bs.load_block(h)
        raw = ss.load_finalize_block_response(h)
        if blk is None or raw is None:
            continue
        resp = decode_finalize_response(raw)
        # one atomic batch a height, rows and the idx:last marker, as
        # the live indexer flushes, so a killed reindex resumes
        sets = []
        for i, tx in enumerate(blk.data.txs):
            if i < len(resp.tx_results):
                sets.extend(txi.tx_sets(h, i, tx, resp.tx_results[i]))
        sets.extend(bli.block_sets(h, resp.events))
        # the marker advances contiguously only; a gap wholly below the
        # store's base is pruned and may be jumped
        last = txi.last_indexed_height()
        if last >= h - 1 or bs.base() >= h:
            sets.append((LAST_INDEXED_KEY, _enc_height(max(last, h))))
        index_db.write_batch(sets)
        count += 1
    print(f"Reindexed {count} blocks [{start},{end}]")
    for db in (block_db, state_db, index_db):
        db.close()
    return 0


@_compute_cmd
def cmd_replay(args) -> int:
    """Re-execute stored blocks against a fresh app through the
    handshake's replay (reference commands/replay.go)."""
    from ..node.inprocess import build_node

    home = _home(args)
    parts = build_node(_genesis(home), config=_load_config(home), home=_paths(home)["data"],
                       device=args.device)
    print(f"Replayed to height {parts.state.last_block_height} (app_hash {parts.state.app_hash.hex()[:16]})")
    parts.close_stores()
    return 0


def cmd_inspect(args) -> int:
    """Read-only RPC over a stopped node's data (reference
    inspect/inspect.go:32)."""
    from ..rpc.env import Environment
    from ..rpc.server import RPCServer
    from ..state.store import Store as StateStore
    from ..store.block_store import BlockStore
    from ..types import events as ev

    home = _home(args)
    env = Environment(
        chain_id=(gen := _genesis(home)).chain_id,
        block_store=BlockStore(_open_db(home, "blockstore.db")),
        state_store=StateStore(_open_db(home, "state.db")),
        event_bus=ev.EventBus(),
        genesis=gen,
        config=_load_config(home),
    )

    async def main():
        srv = RPCServer(env)
        await srv.start(args.rpc_laddr)
        print(f"Inspect RPC serving on {srv.listen_addr} (read-only)", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await srv.stop()

    asyncio.run(main())
    return 0


@_compute_cmd
def cmd_light(args) -> int:
    """Light client daemon: verify new headers from a primary against
    witnesses on ``--device``; with ``--laddr``, serve the verified RPC
    proxy (reference cmd light, light/proxy)."""
    import time

    from ..light import SEQUENTIAL, SKIPPING, Client, TrustOptions
    from ..light.http_provider import HTTPProvider

    primary = HTTPProvider(args.chain_id, args.primary)
    witnesses = [HTTPProvider(args.chain_id, w) for w in (args.witnesses.split(",") if args.witnesses else [])
                 if w]
    store = None
    if args.dir:
        # a persistent trust store (reference light home db): a restart
        # resumes from its last verified header; the command line's
        # trust root only seeds an empty store
        from ..light.store import DBLightStore
        from ..utils.kv import open_kv

        d = os.path.expanduser(args.dir)
        os.makedirs(d, exist_ok=True)
        store = DBLightStore(open_kv("sqlite", os.path.join(d, "light.db")), args.chain_id)
    cli = Client(
        args.chain_id,
        TrustOptions(
            period_ns=int(args.trust_period_h * 3600 * 1e9),
            height=args.trust_height,
            hash=bytes.fromhex(args.trust_hash),
        ),
        primary=primary,
        witnesses=witnesses,
        store=store,
        verification_mode=SEQUENTIAL if args.sequential else SKIPPING,
        device=args.device,
    )
    if args.laddr:
        # proxy mode (the reference command's main role): serve
        # light-verified RPC, proof-checked abci_query and tx included,
        # while tracking the head in the background
        from ..light.proxy import LightProxy

        async def serve():
            proxy = LightProxy(cli, args.primary)
            addr = args.laddr
            for pfx in ("tcp://", "http://"):
                if addr.startswith(pfx):
                    addr = addr[len(pfx):]
            await proxy.start(addr)
            print(f"light proxy for {args.chain_id} on {proxy.listen_addr} (primary {args.primary})",
                  flush=True)
            try:
                while True:
                    try:
                        await asyncio.to_thread(cli.update)
                    except asyncio.CancelledError:
                        raise
                    except Exception as e:
                        # a primary's hiccup must not end the proxy
                        print(f"light update failed (retrying): {e!r}", flush=True)
                    await asyncio.sleep(args.interval_s)
            except (KeyboardInterrupt, asyncio.CancelledError):
                pass
            finally:
                await proxy.stop()
            return 0

        try:
            return asyncio.run(serve()) or 0
        except KeyboardInterrupt:
            return 0

    print(f"light client tracking {args.chain_id} via {args.primary}", flush=True)
    try:
        while True:
            lb = cli.update()
            if lb is not None:
                print(f"verified height {lb.height} hash {lb.hash().hex()[:16]}", flush=True)
            time.sleep(args.interval_s)
    except KeyboardInterrupt:
        return 0


def cmd_signer(args) -> int:
    """A remote signer serving this home's validator key to a node (the
    tmkms role): dials ``-a``, redials after a lost connection."""
    from ..privval.file_pv import FilePV
    from ..privval.signer import SignerServer

    p = _paths(_home(args))
    pv = FilePV.load(p["pv_key"], p["pv_state"])
    server = SignerServer(pv, args.address)

    async def main():
        print(f"signer for {pv.pub_key().address().hex()[:16]} dialing {args.address}", flush=True)
        while True:
            try:
                await server.serve()
            except (
                ConnectionError,
                OSError,
                EOFError,  # IncompleteReadError: the node closed mid-handshake
                asyncio.TimeoutError,
            ) as e:
                print(f"connection lost ({e}); retrying in 1s", flush=True)
            await asyncio.sleep(1.0)

    try:
        asyncio.run(main())
    except KeyboardInterrupt:
        pass
    return 0


def cmd_abci_server(args) -> int:
    """Host the example kvstore app out of process (the reference
    abci-cli's ``kvstore`` command): a node whose ``proxy_app`` is this
    address drives it over the socket or gRPC ABCI protocol."""
    from ..models.kvstore import KVStoreApplication

    app = KVStoreApplication(
        persist_path=os.path.join(_home(args), "data", "kvstore.json") if args.persist else None
    )
    if args.transport == "grpc":
        import threading

        from ..abci.server import GRPCServer

        server = GRPCServer(app, args.address)
        server.start()
        print(f"abci grpc server on port {server.port}", flush=True)
        stop = threading.Event()
        for sig in (signal.SIGINT, signal.SIGTERM):
            signal.signal(sig, lambda *_: stop.set())
        stop.wait()
        server.stop()
        return 0

    from ..abci.server import ABCIServer

    server = ABCIServer(app, args.address)

    async def main():
        await server.start()
        print(f"abci socket server on {server.listen_addr}", flush=True)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGINT, signal.SIGTERM):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await server.stop()

    asyncio.run(main())
    return 0


def cmd_abci_cli(args) -> int:
    """Client side of the reference abci-cli: one-shots, ``console`` and
    piped ``batch`` scripts against a running ABCI server."""
    from .abci_cli import run_abci_cli

    return run_abci_cli(args.address, args.abci_cmd, args.abci_args)


@_compute_cmd
def cmd_bootstrap_state(args) -> int:
    """Offline statesync: light-verify the state at a height on
    ``--device`` and seed the stores, so that ``start`` goes straight
    to blocksync (reference node.BootstrapState, node/node.go:161-280)."""
    from ..node.bootstrap import bootstrap_state

    home = _home(args)
    h = bootstrap_state(_load_config(home), _genesis(home), _paths(home)["data"],
                        height=args.height or None, device=args.device)
    print(f"bootstrapped state at height {h}")
    return 0


def cmd_debug(args) -> int:
    """`debug dump` / `debug kill` (reference
    cmd/cometbft/commands/debug/): archive a live node's status,
    net_info, consensus dump, and profiles; kill additionally
    SIGKILLs the node process after the dump."""
    from ..utils.debug import collect_debug_dump

    path = collect_debug_dump(
        args.rpc_laddr.replace("tcp://", ""),
        args.output_dir,
        pprof_addr=args.pprof_laddr,
        label=args.debug_cmd,
    )
    print(f"wrote {path}")
    if args.debug_cmd == "kill":
        if args.pid <= 0:
            print("debug kill requires --pid <node pid>", file=sys.stderr)
            return 1
        os.kill(args.pid, signal.SIGKILL)
        print(f"killed pid {args.pid}")
    return 0


def cmd_load(args) -> int:
    """Timestamped tx load + commit-latency report (reference
    test/loadtime). It talks to a node over RPC and checks no
    signature, so it resolves no device."""
    import json as _json

    from ..e2e.load import LoadGenerator, latency_report
    from ..rpc.client import HTTPClient

    async def main():
        base = args.rpc_laddr.replace("tcp://", "http://")
        if not base.startswith("http"):
            base = "http://" + base
        cli = HTTPClient(base)
        try:
            st = await cli.status()
            h0 = int(st["sync_info"]["latest_block_height"])
            gen = LoadGenerator(
                cli,
                rate=args.rate,
                connections=args.connections,
                tx_size=args.size,
            )
            res = await gen.run(args.time)
            await asyncio.sleep(2.0)  # let the tail commit
            st = await cli.status()
            h1 = int(st["sync_info"]["latest_block_height"])
            rep = await latency_report(cli, h0 + 1, h1)
            print(
                _json.dumps(
                    {
                        "sent": res.sent,
                        "accepted": res.accepted,
                        "rejected": res.rejected,
                        "send_rate_tx_s": round(res.send_rate, 1),
                        **rep.to_dict(),
                    }
                )
            )
        finally:
            await cli.close()

    asyncio.run(main())
    return 0


def cmd_version(args) -> int:
    print(f"cometbft-tpu-torch v{VERSION}")
    return 0


# --- parser --------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cometbft-tpu-torch", description="BFT consensus node on a GPU")
    ap.add_argument("--home", default=os.environ.get("CMTHOME", "~/.cometbft-tpu-torch"),
                    help="node home directory")
    ap.add_argument("--device", default="cuda",
                    help="where signatures are checked: cuda (the default; fails without a GPU) or cpu")
    sub = ap.add_subparsers(dest="command")

    p = sub.add_parser("init", help="initialise a node home dir")
    p.add_argument("--chain-id", default="")
    p.set_defaults(fn=cmd_init)

    p = sub.add_parser("start", help="run the node")
    p.add_argument("--log-level", default="",
                   help='e.g. "info" or "consensus:debug,*:info" (default: base.log_level)')
    p.set_defaults(fn=cmd_start)

    p = sub.add_parser("testnet", help="generate a local testnet")
    p.add_argument("--v", type=int, default=4, help="number of validators")
    p.add_argument("--o", default="./mytestnet", help="output directory")
    p.add_argument("--chain-id", default="")
    p.add_argument("--starting-port", type=int, default=26656)
    p.set_defaults(fn=cmd_testnet)

    for name, fn in (
        ("gen-node-key", cmd_gen_node_key),
        ("show-node-id", cmd_show_node_id),
        ("gen-validator", cmd_gen_validator),
        ("show-validator", cmd_show_validator),
        ("version", cmd_version),
        ("compact", cmd_compact),
        ("replay", cmd_replay),
    ):
        sub.add_parser(name).set_defaults(fn=fn)

    sub.add_parser("reset", help="delete data, keep keys").set_defaults(fn=cmd_reset)
    sub.add_parser("unsafe-reset-all", help="delete data, keep keys").set_defaults(
        fn=lambda a: cmd_reset(a, all_=True))

    p = sub.add_parser("rollback", help="rewind state by one height")
    p.add_argument("--hard", action="store_true", help="also delete the tip block")
    p.set_defaults(fn=cmd_rollback)

    p = sub.add_parser("reindex-event", help="rebuild tx/block indexes")
    p.add_argument("--start-height", type=int, default=0)
    p.add_argument("--end-height", type=int, default=0)
    p.set_defaults(fn=cmd_reindex_event)

    p = sub.add_parser("inspect", help="read-only RPC over data dirs")
    p.add_argument("--rpc-laddr", default="127.0.0.1:26657")
    p.set_defaults(fn=cmd_inspect)

    p = sub.add_parser("signer", help="remote signer daemon")
    p.add_argument("-a", "--address", required=True, help="validator node's priv_validator_laddr to dial")
    p.set_defaults(fn=cmd_signer)

    p = sub.add_parser("bootstrap-state", help="seed stores with light-verified state (offline statesync)")
    p.add_argument("--height", type=int, default=0)
    p.set_defaults(fn=cmd_bootstrap_state)

    p = sub.add_parser("debug", help="dump/kill a live node")
    p.add_argument("debug_cmd", choices=("dump", "kill"))
    p.add_argument("--pid", type=int, default=0, help="pid (kill only)")
    p.add_argument("--rpc-laddr", default="127.0.0.1:26657")
    p.add_argument("--pprof-laddr", default="")
    p.add_argument("--output-dir", default=".")
    p.set_defaults(fn=cmd_debug)

    p = sub.add_parser("load", help="generate tx load and report commit latency")
    p.add_argument("--rpc-laddr", default="127.0.0.1:26657")
    p.add_argument("-r", "--rate", type=float, default=100.0)
    p.add_argument("-c", "--connections", type=int, default=1)
    p.add_argument("-s", "--size", type=int, default=256)
    p.add_argument("-T", "--time", type=float, default=10.0)
    p.set_defaults(fn=cmd_load)

    p = sub.add_parser("abci-server", help="host the kvstore app over socket/grpc ABCI")
    p.add_argument("-a", "--address", default="tcp://127.0.0.1:26658")
    p.add_argument("-t", "--transport", choices=("socket", "grpc"), default="socket")
    p.add_argument("--persist", action="store_true", help="persist app state to home")
    p.set_defaults(fn=cmd_abci_server)

    p = sub.add_parser("abci-cli", help="client for a running ABCI app: one-shot, console, batch")
    p.add_argument("-a", "--address", default="tcp://127.0.0.1:26658")
    p.add_argument(
        "abci_cmd",
        choices=("echo", "info", "check_tx", "finalize_block", "prepare_proposal", "process_proposal",
                 "commit", "query", "console", "batch"),
    )
    p.add_argument("abci_args", nargs="*")
    p.set_defaults(fn=cmd_abci_cli)

    p = sub.add_parser("light", help="light client daemon / proxy")
    p.add_argument("chain_id")
    p.add_argument("-p", "--primary", required=True)
    p.add_argument("-w", "--witnesses", default="")
    p.add_argument("--trust-height", type=int, required=True)
    p.add_argument("--trust-hash", required=True)
    p.add_argument("--trust-period-h", type=float, default=168.0)
    p.add_argument("--interval-s", type=float, default=1.0)
    p.add_argument("--sequential", action="store_true",
                   help="verify every header in order instead of skipping bisection")
    p.add_argument("--dir", default="",
                   help="persist the trust store here (light.db); a restart resumes from it")
    p.add_argument("--laddr", default="", help="serve the light-verified RPC proxy on this address")
    p.set_defaults(fn=cmd_light)

    return ap


def _resolve_device(name: str):
    from ..device import resolve

    try:
        return resolve(name)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: --device cpu)") from None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not getattr(args, "fn", None):
        build_parser().print_help()
        return 1
    try:
        if getattr(args.fn, "_reaches_device", False):
            args.device = _resolve_device(args.device)
        return args.fn(args)
    except KeyboardInterrupt:
        return 130
    except FileNotFoundError as e:
        print(f"Error: {e.filename or e} not found — did you run `init` in this home dir?", file=sys.stderr)
        return 1
    except Exception as e:
        if os.environ.get("CMT_DEBUG"):
            raise
        print(f"Error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
