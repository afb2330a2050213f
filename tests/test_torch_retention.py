"""The port's storage lifecycle plane held to the JAX package's
(``tests/test_retention.py``).

Every case that needs no chaos harness runs on both packages with the
same inputs (a one-validator chain of the same length, the same
``[storage]`` knobs) and checks the reference's assertions on each;
what the two observe (the reconcile's counts, store and index bases,
snapshot heights, RPC errors, on-disk snapshot files) must be equal:
min-wins targets under the snapshot and serve floors, marker-atomic
pruning of blocks, index rows and states, a crash between bounded
batches (in process, and a power cut at the ``retention-prune-batch``
fail point in a subprocess) resumed idempotently, the indexer's replay
anchored at a pruned base, the snapshot store's rotation, restart and
sweep, the RPC routes' structured below-base errors and the ``health``
route's storage verdict, and a pruned node's restart. The chaos-driven
cases (a crash mid-prune and a snapshot during a prune on a live net, a
statesync join from a pruned source, the soak) wait for the chaos
harness (ROADMAP A10).
"""

import asyncio
import hashlib
import json
import os
import subprocess
import sys
from types import SimpleNamespace

import pytest
import torch

from cometbft_tpu.config.config import test_config as jax_test_cfg
from cometbft_tpu.node import inprocess as jinprocess
from cometbft_tpu.rpc import client as jclient
from cometbft_tpu.rpc import core as jcore
from cometbft_tpu.rpc import env as jenv
from cometbft_tpu.state import indexer as jindexer
from cometbft_tpu.statesync import snapshots as jsnapshots
from cometbft_tpu.store import retention as jretention
from cometbft_tpu.types import genesis as jgenesis
from cometbft_tpu.utils import chaingen as jchaingen
from cometbft_tpu.models import kvstore as jkvstore
from cometbft_tpu_torch.config.config import test_config as port_test_cfg
from cometbft_tpu_torch.crypto import parallel_verify as pv
from cometbft_tpu_torch.crypto import scheduler as sched_mod
from cometbft_tpu_torch.models import kvstore as pkvstore
from cometbft_tpu_torch.node import inprocess as pinprocess
from cometbft_tpu_torch.rpc import client as pclient
from cometbft_tpu_torch.rpc import core as pcore
from cometbft_tpu_torch.rpc import env as penv
from cometbft_tpu_torch.state import indexer as pindexer
from cometbft_tpu_torch.statesync import snapshots as psnapshots
from cometbft_tpu_torch.store import retention as pretention
from cometbft_tpu_torch.types import genesis as pgenesis
from cometbft_tpu_torch.utils import chaingen as pchaingen
from torch_hard_limit import hard_limit  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PKGS = {
    "jax": SimpleNamespace(
        name="jax", test_config=jax_test_cfg, inprocess=jinprocess, chaingen=jchaingen,
        RetentionPlane=jretention.RetentionPlane, SnapshotStore=jsnapshots.SnapshotStore,
        core=jcore, Environment=jenv.Environment, client=jclient, indexer=jindexer,
        kvstore=jkvstore, GenesisDoc=jgenesis.GenesisDoc,
    ),
    "port": SimpleNamespace(
        name="port", test_config=port_test_cfg, inprocess=pinprocess, chaingen=pchaingen,
        RetentionPlane=pretention.RetentionPlane, SnapshotStore=psnapshots.SnapshotStore,
        core=pcore, Environment=penv.Environment, client=pclient, indexer=pindexer,
        kvstore=pkvstore, GenesisDoc=pgenesis.GenesisDoc,
    ),
}


@pytest.fixture(autouse=True)
def host_plane():
    torch.set_num_threads(1)
    eng = pv.ParallelVerifyEngine(workers=2)
    pv.set_engine(eng)
    yield
    sched_mod.set_scheduler(None)
    pv.set_engine(None)
    eng.close()


def both(scenario, tmp_path=None):
    """The scenario's observations on each package (each in its own
    directory under ``tmp_path``); equal, returned once."""
    got = {}
    for name, pkg in PKGS.items():
        if tmp_path is None:
            got[name] = scenario(pkg)
        else:
            d = tmp_path / name
            d.mkdir()
            got[name] = scenario(pkg, d)
    assert got["port"] == got["jax"]
    return got["port"]


def _cfg(pkg, home, **storage):
    cfg = pkg.test_config(str(home))
    cfg.base.db_backend = "sqlite"
    cfg.tx_index.indexer = "kv"
    s = cfg.storage
    s.prune_interval_s = 3600.0  # reconciles are test-driven only
    for k, v in storage.items():
        setattr(s, k, v)
    return cfg


def _build(pkg, genesis, cfg, home, app=None):
    if pkg.name == "jax":
        return pkg.inprocess.build_node(genesis, None, app=app, config=cfg, home=str(home))
    return pkg.inprocess.build_node(genesis, app=app, config=cfg, home=str(home), device="cpu")


def _genesis(pkg):
    """(genesis, raw private keys): the JAX make_genesis returns
    signers, the port's raw keys."""
    genesis, keys = pkg.inprocess.make_genesis(1)
    return genesis, [getattr(k, "priv_key", k) for k in keys]


def _grow(pkg, home, heights, app=None, **storage):
    genesis, privs = _genesis(pkg)
    node = _build(pkg, genesis, _cfg(pkg, home, **storage), home, app=app)
    pkg.chaingen.make_chain(genesis, privs, heights, node=node)
    return genesis, privs, node


# --- target reconciliation (unit) -------------------------------------------


def _plane(pkg, retain=10, snap_interval=0, snap_store=None, app_retain=0):
    cfg = SimpleNamespace(
        retain_blocks=retain, retain_states=0, retain_index=0, prune_batch=4,
        prune_interval_s=3600.0, snapshot_interval=snap_interval, snapshot_keep_recent=2,
    )
    p = pkg.RetentionPlane(cfg, None, None, snapshot_store=snap_store)
    p._app_retain = app_retain
    return p


def test_target_min_wins_app_retain():
    def scenario(pkg):
        got = [
            _plane(pkg, retain=10)._target(100, 10),  # node window alone
            _plane(pkg, retain=10, app_retain=40)._target(100, 10),  # the app wins
            _plane(pkg, retain=10, app_retain=95)._target(100, 10),  # the node wins
            _plane(pkg, retain=0, app_retain=40)._target(100, 0),  # the app alone
            _plane(pkg, retain=0)._target(100, 0),  # nothing prunable
        ]
        assert got == [90, 40, 90, 40, 0]
        return got

    both(scenario)


def test_target_snapshot_floor(tmp_path):
    def scenario(pkg, d):
        ss = pkg.SnapshotStore(str(d), keep_recent=2)
        # snapshotting on, nothing held yet: no pruning yet
        p = _plane(pkg, retain=10, snap_interval=20, snap_store=ss)
        before = p._target(100, 10)
        ss.save(60, b"blob")
        after = p._target(100, 10)  # capped under the held snapshot
        assert (before, after) == (0, 60)
        return before, after

    both(scenario, tmp_path)


def test_target_serve_floor():
    def scenario(pkg):
        p = _plane(pkg, retain=10)
        seen = []
        with p.serving(50):
            seen.append(p._target(100, 10))
            with p.serving(30):
                seen.append(p._target(100, 10))
            seen.append(p._target(100, 10))
        seen.append(p._target(100, 10))
        assert seen == [50, 30, 50, 90]
        return seen

    both(scenario)


# --- full-node pruning and markers -------------------------------------------


def test_reconcile_prunes_all_legs_and_markers(tmp_path):
    def scenario(pkg, d):
        _, _, node = _grow(
            pkg, d, 120, retain_blocks=30, retain_states=40, retain_index=30,
            prune_batch=8, snapshot_interval=10, snapshot_keep_recent=2,
        )
        out = node.retention.reconcile_once()
        bs = node.block_store
        assert bs.base() == 90 and bs.height() == 120
        assert out["blocks"] == 89
        assert bs.load_block(90) is not None and bs.load_block(89) is None
        assert node.tx_indexer.base_height() == 90
        assert node.tx_indexer.last_indexed_height() == 120
        assert out["index"] > 0
        # snapshot rotation: the newest two, under <home>/snapshots
        hs = node.snapshot_store.heights()
        assert hs == [110, 120]
        assert os.path.isdir(os.path.join(str(d), "snapshots"))
        # a second pass is a no-op (idempotent targets)
        out2 = node.retention.reconcile_once()
        assert out2["blocks"] == 0 and out2["index"] == 0
        stats = node.retention.stats()
        node.close_stores()
        return out, out2, hs, {k: stats[k] for k in ("base_height", "index_base_height",
                                                     "pruned_blocks_total", "pruned_index_total")}

    both(scenario, tmp_path)


def test_app_retain_height_caps_node_window(tmp_path):
    """kvstore's retain_height flows through ABCI Commit, the
    executor's hook and the plane: min wins, the app's wider window
    overrides the node's tighter one."""

    def scenario(pkg, d):
        app = pkg.kvstore.KVStoreApplication(retain_height=50)
        _, _, node = _grow(pkg, d, 100, app=app, retain_blocks=4, prune_batch=16)
        assert node.retention._app_retain == 50  # 100 - 50
        node.retention.reconcile_once()
        # the node window alone would put the base at 96
        assert node.block_store.base() == 50
        base = node.block_store.base()
        node.close_stores()
        return base

    both(scenario, tmp_path)


def test_inline_prune_without_the_plane(tmp_path):
    """With no [storage] knob the plane is off and the executor prunes
    inline at the app's retain_height, as the reference does."""

    def scenario(pkg, d):
        app = pkg.kvstore.KVStoreApplication(retain_height=5)
        genesis, privs = _genesis(pkg)
        node = _build(pkg, genesis, _cfg(pkg, d), d, app=app)
        assert not node.retention.enabled
        pkg.chaingen.make_chain(genesis, privs, 20, node=node)
        base = node.block_store.base()
        assert base == 15 and node.block_store.load_block(14) is None
        node.close_stores()
        return base

    both(scenario, tmp_path)


# --- crash mid-prune ---------------------------------------------------------


def test_crash_mid_prune_inprocess_resume(tmp_path):
    """Abort a pass between bounded batches through the batch hook:
    every committed batch carried its own base advance, so the partial
    pass reads consistent and the resume finishes the same targets."""

    class Boom(RuntimeError):
        pass

    def scenario(pkg, d):
        _, _, node = _grow(pkg, d, 60, retain_blocks=10, retain_index=10, prune_batch=5)
        calls = [0]

        def hook():
            calls[0] += 1
            if calls[0] > 2:
                raise Boom()

        node.retention.batch_hook = hook
        with pytest.raises(Boom):
            node.retention.reconcile_once()
        node.retention.batch_hook = None
        bs = node.block_store
        mid = bs.base()
        assert 1 < mid < 50  # partial progress, committed batches only
        assert bs.load_block(mid) is not None and bs.load_block(mid - 1) is None
        node.retention.reconcile_once()
        assert bs.base() == 50 and node.tx_indexer.base_height() == 50
        out = node.retention.reconcile_once()
        assert out["blocks"] == 0 and out["index"] == 0
        node.close_stores()
        return mid

    both(scenario, tmp_path)


_POWERCUT = """
import os, sys
sys.path.insert(0, {repo!r})
pkg = {pkg!r}
if pkg == "jax":
    from cometbft_tpu.config.config import test_config
    from cometbft_tpu.node.inprocess import build_node, make_genesis
    from cometbft_tpu.utils import fail
    from cometbft_tpu.utils.chaingen import make_chain
else:
    from cometbft_tpu_torch.config.config import test_config
    from cometbft_tpu_torch.node.inprocess import build_node, make_genesis
    from cometbft_tpu_torch.utils import fail
    from cometbft_tpu_torch.utils.chaingen import make_chain
home = {home!r}
genesis, keys = make_genesis(1)
with open(home + "/genesis.json", "w") as f:
    f.write(genesis.to_json())
cfg = test_config(home)
cfg.base.db_backend = "sqlite"
cfg.tx_index.indexer = "kv"
cfg.storage.retain_blocks = 10
cfg.storage.retain_index = 10
cfg.storage.prune_batch = 5
cfg.storage.prune_interval_s = 3600.0
if pkg == "jax":
    node = build_node(genesis, None, config=cfg, home=home)
else:
    node = build_node(genesis, config=cfg, home=home, device="cpu")
make_chain(genesis, [getattr(k, "priv_key", k) for k in keys], 60, node=node)
os.environ["FAIL_TEST_INDEX"] = "{fail_index}"
fail.reset()
node.retention.reconcile_once()
raise SystemExit("fail point never hit")
"""


@pytest.mark.parametrize("fail_index", [0, 2])
def test_crash_mid_prune_powercut_then_resume(tmp_path, fail_index):
    """os._exit at the retention-prune-batch fail point (before the
    first / third bounded batch), then a rebuild from the same home
    handshakes cleanly and a resume pass finishes with consistent
    markers."""

    def scenario(pkg, d):
        home = str(d / "home")
        os.makedirs(home)
        proc = subprocess.run(
            [sys.executable, "-c", _POWERCUT.format(repo=REPO, pkg=pkg.name, home=home,
                                                    fail_index=fail_index)],
            cwd=REPO, env=dict(os.environ, JAX_PLATFORMS="cpu"), capture_output=True, text=True,
            timeout=120,
        )
        assert proc.returncode == 99, proc.stderr
        with open(os.path.join(home, "genesis.json")) as f:
            genesis = pkg.GenesisDoc.from_json(f.read())
        cfg = _cfg(pkg, home, retain_blocks=10, retain_index=10, prune_batch=5)
        node = _build(pkg, genesis, cfg, home)
        bs = node.block_store
        # whatever batches committed are consistent: base readable,
        # below-base gone, markers never past the true first row
        mid = bs.base()
        assert bs.height() == 60
        assert bs.load_block(max(1, mid)) is not None
        if mid > 1:
            assert bs.load_block(mid - 1) is None
        ibase = node.tx_indexer.base_height()
        assert ibase <= 50
        node.retention.reconcile_once()
        assert bs.base() == 50 and node.tx_indexer.base_height() == 50
        node.close_stores()
        return mid, ibase

    both(scenario, tmp_path)


# --- anchored index replay over a pruned store -------------------------------


def test_indexer_replay_anchors_at_pruned_base(tmp_path):
    """A lost idx:last marker forces a full replay, which anchors at
    the store base, not at height 1."""

    def scenario(pkg, d):
        _, _, node = _grow(pkg, d, 60, retain_blocks=20, retain_index=20, prune_batch=16)
        node.retention.reconcile_once()
        assert node.block_store.base() == 40
        node.tx_indexer.db.delete(pkg.indexer.LAST_INDEXED_KEY)
        assert node.tx_indexer.last_indexed_height() == 0
        n = node.indexer_service.replay(node.block_store, node.state_store)
        assert n == 21  # heights 40..60, not 1..60
        assert node.tx_indexer.last_indexed_height() == 60
        node.close_stores()
        return n

    both(scenario, tmp_path)


# --- snapshot store ----------------------------------------------------------


def _tree(root):
    """Every file under ``root`` by relative path, with its bytes."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for name in files:
            p = os.path.join(dirpath, name)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_snapshot_store_rotation_and_restart(tmp_path):
    def scenario(pkg, d):
        root = str(d / "snaps")
        ss = pkg.SnapshotStore(root, keep_recent=2)
        for h, blob in ((10, b"a" * 3000), (20, b"b" * 3000), (30, b"c" * 100)):
            ss.save(h, blob, metadata=b"m%d" % h)
        assert ss.heights() == [20, 30]  # keep_recent rotation
        assert ss.latest_height() == 30
        snaps = ss.list_snapshots()
        assert [s.height for s in snaps] == [20, 30]
        assert snaps[0].chunks == 3  # 3000 / 1024
        blob = ss.load_blob(20)
        assert blob == b"b" * 3000 and hashlib.sha256(blob).digest() == snaps[0].hash
        assert ss.load_chunk(20, format_=9, index=0) == b""  # format miss
        # a fresh store over the same root serves the same snapshots
        ss2 = pkg.SnapshotStore(root, keep_recent=2)
        assert ss2.heights() == [20, 30] and ss2.load_blob(30) == b"c" * 100
        return [(s.height, s.format, s.chunks, s.hash, s.metadata) for s in snaps], _tree(root), ss.stats()

    both(scenario, tmp_path)


def test_snapshot_store_sweeps_incomplete_on_open(tmp_path):
    def scenario(pkg, d):
        root = str(d / "snaps")
        ss = pkg.SnapshotStore(root, keep_recent=2)
        ss.save(10, b"complete")
        # a crash mid-save leaves chunks without meta.json
        torn = os.path.join(root, f"{20:015d}")
        os.makedirs(torn)
        with open(os.path.join(torn, "chunk.0000"), "wb") as f:
            f.write(b"torn")
        ss2 = pkg.SnapshotStore(root, keep_recent=2)
        assert ss2.heights() == [10] and not os.path.exists(torn)
        return ss2.heights()

    both(scenario, tmp_path)


# --- RPC below-base hardening ------------------------------------------------


def test_rpc_pruned_height_routes(tmp_path):
    def scenario(pkg, d):
        core = pkg.core
        # retain_index wider than retain_blocks: index rows outlive
        # block bodies, so a block_search hit can land on a pruned body
        genesis, _, node = _grow(
            pkg, d, 40, retain_blocks=10, retain_states=10, retain_index=20, prune_batch=16
        )
        node.retention.reconcile_once()
        env = pkg.Environment(
            chain_id=genesis.chain_id, block_store=node.block_store, state_store=node.state_store,
            tx_indexer=node.tx_indexer, block_indexer=node.block_indexer, genesis=genesis,
            proxy=node.proxy, config=node.config, retention=node.retention,
        )
        base = node.block_store.base()
        ibase = node.tx_indexer.base_height()
        assert base == 30 and ibase == 20
        errors = []
        for route in (core.block, core.block_results, core.commit):
            with pytest.raises(core.RPCError) as ei:
                route(env, height=base - 1)
            assert "pruned" in str(ei.value)
            assert json.loads(ei.value.data) == {"pruned": True, "base": str(base)}
            errors.append((ei.value.code, str(ei.value), ei.value.data))
        assert core.block(env, height=base)["block"] is not None
        with pytest.raises(core.RPCError) as ei:
            asyncio.run(core.block_search(env, query=f"block.height={base - 1}"))
        assert "pruned" in str(ei.value)
        errors.append((ei.value.code, str(ei.value), ei.value.data))
        with pytest.raises(core.RPCError) as ei:
            asyncio.run(core.tx(env, hash="00" * 32))
        assert "pruned below" in str(ei.value)
        assert json.loads(ei.value.data)["index_base"] == str(ibase)
        errors.append((ei.value.code, str(ei.value), ei.value.data))
        st = core.status(env)
        assert st["sync_info"]["earliest_block_height"] == str(base)
        # health carries the lifecycle stats and its verdict
        h = core.health(env)
        storage = h["storage"]
        assert storage["enabled"] and storage["base_height"] == base
        node.close_stores()
        keys = ("base_height", "index_base_height", "app_retain_height", "pruned_blocks_total",
                "pruned_index_total", "pruned_wal_files", "pruned_evidence_total", "reconciles")
        return errors, {k: storage[k] for k in keys}, h.get("status"), sorted(storage)

    both(scenario, tmp_path)


def test_light_proxy_forwards_pruned_error():
    """The client error carries the structured below-base verdict's
    code, message and data as the server raised them."""

    def scenario(pkg):
        err = pkg.core.RPCError(-32603, "height 3 is pruned (base=9)", data='{"pruned": true, "base": "9"}')
        ce = pkg.client.RPCClientError(err.code, str(err), data=err.data)
        assert ce.code == -32603 and "pruned" in ce.message
        assert json.loads(ce.data)["base"] == "9"
        return ce.code, ce.message, ce.data, str(ce)

    both(scenario)


# --- restart survival (handshake over a pruned store) ------------------------


def test_pruned_node_restart_replays_retained_tail_only(tmp_path):
    """A pruned node's restart replays only its retained tail:
    build_node persists the default app's state, so the handshake
    replays app_height+1..store_height, all retained."""

    def scenario(pkg, d):
        genesis, privs, node = _grow(pkg, d, 50, retain_blocks=10, prune_batch=16)
        node.retention.reconcile_once()
        assert node.block_store.base() == 40
        assert os.path.exists(os.path.join(str(d), "app_state.json"))
        node.close_stores()
        node2 = _build(pkg, genesis, _cfg(pkg, d, retain_blocks=10, prune_batch=16), d)
        assert (node2.block_store.base(), node2.block_store.height()) == (40, 50)
        pkg.chaingen.make_chain(genesis, privs, 5, node=node2)
        assert node2.block_store.height() == 55
        node2.close_stores()
        with open(os.path.join(str(d), "app_state.json")) as f:
            app = json.load(f)
        return app["height"], len(app["state"])

    both(scenario, tmp_path)
