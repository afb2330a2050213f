"""RPC route implementations (reference rpc/core/*.go, routes table at
rpc/core/routes.go:15-62).

Every handler takes (env, **params) and returns a JSON-able dict.
Heights arrive as strings or ints (JSON-RPC clients send both).

A copy of the JAX package's ``rpc/core.py``: every route of ``ROUTES``
and ``UNSAFE_ROUTES``, answering with the JAX node's JSON. The planes
the port lacks (the loop watchdog, the serving fleet; ROADMAP A10) are
absent from ``Environment``, and ``health``, ``status`` and
``fleet_status`` answer as the JAX routes do when those fields are
None; ``health`` gives the retention plane's storage verdict. ``broadcast_evidence`` awaits ``Node.add_evidence``
(the JAX route calls the pool directly): the commit checks' tickets
resolve on the loop, and a failed verify route raises
``DeviceRouteError`` to the caller, a JSON-RPC ``-32603`` error, while
the evidence stays on the evidence reactor's retry list (ROADMAP C3).
"""

from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import time
import traceback
from typing import Any, Dict, List, Optional

from ..abci import types as abci
from ..crypto import merkle
from ..evidence.types import decode_evidence
from ..state.execution import decode_finalize_response
from ..types.block import BlockID, tx_hash
from ..utils import codec
from ..utils.pubsub_query import parse as parse_query
from . import encoding as enc


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: str = ""):
        super().__init__(message)
        self.code = code
        self.data = data


def _h(v, default=None) -> Optional[int]:
    if v is None or v == "":
        return default
    return int(v)


def _bool(v) -> bool:
    """GET params arrive as strings; 'false'/'0'/'' are False."""
    if isinstance(v, str):
        return v.strip().lower() not in ("", "0", "false", "no")
    return bool(v)


def _page(v) -> int:
    p = _h(v, 1) or 1
    if p < 1:
        raise RPCError(-32602, f"page must be >= 1, got {p}")
    return p


def _bytes_param(v) -> bytes:
    """Accept hex (0x... or bare) or base64."""
    if v is None:
        return b""
    if isinstance(v, bytes):
        return v
    s = str(v)
    if s.startswith("0x"):
        return bytes.fromhex(s[2:])
    try:
        return bytes.fromhex(s)
    except ValueError:
        return base64.b64decode(s)


def _latest_height(env) -> int:
    return env.block_store.height()


def _pruned_error(h: int, base: int) -> "RPCError":
    """The structured below-base error every height-taking route
    raises once retention pruning (store/retention.py) has moved the
    store base past the request — a clean, machine-readable verdict
    instead of the not-found/None-load a pruned height used to hit."""
    return RPCError(
        -32603,
        f"height {h} is pruned (base={base})",
        data=f'{{"pruned": true, "base": "{base}"}}',
    )


def _check_pruned(env, h: int) -> None:
    base = env.block_store.base()
    if h < base:
        raise _pruned_error(h, base)


def _norm_height(env, height) -> int:
    h = _h(height)
    if h is None:
        return _latest_height(env)
    if h <= 0:
        raise RPCError(-32603, f"height must be positive, got {h}")
    if h > _latest_height(env):
        raise RPCError(
            -32603,
            f"height {h} is ahead of the latest height {_latest_height(env)}",
        )
    _check_pruned(env, h)
    return h


# --- info routes --------------------------------------------------------


# loop-lag p95 above this marks the node degraded: a loop that takes
# a quarter second to schedule a ready callback is serving tails, not
# traffic (half the default stall threshold, config loop_stall_ms)
_HEALTH_LAG_P95_MS = 250.0
# a flight-recorded stall within this window marks the node degraded
_HEALTH_STALL_RECENT_S = 60.0


def health(env) -> Dict[str, Any]:
    """Runtime health verdict: commit freshness, queue backpressure
    and connectivity, with a degraded/ok verdict + reasons. The
    reference returns {} here; every field is additive so `health ==
    ok` probes keep working. The JAX route's loop-watchdog and
    serving-fleet parts read planes the port lacks (ROADMAP A10): it
    answers as the JAX route does when those are None."""
    reasons: List[str] = []
    out: Dict[str, Any] = {}
    latest = env.block_store.height()
    out["latest_block_height"] = str(latest)
    meta = env.block_store.load_block_meta(latest) if latest else None
    if meta is not None:
        age_s = max(0.0, (time.time_ns() - meta.header.time_ns) / 1e9)
        out["last_commit_age_s"] = round(age_s, 3)
    if env.queues is not None:
        # ONE registry pass per request (every stats_fn walks live
        # structures)
        snap = env.queues.snapshot()
        out["queue_high_watermarks"] = {
            name: int(s.get("high_watermark", 0))
            for name, s in snap.items()
        }
        out["queue_dropped_total"] = sum(
            int(s.get("dropped", 0)) for s in snap.values()
        )
        for name, s in snap.items():
            # only single bounded queues report "maxsize"; aggregate
            # entries and soft targets use other field names exactly
            # so this check cannot misread a summed depth
            maxsize = int(s.get("maxsize", 0) or 0)
            if maxsize and int(s.get("depth", 0)) >= maxsize:
                reasons.append(f"queue {name} is full ({maxsize})")
    sw = env.switch
    if sw is not None and hasattr(sw, "num_peers"):
        # connectivity verdict (self-healing plane, p2p/reconnect.py):
        # degraded below min_peers — but only once the node has
        # evidence it is MEANT to be connected (persistent peers
        # configured, addresses learned, or a peer ever lost); a
        # single-node net with nothing to dial stays ok
        n = sw.num_peers()
        min_peers = getattr(sw, "min_peers", 1)
        conn: Dict[str, Any] = {"n_peers": n, "min_peers": min_peers}
        plane = getattr(sw, "reconnect", None)
        if plane is not None:
            st = plane.stats()
            conn.update(st)
            expects_peers = plane.expects_peers()
        else:
            expects_peers = bool(getattr(sw, "persistent_addrs", None))
        conn_reasons: List[str] = []
        if expects_peers and n < min_peers:
            detail = ""
            if plane is not None:
                detail = (
                    f" (reconnect: {st['fast_lane']} fast-lane, "
                    f"{st['slow_lane']} slow-lane, "
                    f"{st['attempts_total']} attempts)"
                )
            conn_reasons.append(
                f"connectivity: {n}/{min_peers} peers connected"
                + detail
            )
        if plane is not None and plane.starving():
            conn_reasons.append(
                "connectivity: starving — zero peers for "
                f"{st['starving_for_s']}s"
            )
        conn["status"] = "degraded" if conn_reasons else "ok"
        out["connectivity"] = conn
        reasons.extend(conn_reasons)
    hc_fn = getattr(env, "light_header_cache_fn", None)
    hc = hc_fn() if hc_fn is not None else None
    if hc is not None and len(hc):
        # shared verified-header cache (light/serving.py): present
        # once a co-resident serving plane shares one — hit/miss/flight
        # counters for "is the serving side sharing verification work"
        out["light_header_cache"] = hc.stats()
    ret = getattr(env, "retention", None)
    if ret is not None and getattr(ret, "enabled", False):
        # storage lifecycle verdict (store/retention.py): the plane's
        # base/pruned/snapshot counters, degraded when the reconciler
        # has stopped keeping the window (pruning far behind target)
        st = ret.stats()
        out["storage"] = st
        cfg = getattr(ret, "cfg", None)
        if cfg is not None and cfg.retain_blocks > 0:
            lag = latest - st["base_height"]
            # 3 windows behind = the reconciler is not keeping up
            # (wedged worker, dead loop) — disk is growing unbounded
            if st["reconciles"] > 0 and lag > 3 * max(cfg.retain_blocks, cfg.prune_batch):
                reasons.append(
                    f"storage: prune base {st['base_height']} lags "
                    f"head {latest} by {lag} "
                    f"(> 3x retain_blocks={cfg.retain_blocks})"
                )
    out["serving_role"] = _serving_role(env)
    # a port node is never a follower replica of a serving fleet
    out["replica_lag_heights"] = 0
    bd = getattr(env.consensus_state, "last_commit_breakdown", None)
    if bd is not None:
        # per-phase attribution of the last committed height:
        # proposal wait, quorum waits, verify, persist/wal/apply, plus
        # the dominant disjoint segment
        out["last_height_commit_breakdown"] = bd
    out["status"] = "degraded" if reasons else "ok"
    if reasons:
        if bd is not None:
            # a degraded verdict cites WHERE the last commit spent
            # its time, so the operator starts at the right phase
            reasons.append(
                f"last commit h={bd['height']} dominated by "
                f"{bd['dominant']} "
                f"({bd['phases'].get(bd['dominant'], '?')}ms)"
            )
        out["reasons"] = reasons
    return out


def _serving_role(env) -> str:
    """validator|follower (docs/FLEET.md): a node without a signing
    key serves reads only — the fleet deployment shape."""
    return "validator" if env.privval_pubkey is not None else "follower"


def fleet_status(env) -> Dict[str, Any]:
    """Per-replica serving-fleet view: only meaningful on a node
    fronting a serving fleet, which the port has not (ROADMAP A10);
    it answers the JAX route's well-formed JSON-RPC error."""
    raise RPCError(-32603, "this node does not front a serving fleet")


# frames kept per task stack in dump_tasks
_STACK_DEPTH = 25


def _all_task_stacks() -> List[dict]:
    """Every asyncio task's name + formatted stack (a copy of the JAX
    package's ``obs/watchdog.all_task_stacks``)."""
    out: List[dict] = []
    try:
        tasks = asyncio.all_tasks()
    except RuntimeError:
        return out
    for task in tasks:
        try:
            lines: List[str] = []
            for fr in task.get_stack(limit=_STACK_DEPTH):
                lines.extend(traceback.format_stack(fr, limit=1)[0].rstrip().splitlines())
            out.append({"name": task.get_name(), "stack": lines})
        except Exception:
            continue
    return out


def dump_tasks(env) -> Dict[str, Any]:
    """Debug route: every asyncio task's stack (the goroutine-dump
    analog, scoped to the loop serving this RPC)."""
    tasks = _all_task_stacks()
    return {"n_tasks": str(len(tasks)), "tasks": tasks}


def status(env) -> Dict[str, Any]:
    bs = env.block_store
    latest = bs.height()
    meta = bs.load_block_meta(latest) if latest else None
    state = env.state_store.load()
    pub = env.privval_pubkey
    return {
        "node_info": {
            "id": env.node_info.node_id if env.node_info else "",
            "network": env.chain_id,
            "moniker": env.node_info.moniker if env.node_info else "",
            "version": env.node_info.version if env.node_info else "",
            "listen_addr": env.node_info.listen_addr if env.node_info else "",
        },
        "sync_info": {
            "latest_block_height": str(latest),
            "latest_block_hash": enc.hexb(meta.block_id.hash) if meta else "",
            "latest_app_hash": enc.hexb(state.app_hash) if state else "",
            "latest_block_time_ns": str(meta.header.time_ns) if meta else "0",
            "earliest_block_height": str(bs.base()),
            "catching_up": bool(
                env.consensus_state is None
                or getattr(env.consensus_state, "queue", None) is None
            ),
        },
        "validator_info": {
            "address": enc.hexb(pub.address()) if pub else "",
            "pub_key": {
                "type": pub.type_,
                "value": enc.b64(bytes(pub)),
            }
            if pub
            else None,
            "voting_power": str(
                _own_power(state, pub) if state and pub else 0
            ),
        },
        "serving_role": _serving_role(env),
        "replica_lag_heights": "0",
    }


def _own_power(state, pub) -> int:
    try:
        _, val = state.validators.get_by_address(pub.address())
        return val.voting_power if val else 0
    except Exception:
        return 0


def net_info(env) -> Dict[str, Any]:
    sw = env.switch
    peers = list(sw.peers.values()) if sw else []
    return {
        "listening": bool(sw),
        "listeners": [sw.transport.listen_addr] if sw else [],
        "n_peers": str(len(peers)),
        "peers": [
            {
                "node_info": {
                    "id": p.peer_id,
                    "moniker": p.node_info.moniker,
                    "network": p.node_info.network,
                    "listen_addr": p.node_info.listen_addr,
                },
                "is_outbound": p.outbound,
                "remote_ip": p.conn_str,
            }
            for p in peers
        ],
    }


def genesis(env) -> Dict[str, Any]:
    return {"genesis": json.loads(env.genesis.to_json())}


def genesis_chunked(env, chunk=0) -> Dict[str, Any]:
    data = env.genesis.to_json().encode()
    size = 16 * 1024
    chunks = [data[i : i + size] for i in range(0, len(data), size)] or [b""]
    c = _h(chunk, 0)
    if not 0 <= c < len(chunks):
        raise RPCError(-32603, f"chunk {c} out of range [0,{len(chunks)})")
    return {
        "chunk": str(c),
        "total": str(len(chunks)),
        "data": enc.b64(chunks[c]),
    }


# --- block routes -------------------------------------------------------


def blockchain(env, minHeight=None, maxHeight=None) -> Dict[str, Any]:
    latest = _latest_height(env)
    max_h = min(_h(maxHeight, latest) or latest, latest)
    min_h = max(_h(minHeight, 1) or 1, env.block_store.base())
    max_h = max(min_h, max_h)
    metas = []
    for h in range(max_h, min_h - 1, -1):
        if len(metas) >= 20:
            break
        meta = env.block_store.load_block_meta(h)
        if meta is None:
            continue
        metas.append(
            {
                "block_id": enc.block_id_json(meta.block_id),
                "block_size": str(meta.block_size),
                "header": enc.header_json(meta.header),
                "num_txs": str(meta.num_txs),
            }
        )
    return {"last_height": str(latest), "block_metas": metas}


def block(env, height=None) -> Dict[str, Any]:
    h = _norm_height(env, height)
    blk = env.block_store.load_block(h)
    meta = env.block_store.load_block_meta(h)
    if blk is None or meta is None:
        raise RPCError(-32603, f"block at height {h} not found")
    commit = env.block_store.load_seen_commit(
        h
    ) or env.block_store.load_block_commit(h)
    return {
        "block_id": enc.block_id_json(meta.block_id),
        "block": enc.block_json(blk),
        "block_b64": enc.b64(codec.encode_block(blk)),
        "commit_b64": enc.b64(codec.encode_commit(commit)) if commit else "",
    }


def block_by_hash(env, hash=None) -> Dict[str, Any]:
    blk = env.block_store.load_block_by_hash(_bytes_param(hash))
    if blk is None:
        raise RPCError(-32603, "block not found")
    return block(env, blk.height)


def header(env, height=None) -> Dict[str, Any]:
    h = _norm_height(env, height)
    blk = env.block_store.load_block(h)
    if blk is None:
        raise RPCError(-32603, f"header at height {h} not found")
    return {
        "header": enc.header_json(blk.header),
        "header_b64": enc.b64(codec.encode_header(blk.header)),
    }


def header_by_hash(env, hash=None) -> Dict[str, Any]:
    blk = env.block_store.load_block_by_hash(_bytes_param(hash))
    if blk is None:
        raise RPCError(-32603, "header not found")
    return header(env, blk.height)


def commit(env, height=None) -> Dict[str, Any]:
    h = _norm_height(env, height)
    blk = env.block_store.load_block(h)
    # canonical = the immutable commit from block h+1's LastCommit;
    # at the store tip only the mutable seen commit exists
    # (reference rpc/core/blocks.go Commit)
    cm = env.block_store.load_block_commit(h)
    canonical = cm is not None
    if cm is None:
        cm = env.block_store.load_seen_commit(h)
    if blk is None or cm is None:
        raise RPCError(-32603, f"commit for height {h} not found")
    return {
        "signed_header": {
            "header": enc.header_json(blk.header),
            "commit": enc.commit_json(cm),
        },
        "header_b64": enc.b64(codec.encode_header(blk.header)),
        "commit_b64": enc.b64(codec.encode_commit(cm)),
        "canonical": canonical,
    }


def block_results(env, height=None) -> Dict[str, Any]:
    h = _norm_height(env, height)
    raw = env.state_store.load_finalize_block_response(h)
    if raw is None:
        raise RPCError(-32603, f"no results for height {h}")
    resp = decode_finalize_response(raw)
    return {
        "height": str(h),
        "txs_results": [enc.tx_result_json(r) for r in resp.tx_results],
        # block-level events persist with the response: the stored
        # record is the indexer's crash-replay source, so it carries
        # everything live indexing saw
        "finalize_block_events": [
            enc.abci_event_json(e) for e in resp.events
        ],
        "app_hash": enc.hexb(resp.app_hash),
        "validator_updates": [
            {"power": str(u.power), "pub_key_type": u.pub_key_type,
             "pub_key": enc.b64(u.pub_key_bytes)}
            for u in resp.validator_updates
        ],
    }


def validators(env, height=None, page=1, per_page=30) -> Dict[str, Any]:
    h = _norm_height(env, height)
    vs = env.state_store.load_validators(h)
    if vs is None:
        raise RPCError(-32603, f"no validator set at height {h}")
    page, per_page = _page(page), min(_h(per_page, 30) or 30, 100)
    vals = vs.validators
    start = (page - 1) * per_page
    return {
        "block_height": str(h),
        "validators": [
            enc.validator_json(v) for v in vals[start : start + per_page]
        ],
        "count": str(min(per_page, max(0, len(vals) - start))),
        "total": str(len(vals)),
        "validator_set_b64": enc.b64(codec.encode_validator_set(vs)),
    }


# --- consensus routes ---------------------------------------------------


def consensus_state(env) -> Dict[str, Any]:
    cs = env.consensus_state
    if cs is None:
        raise RPCError(-32603, "consensus state not available")
    rs = cs.rs
    return {
        "round_state": {
            "height": str(rs.height),
            "round": rs.round,
            "step": int(rs.step),
            "proposal": rs.proposal is not None,
            "proposal_block": rs.proposal_block is not None,
            "locked_round": rs.locked_round,
            "valid_round": rs.valid_round,
        }
    }


def dump_consensus_state(env) -> Dict[str, Any]:
    out = consensus_state(env)
    sw = env.switch
    out["peers"] = [
        {
            "node_address": p.conn_str,
            "peer_state": {
                "round_state": vars(p.get("prs"))
                if p.get("prs") is not None and hasattr(p.get("prs"), "height")
                else {},
            },
        }
        for p in (sw.peers.values() if sw else [])
    ]
    # sets are not JSON-able; flatten
    for p in out["peers"]:
        prs = p["peer_state"]["round_state"]
        if prs:
            p["peer_state"]["round_state"] = {
                "height": prs.get("height"),
                "round": prs.get("round"),
                "step": prs.get("step"),
            }
    return out


def consensus_params(env, height=None) -> Dict[str, Any]:
    h = _norm_height(env, height)
    # per-HEIGHT params (reference env.ConsensusParams loads the
    # params as of the requested height, not the tip): the light
    # proxy verifies their hash against header(h).consensus_hash
    cp = env.state_store.load_consensus_params(h)
    if cp is None:
        cp = env.state_store.load().consensus_params
    return {
        "params_b64": enc.b64(cp.encode()),
        "block_height": str(h),
        "consensus_params": {
            "block": {
                "max_bytes": str(cp.block.max_bytes),
                "max_gas": str(cp.block.max_gas),
            },
            "validator": {
                "pub_key_types": list(cp.validator.pub_key_types)
            },
            "evidence": {
                "max_age_num_blocks": str(cp.evidence.max_age_num_blocks),
                "max_age_duration_ns": str(cp.evidence.max_age_duration_ns),
                "max_bytes": str(cp.evidence.max_bytes),
            },
            "abci": {
                "vote_extensions_enable_height": str(
                    cp.abci.vote_extensions_enable_height
                ),
            },
        },
    }


# --- mempool routes -----------------------------------------------------


def unconfirmed_txs(env, limit=30) -> Dict[str, Any]:
    lim = min(_h(limit, 30) or 30, 100)
    txs = env.mempool.iter_txs()[:lim]
    return {
        "n_txs": str(len(txs)),
        "total": str(env.mempool.size()),
        "total_bytes": str(sum(len(t) for t in txs)),
        "txs": [enc.b64(t) for t in txs],
    }


def num_unconfirmed_txs(env) -> Dict[str, Any]:
    return {
        "n_txs": str(env.mempool.size()),
        "total": str(env.mempool.size()),
        "total_bytes": "0",
    }


def check_tx(env, tx=None) -> Dict[str, Any]:
    res = env.proxy.mempool.check_tx(
        abci.RequestCheckTx(tx=_bytes_param(tx))
    )
    return {"code": res.code, "log": res.log, "gas_wanted": str(res.gas_wanted)}


def broadcast_tx_async(env, tx=None) -> Dict[str, Any]:
    raw = _bytes_param(tx)
    env.submit_tx_nowait(raw)
    return {"code": 0, "data": "", "log": "", "hash": enc.hexb(_tx_hash(raw))}


async def broadcast_tx_sync(env, tx=None) -> Dict[str, Any]:
    raw = _bytes_param(tx)
    res = await env.submit_tx_async(raw)
    return {
        "code": res.code,
        "data": "",
        "log": res.log,
        "hash": enc.hexb(_tx_hash(raw)),
    }


async def broadcast_tx_commit(env, tx=None, timeout_s: float = 10.0):
    """CheckTx, then await inclusion through the height-keyed
    CommitWaiterMap (rpc/fanout.py): ONE lossless sync bus listener
    total and a dict lookup per committed tx, instead of the per-RPC
    predicate subscription the reference shape
    (rpc/core/mempool.go:70) pays on every publish."""
    raw = _bytes_param(tx)
    key = _tx_hash(raw)
    waiters = env.commit_waiters()
    # register BEFORE submitting (the subscribe-before-CheckTx
    # ordering): a commit can never race past the waiter
    fut = waiters.register(key.hex())
    try:
        res = await env.submit_tx_async(raw)
        if res.code != 0:
            return {
                "check_tx": {"code": res.code, "log": res.log},
                "tx_result": {},
                "hash": enc.hexb(key),
                "height": "0",
            }
        event = await asyncio.wait_for(fut, timeout_s)
        return {
            "check_tx": {"code": 0, "log": ""},
            "tx_result": enc.tx_result_json(event.data["result"]),
            "hash": enc.hexb(key),
            "height": str(event.data["height"]),
        }
    except asyncio.TimeoutError:
        raise RPCError(-32603, "timed out waiting for tx to be included")
    finally:
        # timeout, cancellation (gRPC grace expiry) and success all
        # release the map entry here — no leak, no stale resolution
        waiters.unregister(key.hex(), fut)


def _tx_hash(tx: bytes) -> bytes:
    return hashlib.sha256(tx).digest()


async def broadcast_evidence(env, evidence=None) -> Dict[str, Any]:
    """Hand evidence to the node's pool through ``Node.add_evidence``:
    a refusal raises the pool's error, a failed verify route raises
    ``DeviceRouteError`` (no verdict; the evidence reactor retries
    it)."""
    ev = decode_evidence(_bytes_param(evidence))
    await env.add_evidence(ev)
    return {"hash": enc.hexb(ev.hash())}


# --- abci passthrough ---------------------------------------------------


def abci_info(env) -> Dict[str, Any]:
    res = env.proxy.query.info(abci.RequestInfo())
    return {
        "response": {
            "data": res.data,
            "version": res.version,
            "app_version": str(res.app_version),
            "last_block_height": str(res.last_block_height),
            "last_block_app_hash": enc.b64(res.last_block_app_hash),
        }
    }


def abci_query(env, path="", data=None, height=0, prove=False) -> Dict[str, Any]:
    res = env.proxy.query.query(
        abci.RequestQuery(
            data=_bytes_param(data),
            path=str(path or ""),
            height=_h(height, 0) or 0,
            prove=_bool(prove),
        )
    )
    return {
        "response": {
            "code": res.code,
            "log": res.log,
            "key": enc.b64(res.key) if res.key else "",
            "value": enc.b64(res.value) if res.value else "",
            "height": str(res.height),
            # encoded crypto/merkle proof-op chain (apps that support
            # prove=true); light proxies verify it against the
            # light-verified AppHash of height+1
            "proof_ops": enc.b64(res.proof_ops)
            if getattr(res, "proof_ops", b"")
            else "",
        }
    }


# --- tx / block search (indexer-backed) ---------------------------------


async def _index_barrier(env) -> None:
    """Read-your-writes for index queries: indexing flushes per
    height from a bounded async drain (state/indexer.py), so a query
    racing the commit that published its tx waits (bounded) for the
    sealed heights to land before scanning."""
    svc = getattr(env, "indexer_service", None)
    if svc is not None:
        await svc.barrier()


async def tx(env, hash=None, prove=False) -> Dict[str, Any]:
    if env.tx_indexer is None:
        raise RPCError(-32603, "tx indexing is disabled")
    await _index_barrier(env)
    key = _bytes_param(hash)
    res = env.tx_indexer.get(key)
    if res is None:
        ibase = (
            env.tx_indexer.base_height()
            if hasattr(env.tx_indexer, "base_height")
            else 0
        )
        if ibase:
            # the row may have been retention-pruned (idx:base):
            # say so instead of a bare not-found
            raise RPCError(
                -32603,
                f"tx {key.hex()} not found "
                f"(tx index pruned below height {ibase})",
                data=f'{{"index_base": "{ibase}"}}',
            )
        raise RPCError(-32603, f"tx {key.hex()} not found")
    height, index, tx_bytes, tx_result = res
    out = {
        "hash": enc.hexb(key),
        "height": str(height),
        "index": index,
        "tx_result": enc.tx_result_json(tx_result),
        "tx": enc.b64(tx_bytes),
    }
    if _bool(prove):
        # merkle inclusion proof against the block's data_hash
        # (reference rpc/core/tx.go Prove; the light proxy verifies
        # it against the light-verified header)
        out["proof"] = _tx_proof(env, height, index, tx_bytes, {})
    return out


def _height_tx_proofs(env, height: int, cache: dict):
    """(data_hash, [Proof per tx]) for one block, memoized in ``cache``
    so a proved tx_search page over one block builds the merkle tree
    ONCE, not per hit. Raises when the block is pruned/missing — a
    requested proof that cannot be produced is an error, never a
    silently proof-less response (reference rpc/core/tx.go proveTx)."""
    got = cache.get(height)
    if got is None:
        blk = env.block_store.load_block(height)
        if blk is None:
            _check_pruned(env, height)
            raise RPCError(
                -32603,
                f"cannot prove tx: block {height} not in store",
            )
        _, proofs = merkle.proofs_from_byte_slices(
            [tx_hash(t) for t in blk.data.txs]
        )
        got = (blk.header.data_hash, proofs)
        cache[height] = got
    return got


def _tx_proof(env, height: int, index: int, tx_bytes: bytes, cache: dict):
    data_hash, proofs = _height_tx_proofs(env, height, cache)
    if index >= len(proofs):
        raise RPCError(
            -32603, f"cannot prove tx: index {index} out of range"
        )
    return {
        "root_hash": enc.hexb(data_hash),
        "data": enc.b64(tx_bytes),
        "proof_b64": enc.b64(merkle.encode_proof(proofs[index])),
    }


async def tx_search(
    env, query="", prove=False, page=1, per_page=30, order_by="asc"
) -> Dict[str, Any]:
    if env.tx_indexer is None:
        raise RPCError(-32603, "tx indexing is disabled")
    await _index_barrier(env)
    q = parse_query(str(query))
    hits = env.tx_indexer.search(q)
    if str(order_by) == "desc":
        hits = list(reversed(hits))
    page, per_page = _page(page), min(_h(per_page, 30) or 30, 100)
    start = (page - 1) * per_page
    with_proof = _bool(prove)
    proof_cache: dict = {}  # height -> (data_hash, proofs): one tree
    out = []                # build per block, however many hits share it
    for height, index, tx_bytes, tx_result, key in hits[start : start + per_page]:
        item = {
            "hash": enc.hexb(key),
            "height": str(height),
            "index": index,
            "tx_result": enc.tx_result_json(tx_result),
            "tx": enc.b64(tx_bytes),
        }
        if with_proof:
            item["proof"] = _tx_proof(
                env, height, index, tx_bytes, proof_cache
            )
        out.append(item)
    return {"txs": out, "total_count": str(len(hits))}


async def block_search(env, query="", page=1, per_page=30, order_by="asc"):
    if env.block_indexer is None:
        raise RPCError(-32603, "block indexing is disabled")
    await _index_barrier(env)
    q = parse_query(str(query))
    heights = env.block_indexer.search(q)
    if str(order_by) == "desc":
        heights = list(reversed(heights))
    page, per_page = _page(page), min(_h(per_page, 30) or 30, 100)
    start = (page - 1) * per_page
    blocks = []
    for h in heights[start : start + per_page]:
        # an index hit whose block has been retention-pruned must say
        # so, not silently shrink the page (retain_index can be wider
        # than retain_blocks — the row legitimately outlives the body)
        _check_pruned(env, h)
        blk = env.block_store.load_block(h)
        if blk:
            blocks.append(
                {
                    "block_id": enc.block_id_json(BlockID(blk.hash(), None)),
                    "block": enc.block_json(blk),
                }
            )
    return {"blocks": blocks, "total_count": str(len(heights))}


# --- route table --------------------------------------------------------

# --- unsafe routes (reference rpc/core/routes.go AddUnsafeRoutes:
# dial_seeds, dial_peers, unsafe_flush_mempool; registered only when
# config.rpc.unsafe) ------------------------------------------------------


def _addr_list(v) -> list:
    """Accept a JSON array (POST) or the URI forms '["a","b"]' /
    'a,b' (GET params arrive as plain strings)."""
    if v is None:
        return []
    if isinstance(v, str):
        s = v.strip()
        if s.startswith("["):
            return [str(x) for x in json.loads(s)]
        return [a.strip() for a in s.split(",") if a.strip()]
    return [str(x) for x in v]


def dial_seeds(env, seeds=None) -> Dict[str, Any]:
    if not env.switch:
        raise RPCError(-32603, "p2p switch not available")
    addrs = _addr_list(seeds)
    env.switch.dial_peers_async(addrs, persistent=False)
    return {"log": f"dialing seeds: {addrs}"}


def dial_peers(env, peers=None, persistent=None) -> Dict[str, Any]:
    if not env.switch:
        raise RPCError(-32603, "p2p switch not available")
    addrs = _addr_list(peers)
    env.switch.dial_peers_async(
        addrs, persistent=str(persistent).lower() in ("true", "1")
    )
    return {"log": f"dialing peers: {addrs}"}


def unsafe_flush_mempool(env) -> Dict[str, Any]:
    env.mempool.flush()
    return {}


def unsafe_disconnect_peers(env) -> Dict[str, Any]:
    """Drop every peer connection (e2e 'disconnect' perturbation; the
    reference does this at the docker network layer)."""
    sw = env.switch
    if not sw:
        raise RPCError(-32603, "p2p switch not available")
    peers = list(sw.peers.values())
    for p in peers:
        asyncio.ensure_future(sw._remove_peer(p, None))
    return {"log": f"disconnected {len(peers)} peers"}


UNSAFE_ROUTES = {
    "dial_seeds": dial_seeds,
    "dial_peers": dial_peers,
    "unsafe_flush_mempool": unsafe_flush_mempool,
    "unsafe_disconnect_peers": unsafe_disconnect_peers,
}

ROUTES = {
    "health": health,
    "dump_tasks": dump_tasks,
    "status": status,
    "fleet_status": fleet_status,
    "net_info": net_info,
    "genesis": genesis,
    "genesis_chunked": genesis_chunked,
    "blockchain": blockchain,
    "block": block,
    "block_by_hash": block_by_hash,
    "header": header,
    "header_by_hash": header_by_hash,
    "commit": commit,
    "block_results": block_results,
    "validators": validators,
    "consensus_state": consensus_state,
    "dump_consensus_state": dump_consensus_state,
    "consensus_params": consensus_params,
    "unconfirmed_txs": unconfirmed_txs,
    "num_unconfirmed_txs": num_unconfirmed_txs,
    "check_tx": check_tx,
    "broadcast_tx_async": broadcast_tx_async,
    "broadcast_tx_sync": broadcast_tx_sync,
    "broadcast_tx_commit": broadcast_tx_commit,
    "broadcast_evidence": broadcast_evidence,
    "abci_info": abci_info,
    "abci_query": abci_query,
    "tx": tx,
    "tx_search": tx_search,
    "block_search": block_search,
}
