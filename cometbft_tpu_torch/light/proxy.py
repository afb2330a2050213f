"""Light client RPC proxy (reference light/proxy/proxy.go + light/rpc):
a local JSON-RPC server whose block/header/commit/validators responses
are LIGHT-VERIFIED before being served — a wallet can point at this
instead of trusting a full node.

Routes proxied with verification: block, header, commit, validators,
status (verified tip), abci_query (merkle proof-op chain against the
light-verified AppHash of height+1 — value AND absence responses,
reference light/rpc/client.go:126-187), tx (inclusion proof against
the verified header's data hash, :473) and block_results (tx-results
merkle root against the next trusted header's LastResultsHash,
:382-424). Unverifiable routes (tx submission) pass through to the
primary.

A copy of the JAX package's ``light/proxy.py`` without its CLI mode
(ROADMAP A8, ``cmd/``), with one departure (ROADMAP C3, "on the serving
path"): a request whose verification met a failed verify route
(``DeviceRouteError``) is answered with JSON-RPC error ``-32603``, as
the JAX proxy answers any other failure, with a message that names the
failed route, never "verification failed"; the session ends as any
request's does, and the plane, its cache and the client's trusted
store are as they were, so the same request verifies once the card
answers."""

from __future__ import annotations

import asyncio
import base64
import time
from typing import Any, Dict, Optional

from aiohttp import web

from ..abci import types as abci
from ..crypto import merkle
from ..crypto.scheduler import DeviceRouteError
from ..rpc import encoding as enc
from ..rpc.client import HTTPClient, RPCClientError
from ..rpc.core import _bytes_param
from ..state.execution import results_hash
from ..state.state_types import ConsensusParams
from ..types.block import tx_hash
from ..utils import codec
from .client import Client
from .serving import LightServingPlane, ServingOverloadError

# JSON-RPC error code for an admission shed (server overloaded,
# request is retryable) — distinct from -32603 internal error so SDK
# retry policies can tell them apart
RPC_OVERLOADED = -32005


class LightProxy:
    def __init__(
        self,
        client: Client,
        primary_url: str,
        *,
        plane: Optional[LightServingPlane] = None,
        max_sessions: int = 1024,
        max_inflight: int = 32,
        tracer=None,
    ):
        self.lc = client
        # the serving plane (light/serving.py): shared verified-header
        # cache + coalesced verification + bounded instrumented
        # admission, on the client's device. A caller-provided plane
        # lets several fronts share one cache.
        if plane is None:
            kw = {"tracer": tracer} if tracer is not None else {}
            plane = LightServingPlane(
                [client],
                max_sessions=max_sessions,
                max_inflight=max_inflight,
                device=client.device,
                **kw,
            )
        else:
            plane.adopt_client(client)
        self.plane = plane
        self.primary = HTTPClient(primary_url)
        self.app = web.Application()
        self.app.router.add_get("/{method}", self._handle)
        self.app.router.add_post("/", self._handle_post)
        self._runner: Optional[web.AppRunner] = None
        self.listen_addr = ""

    async def start(self, addr: str) -> None:
        host, _, port = addr.rpartition(":")
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        site = web.TCPSite(self._runner, host or "127.0.0.1", int(port))
        await site.start()
        h, p = site._server.sockets[0].getsockname()[:2]  # noqa: SLF001
        self.listen_addr = f"{h}:{p}"

    async def stop(self) -> None:
        if self._runner:
            await self._runner.cleanup()
        await self.primary.close()

    # --- verified route implementations -------------------------------

    async def _verified_light_block(self, height: Optional[int]):
        """Run the (blocking) serving plane off-loop: shared cache →
        single-flight → coalesced verification (light/serving.py)."""
        if height is None:
            st = await self.primary.status()
            height = int(st["sync_info"]["latest_block_height"])
        return await asyncio.to_thread(self.plane.serve, height)

    async def _call(self, method: str, params: Dict[str, Any]):
        h = params.get("height")
        h = int(h) if h not in (None, "") else None
        if method == "header":
            lb = await self._verified_light_block(h)
            return {
                "header": enc.header_json(lb.header),
                "header_b64": enc.b64(codec.encode_header(lb.header)),
                "verified": True,
            }
        if method == "commit":
            lb = await self._verified_light_block(h)
            return {
                "signed_header": {
                    "header": enc.header_json(lb.header),
                    "commit": enc.commit_json(lb.commit),
                },
                "header_b64": enc.b64(codec.encode_header(lb.header)),
                "commit_b64": enc.b64(codec.encode_commit(lb.commit)),
                "verified": True,
            }
        if method == "validators":
            lb = await self._verified_light_block(h)
            return {
                "block_height": str(lb.height),
                "validators": [
                    enc.validator_json(v)
                    for v in lb.validator_set.validators
                ],
                "validator_set_b64": enc.b64(
                    codec.encode_validator_set(lb.validator_set)
                ),
                "verified": True,
            }
        if method == "block":
            lb = await self._verified_light_block(h)
            # fetch the full block from the primary, verify its hash
            # against the light-verified header
            res = await self.primary.block(lb.height)
            blk = codec.decode_block(base64.b64decode(res["block_b64"]))
            if bytes(blk.hash()) != bytes(lb.header.hash()):
                raise RuntimeError(
                    "primary served a block that does not match the "
                    "verified header"
                )
            res["verified"] = True
            return res
        if method == "status":
            lb = await self._verified_light_block(None)
            return {
                "sync_info": {
                    "latest_block_height": str(lb.height),
                    "latest_block_hash": enc.hexb(lb.hash()),
                    "latest_block_time_ns": str(lb.header.time_ns),
                },
                "verified": True,
            }
        if method == "abci_query":
            return await self._verified_abci_query(params)
        if method == "tx":
            return await self._verified_tx(params)
        if method == "block_results":
            return await self._verified_block_results(h)
        if method == "consensus_params":
            return await self._verified_consensus_params(h)
        if method == "serving_status":
            # local introspection: sessions, admission gate, cache +
            # coalesce stats (docs/PERF.md "Light-client serving
            # plane") — never touches the primary
            return self.plane.stats()
        # passthrough (tx submission, unverifiable routes)
        return await self.primary.call(method, **params)

    async def _verified_consensus_params(self, height: Optional[int]):
        """Consensus params whose hash must equal the trusted
        header's consensus_hash at that height (reference
        light/rpc/client.go:229-256)."""
        params = {} if height is None else {"height": str(height)}
        res = await self.primary.call("consensus_params", **params)
        h = int(res.get("block_height") or 0)
        if h <= 0:
            raise RuntimeError(
                "primary returned no height for consensus params"
            )
        if height is not None and h != height:
            raise RuntimeError(
                "primary answered for a different height than "
                "requested"
            )
        cp = ConsensusParams.decode(
            base64.b64decode(res.get("params_b64") or "")
        )
        lb = await self._verified_light_block(h)
        if bytes(cp.hash()) != bytes(lb.header.consensus_hash):
            raise RuntimeError(
                "consensus params do not match the trusted header's "
                "consensus hash"
            )
        # serve the dict REBUILT from the verified bytes: the
        # primary's human-readable fields are what a wallet reads,
        # and they must not be independently forgeable next to an
        # honest params_b64
        return {
            "block_height": str(h),
            "params_b64": res.get("params_b64"),
            "consensus_params": cp.to_dict(),
            "verified": True,
        }

    async def _verified_block_results(self, height: Optional[int]):
        """Block results verified against the NEXT trusted header's
        LastResultsHash (reference light/rpc/client.go:382-424): the
        deterministic tx-result subset (code, data, gas, codespace) is
        re-encoded and its merkle root must equal what block
        height+1's header committed to. Without a height, serve the
        block PRECEDING the latest — the latest's results are not
        provable yet. NOTE (as the reference notes): only tx results
        are verifiable; events/finalize data are not part of the
        committed hash."""
        if height is None:
            st = await self.primary.status()
            height = int(st["sync_info"]["latest_block_height"]) - 1
        if height <= 0:
            raise RuntimeError(
                "block_results needs a positive provable height"
            )
        res = await self.primary.call(
            "block_results", height=str(height)
        )
        if int(res.get("height") or 0) != height:
            raise RuntimeError(
                "primary returned results for a different height"
            )
        txrs = [
            abci.ExecTxResult(
                code=int(tr.get("code") or 0),
                data=base64.b64decode(tr.get("data") or ""),
                gas_wanted=int(tr.get("gas_wanted") or 0),
                gas_used=int(tr.get("gas_used") or 0),
                codespace=tr.get("codespace") or "",
            )
            for tr in res.get("txs_results") or []
        ]
        lb = await self._verified_light_block(height + 1)
        if results_hash(txrs) != bytes(lb.header.last_results_hash):
            raise RuntimeError(
                "tx results do not match the trusted LastResultsHash"
            )
        res["verified"] = True
        return res

    async def _verified_abci_query(self, params: Dict[str, Any]):
        """ABCI query with merkle proof verification against the
        light-verified AppHash (reference light/rpc/client.go:126-187):
        the primary is forced to prove=true, the proof-op chain must
        land on the AppHash of the light block at height+1 (the header
        that commits the post-height state), and BOTH value and
        absence responses are proven — a primary that tampers with
        either gets rejected, not relayed."""
        params = dict(params)
        params["prove"] = True
        res = await self.primary.call("abci_query", **params)
        resp = res.get("response") or {}
        code = int(resp.get("code") or 0)
        key = base64.b64decode(resp.get("key") or "")
        value = base64.b64decode(resp.get("value") or "")
        # the proof must be for the key the CALLER asked about — a
        # primary substituting another committed key's (genuinely
        # provable) value or absence must be rejected, not relayed
        requested = _bytes_param(params.get("data"))
        if key != requested:
            raise RuntimeError(
                "primary answered for a different key than requested"
            )
        h = int(resp.get("height") or 0)
        if h <= 0:
            raise RuntimeError("primary returned no proof height")
        ops_b64 = resp.get("proof_ops") or ""
        if not ops_b64:
            raise RuntimeError(
                "primary returned no proof ops (app without prove "
                "support cannot be light-verified)"
            )
        ops = merkle.decode_proof_ops(base64.b64decode(ops_b64))
        # the proof lands on the AppHash of height+1, which only exists
        # once the NEXT block commits; at the tip that is up to one
        # block interval away — wait bounded for the chain to advance
        deadline = time.monotonic() + 15.0
        while True:
            st = await self.primary.status()
            if (
                int(st["sync_info"]["latest_block_height"]) >= h + 1
            ):
                break
            if time.monotonic() > deadline:
                raise RuntimeError(
                    f"chain did not reach proof height {h + 1}"
                )
            await asyncio.sleep(0.1)
        lb = await self._verified_light_block(h + 1)
        rt = merkle.ProofRuntime()
        # route by CODE, not value truthiness: a key legitimately
        # committed with an EMPTY value still gets a value proof
        if code == 0:
            rt.verify_value(ops, lb.header.app_hash, key, value)
        else:
            rt.verify_absence(ops, lb.header.app_hash, key)
        res["verified"] = True
        return res

    async def _verified_tx(self, params: Dict[str, Any]):
        """Tx lookup with inclusion-proof verification against the
        light-verified header's data hash (reference
        light/rpc/client.go:473)."""
        params = dict(params)
        params["prove"] = True
        # the hash param must be present and parseable BEFORE the
        # primary is consulted: without it the identity check below
        # has nothing to bind to, and a primary could return any
        # committed tx with a valid inclusion proof and have it marked
        # verified
        requested = _bytes_param(params.get("hash"))
        if not requested:
            raise RuntimeError(
                "verified tx lookup requires a tx hash param"
            )
        res = await self.primary.call("tx", **params)
        height = int(res.get("height") or 0)
        if height <= 0:
            # height=0 would resolve _verified_light_block to the
            # primary-chosen latest height — reject malformed responses
            raise RuntimeError(
                "primary returned a tx without a positive height"
            )
        proof = res.get("proof") or {}
        if not proof.get("proof_b64"):
            raise RuntimeError("primary returned no tx inclusion proof")
        tx_bytes = base64.b64decode(res.get("tx") or "")
        # the returned tx must BE the one the caller asked about — an
        # inclusion proof for a different (genuinely committed) tx
        # would otherwise verify
        if tx_hash(tx_bytes) != requested:
            raise RuntimeError(
                "primary returned a different tx than requested"
            )
        p = merkle.decode_proof(
            base64.b64decode(proof["proof_b64"])
        )
        lb = await self._verified_light_block(height)
        if not p.verify(lb.header.data_hash, tx_hash(tx_bytes)):
            raise RuntimeError(
                "tx inclusion proof does not verify against the "
                "light-verified header"
            )
        res["verified"] = True
        return res

    # --- http plumbing -------------------------------------------------

    async def _handle(self, request: web.Request) -> web.Response:
        method = request.match_info["method"]
        params = {
            k: v.strip('"') for k, v in request.query.items()
        }
        return await self._respond(method, params, -1)

    async def _handle_post(self, request: web.Request) -> web.Response:
        body = await request.json()
        return await self._respond(
            body.get("method", ""), body.get("params") or {}, body.get("id")
        )

    async def _respond(self, method, params, id_) -> web.Response:
        # each in-flight HTTP request is one serving session: the
        # plane bounds them (max_sessions) and sheds-and-counts past
        # the bound rather than queueing unbounded work
        try:
            session = self.plane.open_session()
        except ServingOverloadError as e:
            return web.json_response(
                {
                    "jsonrpc": "2.0",
                    "id": id_,
                    "error": {
                        "code": RPC_OVERLOADED,
                        "message": f"overloaded: {e}",
                    },
                }
            )
        try:
            result = await self._call(method, params)
            return web.json_response(
                {"jsonrpc": "2.0", "id": id_, "result": result}
            )
        except ServingOverloadError as e:
            return web.json_response(
                {
                    "jsonrpc": "2.0",
                    "id": id_,
                    "error": {
                        "code": RPC_OVERLOADED,
                        "message": f"overloaded: {e}",
                    },
                }
            )
        except asyncio.CancelledError:
            raise  # server stop cancels in-flight handlers
        except DeviceRouteError as e:
            # no verdict (C3): the card failed, not the primary's data
            return web.json_response(
                {
                    "jsonrpc": "2.0",
                    "id": id_,
                    "error": {"code": -32603, "message": f"no verdict: {e}"},
                }
            )
        except RPCClientError as e:
            # forward the primary's structured error VERBATIM —
            # above all the retention plane's "height pruned
            # (base=N)" verdict (rpc/core.py _pruned_error), whose
            # machine-readable data field a light client uses to
            # redirect the query to an archive node
            return web.json_response(
                {
                    "jsonrpc": "2.0",
                    "id": id_,
                    "error": {
                        "code": e.code,
                        "message": e.message,
                        "data": e.data,
                    },
                }
            )
        except Exception as e:
            return web.json_response(
                {
                    "jsonrpc": "2.0",
                    "id": id_,
                    "error": {"code": -32603, "message": str(e)},
                }
            )
        finally:
            session.close()
