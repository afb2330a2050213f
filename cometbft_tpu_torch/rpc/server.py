"""JSON-RPC 2.0 server over HTTP + WebSocket (reference
rpc/jsonrpc/server/): POST bodies, GET URI params, and a `/websocket`
endpoint with subscribe/unsubscribe event streaming backed by the
node's EventBus through the outbound fan-out plane (rpc/fanout.py —
one serialization pass per event × query shape, not per
subscriber).

A copy of the JAX package's ``rpc/server.py`` on the same ``aiohttp``
stack: JAX clients and websocket subscribers read a port node as they
read a JAX node."""

from __future__ import annotations

import asyncio
import json
import traceback
from typing import Any, Dict, Optional

from aiohttp import WSMsgType, web

from ..utils.pubsub_query import parse as parse_query
from . import core
from .env import Environment
from .fanout import FanoutHub


def _rpc_response(id_, result=None, error=None) -> Dict[str, Any]:
    out: Dict[str, Any] = {"jsonrpc": "2.0", "id": id_}
    if error is not None:
        out["error"] = error
    else:
        out["result"] = result
    return out


def _rpc_error(code: int, message: str, data: str = "") -> Dict[str, Any]:
    e: Dict[str, Any] = {"code": code, "message": message}
    if data:
        e["data"] = data
    return e


class RPCServer:
    def __init__(self, env: Environment):
        self.env = env
        # outbound fan-out plane: ONE bus subscription, one
        # serialization per event × query shape
        self.fanout = FanoutHub(
            env.event_bus, tracer=getattr(env, "tracer", None)
        )
        self.app = web.Application()
        self.app.router.add_post("/", self._handle_post)
        self.app.router.add_get("/websocket", self._handle_ws)
        self.app.router.add_get("/{method}", self._handle_get)
        self._runner: Optional[web.AppRunner] = None
        self._site = None
        self.listen_addr = ""

    # --- lifecycle ----------------------------------------------------

    async def start(self, addr: str) -> None:
        host, _, port = addr.rpartition(":")
        for p in ("tcp://", "http://"):
            if host.startswith(p):
                host = host[len(p):]
        self._runner = web.AppRunner(self.app, access_log=None)
        await self._runner.setup()
        self._site = web.TCPSite(self._runner, host or "127.0.0.1", int(port))
        await self._site.start()
        srv_sockets = self._site._server.sockets  # noqa: SLF001
        h, p = srv_sockets[0].getsockname()[:2]
        self.listen_addr = f"{h}:{p}"

    def _unsafe_enabled(self) -> bool:
        cfg = getattr(self.env, "config", None)
        return bool(cfg and getattr(cfg.rpc, "unsafe", False))

    async def stop(self) -> None:
        if self._runner:
            # bounded: aiohttp cleanup waits on open
            # websocket handlers — a stuck subscriber must not wedge
            # node shutdown
            try:
                await asyncio.wait_for(self._runner.cleanup(), 5.0)
            except asyncio.TimeoutError:
                pass
        # fan-out plane after the handlers: their exit paths detach
        # cleanly; close() reaps whatever a breached cleanup left
        try:
            await asyncio.wait_for(self.fanout.close(), 5.0)
        except asyncio.TimeoutError:
            pass

    # --- dispatch -----------------------------------------------------

    async def _call(self, method: str, params: Dict[str, Any]):
        fn = core.ROUTES.get(method)
        if fn is None and self._unsafe_enabled():
            fn = core.UNSAFE_ROUTES.get(method)
        if fn is None:
            raise core.RPCError(-32601, f"method {method!r} not found")
        res = fn(self.env, **params)
        if asyncio.iscoroutine(res):
            res = await res
        return res

    async def _handle_post(self, request: web.Request) -> web.Response:
        try:
            body = await request.json()
        except asyncio.CancelledError:
            raise
        except (ValueError, UnicodeDecodeError):
            return web.json_response(
                _rpc_response(None, error=_rpc_error(-32700, "parse error"))
            )
        batch = body if isinstance(body, list) else [body]
        out = []
        for req in batch:
            id_ = req.get("id")
            try:
                result = await self._call(
                    req.get("method", ""), req.get("params") or {}
                )
                out.append(_rpc_response(id_, result))
            except core.RPCError as e:
                out.append(
                    _rpc_response(id_, error=_rpc_error(e.code, str(e), e.data))
                )
            except TypeError as e:
                out.append(
                    _rpc_response(id_, error=_rpc_error(-32602, str(e)))
                )
            except asyncio.CancelledError:
                raise  # server stop cancels in-flight handlers
            except Exception as e:
                traceback.print_exc()
                out.append(
                    _rpc_response(
                        id_, error=_rpc_error(-32603, f"internal: {e}")
                    )
                )
        payload = out if isinstance(body, list) else out[0]
        return web.json_response(payload)

    async def _handle_get(self, request: web.Request) -> web.Response:
        method = request.match_info["method"]
        params = {k: v for k, v in request.query.items()}
        # strip the reference's quoted-string URI convention
        for k, v in params.items():
            if len(v) >= 2 and v[0] == '"' and v[-1] == '"':
                params[k] = v[1:-1]
        try:
            result = await self._call(method, params)
            return web.json_response(_rpc_response(-1, result))
        except core.RPCError as e:
            return web.json_response(
                _rpc_response(-1, error=_rpc_error(e.code, str(e), e.data))
            )
        except TypeError as e:
            return web.json_response(
                _rpc_response(-1, error=_rpc_error(-32602, str(e)))
            )
        except asyncio.CancelledError:
            raise  # server stop cancels in-flight handlers
        except Exception as e:
            traceback.print_exc()
            return web.json_response(
                _rpc_response(-1, error=_rpc_error(-32603, f"internal: {e}"))
            )

    # --- websocket subscriptions ---------------------------------------

    async def _handle_ws(self, request: web.Request):
        ws = web.WebSocketResponse()
        await ws.prepare(request)
        # query string -> FanoutSubscriber: the hub owns the bus
        # subscription + delivery; this handler only manages
        # membership for this socket's lifetime
        subs: Dict[str, object] = {}

        try:
            async for msg in ws:
                if msg.type != WSMsgType.TEXT:
                    continue
                try:
                    req = json.loads(msg.data)
                except Exception:
                    await ws.send_json(
                        _rpc_response(
                            None, error=_rpc_error(-32700, "parse error")
                        )
                    )
                    continue
                id_ = req.get("id")
                method = req.get("method", "")
                params = req.get("params") or {}
                if method == "subscribe":
                    qs = str(params.get("query", ""))
                    if qs in subs:
                        # reference errors on duplicate subscriptions;
                        # silently replacing would leak the old one
                        await ws.send_json(
                            _rpc_response(
                                id_,
                                error=_rpc_error(
                                    -32603, "already subscribed"
                                ),
                            )
                        )
                        continue
                    try:
                        q = parse_query(qs)
                    except ValueError as e:
                        await ws.send_json(
                            _rpc_response(
                                id_, error=_rpc_error(-32602, str(e))
                            )
                        )
                        continue
                    subs[qs] = self.fanout.attach(ws, qs, q, id_)
                    await ws.send_json(_rpc_response(id_, {}))
                elif method == "unsubscribe":
                    qs = str(params.get("query", ""))
                    sub = subs.pop(qs, None)
                    if sub is not None:
                        # awaits the cancelled writer (bounded): no
                        # mid-send task may outlive the subscription
                        await self.fanout.detach(sub)
                    await ws.send_json(_rpc_response(id_, {}))
                elif method == "unsubscribe_all":
                    await self.fanout.detach_all(subs.values())
                    subs.clear()
                    await ws.send_json(_rpc_response(id_, {}))
                else:
                    try:
                        result = await self._call(method, params)
                        await ws.send_json(_rpc_response(id_, result))
                    except core.RPCError as e:
                        await ws.send_json(
                            _rpc_response(
                                id_, error=_rpc_error(e.code, str(e))
                            )
                        )
                    except asyncio.CancelledError:
                        raise  # server stop cancels the ws handler
                    except Exception as e:
                        traceback.print_exc()
                        await ws.send_json(
                            _rpc_response(
                                id_, error=_rpc_error(-32603, str(e))
                            )
                        )
        finally:
            # handler exit (socket closed / server cleanup): detach
            # AND await every writer task bounded — fire-and-forget
            # cancel here used to leak mid-send tasks into loop
            # teardown
            await self.fanout.detach_all(subs.values())
        return ws
